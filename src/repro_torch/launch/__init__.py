"""Entry points and launch helpers of the port: LM ``serve``, ``train``
and ``profile``, the cohort mesh and the production mesh of ranks over
``torch.distributed`` (``mesh``), the mesh context model code reads
(``context``), the sharding rules (``sharding``), collective traffic
read from ``torch.profiler`` traces (``collectives``), and the dry run
(``dryrun``) with its per-rank cost counter (``cost_analysis``)."""
