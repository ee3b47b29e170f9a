"""Entry points and launch helpers of the port: LM ``serve``, ``train``
and ``profile``, the cohort mesh and the production mesh of ranks over
``torch.distributed`` (``mesh``), the mesh context model code reads
(``context``), the sharding rules (``sharding``) and collective traffic
read from ``torch.profiler`` traces (``collectives``). Dry runs come with
ROADMAP.md queue 1 item 14."""
