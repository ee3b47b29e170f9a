"""Entry points and launch helpers of the port: LM ``serve``, ``train``
and ``profile``, the cohort mesh over ``torch.distributed`` (``mesh``),
the sharding rules (``sharding``) and collective traffic read from
``torch.profiler`` traces (``collectives``). Dry runs and the production
mesh come with ROADMAP.md queue 1 item 14."""
