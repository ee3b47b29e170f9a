"""FL runtime of the port: the composable round pipeline
(``repro_torch.fl.api`` + ``repro_torch.fl.phases``), the sync and async
schedulers driving it (``repro_torch.fl.sched``), fault injection
(``repro_torch.fl.faults``) and the simulation entry point
(``repro_torch.fl.engine``)."""

from repro_torch.fl.api import (
    CodecConfig,
    ExecutionConfig,
    FaultConfig,
    FLConfig,
    PersonalizationConfig,
    RoundPipeline,
    RoundState,
    SchedulerConfig,
    SelectionConfig,
    TrainConfig,
    build_chunk_step,
    build_env,
    build_round_step,
    pipeline_from_config,
)
from repro_torch.fl.engine import FLHistory, make_round_step, run_federated
from repro_torch.fl.sched import AsyncScheduler, SyncScheduler, make_scheduler

__all__ = [
    "FLConfig",
    "SelectionConfig",
    "PersonalizationConfig",
    "CodecConfig",
    "SchedulerConfig",
    "ExecutionConfig",
    "TrainConfig",
    "FaultConfig",
    "FLHistory",
    "RoundPipeline",
    "RoundState",
    "pipeline_from_config",
    "build_env",
    "build_round_step",
    "build_chunk_step",
    "run_federated",
    "make_round_step",
    "SyncScheduler",
    "AsyncScheduler",
    "make_scheduler",
]
