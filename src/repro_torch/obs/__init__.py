"""repro_torch.obs — host-side observability for the federated schedulers,
the port of the JAX package's ``repro.obs``.

Three layers, all opt-in and all pure host-side observation (a recorded
run's device trajectory is bit-identical to an unrecorded one):

- ``repro_torch.obs.record`` — ``RunRecorder``: structured run records
  (manifest + per-round ``metrics.jsonl`` + progress log), fed by the
  schedulers from the numpy records of each chunk's or event's one
  device-to-host copy.
- ``repro_torch.obs.trace``  — Chrome/Perfetto trace-event export on the
  *simulated* clock (per-client dispatch/train/upload lanes, aggregation
  instants, sync round/chunk spans) and its schema validator.
- ``repro_torch.obs.profile`` — opt-in wall-clock profiling of the real
  loop (CUDA-graph capture vs dispatch vs device_get per chunk, the number
  of captures, the card's memory watermark, optional ``torch.profiler``
  capture through ``torch_trace_dir``).

Attach a recorder through the entry point::

    from repro_torch.obs import RunRecorder
    rec = RunRecorder("experiments/run0", trace=True)
    h = run_federated(ds, cfg, recorder=rec)      # writes experiments/run0/

Open ``trace.json`` at https://ui.perfetto.dev (or chrome://tracing).
"""

from repro_torch.obs.profile import Profiler
from repro_torch.obs.record import (
    RunRecorder,
    environment_snapshot,
    format_async_progress,
    format_sync_progress,
)
from repro_torch.obs.trace import TraceBuilder, validate_trace, validate_trace_file

__all__ = [
    "Profiler",
    "RunRecorder",
    "TraceBuilder",
    "environment_snapshot",
    "format_async_progress",
    "format_sync_progress",
    "validate_trace",
    "validate_trace_file",
]
