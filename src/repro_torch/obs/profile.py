"""Opt-in wall-clock profiling of the real executor loop — the port of the
JAX package's ``obs/profile.py``.

Where the rest of ``repro_torch.obs`` observes the *simulated* clock, the
``Profiler`` measures where host time goes while the schedulers drive the
device: per chunk (sync) or per event (async) it splits

- ``capture``    — capturing a chunk step's CUDA graph
                   (``repro_torch.fl.api.build_chunk_step``; the port's
                   counterpart of the JAX package's ``compile``), once per
                   distinct chunk length, inside that chunk's first call,
- ``dispatch``   — the eager round or event step, or the graph's replay,
                   until it returns (on the card this is mostly enqueue
                   time; on the CPU it includes the compute), less any
                   capture inside it (a phase timed inside another counts
                   for itself only),
- ``device_get`` — the one blocking device-to-host copy of the chunk's or
                   event's records (``StackedOuts.numpy``),
- ``record``     — the recorder's own host pass over those records (metric
                   rows and trace spans): what the recording costs,

plus the number of CUDA-graph captures (one a ``capture`` phase) and a
device-memory watermark:
``torch.cuda.memory_allocated`` after each chunk and
``torch.cuda.max_memory_allocated`` over the run, on the run's device. A
run on the CPU has no such counter, and its watermark is ``None``.

``torch_trace_dir`` additionally captures a ``torch.profiler`` trace (CPU
activity, and CUDA activity on the card) around the run and writes it as a
Chrome trace (``torch_trace.json``) into that directory. A profiler that
fails to start or to write raises: nothing falls back quietly.

The profiler is opt-in end to end: the schedulers hold ``None`` unless
``RunRecorder(profile=True)`` attached one, and every hook sits behind an
``is not None`` check, so the disabled path costs nothing.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["Profiler", "phase_timer"]

TORCH_TRACE_FILE = "torch_trace.json"


def phase_timer(prof: "Profiler | None", name: str):
    """Context manager timing a phase on ``prof`` — a no-op context when
    profiling is off (the schedulers' single call site for both paths)."""
    if prof is None:
        return contextlib.nullcontext()
    return prof.phase(name)


class Profiler:
    """Accumulates per-chunk phase timings and the memory watermark; pure
    host state, summarized by ``summary()`` into ``profile.json``."""

    def __init__(self, torch_trace_dir: str | None = None):
        self.totals: dict[str, float] = {}
        self.chunks: list[dict] = []
        self.captures = 0
        self.peak_live_bytes: int | None = None
        self._current: dict | None = None
        self._inner: list[float] = []  # per open phase: time of the phases inside it
        self._device: torch.device | None = None
        self._torch_trace_dir = torch_trace_dir
        self._torch_prof = None
        self._torch_trace_path: str | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, device=None):
        """Begin a run on ``device`` (the watermark's device; None or a CPU
        device: no watermark) and, with ``torch_trace_dir``, start the
        ``torch.profiler`` capture."""
        self._device = None if device is None else torch.device(device)
        if self._on_cuda():
            torch.cuda.reset_peak_memory_stats(self._device)
            self.peak_live_bytes = 0
        if self._torch_trace_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self._on_cuda():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._torch_prof = torch.profiler.profile(activities=activities)
            self._torch_prof.start()

    def stop(self):
        """Stop the ``torch.profiler`` capture and write its Chrome trace."""
        if self._torch_prof is not None:
            prof, self._torch_prof = self._torch_prof, None
            prof.stop()
            os.makedirs(self._torch_trace_dir, exist_ok=True)
            self._torch_trace_path = os.path.join(self._torch_trace_dir, TORCH_TRACE_FILE)
            prof.export_chrome_trace(self._torch_trace_path)

    def _on_cuda(self) -> bool:
        return self._device is not None and self._device.type == "cuda"

    # -- per-chunk hooks ---------------------------------------------------
    def begin_chunk(self, t0: int, n: int):
        self._current = {"t0": int(t0), "rounds": int(n)}
        self.chunks.append(self._current)

    def end_chunk(self):
        self.sample_memory()
        self._current = None

    @contextlib.contextmanager
    def phase(self, name: str):
        if name == "capture":
            self.captures += 1
        t0 = time.perf_counter()
        self._inner.append(0.0)
        try:
            yield
        finally:
            elapsed = time.perf_counter() - t0
            dt = elapsed - self._inner.pop()
            if self._inner:
                self._inner[-1] += elapsed
            self.totals[name] = self.totals.get(name, 0.0) + dt
            if self._current is not None:
                self._current[f"{name}_s"] = self._current.get(f"{name}_s", 0.0) + dt

    def sample_memory(self):
        """The device's allocated bytes now and its peak so far (the card
        only)."""
        if not self._on_cuda():
            return
        live = int(torch.cuda.memory_allocated(self._device))
        self.peak_live_bytes = int(torch.cuda.max_memory_allocated(self._device))
        if self._current is not None:
            self._current["live_bytes"] = live

    # -- output ------------------------------------------------------------
    def summary(self) -> dict:
        return {
            "totals_s": dict(self.totals),
            "graph_captures": self.captures,
            "peak_live_bytes": self.peak_live_bytes,
            "device": None if self._device is None else str(self._device),
            "torch_trace_dir": self._torch_trace_dir,
            "torch_trace": self._torch_trace_path,
            "chunks": self.chunks,
        }
