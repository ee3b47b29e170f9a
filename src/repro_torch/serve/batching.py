"""Continuous-batching request loop over fixed batch lanes.

The server owns ``B`` lanes. Requests queue; a free lane takes the oldest
waiting request, every occupied lane advances one engine step per loop
iteration, finished lanes retire and are back-filled from the queue in the
same iteration. Per-request latency is measured enqueue -> finish on the
host wall clock, so queueing delay under load is part of p99.

The loop is engine-agnostic via ``LaneProgram``: the classify path
(``ClassifyProgram`` — one batched personalized forward, every lane
finishes each step) and the decode path
(``repro_torch.serve.decode.DecodeProgram`` — lanes retire on EOS or
max-new) both run under the same batcher and the same accounting, with a
``ServeRecorder`` (``repro_torch.serve.record``) receiving one span per
request. A copy of the JAX package's ``serve/batching.py`` (pure Python and
numpy; ``ClassifyProgram`` hands its lanes to the torch engine).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np

__all__ = [
    "ServeRequest",
    "ServeResult",
    "LaneProgram",
    "ClassifyProgram",
    "ContinuousBatcher",
    "latency_stats",
]


@dataclasses.dataclass
class ServeRequest:
    """One inference request: which client's model, plus its inputs.
    ``steps`` bounds multi-step (decode) requests."""

    rid: int
    client_id: int
    inputs: Any
    steps: int = 1


@dataclasses.dataclass
class ServeResult:
    rid: int
    client_id: int
    output: Any
    enqueue_s: float      # relative to the batcher's t0
    start_s: float        # lane assignment time
    finish_s: float
    steps: int = 1

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.enqueue_s


class LaneProgram:
    """What one batched engine step does. ``step`` advances every occupied
    lane once and returns per-lane ``(done, output)``."""

    def start(self, lane: int, req: ServeRequest) -> None:
        raise NotImplementedError

    def step(self, occupied: np.ndarray):
        """occupied: (B,) bool. Returns (done (B,) bool, outputs list[B])."""
        raise NotImplementedError


class ClassifyProgram(LaneProgram):
    """Personalized classification: each step is ONE batched composed
    forward over the program's lanes (``PersonalizedEngine.forward``);
    every occupied lane finishes per step. Empty lanes compute client 0 on
    zero-filled (or stale) inputs and are masked out, so the batch shape
    stays static."""

    def __init__(self, engine, batch_size: int):
        self.engine = engine
        self.b = batch_size
        feat = int(engine.artifact.global_params[0]["w"].shape[0])
        self._ids = np.zeros((batch_size,), np.int64)
        self._x = np.zeros((batch_size, feat), np.float32)

    def start(self, lane: int, req: ServeRequest) -> None:
        self._ids[lane] = req.client_id
        self._x[lane] = np.asarray(req.inputs, np.float32)

    def step(self, occupied: np.ndarray):
        out = self.engine.forward(self._ids, self._x).cpu().numpy()
        done = occupied.copy()
        return done, [out[i] if occupied[i] else None for i in range(self.b)]


class ContinuousBatcher:
    """Drives a ``LaneProgram`` over a request stream with lane
    retirement/backfill and per-request latency spans; ``recorder`` (a
    ``ServeRecorder``) gets each finished request's ``ServeResult``."""

    def __init__(self, program: LaneProgram, batch_size: int, recorder=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.program = program
        self.b = batch_size
        self.recorder = recorder
        self.clock = clock

    def run(self, requests: Sequence[ServeRequest]) -> list[ServeResult]:
        t0 = self.clock()
        now = lambda: self.clock() - t0  # noqa: E731
        queue: list[tuple[ServeRequest, float]] = [(r, 0.0) for r in requests]
        lanes: list[tuple[ServeRequest, float, float] | None] = [None] * self.b
        occupied = np.zeros((self.b,), bool)
        results: list[ServeResult] = []

        def backfill():
            for i in range(self.b):
                if lanes[i] is None and queue:
                    req, enq = queue.pop(0)
                    self.program.start(i, req)
                    lanes[i] = (req, enq, now())
                    occupied[i] = True

        backfill()
        while occupied.any():
            done, outputs = self.program.step(occupied)
            t_fin = now()
            finish_steps = getattr(self.program, "finish_steps", None)
            for i in range(self.b):
                if occupied[i] and done[i]:
                    req, enq, start = lanes[i]
                    res = ServeResult(
                        rid=req.rid, client_id=req.client_id, output=outputs[i],
                        enqueue_s=enq, start_s=start, finish_s=t_fin,
                        # decode reports the tokens it generated (EOS can
                        # undershoot the budget)
                        steps=finish_steps(i, outputs[i]) if finish_steps else req.steps,
                    )
                    results.append(res)
                    if self.recorder is not None:
                        self.recorder.on_request(res)
                    lanes[i] = None
                    occupied[i] = False
            backfill()  # retired lanes refill before the next step
        return results


def latency_stats(results: Sequence[ServeResult]) -> dict:
    """QPS + latency percentiles for a completed request stream."""
    if not results:
        return {"n_requests": 0, "qps": 0.0}
    lat = np.asarray([r.latency_s for r in results], np.float64)
    span = max(max(r.finish_s for r in results), 1e-9)
    return {
        "n_requests": len(results),
        "qps": len(results) / span,
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "latency_mean_ms": float(lat.mean() * 1e3),
        "wall_s": float(span),
    }
