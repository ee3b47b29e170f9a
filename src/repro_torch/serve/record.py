"""Serve-side observability: structured serve records through
``repro_torch.obs`` — the port of the JAX package's ``serve/record.py``.

``ServeRecorder`` mirrors ``repro_torch.obs.RunRecorder`` for the serving
loop:
one record directory per serve session, containing

- ``manifest.json``   — artifact metadata (mode, population, config hash
  lineage), engine/batch configuration, environment snapshot (the card's
  name and power limit on the card), and (at close) the latency summary
  (QPS, p50/p99);
- ``requests.jsonl``  — one JSON object per served request: client id,
  enqueue/start/finish seconds, queue wait, latency, steps (decode:
  tokens generated);
- ``trace.json``      — opt-in Chrome/Perfetto trace
  (``repro_torch.obs.trace``) with one ``request`` span per served request
  on a per-lane timeline (wall-clock seconds relative to the session
  start), valid under the same schema checker as training traces.

Like training observation, serve recording is pure host-side: outputs are
bit-identical with or without a recorder attached.
"""

from __future__ import annotations

import json
import os

from repro_torch.obs.record import environment_snapshot
from repro_torch.obs.trace import TraceBuilder

__all__ = ["ServeRecorder"]

SERVE_RECORD_SCHEMA_VERSION = 1
PID_LANES = 1


class ServeRecorder:
    """One structured record of one serving session.

    Lifecycle: ``open_session`` once, ``on_request`` per completed request
    (the ``ContinuousBatcher`` calls it), ``close(stats)`` to finalize."""

    def __init__(self, out_dir: str, trace: bool = False, echo: bool = False):
        self.out_dir = out_dir
        self.echo = echo
        self._want_trace = trace
        self._trace: TraceBuilder | None = None
        self._requests = None
        self._manifest: dict = {}
        self._n = 0
        self._lane_end: list = []  # per trace lane: last span end (greedy packing)
        self._closed = False

    def open_session(self, *, artifact_meta: dict, engine: str,
                     batch_size: int, extra: dict | None = None, device=None):
        """Start the record; ``device`` is the serving device the
        environment snapshot describes (default: the card when there is
        one)."""
        if self._requests is not None:
            raise ValueError("serve recorder already opened")
        os.makedirs(self.out_dir, exist_ok=True)
        self._manifest = {
            "schema_version": SERVE_RECORD_SCHEMA_VERSION,
            "kind": "serve",
            "engine": engine,
            "batch_size": int(batch_size),
            "artifact": artifact_meta,
            "environment": environment_snapshot(device),
        }
        if extra:
            self._manifest.update(extra)
        self._requests = open(os.path.join(self.out_dir, "requests.jsonl"), "w")
        if self._want_trace:
            self._trace = TraceBuilder()
            self._trace.process_name(PID_LANES, "serve lanes")

    def on_request(self, res):
        """Record one completed ``ServeResult``."""
        row = {
            "rid": int(res.rid),
            "client": int(res.client_id),
            "enqueue_s": float(res.enqueue_s),
            "start_s": float(res.start_s),
            "finish_s": float(res.finish_s),
            "queue_wait_s": float(res.start_s - res.enqueue_s),
            "latency_s": float(res.latency_s),
            "steps": int(res.steps),
        }
        self._requests.write(json.dumps(row) + "\n")
        self._n += 1
        if self.echo:
            print(f"  request {res.rid}: client {res.client_id} "
                  f"{res.latency_s * 1e3:.2f}ms")
        if self._trace is not None:
            # greedy interval packing: first lane whose last span ended by
            # this start — spans in a lane never overlap, so the trace
            # stays stack-valid under the schema checker
            lane = next(
                (i for i, e in enumerate(self._lane_end) if e <= res.start_s),
                len(self._lane_end),
            )
            if lane == len(self._lane_end):
                self._lane_end.append(0.0)
            self._lane_end[lane] = res.finish_s
            self._trace._lane(PID_LANES, lane, f"lane {lane}")
            self._trace.span(
                "request", PID_LANES, lane, res.start_s, res.finish_s,
                {"rid": int(res.rid), "client": int(res.client_id),
                 "enqueue_s": float(res.enqueue_s)},
            )

    def close(self, stats: dict | None = None) -> str:
        if self._closed:
            return self.out_dir
        self._closed = True
        files = {"requests": "requests.jsonl"}
        if self._requests is not None:
            self._requests.close()
        if self._trace is not None:
            self._trace.save(os.path.join(self.out_dir, "trace.json"))
            files["trace"] = "trace.json"
        self._manifest["files"] = files
        self._manifest["requests_recorded"] = self._n
        if stats:
            self._manifest["summary"] = stats
        with open(os.path.join(self.out_dir, "manifest.json"), "w") as f:
            json.dump(self._manifest, f, indent=2, default=str)
            f.write("\n")
        return self.out_dir
