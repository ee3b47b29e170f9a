"""Chrome/Perfetto trace-event export on the *simulated* clock — a copy of
the JAX package's ``obs/trace.py`` (pure Python and JSON).

``TraceBuilder`` accumulates trace events in the Trace Event JSON format
(the ``{"traceEvents": [...]}`` container Perfetto and ``chrome://tracing``
load directly) with timestamps in microseconds of **simulated** time — the
event clock the schedulers run on (``CommModel`` / ``ClientClock``), not
wall-clock. The lane convention:

- ``pid 0`` ("server") — the scheduler's own timeline: ``chunk`` spans
  (the host-sync cadence of a chunk of rounds) nesting ``round`` spans
  under the sync barrier, and ``aggregate`` instants (one per aggregation,
  with staleness / ``buffer_k`` annotations under async).
- ``pid 1`` ("clients") — one thread lane per client id: each dispatch
  becomes a ``dispatch`` (downlink) -> ``train`` -> ``upload`` span triple
  tiling ``[t_dispatch, t_finish)`` exactly (the upload span absorbs the
  float remainder, so the triple's end is bit-identical to the finish time
  the scheduler's event queue used).

Span boundaries carry the exact float64 simulated seconds in ``args``
(``start_s`` / ``end_s`` / ``clock_s``) so downstream checks can compare
against ``FLHistory`` bit-for-bit instead of re-deriving seconds from the
microsecond ``ts`` field.

``validate_trace`` / ``validate_trace_file`` are the schema checks:
well-formed events, non-decreasing ``ts``, stack-disciplined B/E matching
per lane, and client lanes within the population.
"""

from __future__ import annotations

import json
from typing import Any

__all__ = [
    "PID_CLIENTS",
    "PID_SERVER",
    "TraceBuilder",
    "validate_trace",
    "validate_trace_file",
]

PID_SERVER = 0
PID_CLIENTS = 1

_PHASES = ("B", "E", "i", "X", "C", "M")  # the subset we emit / accept


class TraceBuilder:
    """Accumulates trace events; ``save`` sorts by timestamp and writes the
    Perfetto-loadable container. Emission order is preserved among events
    with equal ``ts`` (stable sort), so a span ending exactly where its
    sibling begins keeps E-before-B order and stays stack-valid."""

    def __init__(self):
        self._events: list[dict] = []
        self._lanes: set[tuple[int, int]] = set()
        self.process_name(PID_SERVER, "server")
        self.process_name(PID_CLIENTS, "clients")

    # -- metadata ----------------------------------------------------------
    def process_name(self, pid: int, name: str):
        self._events.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": name}}
        )

    def _lane(self, pid: int, tid: int, name: str):
        if (pid, tid) not in self._lanes:
            self._lanes.add((pid, tid))
            self._events.append(
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": name}}
            )

    def client_lane(self, client: int):
        self._lane(PID_CLIENTS, int(client), f"client {int(client)}")

    def server_lane(self, tid: int = 0, name: str = "scheduler"):
        self._lane(PID_SERVER, tid, name)

    # -- events (ts in simulated seconds; stored as microseconds) ----------
    def begin(self, name: str, pid: int, tid: int, t_s: float, args: dict | None = None):
        ev = {"name": name, "ph": "B", "pid": pid, "tid": int(tid),
              "ts": float(t_s) * 1e6}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def end(self, name: str, pid: int, tid: int, t_s: float):
        self._events.append(
            {"name": name, "ph": "E", "pid": pid, "tid": int(tid),
             "ts": float(t_s) * 1e6}
        )

    def span(self, name: str, pid: int, tid: int, t0_s: float, t1_s: float,
             args: dict | None = None):
        self.begin(name, pid, tid, t0_s, args)
        self.end(name, pid, tid, t1_s)

    def instant(self, name: str, pid: int, tid: int, t_s: float,
                args: dict | None = None):
        ev = {"name": name, "ph": "i", "pid": pid, "tid": int(tid),
              "ts": float(t_s) * 1e6, "s": "t"}
        if args:
            ev["args"] = args
        self._events.append(ev)

    # -- output ------------------------------------------------------------
    def to_obj(self) -> dict:
        meta = [e for e in self._events if e["ph"] == "M"]
        timed = [e for e in self._events if e["ph"] != "M"]
        timed.sort(key=lambda e: e["ts"])  # stable: emission order on ties
        return {"traceEvents": meta + timed, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_obj(), f)
            f.write("\n")
        return path


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def validate_trace(obj: Any, population: int | None = None) -> list[str]:
    """Schema-check a trace-event object; returns a list of problems
    (empty = valid). Checks: container shape, per-event required fields,
    non-decreasing ``ts`` over the timed events, stack-disciplined B/E
    matching per ``(pid, tid)`` lane, and — when ``population`` is given —
    every client-process lane id in ``[0, population)``."""
    errors: list[str] = []
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        return ["top level must be a dict with a 'traceEvents' list"]
    stacks: dict[tuple, list[str]] = {}
    last_ts = None
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"event {i}: bad ph {ph!r}")
            continue
        for field in ("name", "pid", "tid"):
            if field not in ev:
                errors.append(f"event {i} ({ph}): missing {field!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i} ({ev.get('name')}): bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            errors.append(
                f"event {i} ({ev.get('name')}): ts {ts} decreases from {last_ts}"
            )
        last_ts = ts
        lane = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(lane, []).append(ev.get("name"))
        elif ph == "E":
            stack = stacks.setdefault(lane, [])
            if not stack:
                errors.append(
                    f"event {i}: E {ev.get('name')!r} on lane {lane} with empty stack"
                )
            elif stack[-1] != ev.get("name"):
                errors.append(
                    f"event {i}: E {ev.get('name')!r} does not match open span "
                    f"{stack[-1]!r} on lane {lane}"
                )
            else:
                stack.pop()
        if population is not None and ev.get("pid") == PID_CLIENTS:
            tid = ev.get("tid")
            if not isinstance(tid, int) or not 0 <= tid < population:
                errors.append(
                    f"event {i} ({ev.get('name')}): client lane {tid!r} outside "
                    f"population [0, {population})"
                )
    for lane, stack in stacks.items():
        if stack:
            errors.append(f"lane {lane}: {len(stack)} unclosed span(s): {stack}")
    return errors


def validate_trace_file(path: str, population: int | None = None) -> list[str]:
    """``validate_trace`` over a JSON file; parse failures come back as a
    one-element error list rather than an exception."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: cannot load trace JSON: {e}"]
    return validate_trace(obj, population=population)
