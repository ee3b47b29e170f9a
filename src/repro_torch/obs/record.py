"""Structured run records for the federated schedulers — the port of the
JAX package's ``obs/record.py``.

``RunRecorder`` is the host-side telemetry sink both schedulers thread
their per-round signals through (``repro_torch.fl.sched``): one record
directory per run, containing

- ``manifest.json``  — config snapshot + sha256 hash, backend and device
  (the card's name and power limit), torch and CUDA versions, git
  revision, package versions, seed, file inventory, and (at close) final
  summary stats from the returned ``FLHistory``; the field names are the
  JAX package's;
- ``metrics.jsonl``  — one JSON object per round (sync) or aggregation
  event (async): accuracy, cohort size, uplink wire bytes, tx parameter
  counts, simulated round time and clock, mean update norm, staleness,
  in-flight lanes — the lanes ``FLHistory`` carries, plus the phase cost
  signals;
- ``run.log``        — the ``progress=True`` lines (the schedulers route
  progress through ``RunRecorder.log``);
- ``trace.json``     — opt-in Perfetto trace on the simulated clock
  (``repro_torch.obs.trace``);
- ``profile.json``   — opt-in wall-clock profile of the real loop
  (``repro_torch.obs.profile``).

The recorder reads the numpy records the scheduler already fetched: a
chunk's ``StackedOuts.numpy()`` (sync) or an event's (async) — one
vectorized numpy pass and one buffered write per chunk, never a device
read or sync of its own — and the emitted streams are **identical across
``scan_chunk`` sizes** (the simulated clock accumulates exactly like the
``np.cumsum`` the history uses). Observation is pure host-side: with a
recorder attached, device trajectories (and the committed goldens) are
bit-identical to an unrecorded run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import subprocess
import sys

import numpy as np
import torch

from repro_torch.obs.profile import Profiler
from repro_torch.obs.trace import PID_SERVER, TraceBuilder

__all__ = [
    "RunRecorder",
    "config_hash",
    "config_snapshot",
    "environment_snapshot",
    "format_async_progress",
    "format_sync_progress",
]

SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# progress formatting — the ONE path for scheduler progress lines
# ---------------------------------------------------------------------------


def format_sync_progress(t: int, acc_mean: float, n_selected: int) -> str:
    """The sync barrier's progress line."""
    return f"  round {t:3d}  acc={acc_mean:.4f}  |S|={n_selected}"


def format_async_progress(
    t: int, acc_mean: float, n_landed: int, clock_s: float, staleness: float
) -> str:
    """The async scheduler's per-event progress line."""
    return (
        f"  event {t:3d}  acc={acc_mean:.4f}  |K|={n_landed}  "
        f"clock={clock_s:.2f}s  staleness={staleness:.2f}"
    )


# ---------------------------------------------------------------------------
# environment / config snapshots
# ---------------------------------------------------------------------------


def _git_rev() -> str | None:
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=5,
            ).stdout.strip()
            or None
        )
    except Exception:
        return None


def _package_versions() -> dict[str, str | None]:
    from importlib import metadata

    versions: dict[str, str | None] = {}
    for pkg in ("torch", "numpy", "triton"):
        try:
            versions[pkg] = metadata.version(pkg)
        except Exception:
            versions[pkg] = None
    return versions


def _card_lines() -> list[str]:
    """``nvidia-smi``'s name and power limit, one line a card (raises when
    it cannot be read: a record of a run on the card names its card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def environment_snapshot(device=None) -> dict:
    """Backend, device, version facts that make a run record reproducible.
    ``device`` is the run's device (default: the CUDA card when there is
    one, else the CPU); on the card the snapshot holds its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    return {
        "backend": dev.type,
        "device_count": torch.cuda.device_count() if on_cuda else 1,
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if on_cuda else [str(dev)]),
        "gpu": _card_lines() if on_cuda else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "packages": _package_versions(),
        "git_rev": _git_rev(),
    }


def _jsonable(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return repr(x)


def config_snapshot(cfg) -> dict:
    """A JSON-safe dict of an ``FLConfig`` (nested frozen dataclasses)."""
    if dataclasses.is_dataclass(cfg):
        return dataclasses.asdict(cfg)
    return {"repr": repr(cfg)}


def config_hash(snapshot: dict) -> str:
    """sha256 of the snapshot's sorted-key JSON: the run id's source."""
    body = json.dumps(snapshot, sort_keys=True, default=_jsonable)
    return hashlib.sha256(body.encode()).hexdigest()


# ---------------------------------------------------------------------------
# RunRecorder
# ---------------------------------------------------------------------------


class RunRecorder:
    """One structured record of one scheduler run (see module docstring).

    Lifecycle (driven by the scheduler): ``open_run`` once, then
    ``on_sync_chunk`` per chunk / ``on_async_event`` (+
    ``on_async_dispatch``) per aggregation event, ``log`` for progress
    lines, and ``close(history)`` to finalize the manifest. ``profiler``
    is a ``repro_torch.obs.profile.Profiler`` when ``profile=True`` (or a
    ``torch_trace_dir`` is given) else None — schedulers hook it only
    through ``is not None`` checks, so a run with ``recorder=None`` costs
    nothing.
    """

    def __init__(
        self,
        out_dir: str,
        trace: bool = False,
        profile: bool = False,
        torch_trace_dir: str | None = None,
        echo: bool = True,
    ):
        self.out_dir = out_dir
        self.echo = echo
        self._want_trace = trace
        self.profiler = (
            Profiler(torch_trace_dir=torch_trace_dir) if profile or torch_trace_dir else None
        )
        self._trace: TraceBuilder | None = None
        self._metrics = None
        self._log = None
        self._manifest: dict = {}
        self._clock = None
        self._comm = None
        self._mode: str | None = None
        self._t = 0               # rounds/events recorded so far
        self._sim_clock = 0.0     # float64 accumulation, == np.cumsum exactly
        self._pending: dict[int, tuple] = {}  # async: client -> dispatch span
        self._closed = False

    # -- lifecycle ---------------------------------------------------------
    def open_run(self, *, mode: str, cfg, data, comm, clock,
                 lanes: int | None = None, buffer_k: int | None = None,
                 device=None, mesh=None, population_plane: dict | None = None):
        """Called by the scheduler before its first event. ``clock`` is the
        scheduler's ``ClientClock`` (span components come from it), ``comm``
        its ``CommModel``, ``lanes`` the cohort size K (sync) or slot count
        M (async), ``device`` the run's torch device (the environment
        snapshot and the profiler's watermark read it). ``mesh`` is the
        cohort mesh of a sharded round step (``repro_torch.fl.shard``;
        None when unsharded), recorded as the JAX package records it.
        ``population_plane`` is the population tier's manifest block (the
        host-plane runners pass their store's backing); by default it is
        derived from ``cfg.execution``, as the JAX package's."""
        if self._metrics is not None:
            raise ValueError(f"recorder already opened for a {self._mode!r} run")
        os.makedirs(self.out_dir, exist_ok=True)
        self._mode = mode
        self._clock = clock
        self._comm = comm
        if population_plane is None:
            ex = cfg.execution
            population_plane = {
                "host_population": bool(ex.resolved_host_population(data.n_clients)),
                "edge_groups": int(ex.edge_groups),
                "store_backing": None,
            }
        snapshot = config_snapshot(cfg)
        chash = config_hash(snapshot)
        self._manifest = {
            "schema_version": SCHEMA_VERSION,
            "run_id": chash[:16],           # content hash: timestamp-free
            "mode": mode,
            "population": int(data.n_clients),
            "lanes": None if lanes is None else int(lanes),
            "buffer_k": None if buffer_k is None else int(buffer_k),
            # cohort mesh of a sharded round step: axis names + sizes, so
            # run records distinguish D=1 from D=8 (None = unsharded)
            "mesh": None if mesh is None else {
                "axis_names": [str(a) for a in mesh.axis_names],
                "shape": [int(mesh.shape[a]) for a in mesh.axis_names],
                "devices": int(mesh.size),
            },
            "seed": int(cfg.seed),
            "population_plane": population_plane,
            "config": snapshot,
            "config_hash": chash,
            "environment": environment_snapshot(device),
        }
        self._metrics = open(os.path.join(self.out_dir, "metrics.jsonl"), "w")
        self._log = open(os.path.join(self.out_dir, "run.log"), "w")
        if self._want_trace:
            self._trace = TraceBuilder()
            self._trace.server_lane()
        if self.profiler is not None:
            self.profiler.start(device)

    def log(self, line: str):
        """Progress logger: echoes to stdout and appends to ``run.log``."""
        if self.echo:
            print(line)
        if self._log is not None:
            self._log.write(line + "\n")
            self._log.flush()

    def close(self, history=None) -> str:
        """Finalize: flush streams, write trace/profile artifacts, and the
        summary manifest (run totals from ``history`` when given).
        Idempotent; returns the record directory."""
        if self._closed:
            return self.out_dir
        self._closed = True
        if self.profiler is not None:
            self.profiler.stop()
        files = {"metrics": "metrics.jsonl", "log": "run.log"}
        if self._metrics is not None:
            self._metrics.close()
        if self._log is not None:
            self._log.close()
        if self._trace is not None:
            self._trace.save(os.path.join(self.out_dir, "trace.json"))
            files["trace"] = "trace.json"
        if self.profiler is not None:
            with open(os.path.join(self.out_dir, "profile.json"), "w") as f:
                json.dump(self.profiler.summary(), f, indent=2, default=_jsonable)
                f.write("\n")
            files["profile"] = "profile.json"
        self._manifest["files"] = files
        self._manifest["rounds_recorded"] = self._t
        if history is not None:
            self._manifest["summary"] = {
                "rounds": int(len(history.accuracy_mean)),
                "final_accuracy": float(history.accuracy_mean[-1]),
                "worst_client_accuracy": float(history.accuracy_per_client[-1].min()),
                "tx_wire_mb": float(history.tx_bytes_cum[-1] / 1e6),
                "sim_clock_s": float(history.sim_clock[-1]),
                "mean_staleness": float(history.staleness_mean.mean()),
                "mean_in_flight": float(history.in_flight.mean()),
            }
        with open(os.path.join(self.out_dir, "manifest.json"), "w") as f:
            json.dump(self._manifest, f, indent=2, default=_jsonable)
            f.write("\n")
        return self.out_dir

    # -- metric rows -------------------------------------------------------
    def _row(self, **kv):
        self._metrics.write(json.dumps(kv, default=_jsonable) + "\n")
        self._t += 1

    def on_sync_chunk(self, *, t0: int, acc, sel, pms, wire, tx, times,
                      update_norm, lanes: int, host_gather_ms=None, staged_bytes=None,
                      rejected=None, dropped=None):
        """Record one chunk from its stacked ``(n, C)`` numpy records — one
        vectorized pass over the chunk, no device read (the scheduler
        already holds the arrays). ``host_gather_ms`` / ``staged_bytes``
        ((n,) sequences) are the host-plane runner's staging costs, columns
        of host-plane runs only; ``rejected`` ((n,) finite-guard
        rejections) and ``dropped`` ((n,) crash/deadline dropouts,
        fault-mode only) are optional columns too; nonzero rounds are also
        marked as fault instants on the trace."""
        n = acc.shape[0]
        acc_mean = acc.mean(axis=1)
        acc_min = acc.min(axis=1)
        n_sel = sel.sum(axis=1)
        wire_sum = wire.sum(axis=1)
        pms_mean = np.asarray(pms, np.float64).mean(axis=1)
        un_mean = (np.asarray(update_norm, np.float64) * sel).sum(axis=1) / np.maximum(
            n_sel, 1
        )
        tb = self._trace
        if tb is not None:
            rx, train, total = self._clock.component_times(pms)  # (n, C) each
            tb.begin("chunk", PID_SERVER, 0, self._sim_clock,
                     {"t0": int(t0), "rounds": int(n)})
        for i in range(n):
            s0 = self._sim_clock
            s1 = s0 + float(times[i])
            if tb is not None:
                t = t0 + i
                tb.begin("round", PID_SERVER, 0, s0,
                         {"t": t, "n_selected": int(n_sel[i])})
                for c in np.nonzero(sel[i])[0]:
                    c = int(c)
                    tb.client_lane(c)
                    e_rx = s0 + rx[i, c]
                    e_tr = e_rx + train[i, c]
                    e_up = s0 + total[i, c]
                    tb.span("dispatch", 1, c, s0, e_rx, {"t": t})
                    tb.span("train", 1, c, e_rx, e_tr)
                    tb.span("upload", 1, c, e_tr, e_up,
                            {"start_s": s0, "end_s": float(e_up)})
                tb.end("round", PID_SERVER, 0, s1)
                tb.instant("aggregate", PID_SERVER, 0, s1,
                           {"t": t, "clock_s": s1, "n_landed": int(n_sel[i]),
                            "staleness_mean": 0.0})
            extra = {}
            if host_gather_ms is not None:
                extra["host_gather_ms"] = float(host_gather_ms[i])
            if staged_bytes is not None:
                extra["staged_bytes"] = float(staged_bytes[i])
            if rejected is not None:
                extra["rejected"] = int(np.asarray(rejected)[i])
            if dropped is not None:
                extra["dropped"] = int(np.asarray(dropped)[i])
            if tb is not None and (extra.get("rejected") or extra.get("dropped")):
                tb.instant("fault", PID_SERVER, 0, s1,
                           {"t": int(t0 + i),
                            "rejected": extra.get("rejected", 0),
                            "dropped": extra.get("dropped", 0)})
            self._row(
                t=int(t0 + i),
                acc_mean=float(acc_mean[i]),
                acc_min=float(acc_min[i]),
                n_selected=int(n_sel[i]),
                tx_params=float(tx[i]),
                wire_bytes=float(wire_sum[i]),
                round_time_s=float(times[i]),
                sim_clock_s=s1,
                pms_mean=float(pms_mean[i]),
                update_norm_mean=float(un_mean[i]),
                staleness_mean=0.0,
                in_flight=int(lanes),
                buffer_k=None,
                **extra,
            )
            self._sim_clock = s1
        if tb is not None:
            tb.end("chunk", PID_SERVER, 0, self._sim_clock)

    def on_async_dispatch(self, clients, t_dispatch: float, client_pms):
        """Note a set of dispatches cut at simulated time ``t_dispatch``
        (trace bookkeeping only — spans are emitted when the client lands).
        ``client_pms`` is the (C,) share-depth lane the scheduler charged
        completion times with, so span components replicate its clock."""
        if self._trace is None:
            return
        rx, train, total = self._clock.component_times(client_pms)  # (C,)
        for c in np.asarray(clients):
            c = int(c)
            self._pending[c] = (
                float(t_dispatch), float(rx[c]), float(train[c]),
                float(t_dispatch + total[c]),
            )

    def on_async_event(self, *, t: int, acc, sel, tx: float, pms, wire: float,
                       dt: float, new_clock: float, staleness_mean: float,
                       in_flight: int, buffer_k: int, update_norm,
                       merge_discount: float | None,
                       landed_clients, landed_finish, landed_staleness,
                       rejected=None, retried=None, timed_out=None,
                       dropped=None):
        """Record one buffered-aggregation event: the landing clients'
        dispatch->train->upload spans (ending at the exact finish times the
        event queue popped), the aggregation instant, and the metric row.
        ``rejected`` (finite-guard rejections this event) and the
        fault-mode counters ``retried``/``timed_out``/``dropped`` (slot
        failures noticed since the previous event) are optional columns;
        nonzero fault counts also land as fault instants on the trace."""
        sel = np.asarray(sel, bool)
        n_landed = int(sel.sum())
        un = np.asarray(update_norm, np.float64)
        un_mean = float((un * sel).sum() / max(n_landed, 1))
        fault_cols = {}
        for key, val in (("rejected", rejected), ("retried", retried),
                         ("timed_out", timed_out), ("dropped", dropped)):
            if val is not None:
                fault_cols[key] = int(val)
        tb = self._trace
        if tb is not None:
            for c, f, st in zip(
                np.asarray(landed_clients), np.asarray(landed_finish),
                np.asarray(landed_staleness),
            ):
                c = int(c)
                pend = self._pending.pop(c, None)
                if pend is None:
                    continue
                s0, rx, train, _end = pend
                tb.client_lane(c)
                e_rx = s0 + rx
                e_tr = e_rx + train
                tb.span("dispatch", 1, c, s0, e_rx, {"t": t})
                tb.span("train", 1, c, e_rx, e_tr)
                tb.span("upload", 1, c, e_tr, float(f),
                        {"start_s": s0, "end_s": float(f), "staleness": int(st)})
            tb.instant(
                "aggregate", PID_SERVER, 0, float(new_clock),
                {"t": t, "clock_s": float(new_clock), "buffer_k": int(buffer_k),
                 "n_landed": n_landed,
                 "staleness_mean": float(staleness_mean),
                 "landed": [int(c) for c in np.asarray(landed_clients)],
                 "finish_s": [float(f) for f in np.asarray(landed_finish)]},
            )
            if any(fault_cols.values()):
                tb.instant("fault", PID_SERVER, 0, float(new_clock),
                           {"t": int(t), **fault_cols})
        self._row(
            t=int(t),
            acc_mean=float(np.mean(acc)),
            acc_min=float(np.min(acc)),
            n_selected=n_landed,
            tx_params=float(tx),
            wire_bytes=float(wire),
            round_time_s=float(dt),
            sim_clock_s=float(new_clock),
            pms_mean=float(np.asarray(pms, np.float64).mean()),
            update_norm_mean=un_mean,
            staleness_mean=float(staleness_mean),
            in_flight=int(in_flight),
            buffer_k=int(buffer_k),
            merge_discount_mean=(
                None if merge_discount is None else float(merge_discount)
            ),
            **fault_cols,
        )
        self._sim_clock = float(new_clock)
