"""The server loops — the port of the JAX package's ``fl/sched.py``
(``ClientClock``, ``EventQueue``, ``SyncScheduler``, ``AsyncState``,
``build_async_step``, ``AsyncScheduler``).

- ``SyncScheduler`` is the paper's Algorithm 1 barrier: every selected
  client finishes before the server aggregates, so a round costs the
  slowest selected client on the simulated clock (``ClientClock``,
  host-side numpy in float64). The rounds run on the device, in chunks of
  ``ExecutionConfig.scan_chunk`` rounds (``repro_torch.fl.api.build_chunk_step``:
  one CUDA-graph replay a chunk on the card) or one eager round step a
  call at ``scan_chunk=1``; the host fetches each chunk's records with one
  copy and does the clock accounting for the chunk in one numpy pass.
  Fault injection resolves each round's plan on the host, so it runs
  round by round.
- ``AsyncScheduler`` is FedBuff-style buffered execution over M dispatch
  slots: a host event queue pops the ``buffer_k`` earliest arrivals, the
  async step (``build_async_step``, eager, one call an event) merges their
  deltas with a staleness discount (one launch of masked_aggregate's
  kernel), evaluates, selects and refills the freed slots; with faults the
  host arms crashes, deadlines, retries with backoff and drops.

Both snapshot and resume their whole state (``repro_torch.checkpoint``):
a resumed run gives the uninterrupted run's history bit for bit. Both
feed an optional ``repro_torch.obs.RunRecorder`` (``recorder=``) from the
numpy records of each chunk's or event's one fetch, and time their
phases on its profiler; the device work is the unrecorded run's. With
``edge_groups`` E >= 1 both account the two-level topology: the
edge-to-server hop bytes a round (``FLHistory.tx_edge_bytes``, (T, E)) and,
under the barrier, edge round times. A population at or above the host
threshold (``ExecutionConfig.resolved_host_population``), or a dataset
with no eager ``x_train`` (``ShardedFederatedData``), runs on the
host-resident population plane (``repro_torch.fl.population``) instead.
With ``cohort_devices`` the barrier loop runs the sharded round step
(``repro_torch.fl.shard``) on every rank of a process group: every rank
returns the same history, and only rank 0 records, checkpoints and prints
progress. The async scheduler does what the JAX package's does with
``cohort_devices``: nothing (``build_async_step`` has no sharded form), so
each rank runs the whole unsharded async run.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.checkpoint import load_fl_state, load_host_arrays, save_fl_state, save_host_arrays
from repro_torch.comm import Codec, tree_wire_bytes
from repro_torch.core.aggregation import transmitted_parameters
from repro_torch.core.layersharing import layer_param_sizes, layer_share_mask
from repro_torch.core.metrics import BYTES_PER_PARAM, CommModel, edge_hop_bytes, edge_partition
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl import phases
from repro_torch.fl.api import (
    FLConfig,
    RoundPipeline,
    RoundState,
    StackedOuts,
    build_chunk_step,
    build_env,
    build_round_step,
    compute_lanes,
    pipeline_from_config,
)
from repro_torch.fl.cohort import scatter_rows, tree_scatter, tree_take
from repro_torch.fl.faults import compile_fault_plan
from repro_torch.models.mlp import init_mlp, mlp_accuracy, mlp_loss
from repro_torch.obs.profile import phase_timer
from repro_torch.obs.record import format_async_progress, format_sync_progress
from repro_torch.tree import tree_map

__all__ = ["AsyncScheduler", "AsyncState", "ClientClock", "EventQueue", "SyncScheduler",
           "build_async_step", "check_slice", "make_scheduler", "resolve_checkpoint_dir"]


def check_slice(cfg: FLConfig) -> None:
    """Raise the JAX package's ``ValueError`` for fault injection with an
    edge topology, or with cohort sharding under the barrier (the async
    scheduler runs unsharded whatever ``cohort_devices`` says)."""
    ex = cfg.execution
    if cfg.faults.enabled and ex.edge_groups >= 1:
        raise ValueError("fault injection with an edge_groups topology is not supported yet; "
                         "set edge_groups=0 or disable FaultConfig")
    if cfg.faults.enabled and ex.cohort_devices != 0 and cfg.scheduler.mode != "async":
        raise ValueError("fault injection composes with the cohort runtime but not with "
                         "cohort_devices sharding; set cohort_devices=0 or disable FaultConfig")


def on_host_plane(cfg: FLConfig, data) -> bool:
    """Whether a run belongs to the host-resident population plane: the
    population is at or above the threshold (or ``host_population=1``), or
    the dataset has no eager ``x_train`` slab to put on the device (the
    JAX package's routing)."""
    return cfg.execution.resolved_host_population(data.n_clients) or not hasattr(data, "x_train")


# ---------------------------------------------------------------------------
# simulated event clock
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClientClock:
    """Per-client completion times for the simulated clock: cumulative
    per-layer parameter and wire-byte prefixes turn a client's share depth
    into its uplink, downlink and training cost with one lookup."""

    comm: CommModel
    n_samples: np.ndarray      # (C,) float64 — |d_i|
    epochs: int
    params_prefix: np.ndarray  # (L+1,) — params in the first k layers
    wire_prefix: np.ndarray    # (L+1,) float64 — codec uplink wire bytes
    heterogeneity: float = 0.0  # lognormal sigma; 0 = uniform clocks
    delay_seed: int = 0
    n_clients: int = 0
    _delay: np.ndarray | None = dataclasses.field(default=None, repr=False)

    @classmethod
    def build(cls, global_params, codec: Codec, data: FederatedDataset, cfg: FLConfig,
              comm: CommModel, client_delay: np.ndarray | None = None) -> "ClientClock":
        sizes = np.asarray(layer_param_sizes(global_params), np.int64)
        layer_wire = np.asarray(
            [tree_wire_bytes(codec, layer) for layer in global_params], np.float64
        )
        return cls(
            comm=comm,
            n_samples=np.asarray(data.n_samples, np.float64),
            epochs=cfg.epochs,
            params_prefix=np.concatenate([[0], np.cumsum(sizes)]),
            wire_prefix=np.concatenate([[0.0], np.cumsum(layer_wire)]),
            heterogeneity=cfg.scheduler.heterogeneity if client_delay is None else 0.0,
            delay_seed=cfg.seed,
            n_clients=data.n_clients,
            _delay=None if client_delay is None else np.asarray(client_delay, np.float64),
        )

    @property
    def delay(self) -> np.ndarray:
        """(C,) multiplicative heterogeneity lane (``default_rng(seed +
        4242)`` lognormal, the JAX package's stream), sampled on first use."""
        if self._delay is None:
            if self.heterogeneity > 0.0:
                self._delay = np.random.default_rng(self.delay_seed + 4242).lognormal(
                    0.0, self.heterogeneity, self.n_clients)
            else:
                self._delay = np.ones((self.n_clients,))
        return self._delay

    @property
    def uniform(self) -> bool:
        if self._delay is None:
            return self.heterogeneity == 0.0
        return bool(np.all(self._delay == 1.0))

    def shared_params(self, pms: np.ndarray) -> np.ndarray:
        """Parameter count each client shares at depth ``pms`` (broadcasts)."""
        return self.params_prefix[np.asarray(pms)]

    def round_flops(self, pms: np.ndarray, cids: np.ndarray | None = None) -> np.ndarray:
        """Local-training FLOPs per client (fwd+bwd ~ 6 * params * samples *
        epochs) at share depth ``pms`` (broadcasts: a chunk's (T, C) depths
        batch); ``cids`` restricts to a client subset whose depths ``pms``
        carries."""
        n_samples = self.n_samples if cids is None else self.n_samples[np.asarray(cids)]
        return 6.0 * self.shared_params(pms) * n_samples * self.epochs

    def durations(self, pms: np.ndarray, cids: np.ndarray | None = None) -> np.ndarray:
        """Simulated seconds of one dispatch at share depth ``pms``:
        float32 downlink + local epochs + codec uplink, times the delay
        lane. ``cids`` computes only those clients' rows; every term is
        elementwise, so subset rows are bitwise the full rows."""
        params = self.shared_params(pms)
        delay = None
        if not self.uniform:
            delay = self.delay if cids is None else self.delay[np.asarray(cids)]
        return np.asarray(self.comm.client_times(
            self.wire_prefix[np.asarray(pms)], self.round_flops(pms, cids=cids),
            rx_bytes_per_client=params * float(BYTES_PER_PARAM), delay=delay), np.float64)

    def component_times(self, pms: np.ndarray, cids: np.ndarray | None = None):
        """``durations`` split into ``(rx, train, total)`` per client; the
        upload is ``total - rx - train``, so the three end at the exact
        ``durations`` value."""
        total = self.durations(pms, cids=cids)
        rx = self.shared_params(pms) * float(BYTES_PER_PARAM) / self.comm.bandwidth_bytes_per_s
        train = self.round_flops(pms, cids=cids) / self.comm.client_flops_per_s
        if not self.uniform:
            delay = self.delay if cids is None else self.delay[np.asarray(cids)]
            rx = rx * delay
            train = train * delay
        return rx, train, total


class EventQueue:
    """Heap-backed simulated event clock over M dispatch slots: ``push`` on
    dispatch, ``pop_k`` the k earliest arrivals in O(k log M). Entries order
    by ``(finish, client id)``, a total order over live entries (in-flight
    slots hold distinct clients); re-pushing a slot bumps its generation,
    so a superseded entry is skipped on pop. ``finish`` keeps each slot's
    current finish time. The JAX package's queue, line for line."""

    def __init__(self, n_slots: int):
        self.finish = np.full((n_slots,), np.inf, np.float64)
        self._gen = np.zeros((n_slots,), np.int64)
        self._live = np.zeros((n_slots,), bool)
        self._heap: list[tuple[float, int, int, int]] = []

    def push(self, slot: int, finish: float, client: int) -> None:
        """(Re-)arm ``slot``: ``client`` finishes at simulated ``finish``."""
        self._gen[slot] += 1
        self.finish[slot] = finish
        self._live[slot] = True
        heapq.heappush(self._heap, (float(finish), int(client), int(slot), int(self._gen[slot])))

    def pop_k(self, k: int) -> np.ndarray:
        """Slots of the k earliest live entries, in (finish, client id)
        order; the popped slots leave the queue."""
        out = []
        while len(out) < k:
            _, _, slot, gen = heapq.heappop(self._heap)
            if gen == self._gen[slot] and self._live[slot]:
                self._live[slot] = False
                out.append(slot)
        return np.asarray(out, np.int64)


# ---------------------------------------------------------------------------
# shared run initialization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _RunSetup:
    pipeline: RoundPipeline
    comm: CommModel
    env: phases.RoundEnv
    clock: ClientClock
    g0: Any
    loc0: Any          # g0 on every client lane; None for stateless personalizers
    residual0: Any     # EF residuals (lossy codec) or None
    pms0: int
    n_layers: int
    r_loop: torch.Tensor


def _setup_run(data: FederatedDataset, cfg: FLConfig, device: torch.device,
               init_fn: Callable | None, loss_fn: Callable, acc_fn: Callable,
               comm: CommModel | None, pipeline: RoundPipeline | None,
               client_delay: np.ndarray | None) -> _RunSetup:
    """The JAX package's run set-up, with its key split order:
    ``r_init, r_loop = split(PRNGKey(seed))``. ``init_fn`` maps a key on
    ``device`` to a layered model on ``device``."""
    pipeline = pipeline or pipeline_from_config(cfg)
    comm = comm or CommModel()
    r_init, r_loop = prng.split(prng.PRNGKey(cfg.seed, device=device))
    if init_fn is None:
        init_fn = lambda r: init_mlp(r, data.n_features, data.n_classes)  # noqa: E731
    g0 = init_fn(r_init)
    n_layers = len(g0)
    c = data.n_clients
    # every client starts from the same init (the server broadcasts w(0))
    loc0 = (tree_map(lambda gl: gl.expand((c,) + tuple(gl.shape)).clone(), g0)
            if pipeline.personalizer.stateful else None)
    residual0 = (tree_map(lambda gl: torch.zeros((c,) + tuple(gl.shape), dtype=gl.dtype,
                                                 device=gl.device), g0)
                 if pipeline.transmit.lossy else None)
    # Algorithm 1: round 1 selects every client; PMS cuts from the first
    # round, DLD starts full (A = 0 <= 0.25 -> all layers)
    pms0 = cfg.pms_layers if cfg.personalization.mode == "pms" else n_layers
    return _RunSetup(
        pipeline=pipeline,
        comm=comm,
        env=build_env(data, cfg.seed, device, loss_fn=loss_fn, acc_fn=acc_fn),
        clock=ClientClock.build(g0, pipeline.transmit.codec, data, cfg, comm, client_delay),
        g0=g0,
        loc0=loc0,
        residual0=residual0,
        pms0=pms0,
        n_layers=n_layers,
        r_loop=r_loop,
    )


def initial_state(su: _RunSetup, n_clients: int) -> RoundState:
    """Round 0's state: everyone selected, zero accuracy/loss/norms."""
    dev = su.r_loop.device
    zeros_f = lambda: torch.zeros((n_clients,), dtype=torch.float32, device=dev)  # noqa: E731
    return RoundState(
        global_params=su.g0,
        local_params=su.loc0,
        accuracy=zeros_f(),
        select=torch.ones((n_clients,), dtype=torch.bool, device=dev),
        pms=torch.full((n_clients,), su.pms0, dtype=torch.int32, device=dev),
        rng=su.r_loop,
        residual=su.residual0,
        participation=torch.zeros((n_clients,), dtype=torch.int32, device=dev),
        loss=zeros_f(),
        update_norm=zeros_f(),
    )


# ---------------------------------------------------------------------------
# checkpoint/resume and fault plumbing shared by the schedulers
# ---------------------------------------------------------------------------


def resolve_checkpoint_dir(checkpoint_every: int, checkpoint_dir: str | None,
                           resume_from: str | None) -> str | None:
    """Where snapshots go: ``checkpoint_dir``, else ``resume_from`` (a
    resumed run keeps writing into its run directory). ``checkpoint_every >
    0`` with nowhere to write raises ``ValueError``."""
    directory = checkpoint_dir or resume_from
    if checkpoint_every and not directory:
        raise ValueError("checkpoint_every > 0 needs checkpoint_dir= (or resume_from=, which "
                         "doubles as the save directory)")
    return directory


def _sync_fault_inputs(faults, seed: int, t: int, clock: ClientClock, pms_host: np.ndarray):
    """One sync round's host-side fault resolution: the compiled plan, the
    (C,) survivors (not crashed, and inside the deadline at the slowed
    duration) and the slowed durations."""
    plan = compile_fault_plan(faults, seed, t, pms_host.shape[0])
    dur = clock.durations(pms_host) * plan.slow
    alive = ~plan.crash
    if faults.deadline_s > 0.0:
        alive = alive & (dur <= faults.deadline_s)
    return plan, alive, dur


def _host_to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host lane on ``device`` (one copy)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# SyncScheduler — Algorithm 1's barrier loop
# ---------------------------------------------------------------------------


def _progress_rows(t0: int, n: int, chunk: int, rounds: int) -> list[int]:
    """Which rows of a fetched ``[t0, t0 + n)`` chunk ``progress=True``
    prints: at ``scan_chunk=1`` every 10th round and the last one; with
    chunks, round 0 and each chunk's last round (the JAX package's
    cadence)."""
    if chunk <= 1:
        return [i for i in range(n) if (t0 + i) % 10 == 0 or t0 + i == rounds - 1]
    rows = [0] if t0 == 0 else []
    if n - 1 not in rows:
        rows.append(n - 1)
    return rows


_SYNC_HIST = ("acc", "selected", "tx_params", "pms", "round_time", "wire", "rejected", "wall")


@dataclasses.dataclass
class _EdgeTopology:
    """The two-level (client -> edge -> server) topology's accounting, on
    the host in float64: the static client-to-edge partition, the
    edge-to-server hop bytes of a chunk's rounds, and the barrier's round
    times, each edge waiting for its slowest member and then forwarding
    its partials (the JAX package's ``core/metrics`` functions)."""

    edge_ids: np.ndarray     # (C,) edge of each client
    n_edges: int
    layer_sizes: np.ndarray  # (L,) parameters a layer

    @classmethod
    def build(cls, cfg: FLConfig, n_clients: int, clock: ClientClock) -> "_EdgeTopology | None":
        """The topology of ``cfg.execution.edge_groups`` E >= 1; None when flat."""
        n_edges = cfg.execution.edge_groups
        if n_edges < 1:
            return None
        return cls(edge_partition(n_clients, n_edges), n_edges, np.diff(clock.params_prefix))

    def hop_bytes(self, sel: np.ndarray, pms: np.ndarray) -> np.ndarray:
        """(T, E) edge-to-server bytes of the (T, C) selections and depths."""
        return edge_hop_bytes(sel, pms, self.layer_sizes, self.edge_ids, self.n_edges)

    def round_times(self, comm: CommModel, clock: ClientClock, wire, sel, pms, e_bytes,
                    delay) -> np.ndarray:
        """(T,) simulated seconds of barrier rounds over the two hops."""
        return comm.edge_round_times(
            wire, clock.round_flops(pms), sel, self.edge_ids, e_bytes,
            rx_bytes=clock.shared_params(pms) * float(BYTES_PER_PARAM), delay=delay)


@dataclasses.dataclass
class SyncScheduler:
    """The synchronous barrier loop: chunks of ``scan_chunk`` rounds on the
    device (``build_chunk_step``, one chunk step per distinct chunk length:
    the body's and the tail's), or the eager round step once a round at
    ``scan_chunk=1``. The host fetches a chunk's records with one copy and
    accounts the simulated round times (slowest selected client:
    codec-compressed uplink, uncompressed float32 downlink, local training)
    in one float64 numpy pass over the chunk. Every chunk length gives the
    same history bit for bit. ``FLHistory.wall_time`` splits each chunk's
    host time evenly over its rounds.

    With an enabled ``FaultConfig`` the host resolves each round's plan
    (so the chunk is 1): crashed and late clients leave the selection, the
    corruption kinds ride into the fault step, a round whose every selected
    client died runs fault-free, and the round time is the slowest
    dispatched client's slowed duration capped at the deadline.
    ``checkpoint_every`` snapshots the state and the history so far at the
    first chunk boundary past each multiple; ``resume_from`` continues from
    the latest snapshot bit for bit.

    A sharded round step (``cohort_devices``) runs on every rank of its
    process group; every rank returns the same history (``wall_time``
    aside), only rank 0 writes the run record, the snapshots and the
    progress lines, and a world-1 group the step opened is closed at the
    end of the run."""

    def run(self, data: FederatedDataset, cfg: FLConfig, device: torch.device,
            init_fn: Callable | None = None, loss_fn: Callable = mlp_loss,
            acc_fn: Callable = mlp_accuracy, comm: CommModel | None = None,
            progress: bool = False, pipeline: RoundPipeline | None = None,
            client_delay: np.ndarray | None = None, recorder=None, checkpoint_every: int = 0,
            checkpoint_dir: str | None = None, resume_from: str | None = None):
        check_slice(cfg)
        if on_host_plane(cfg, data):
            from repro_torch.fl.population import run_host_sync

            return run_host_sync(data, cfg, device, init_fn=init_fn, loss_fn=loss_fn,
                                 acc_fn=acc_fn, comm=comm, progress=progress, pipeline=pipeline,
                                 client_delay=client_delay, recorder=recorder,
                                 checkpoint_every=checkpoint_every,
                                 checkpoint_dir=checkpoint_dir, resume_from=resume_from)
        faults = cfg.faults
        faulty = faults.enabled
        ckpt_dir = resolve_checkpoint_dir(checkpoint_every, checkpoint_dir, resume_from)
        su = _setup_run(data, cfg, device, init_fn, loss_fn, acc_fn, comm, pipeline,
                        client_delay)
        state = initial_state(su, data.n_clients)
        round_step = build_round_step(su.env, su.pipeline, cfg.execution,
                                      faults=faults if faulty else None)
        mesh = getattr(round_step, "mesh", None)
        try:
            return self._loop(data, cfg, device, su, state, round_step, mesh, progress,
                              recorder, checkpoint_every, ckpt_dir, resume_from)
        finally:
            if mesh is not None:
                mesh.close()

    def _loop(self, data, cfg, device, su, state, round_step, mesh, progress, recorder,
              checkpoint_every, ckpt_dir, resume_from):
        faults = cfg.faults
        faulty = faults.enabled
        comm, clock = su.comm, su.clock
        if mesh is not None and mesh.rank != 0:  # rank 0 speaks for the group
            recorder, progress, ckpt_dir = None, False, None
        # fault mode needs the host every round (the plan feeds the step)
        chunk = 1 if faulty else cfg.execution.resolved_chunk(cfg.rounds)
        chunk_steps: dict[int, Callable] = {}  # length -> chunk step (body and tail)
        lanes = cfg.execution.resolved_cohort(data.n_clients)
        delay = None if clock.uniform else clock.delay
        if recorder is not None:
            recorder.open_run(mode="sync", cfg=cfg, data=data, comm=comm, clock=clock,
                              lanes=lanes, device=device, mesh=mesh)
        prof = recorder.profiler if recorder is not None else None
        emit = recorder.log if recorder is not None else print
        edges = _EdgeTopology.build(cfg, data.n_clients, clock)
        keys = _SYNC_HIST + (("tx_edge_bytes",) if edges else ())
        hist: dict[str, list] = {k: [] for k in keys}
        start = 0
        if resume_from is not None:
            # the latest snapshot: the state (rng chain included) and the
            # history lanes so far, verbatim
            trees, meta = load_fl_state({"state": state}, resume_from)
            state = trees["state"]
            start = int(meta["round"])
            saved = load_host_arrays(resume_from, f"hist_{start:05d}")
            hist = {k: [saved[k]] for k in keys}
        for t0 in range(start, cfg.rounds, chunk):
            n = min(chunk, cfg.rounds - t0)
            t_start = time.perf_counter()
            if prof is not None:
                prof.begin_chunk(t0, n)
            if faulty:
                pms_host = state.pms.cpu().numpy()
                sel_pre = state.select.cpu().numpy()
                plan, alive_np, dur_t = _sync_fault_inputs(faults, cfg.seed, t0, clock, pms_host)
                if not (sel_pre & alive_np).any():
                    # every selected client died: the server re-dispatches
                    # until someone answers, so the round runs fault-free
                    alive_np = np.ones_like(alive_np)
                with phase_timer(prof, "dispatch"):
                    state, out = round_step(state, t0, _host_to(alive_np, device),
                                            _host_to(plan.corrupt.astype(np.int32), device))
                    outs = StackedOuts([out])
            elif chunk == 1:
                with phase_timer(prof, "dispatch"):
                    state, out = round_step(state, t0)
                    outs = StackedOuts([out])
            else:
                ts = torch.arange(t0, t0 + n, dtype=torch.int32, device=device)
                step = chunk_steps.get(n)
                if step is None:
                    step = chunk_steps[n] = build_chunk_step(round_step, n)
                with phase_timer(prof, "dispatch"):
                    # a first call captures the graph: timed as its own phase
                    state, outs = step(state, ts,
                                       on_capture=functools.partial(phase_timer, prof, "capture"))
            with phase_timer(prof, "device_get"):
                host = outs.numpy()  # the one device-to-host copy of the chunk
            if prof is not None:
                prof.end_chunk()
            acc, sel, pms = host["acc"], host["selected"], host["pms"]          # (n, C)
            wire = host["wire_per_client"].astype(np.float64)                   # (n, C)
            n_dropped = None
            if faulty:
                # the server waits on everyone it dispatched, up to the deadline
                wait = dur_t[sel_pre]
                rt = float(wait.max()) if wait.size else 0.0
                if faults.deadline_s > 0.0:
                    rt = min(rt, faults.deadline_s)
                rt = np.asarray([rt + comm.server_latency_s], np.float64)
                n_dropped = int((sel_pre & ~alive_np).sum())
            elif edges:
                e_bytes = edges.hop_bytes(sel, pms)
                hist["tx_edge_bytes"].append(e_bytes)
                rt = edges.round_times(comm, clock, wire, sel, pms, e_bytes, delay)
            else:
                rt = comm.round_times(
                    wire, clock.round_flops(pms), sel,
                    rx_bytes=clock.shared_params(pms) * float(BYTES_PER_PARAM), delay=delay)
            hist["round_time"].append(rt)
            hist["acc"].append(acc)
            hist["selected"].append(sel)
            hist["pms"].append(pms)
            hist["wire"].append(wire.sum(axis=1))
            hist["tx_params"].append(host["tx_params"].astype(np.float64))
            hist["rejected"].append(host["rejected"].astype(np.int64))
            if recorder is not None:
                # straight off the chunk's one fetch above: no device read
                with phase_timer(prof, "record"):
                    recorder.on_sync_chunk(
                        t0=t0, acc=acc, sel=sel, pms=pms, wire=wire, tx=hist["tx_params"][-1],
                        times=rt, update_norm=host["update_norm"], lanes=lanes,
                        rejected=hist["rejected"][-1],
                        dropped=None if n_dropped is None else np.asarray([n_dropped], np.int64))
            hist["wall"].append(np.full((n,), (time.perf_counter() - t_start) / n))
            if progress:
                for i in _progress_rows(t0, n, chunk, cfg.rounds):
                    emit(format_sync_progress(t0 + i, float(acc[i].mean()), int(sel[i].sum())))
            r = t0 + n
            if ckpt_dir and checkpoint_every and r // checkpoint_every > t0 // checkpoint_every:
                save_fl_state({"state": state}, ckpt_dir, r)
                save_host_arrays({k: np.concatenate(v) for k, v in hist.items()}, ckpt_dir,
                                 f"hist_{r:05d}")

        history = sync_history(hist, lanes)
        if recorder is not None:
            recorder.close(history)
        return history


def sync_history(hist: dict, lanes: int):
    """The ``FLHistory`` of a barrier run's history chunks (``lanes``
    clients in flight a round)."""
    from repro_torch.fl.engine import FLHistory

    h = {k: np.concatenate(v) for k, v in hist.items()}
    times = h["round_time"]
    return FLHistory(
        accuracy_mean=h["acc"].mean(axis=1),
        accuracy_per_client=h["acc"],
        selected=h["selected"],
        tx_params=h["tx_params"],
        tx_bytes_cum=np.cumsum(h["wire"]),
        round_time=times,
        pms=h["pms"],
        tx_wire_bytes=h["wire"],
        sim_clock=np.cumsum(times),
        staleness_mean=np.zeros_like(times),
        in_flight=np.full(times.shape, lanes, np.int64),
        tx_edge_bytes=h.get("tx_edge_bytes"),
        rejected_updates=h["rejected"],
        wall_time=np.asarray(h["wall"], np.float64),
    )


# ---------------------------------------------------------------------------
# AsyncScheduler — buffered staleness-weighted execution over dispatch slots
# ---------------------------------------------------------------------------


class AsyncState(NamedTuple):
    """Carried async server state: tensors on the run's device. In-flight
    work lives in M dispatch slots keyed by client id; each carries the
    snapshot and share depth its client was dispatched with."""

    global_params: Any        # layered list, leaves (...): the server model
    slot_params: Any          # layered list, leaves (M, ...): each slot's snapshot
    slot_client: torch.Tensor  # (M,) int64: the client in each slot
    slot_pms: torch.Tensor    # (M,) int32: share depth frozen at dispatch
    client_pms: torch.Tensor  # (C,) int32: depth each client was last dispatched with
    local_params: Any         # layered list, leaves (C, ...); None when stateless
    accuracy: torch.Tensor    # (C,) last-known accuracy
    loss: torch.Tensor        # (C,) last-known eval loss
    update_norm: torch.Tensor  # (C,) last-known compressed-delta norm
    rng: torch.Tensor         # (2,) threefry key
    residual: Any = None      # EF residuals (lossy codec), (C, ...)
    participation: Any = None  # (C,) int32 cumulative landings


def _lane(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (leaf.ndim - 1))


def assign_slots(next_select, next_pms, idle_now, land, active, force, cids, slot_pms):
    """Refill the freed slots: the selector's wanted idle clients go to the
    freed slots (landed or inactive), ascending ids on both sides; with no
    one else in flight and no wanted idle client (``force``), the landing
    slots re-dispatch their own clients, so the queue never drains. Returns
    ``(dispatched (M,), new_slot_client (M,), new_slot_pms (M,), disp_pms
    (M,))``; a client's depth is frozen at dispatch, like its snapshot."""
    c = next_select.shape[0]
    want = next_select & idle_now                       # (C,)
    free = land | ~active                               # (M,)
    n_assign = torch.minimum(want.sum(), free.sum())
    slot_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    # wanted ids first, each group ascending (a stable sort of 0/1 keys)
    cand_order = torch.argsort((~want).to(torch.int8), stable=True)
    assigned = free & (slot_rank < n_assign)
    new_cid = cand_order.index_select(0, torch.clamp(slot_rank, 0, c - 1).to(torch.int64))
    dispatched = torch.where(force & (n_assign == 0), land, assigned)
    new_slot_client = torch.where(assigned, new_cid, cids)
    disp_pms = next_pms.index_select(0, new_slot_client)
    return dispatched, new_slot_client, torch.where(dispatched, disp_pms, slot_pms), disp_pms


def build_async_step(env: phases.RoundEnv, pipeline: RoundPipeline, faults=None):
    """The buffered-aggregation step ``(AsyncState, t, land (M,) bool,
    staleness (M,) int32, active (M,) bool, idle_now (C,) bool, force ()
    bool) -> (AsyncState, out)`` — the JAX package's, phase for phase and
    key split for key split.

    Its cohort lanes are the M dispatch slots: every slot trains its
    client's shard from its snapshot (only ``land`` lanes commit), the
    landing deltas ride the wire codec with EF and merge into the global
    model with staleness weights (``StalenessAggregator``: one launch of
    masked_aggregate's kernel), the population is evaluated and selects,
    and the selector's wanted idle clients fill the freed slots in
    ascending id order. ``force`` keeps the queue from draining: with no
    one else in flight and no wanted idle client, the landing slots
    re-dispatch their own clients. The finite guard is always on; with an
    enabled ``faults`` the step takes one more argument, the slots'
    corruption kinds ``corrupt (M,) int``, applied to the trained params
    before transmit."""
    c = env.n_clients
    stateful = pipeline.personalizer.stateful
    lossy = pipeline.transmit.lossy
    faulty = faults is not None and faults.enabled
    max_norm = float(faults.max_update_norm) if faulty else 0.0
    corrupt_scale = float(faults.corrupt_scale) if faulty else 0.0

    def _async_body(state: AsyncState, t, land, staleness, active, idle_now, force, corrupt):
        g = state.global_params
        n_layers = len(g)
        dev = land.device
        cids = state.slot_client
        land = land & active
        share_m = layer_share_mask(n_layers, state.slot_pms)  # (M, L)
        keys = prng.split(state.rng, 4 if lossy else 3)
        rng, r_fit, r_sel = keys[0], keys[1], keys[2]
        r_codec = keys[3] if lossy else None

        prev_part = (state.participation if state.participation is not None
                     else torch.zeros((c,), dtype=torch.int32, device=dev))
        # non-landing (and inactive, possibly duplicate-id) slots point at
        # the sentinel C and write nothing
        sentinel = torch.full_like(cids, c)
        land_cid = torch.where(land, cids, sentinel)
        land_c = scatter_rows(torch.zeros((c,), dtype=torch.bool, device=dev), land_cid, land,
                              mode="drop")
        participation = prev_part + land_c.to(torch.int32)

        menv = env.take(cids)
        cctx = phases.RoundContext(
            t=t,
            global_params=g,
            local_params=tree_take(state.local_params, cids) if stateful else None,
            select=land,
            pms=state.slot_pms,
            share=share_m,
            residual=tree_take(state.residual, cids),
            participation=participation.index_select(0, cids),
            cohort_idx=cids,
            cohort_mask=land,
            dispatch_params=state.slot_params,
            staleness=staleness,
            rng_fit=r_fit,
            rng_codec=r_codec,
            rng_sel=r_sel,
        )

        # --- every slot lane trains from its own dispatch snapshot; the
        # landing slots' deltas ride the codec and merge with staleness
        # weights (the aggregator) ---
        kinds_m = None if corrupt is None else torch.where(land, corrupt, torch.zeros_like(corrupt))
        cctx, n_rejected = compute_lanes(pipeline, cctx, menv,
                                         state.update_norm.index_select(0, cids), kinds_m,
                                         max_norm, corrupt_scale)

        # --- scatter landing lanes into the (C, ...) client state ---
        new_local = (tree_scatter(state.local_params, land_cid, cctx.new_local, mode="drop")
                     if stateful else None)
        new_residual = tree_scatter(state.residual, land_cid, cctx.residual, mode="drop")
        update_norm = scatter_rows(state.update_norm, land_cid, cctx.update_norm, mode="drop")
        wire_paid_c = scatter_rows(torch.zeros((c,), dtype=torch.float32, device=dev), land_cid,
                                   cctx.wire_paid, mode="drop")
        share_c = layer_share_mask(n_layers, state.client_pms)  # (C, L)
        wire_prospective, _ = pipeline.transmit.wire_costs(g, share_c, land_c)

        # --- population phases: evaluation (thinned by eval_every), selection ---
        pctx = cctx._replace(
            local_params=state.local_params,
            select=land_c,
            pms=state.client_pms,
            share=share_c,
            residual=new_residual,
            participation=participation,
            cohort_idx=None,
            cohort_mask=None,
            dispatch_params=None,
            staleness=None,
            new_local=new_local,
            wire_bytes=wire_prospective,
            wire_paid=wire_paid_c,
            update_norm=update_norm,
            prev_accuracy=state.accuracy,
            prev_loss=state.loss,
        )
        pctx = pctx._replace(eval_model=pipeline.personalizer.eval_model(pctx, env))
        pctx = pipeline.evaluator.evaluate(pctx, env)
        pctx = pipeline.selector.select(pctx, env)
        pctx = pctx._replace(next_pms=pipeline.layer_policy.next_pms(pctx, env, n_layers))

        dispatched, new_slot_client, new_slot_pms, disp_pms = assign_slots(
            pctx.next_select, pctx.next_pms, idle_now, land, active, force, cids, state.slot_pms)
        disp_cid = torch.where(dispatched, new_slot_client, sentinel)
        new_client_pms = scatter_rows(state.client_pms, disp_cid, disp_pms, mode="drop")
        new_slot_params = tree_map(
            lambda s_, gl: torch.where(_lane(dispatched, s_), gl.expand_as(s_), s_),
            state.slot_params, pctx.new_global)

        land_f = land.to(torch.float32)
        new_state = AsyncState(
            global_params=pctx.new_global,
            slot_params=new_slot_params,
            slot_client=new_slot_client,
            slot_pms=new_slot_pms,
            client_pms=new_client_pms,
            local_params=new_local,
            accuracy=pctx.accuracy,
            loss=pctx.loss,
            update_norm=update_norm,
            rng=rng,
            residual=new_residual,
            participation=participation,
        )
        n_land = torch.clamp_min(torch.sum(land_f), 1.0)
        merge_w = cctx.merge_weight if cctx.merge_weight is not None else torch.ones_like(land_f)
        out = {
            "acc": pctx.accuracy,
            "selected": land_c,
            "tx_params": transmitted_parameters(land, share_m, layer_param_sizes(g)),
            "pms": state.client_pms,
            "wire_per_client": wire_paid_c,
            "update_norm": update_norm,
            "dispatched": dispatched,
            "slot_client": new_slot_client,
            "client_pms": new_client_pms,
            "staleness_mean": torch.sum(land_f * staleness.to(torch.float32)) / n_land,
            "merge_discount_mean": torch.sum(land_f * merge_w) / n_land,
            "rejected": n_rejected,
        }
        return new_state, out

    def _t(t, dev):
        return t if torch.is_tensor(t) else torch.full((), int(t), dtype=torch.int32, device=dev)

    def async_step(state, t, land, staleness, active, idle_now, force):
        with torch.no_grad():
            return _async_body(state, _t(t, land.device), land, staleness, active, idle_now,
                               force, None)

    def fault_async_step(state, t, land, staleness, active, idle_now, force, corrupt):
        with torch.no_grad():
            return _async_body(state, _t(t, land.device), land, staleness, active, idle_now,
                               force, corrupt)

    return fault_async_step if faulty else async_step


_ASYNC_HIST = ("acc", "selected", "tx_params", "pms", "round_time", "wire", "sim_clock_hist",
               "staleness", "in_flight_hist", "rejected", "wall")


class _Landing(NamedTuple):
    """One aggregation event's landings, resolved on the host."""

    landers: np.ndarray         # slots landing, in (finish, client id) order
    land: np.ndarray            # (M,) bool
    land_finish: np.ndarray     # their finish times
    landed_clients: np.ndarray  # their clients
    staleness: np.ndarray       # (M,) int32 events since dispatch (0 off land)
    idle_now: np.ndarray        # (C,) bool: clients free to be dispatched
    new_clock: float            # the event's simulated time
    force: bool                 # no one else in flight: landing slots must re-dispatch
    buffer_k: int               # landings popped


@dataclasses.dataclass
class _SlotPlane:
    """The host side of the async scheduler's M dispatch slots: the client
    each slot holds, the event queue of their simulated finish times, the
    model version each was dispatched at and, with faults, each dispatch's
    failure code, corruption kind and retries. Both async runners (device-
    resident and host-plane) drive their events through it."""

    faults: Any
    seed: int
    clock: ClientClock
    comm: CommModel
    client_pms: np.ndarray         # (C,) int32: depth each client was last dispatched with
    slot_client: np.ndarray        # (M,) int32
    active: np.ndarray             # (M,) bool
    in_flight_clients: np.ndarray  # (C,) bool
    dispatch_version: np.ndarray   # (M,) int64
    slot_fail: np.ndarray          # (M,) int8: 0 ok, 1 crash, 2 deadline timeout
    slot_kind: np.ndarray          # (M,) int32 corruption kinds
    retries: np.ndarray            # (M,) int64
    queue: EventQueue
    # slot failures noticed since the last aggregation event (fault mode)
    pending: dict = dataclasses.field(
        default_factory=lambda: dict(retried=0, timed_out=0, dropped=0))

    # the arrays a checkpoint carries (with the queue's finish times)
    SNAPSHOT = ("slot_client", "client_pms", "active", "in_flight_clients", "dispatch_version",
                "slot_fail", "slot_kind", "retries")

    @classmethod
    def start(cls, cfg: FLConfig, clock: ClientClock, comm: CommModel, client_pms: np.ndarray,
              m: int) -> "_SlotPlane":
        """The warm start: w(0) dispatched to the first M clients at
        simulated time 0 (armed from the version-0 plan with faults)."""
        c = client_pms.shape[0]
        slot_client = np.arange(m, dtype=np.int32)
        plane = cls(faults=cfg.faults, seed=cfg.seed, clock=clock, comm=comm,
                    client_pms=client_pms, slot_client=slot_client,
                    active=np.ones((m,), bool), in_flight_clients=np.zeros((c,), bool),
                    dispatch_version=np.zeros((m,), np.int64),
                    slot_fail=np.zeros((m,), np.int8), slot_kind=np.zeros((m,), np.int32),
                    retries=np.zeros((m,), np.int64), queue=EventQueue(m))
        plane.in_flight_clients[slot_client] = True
        d0 = clock.durations(client_pms[slot_client], cids=slot_client)
        if cfg.faults.enabled:
            d0, plane.slot_fail, plane.slot_kind = plane.arm(slot_client, d0, 0)
        for s in range(m):
            plane.queue.push(s, d0[s], int(slot_client[s]))
        return plane

    def arm(self, cids, durations, version: int):
        """Fault-arm a dispatch batch from the plan of the dispatching model
        version: slowed notice times, failure codes (0 ok, 1 crash, 2
        deadline timeout) and corruption kinds. A failure is noticed at
        ``min(duration, deadline)``."""
        deadline = float(self.faults.deadline_s)
        plan = compile_fault_plan(self.faults, self.seed, version, self.client_pms.shape[0])
        cids = np.asarray(cids)
        dur = durations * plan.slow[cids]
        code = np.where(plan.crash[cids], 1, 0).astype(np.int8)
        if deadline > 0.0:
            code = np.where((code == 0) & (dur > deadline), 2, code)
            dur = np.where(code != 0, np.minimum(dur, deadline), dur)
        kind = np.where(code == 0, plan.corrupt[cids], 0).astype(np.int32)
        return dur, code, kind

    def snapshot(self) -> dict:
        return {**{k: getattr(self, k) for k in self.SNAPSHOT},
                "queue_finish": np.asarray(self.queue.finish, np.float64)}

    def restore(self, host: dict) -> None:
        """Load a snapshot's arrays, and rebuild the queue by re-pushing the
        in-flight slots at their saved finish times (a total order: replay
        is exact)."""
        for k in self.SNAPSHOT:
            getattr(self, k)[...] = host[k]
        self.queue = EventQueue(self.slot_client.shape[0])
        for s in np.nonzero(self.active)[0]:
            self.queue.push(int(s), float(host["queue_finish"][s]), int(self.slot_client[s]))

    def land(self, buffer_k: int, version: int) -> _Landing | None:
        """Pop the ``buffer_k`` earliest arrivals (fewer if fewer are in
        flight; at least one slot must be active). With faults, failed
        landers retry with exponential backoff on their slot, or drop and
        free it once their retries run out; None when every lander retried
        (a pure-retry event: no aggregation)."""
        faults = self.faults
        k = max(1, min(buffer_k, int(self.active.sum())))
        landers = self.queue.pop_k(k)  # earliest finishers; ties by client id
        if faults.enabled:
            codes = self.slot_fail[landers]
            ok_l, bad = landers[codes == 0], landers[codes != 0]
            self.pending["timed_out"] += int((codes == 2).sum())
            notice_max = float(self.queue.finish[landers].max())  # before retries re-push
            can_retry = self.retries[bad] < faults.max_retries
            retry_slots, drop_slots = bad[can_retry], bad[~can_retry]
            for s in retry_slots:
                # back off, then re-dispatch the same client on the same
                # slot and snapshot with fresh draws at the current version
                self.retries[s] += 1
                cid = int(self.slot_client[s])
                backoff = faults.backoff_s * (2.0 ** float(self.retries[s] - 1))
                d_r, code_r, kind_r = self.arm(
                    [cid], self.clock.durations(self.client_pms[[cid]], cids=[cid]), version)
                self.slot_fail[s] = code_r[0]
                self.slot_kind[s] = kind_r[0]
                self.queue.push(s, float(self.queue.finish[s]) + backoff + float(d_r[0]), cid)
            self.pending["retried"] += int(retry_slots.size)
            if drop_slots.size:
                # retries exhausted: free the slot and the client
                self.pending["dropped"] += int(drop_slots.size)
                self.active[drop_slots] = False
                self.in_flight_clients[self.slot_client[drop_slots]] = False
            if ok_l.size == 0 and drop_slots.size == 0:
                return None
            landers = ok_l
            new_clock = notice_max + self.comm.server_latency_s
        else:
            new_clock = float(self.queue.finish[landers].max()) + self.comm.server_latency_s
        land = np.zeros(self.active.shape, bool)
        land[landers] = True
        # with faults a freed slot is no longer active; else the landers are
        force = bool(int((self.active & ~land).sum()) == 0)
        landed_clients = self.slot_client[landers]
        idle_now = ~self.in_flight_clients
        idle_now[landed_clients] = True
        return _Landing(
            landers=landers, land=land, land_finish=self.queue.finish[landers].copy(),
            landed_clients=landed_clients,
            staleness=np.where(land, version - self.dispatch_version, 0).astype(np.int32),
            idle_now=idle_now, new_clock=new_clock, force=force, buffer_k=k)

    def dispatch(self, ev: _Landing, dispatched: np.ndarray, new_slot_client: np.ndarray,
                 version: int) -> None:
        """After the event's step: free the landers, hand the ``dispatched``
        slots their new clients (``client_pms`` already holds their depths)
        and push their finish times, armed from the next version's plan."""
        self.active = (self.active & ~ev.land) | dispatched
        self.in_flight_clients[ev.landed_clients] = False
        self.in_flight_clients[new_slot_client[dispatched]] = True
        # re-arm only the dispatched slots (subset rows are bitwise the full rows)
        disp_slots = np.nonzero(dispatched)[0]
        if disp_slots.size:
            disp_cids = new_slot_client[disp_slots]
            d_disp = self.clock.durations(self.client_pms[disp_cids], cids=disp_cids)
            if self.faults.enabled:
                # fresh draws at the version these slots train from
                d_disp, code_d, kind_d = self.arm(disp_cids, d_disp, version + 1)
                self.slot_fail[disp_slots] = code_d
                self.slot_kind[disp_slots] = kind_d
                self.retries[disp_slots] = 0
            for s, f, cid in zip(disp_slots, ev.new_clock + d_disp, disp_cids):
                self.queue.push(int(s), float(f), int(cid))
        self.dispatch_version = np.where(dispatched, version + 1, self.dispatch_version)
        self.slot_client = new_slot_client

    def take_pending(self) -> dict:
        """The slot failures noticed since the last event, then zeroed."""
        out, self.pending = self.pending, dict(retried=0, timed_out=0, dropped=0)
        return out


def check_async_aggregator(pipeline: RoundPipeline) -> None:
    """A barrier aggregator averages absolute parameters and would
    mis-merge stale snapshots: fail fast."""
    if isinstance(pipeline.aggregator, (phases.FedAvgAggregator, phases.MaskedPartialAggregator)):
        raise ValueError(
            "AsyncScheduler needs an aggregator that merges deltas against dispatch "
            f"snapshots, got {type(pipeline.aggregator).__name__}; build the pipeline "
            "from an async-mode config (scheduler.mode='async') or swap in "
            "phases.StalenessAggregator")


def async_slots(cfg: FLConfig, n_clients: int) -> int:
    """M dispatch slots: ``max_concurrency or cohort_size or C``."""
    return min(cfg.scheduler.max_concurrency or cfg.execution.cohort_size or n_clients, n_clients)


def record_async_event(recorder, prof, plane: _SlotPlane, ev: _Landing, t: int, hist: dict,
                       out: dict, faulty: bool) -> None:
    """Feed an event's records to the recorder (and the re-dispatches, cut at
    the event's clock)."""
    fault_kw = plane.take_pending() if faulty else {}
    if recorder is None:
        return
    with phase_timer(prof, "record"):
        recorder.on_async_event(
            t=t, acc=out["acc"], sel=out["selected"], tx=hist["tx_params"][-1],
            pms=out["pms"], wire=hist["wire"][-1], dt=hist["round_time"][-1],
            new_clock=ev.new_clock, staleness_mean=hist["staleness"][-1],
            in_flight=hist["in_flight_hist"][-1], buffer_k=ev.buffer_k,
            update_norm=out["update_norm"], merge_discount=float(out["merge_discount_mean"]),
            landed_clients=ev.landed_clients, landed_finish=ev.land_finish,
            landed_staleness=ev.staleness[ev.landers], rejected=hist["rejected"][-1],
            **fault_kw)
        if out["dispatched"].any():  # re-dispatches cut at the new clock
            recorder.on_async_dispatch(plane.slot_client[out["dispatched"]], ev.new_clock,
                                       plane.client_pms)


def append_async_event(hist: dict, out: dict, ev: _Landing, sim_clock: float, plane: _SlotPlane,
                       edges: "_EdgeTopology | None") -> None:
    """An event's history rows from its host records ``out``."""
    hist["acc"].append(out["acc"])
    hist["selected"].append(out["selected"])
    hist["tx_params"].append(float(out["tx_params"]))
    hist["pms"].append(out["pms"])
    hist["wire"].append(np.asarray(out["wire_per_client"], np.float64).sum())
    hist["round_time"].append(ev.new_clock - sim_clock)
    hist["sim_clock_hist"].append(ev.new_clock)
    hist["staleness"].append(float(out["staleness_mean"]))
    hist["in_flight_hist"].append(int(plane.in_flight_clients.sum()))
    hist["rejected"].append(int(out["rejected"]))
    if edges:
        # the landers' edge-to-server bytes; the event clock stays flat
        hist["tx_edge_bytes"].append(edges.hop_bytes(out["selected"][None], out["pms"][None])[0])


def async_history(hist: dict):
    """The ``FLHistory`` of an async run's history rows."""
    from repro_torch.fl.engine import FLHistory

    h = {k: _stacked(k, v) for k, v in hist.items()}
    return FLHistory(
        accuracy_mean=h["acc"].mean(axis=1),
        accuracy_per_client=h["acc"],
        selected=h["selected"],
        tx_params=h["tx_params"],
        tx_bytes_cum=np.cumsum(h["wire"]),
        round_time=h["round_time"],
        pms=h["pms"],
        tx_wire_bytes=h["wire"],
        sim_clock=h["sim_clock_hist"],
        staleness_mean=h["staleness"],
        in_flight=h["in_flight_hist"],
        tx_edge_bytes=h.get("tx_edge_bytes"),
        rejected_updates=h["rejected"],
        wall_time=h["wall"],
    )


@dataclasses.dataclass
class AsyncScheduler:
    """FedBuff-style event-driven server loop over M dispatch slots.

    A host event queue (``EventQueue``) holds each slot's simulated finish
    time (``ClientClock``). Each of ``cfg.rounds`` aggregation events pops
    the ``buffer_k`` earliest arrivals (fewer only if fewer are in flight),
    advances the clock to the last of them plus the server latency, and
    runs the async step once. ``buffer_k=0`` resolves to ``C // 2``;
    M = ``max_concurrency or cohort_size or C``. The trajectory is a pure
    function of (data, cfg, pipeline, delays): ties on the clock break by
    client id.

    With an enabled ``FaultConfig`` each dispatch is armed from the plan
    of the model version it trains from: crashes and deadline timeouts are
    noticed at ``min(duration, deadline)``, retried on the same slot with
    exponential backoff up to ``max_retries``, then dropped (the slot
    frees); an event whose landers all failed and retried aggregates
    nothing. ``checkpoint_every`` snapshots the AsyncState, every host
    lane and the queue's finish times after each multiple of events;
    ``resume_from`` continues from the latest snapshot bit for bit."""

    def run(self, data: FederatedDataset, cfg: FLConfig, device: torch.device,
            init_fn: Callable | None = None, loss_fn: Callable = mlp_loss,
            acc_fn: Callable = mlp_accuracy, comm: CommModel | None = None,
            progress: bool = False, pipeline: RoundPipeline | None = None,
            client_delay: np.ndarray | None = None, recorder=None, checkpoint_every: int = 0,
            checkpoint_dir: str | None = None, resume_from: str | None = None):
        check_slice(cfg)
        if on_host_plane(cfg, data):
            from repro_torch.fl.population import run_host_async

            return run_host_async(data, cfg, device, init_fn=init_fn, loss_fn=loss_fn,
                                  acc_fn=acc_fn, comm=comm, progress=progress, pipeline=pipeline,
                                  client_delay=client_delay, recorder=recorder,
                                  checkpoint_every=checkpoint_every,
                                  checkpoint_dir=checkpoint_dir, resume_from=resume_from)
        faults = cfg.faults
        faulty = faults.enabled
        ckpt_dir = resolve_checkpoint_dir(checkpoint_every, checkpoint_dir, resume_from)
        su = _setup_run(data, cfg, device, init_fn, loss_fn, acc_fn, comm, pipeline,
                        client_delay)
        comm, clock = su.comm, su.clock
        check_async_aggregator(su.pipeline)
        c = data.n_clients
        m = async_slots(cfg, c)
        dev = su.r_loop.device
        state = AsyncState(
            global_params=su.g0,
            # the warm start dispatches w(0) to the first M clients
            slot_params=tree_map(lambda gl: gl.expand((m,) + tuple(gl.shape)).clone(), su.g0),
            slot_client=torch.arange(m, dtype=torch.int64, device=dev),
            slot_pms=torch.full((m,), su.pms0, dtype=torch.int32, device=dev),
            client_pms=torch.full((c,), su.pms0, dtype=torch.int32, device=dev),
            local_params=su.loc0,
            accuracy=torch.zeros((c,), dtype=torch.float32, device=dev),
            loss=torch.zeros((c,), dtype=torch.float32, device=dev),
            update_norm=torch.zeros((c,), dtype=torch.float32, device=dev),
            rng=su.r_loop,
            residual=su.residual0,
            participation=torch.zeros((c,), dtype=torch.int32, device=dev),
        )
        step = build_async_step(su.env, su.pipeline, faults=faults if faulty else None)
        buffer_k = cfg.scheduler.buffer_k or max(1, c // 2)
        if recorder is not None:
            recorder.open_run(mode="async", cfg=cfg, data=data, comm=comm, clock=clock,
                              lanes=m, buffer_k=buffer_k, device=device)
        prof = recorder.profiler if recorder is not None else None
        emit = recorder.log if recorder is not None else print

        # --- host event queue over the M slots ---
        plane = _SlotPlane.start(cfg, clock, comm, np.full((c,), su.pms0, np.int32), m)
        if recorder is not None:  # warm start: w(0) cut at simulated t=0
            recorder.on_async_dispatch(plane.slot_client, 0.0, plane.client_pms)
        edges = _EdgeTopology.build(cfg, c, clock)
        keys = _ASYNC_HIST + (("tx_edge_bytes",) if edges else ())
        hist: dict[str, list] = {k: [] for k in keys}
        sim_clock = 0.0
        version = 0
        t = 0
        if resume_from is not None:
            # the latest snapshot: the AsyncState, every host lane verbatim
            trees, meta = load_fl_state({"state": state}, resume_from)
            state = trees["state"]
            t = int(meta["round"])
            sim_clock = float(meta["sim_clock"])
            version = int(meta["version"])
            host = load_host_arrays(resume_from, f"hist_{t:05d}")
            plane.restore(host)
            hist = {k: list(host[k]) for k in keys}
        while t < cfg.rounds:
            if not plane.active.any():
                # every slot's retries ran out: end with the history so far
                break
            t_start = time.perf_counter()
            ev = plane.land(buffer_k, version)
            if ev is None:
                continue  # a pure-retry event: no aggregation
            if prof is not None:
                prof.begin_chunk(t, 1)
            with phase_timer(prof, "dispatch"):
                args = [state, t, _host_to(ev.land, dev), _host_to(ev.staleness, dev),
                        _host_to(plane.active, dev), _host_to(ev.idle_now, dev),
                        _host_to(np.asarray(ev.force), dev)]
                if faulty:
                    args.append(_host_to(plane.slot_kind, dev))
                state, out = step(*args)
                outs = StackedOuts([out])
            with phase_timer(prof, "device_get"):
                out = outs.numpy()  # the one device-to-host copy of the event
            if prof is not None:
                prof.end_chunk()
            out = {key: v[0] for key, v in out.items()}

            plane.client_pms = out["client_pms"].astype(np.int32)
            plane.dispatch(ev, out["dispatched"], out["slot_client"].astype(np.int32), version)
            append_async_event(hist, out, ev, sim_clock, plane, edges)
            record_async_event(recorder, prof, plane, ev, t, hist, out, faulty)
            hist["wall"].append(time.perf_counter() - t_start)
            sim_clock = ev.new_clock
            version += 1
            if progress and (t % 10 == 0 or t == cfg.rounds - 1):
                emit(format_async_progress(t, float(np.mean(out["acc"])), int(ev.land.sum()),
                                           ev.new_clock, hist["staleness"][-1]))
            t += 1
            if ckpt_dir and checkpoint_every and t % checkpoint_every == 0:
                save_fl_state({"state": state, "sim_clock": float(sim_clock),
                               "version": int(version)}, ckpt_dir, t)
                save_host_arrays({**plane.snapshot(),
                                  **{k: _stacked(k, v) for k, v in hist.items()}},
                                 ckpt_dir, f"hist_{t:05d}")

        history = async_history(hist)
        if recorder is not None:
            recorder.close(history)
        return history


def _stacked(key: str, rows: list) -> np.ndarray:
    """An async history lane as one array (the JAX package's dtypes)."""
    if key in ("acc", "selected", "pms", "tx_edge_bytes"):
        return np.stack(rows)
    if key in ("in_flight_hist", "rejected"):
        return np.asarray(rows, np.int64)
    return np.asarray(rows, np.float64)


def make_scheduler(cfg: FLConfig):
    """Scheduler for ``cfg.scheduler.mode``."""
    return AsyncScheduler() if cfg.scheduler.mode == "async" else SyncScheduler()
