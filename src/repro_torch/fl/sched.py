"""The synchronous server loop — the port of the JAX package's
``fl/sched.py`` (``ClientClock``, ``_setup_run``, ``SyncScheduler``).

``SyncScheduler`` is the paper's Algorithm 1 barrier: every selected client
finishes before the server aggregates, so a round costs the slowest
selected client on the simulated clock (``ClientClock``, host-side numpy in
float64). The rounds run on the device, in chunks of
``ExecutionConfig.scan_chunk`` rounds (``repro_torch.fl.api.build_chunk_step``:
one CUDA-graph replay a chunk on the card) or one eager round step a call
at ``scan_chunk=1``; the host fetches each chunk's records with one copy
and does the clock accounting for the chunk in one numpy pass.

The port covers the synchronous loop with cohorts of K <= C clients,
thinned evaluation and fused chunks of rounds; faults, the recorder and
checkpoints are not ported. ``check_slice`` raises ``NotImplementedError``
for every option outside that, naming the ROADMAP.md item that ports it, so
no option is silently ignored.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.comm import Codec, tree_wire_bytes
from repro_torch.core.layersharing import layer_param_sizes
from repro_torch.core.metrics import BYTES_PER_PARAM, CommModel
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
    pipeline_from_config,
)
from repro_torch.models.mlp import init_mlp, mlp_accuracy, mlp_loss
from repro_torch.tree import tree_map

__all__ = ["ClientClock", "SyncScheduler", "check_slice", "make_scheduler"]


def _not_ported(option: str, item: int, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet ({what}): ROADMAP.md queue 1 item {item}"
    )


def check_slice(cfg: FLConfig, data) -> None:
    """Raise ``NotImplementedError`` for every option or dataset outside
    the ported slice (ROADMAP.md names the item that lifts each)."""
    if getattr(data, "x_train", None) is None:
        raise _not_ported("a dataset with no eager x_train", 10,
                          "host-resident population plane")
    n_clients = data.n_clients
    ex = cfg.execution
    if cfg.scheduler.mode != "sync":
        raise _not_ported("scheduler mode 'async'", 8, "AsyncScheduler")
    if cfg.faults.enabled:
        raise _not_ported("fault injection", 9, "fl/faults.py")
    if ex.host_population == 1 or ex.resolved_host_population(n_clients):
        raise _not_ported("host_population", 10, "host-resident population plane")
    if ex.eval_chunk != 0:
        raise _not_ported("eval_chunk", 10, "host-population eval streaming")
    if ex.edge_groups != 0:
        raise _not_ported("edge_groups", 10, "two-level edge aggregation")
    if ex.cohort_devices != 0:
        raise _not_ported("cohort_devices", 12, "sharded cohort rounds")


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

    def round_flops(self, pms: np.ndarray) -> np.ndarray:
        """Local-training FLOPs per client (fwd+bwd ~ 6 * params * samples *
        epochs) at share depth ``pms``."""
        return 6.0 * self.shared_params(pms) * self.n_samples * self.epochs


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
    host time evenly over its rounds."""

    def run(self, data: FederatedDataset, cfg: FLConfig, device: torch.device,
            init_fn: Callable | None = None, loss_fn: Callable = mlp_loss,
            acc_fn: Callable = mlp_accuracy, comm: CommModel | None = None,
            progress: bool = False, pipeline: RoundPipeline | None = None,
            client_delay: np.ndarray | None = None):
        from repro_torch.fl.engine import FLHistory

        check_slice(cfg, data)
        su = _setup_run(data, cfg, device, init_fn, loss_fn, acc_fn, comm, pipeline,
                        client_delay)
        comm, clock = su.comm, su.clock
        state = initial_state(su, data.n_clients)
        round_step = build_round_step(su.env, su.pipeline, cfg.execution)
        chunk = cfg.execution.resolved_chunk(cfg.rounds)
        chunk_steps: dict[int, Callable] = {}  # length -> chunk step (body and tail)
        lanes = cfg.execution.resolved_cohort(data.n_clients)
        delay = None if clock.uniform else clock.delay
        accs, sel_hist, tx_hist, pms_hist, times, wire_hist, rejected = [], [], [], [], [], [], []
        wall = []
        for t0 in range(0, cfg.rounds, chunk):
            n = min(chunk, cfg.rounds - t0)
            t_start = time.perf_counter()
            if chunk == 1:
                state, out = round_step(state, t0)
                outs = StackedOuts([out])
            else:
                step = chunk_steps.get(n)
                if step is None:
                    step = chunk_steps[n] = build_chunk_step(round_step, n)
                state, outs = step(state, torch.arange(t0, t0 + n, dtype=torch.int32,
                                                       device=device))
            host = outs.numpy()  # the one device-to-host copy of the chunk
            acc, sel, pms = host["acc"], host["selected"], host["pms"]          # (n, C)
            wire = host["wire_per_client"].astype(np.float64)                   # (n, C)
            times.append(comm.round_times(
                wire, clock.round_flops(pms), sel,
                rx_bytes=clock.shared_params(pms) * float(BYTES_PER_PARAM),
                delay=delay,
            ))
            accs.append(acc)
            sel_hist.append(sel)
            pms_hist.append(pms)
            wire_hist.append(wire.sum(axis=1))
            tx_hist.append(host["tx_params"].astype(np.float64))
            rejected.append(host["rejected"].astype(np.int64))
            wall += [(time.perf_counter() - t_start) / n] * n
            if progress:
                for i in _progress_rows(t0, n, chunk, cfg.rounds):
                    print(f"  round {t0 + i:3d}  acc={float(acc[i].mean()):.4f}  "
                          f"|S|={int(sel[i].sum())}")

        acc_pc = np.concatenate(accs)
        wire = np.concatenate(wire_hist)
        times = np.concatenate(times)
        return FLHistory(
            accuracy_mean=acc_pc.mean(axis=1),
            accuracy_per_client=acc_pc,
            selected=np.concatenate(sel_hist),
            tx_params=np.concatenate(tx_hist),
            tx_bytes_cum=np.cumsum(wire),
            round_time=times,
            pms=np.concatenate(pms_hist),
            tx_wire_bytes=wire,
            sim_clock=np.cumsum(times),
            staleness_mean=np.zeros_like(times),
            in_flight=np.full(times.shape, lanes, np.int64),
            tx_edge_bytes=None,
            rejected_updates=np.concatenate(rejected),
            wall_time=np.asarray(wall, np.float64),
        )


def make_scheduler(cfg: FLConfig):
    """Scheduler for ``cfg.scheduler.mode`` (only ``sync`` is ported)."""
    if cfg.scheduler.mode != "sync":
        raise _not_ported("scheduler mode 'async'", 8, "AsyncScheduler")
    return SyncScheduler()
