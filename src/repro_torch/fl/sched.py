"""The synchronous server loop — the port of the JAX package's
``fl/sched.py`` (``ClientClock``, ``_setup_run``, ``SyncScheduler``).

``SyncScheduler`` is the paper's Algorithm 1 barrier: every selected client
finishes before the server aggregates, so a round costs the slowest
selected client on the simulated clock (``ClientClock``, host-side numpy in
float64). The round itself runs on the device through
``repro_torch.fl.api.build_round_step``, one call per round; the host
fetches each round's records and does the clock accounting.

The port covers the main path only: dense cohort (K = C), per-round
evaluation and dispatch, faults off, no recorder and no checkpoint.
``check_slice`` raises ``NotImplementedError`` for every other option,
naming the ROADMAP.md item that ports it, so no option is silently ignored.
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
    if ex.cohort_size != 0:
        raise _not_ported("cohort_size > 0", 7, "K < C cohort rounds")
    if ex.eval_every != 1:
        raise _not_ported("eval_every > 1", 7, "thinned evaluation")
    if ex.resolved_chunk(cfg.rounds) > 1:
        raise _not_ported("scan_chunk != 1", 7, "fused chunks of rounds")
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


@dataclasses.dataclass
class SyncScheduler:
    """The synchronous barrier loop: one round step per round on the
    device, then the host fetches the round's records and accounts the
    simulated round time (slowest selected client: codec-compressed uplink,
    uncompressed float32 downlink, local training)."""

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
        delay = None if clock.uniform else clock.delay
        accs, sel_hist, tx_hist, pms_hist, times, wire_hist, rejected = [], [], [], [], [], [], []
        wall = []
        for t in range(cfg.rounds):
            t_start = time.perf_counter()
            state, out = round_step(state, t)
            acc = out["acc"].cpu().numpy()[None]                       # (1, C)
            sel = out["selected"].cpu().numpy()[None]
            pms = out["pms"].cpu().numpy()[None]
            wire = out["wire_per_client"].cpu().numpy().astype(np.float64)[None]
            rt = comm.round_times(
                wire, clock.round_flops(pms), sel,
                rx_bytes=clock.shared_params(pms) * float(BYTES_PER_PARAM),
                delay=delay,
            )
            accs.append(acc)
            sel_hist.append(sel)
            pms_hist.append(pms)
            times.append(rt)
            wire_hist.append(wire.sum(axis=1))
            tx_hist.append(np.asarray([float(out["tx_params"])], np.float64))
            rejected.append(np.asarray([int(out["rejected"])], np.int64))
            wall.append(time.perf_counter() - t_start)
            if progress and (t % 10 == 0 or t == cfg.rounds - 1):
                print(f"round {t:4d}  acc={float(acc.mean()):.4f}  "
                      f"selected={int(sel.sum())}")

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
            in_flight=np.full(times.shape, data.n_clients, np.int64),
            tx_edge_bytes=None,
            rejected_updates=np.concatenate(rejected),
            wall_time=np.asarray(wall, np.float64),
        )


def make_scheduler(cfg: FLConfig):
    """Scheduler for ``cfg.scheduler.mode`` (only ``sync`` is ported)."""
    if cfg.scheduler.mode != "sync":
        raise _not_ported("scheduler mode 'async'", 8, "AsyncScheduler")
    return SyncScheduler()
