"""Federated simulation entry point of the port — the port of the JAX
package's ``fl/engine.py``: ``FLHistory``, ``make_round_step`` and
``run_federated``.

A round is the phase pipeline of ``repro_torch.fl.api``:

  Personalizer -> LocalTrainer -> TransmitPhase (wire codec + EF)
               -> Aggregator -> Evaluator -> SelectorPhase -> LayerPolicy

driven by ``repro_torch.fl.sched.SyncScheduler`` (the paper's barrier) or
``AsyncScheduler`` (FedBuff-style buffered aggregation over dispatch
slots), with optional fault injection, checkpoint/resume and a run recorder
(``repro_torch.obs``) under both; large or lazily generated populations run
on the host-resident population plane (``repro_torch.fl.population``), and
``edge_groups`` adds the two-level edge topology, and ``cohort_devices``
shards a barrier round's lanes over the ranks of a process group
(``repro_torch.fl.shard``).
Every entry point takes
``device=``: the CUDA card by default, the CPU only when asked for; with no
card and ``device=None`` they raise rather than run on the CPU quietly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from repro_torch.core.metrics import CommModel
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.fl.api import (
    FLConfig,
    RoundPipeline,
    build_env,
    build_round_step,
    pipeline_from_config,
)
from repro_torch.launch.mesh import rank_device
from repro_torch.models.mlp import mlp_accuracy, mlp_loss

__all__ = ["FLConfig", "FLHistory", "make_round_step", "run_federated"]


class FLHistory(NamedTuple):
    """Per-round records (numpy, host-side): the JAX package's
    ``FLHistory`` fields, plus the measured ``wall_time``."""

    accuracy_mean: np.ndarray        # (T,)
    accuracy_per_client: np.ndarray  # (T, C)
    selected: np.ndarray             # (T, C) bool
    tx_params: np.ndarray            # (T,) uplink parameter count
    tx_bytes_cum: np.ndarray         # (T,) cumulative uplink wire bytes
    round_time: np.ndarray           # (T,) simulated seconds per round
    pms: np.ndarray                  # (T, C) layers shared per client
    tx_wire_bytes: np.ndarray        # (T,) per-round uplink wire bytes
    sim_clock: np.ndarray            # (T,) simulated clock at each round
    staleness_mean: np.ndarray       # (T,) 0 under the sync barrier
    in_flight: np.ndarray            # (T,) executing client lanes (sync: K;
                                     # async: clients in flight after the event)
    tx_edge_bytes: np.ndarray | None = None   # (T, E) edge-to-server hop bytes
                                              # (edge_groups E >= 1; None when flat)
    rejected_updates: np.ndarray | None = None  # (T,) finite-guard rejections
    wall_time: np.ndarray | None = None  # (T,) host seconds per round: its
                                         # chunk's time, up to the fetch of the
                                         # records, their accounting and the
                                         # recorder's pass, split evenly over
                                         # the chunk's rounds; the port's own
                                         # field


def _run_device(cfg: FLConfig, device):
    """The run's device: ``device`` if given; else the card, and with
    ``cohort_devices`` rank r's ``cuda:{r % device_count}``."""
    if cfg.execution.cohort_devices != 0:
        return rank_device(device)
    return resolve_device(device)


def make_round_step(data: FederatedDataset, cfg: FLConfig, device=None,
                    loss_fn: Callable = mlp_loss, acc_fn: Callable = mlp_accuracy,
                    pipeline: RoundPipeline | None = None):
    """The synchronous round step ``(RoundState, t) -> (RoundState, out)``
    for ``cfg``'s default pipeline (or ``pipeline``) over ``data`` on
    ``device``; with enabled faults, the fault step ``(state, t, alive,
    corrupt)``; with ``cohort_devices`` the sharded step of this rank
    (``repro_torch.fl.shard``; ``step.mesh.close()`` ends a world-1 group it
    opened)."""
    from repro_torch.fl.sched import check_slice

    dev = _run_device(cfg, device)
    check_slice(cfg)
    pipeline = pipeline or pipeline_from_config(cfg)
    env = build_env(data, cfg.seed, dev, loss_fn=loss_fn, acc_fn=acc_fn)
    return build_round_step(env, pipeline, cfg.execution,
                            faults=cfg.faults if cfg.faults.enabled else None)


def run_federated(data: FederatedDataset, cfg: FLConfig, device=None,
                  init_fn: Callable | None = None, loss_fn: Callable = mlp_loss,
                  acc_fn: Callable = mlp_accuracy, comm: CommModel | None = None,
                  progress: bool = False, pipeline: RoundPipeline | None = None,
                  client_delay: np.ndarray | None = None, recorder=None,
                  checkpoint_every: int = 0, resume_from: str | None = None,
                  checkpoint_dir: str | None = None) -> FLHistory:
    """Run ``cfg.rounds`` federated rounds (sync) or aggregation events
    (``scheduler="async"``) on ``device`` (the CUDA card by default) and
    return the host-side history.

    ``init_fn`` maps a threefry key on the run's device to the initial
    layered model (default: ``init_mlp`` for the data's widths).
    ``client_delay`` is an optional (C,) heterogeneity lane for the
    simulated clock. ``checkpoint_every`` snapshots the run into
    ``checkpoint_dir`` (or ``resume_from``, which doubles as the write
    directory); ``resume_from`` continues from its latest snapshot, bit for
    bit the uninterrupted run. ``recorder`` (a
    ``repro_torch.obs.RunRecorder``) writes the run's record — manifest,
    per-round metrics, progress log, optional trace and profile — from
    the numpy records of each chunk's or event's one fetch; the history is
    bitwise the unrecorded run's.

    ``FLConfig(cohort_devices=D)`` shards the cohort's lanes over the D
    ranks of a ``torch.distributed`` process group: call ``run_federated``
    on every rank (``torchrun --nproc-per-node D`` or
    ``torch.multiprocessing.spawn``, with the group initialized first;
    ``cohort_devices=1`` with no group opens a world-1 group for the run).
    Rank r runs on ``cuda:{r % device_count}`` unless ``device`` is given;
    ``device="cpu"`` takes gloo. Every rank returns the same history.
    """
    from repro_torch.fl.sched import make_scheduler

    dev = _run_device(cfg, device)
    return make_scheduler(cfg).run(
        data, cfg, dev, init_fn=init_fn, loss_fn=loss_fn, acc_fn=acc_fn, comm=comm,
        progress=progress, pipeline=pipeline, client_delay=client_delay, recorder=recorder,
        checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir,
        resume_from=resume_from,
    )
