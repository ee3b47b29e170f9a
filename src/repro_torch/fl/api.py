"""Composable round-pipeline API of the port — the port of the JAX
package's ``fl/api.py``.

A federated round is a ``RoundPipeline`` of phases (``repro_torch.fl.phases``):

  Personalizer -> LocalTrainer -> TransmitPhase (wire codec + EF)
               -> Aggregator -> Evaluator -> SelectorPhase -> LayerPolicy

``FLConfig`` is the declarative form (seven nested validated sub-configs,
or the seed's flat kwargs), the same class as the JAX package's.
``pipeline_from_config`` maps a config onto phases through the registries;
``build_round_step`` composes a pipeline into the round step
``(RoundState, t) -> (RoundState, out)``, which runs eagerly, one round a
call; ``build_chunk_step`` fuses ``length`` rounds into one call, on CUDA
one replay of a CUDA graph (the counterpart of the JAX package's donated
``lax.scan`` of rounds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch import random as prng
from repro_torch.configs.base import (
    CodecConfig,
    ExecutionConfig,
    FaultConfig,
    PersonalizationConfig,
    SchedulerConfig,
    SelectionConfig,
    TrainConfig,
)
from repro_torch.core.aggregation import finite_update_guard, transmitted_parameters
from repro_torch.core.layersharing import layer_param_sizes, layer_share_mask
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl import phases
from repro_torch.fl.cohort import cohort_indices, tree_scatter, tree_take
from repro_torch.fl.faults import apply_corruption
from repro_torch.models.mlp import mlp_accuracy, mlp_loss
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "FLConfig",
    "SelectionConfig",
    "PersonalizationConfig",
    "CodecConfig",
    "SchedulerConfig",
    "ExecutionConfig",
    "FaultConfig",
    "TrainConfig",
    "RoundPipeline",
    "RoundState",
    "pipeline_from_config",
    "build_env",
    "build_round_step",
    "compose_round_step",
    "build_chunk_step",
    "CollectiveCaptureError",
    "StackedOuts",
]


# ---------------------------------------------------------------------------
# FLConfig — nested sub-configs + flat-kwargs backward compat (a copy of the
# JAX package's class, so both packages read a config the same way)
# ---------------------------------------------------------------------------

# flat kwarg -> (group field, sub-config attribute)
_FLAT_KEYS = {
    "strategy": ("selection", "strategy"),
    "fraction": ("selection", "fraction"),
    "decay": ("selection", "decay"),
    "personalization": ("personalization", "mode"),
    "pms_layers": ("personalization", "pms_layers"),
    "codec": ("codec", "spec"),
    "codec_bits": ("codec", "bits"),
    "topk_fraction": ("codec", "topk_fraction"),
    "rounds": ("train", "rounds"),
    "epochs": ("train", "epochs"),
    "batch_size": ("train", "batch_size"),
    "lr": ("train", "lr"),
    "momentum": ("train", "momentum"),
    "seed": ("train", "seed"),
    "remainder": ("train", "remainder"),
    "scheduler": ("scheduler", "mode"),
    "buffer_k": ("scheduler", "buffer_k"),
    "max_concurrency": ("scheduler", "max_concurrency"),
    "staleness_fn": ("scheduler", "staleness_fn"),
    "heterogeneity": ("scheduler", "heterogeneity"),
    "cohort_size": ("execution", "cohort_size"),
    "eval_every": ("execution", "eval_every"),
    "scan_chunk": ("execution", "scan_chunk"),
    "cohort_devices": ("execution", "cohort_devices"),
    "host_population": ("execution", "host_population"),
    "eval_chunk": ("execution", "eval_chunk"),
    "edge_groups": ("execution", "edge_groups"),
    "dropout_rate": ("faults", "dropout_rate"),
    "deadline_s": ("faults", "deadline_s"),
    "corrupt_rate": ("faults", "corrupt_rate"),
    "max_retries": ("faults", "max_retries"),
}

_GROUP_TYPES = {
    "selection": SelectionConfig,
    "personalization": PersonalizationConfig,
    "codec": CodecConfig,
    "train": TrainConfig,
    "scheduler": SchedulerConfig,
    "execution": ExecutionConfig,
    "faults": FaultConfig,
}


@dataclasses.dataclass(frozen=True, init=False)
class FLConfig:
    """Federated experiment config: seven nested validated sub-configs.

    Accepts either the nested objects (``selection=SelectionConfig(...)``)
    or the seed's flat kwargs (``strategy="oort", fraction=0.5, rounds=30,
    codec="int8", cohort_size=64, dropout_rate=0.3``) — but not both forms
    for the same group. The seed's flat attributes (``cfg.strategy``,
    ``cfg.rounds``, ...) remain readable.
    """

    selection: SelectionConfig
    personalization: PersonalizationConfig
    codec: CodecConfig
    train: TrainConfig
    scheduler: SchedulerConfig
    execution: ExecutionConfig
    faults: FaultConfig

    def __init__(self, selection=None, personalization=None, codec=None,
                 train=None, scheduler=None, execution=None, faults=None,
                 **flat):
        # string conveniences on the group params themselves: the seed's
        # FLConfig(personalization="dld", codec="int8") spelled the mode/spec
        # directly, so route strings into the flat namespace
        if isinstance(personalization, str):
            flat["personalization"], personalization = personalization, None
        if isinstance(codec, str):
            flat["codec"], codec = codec, None
        if isinstance(selection, str):
            flat["strategy"], selection = selection, None
        if isinstance(scheduler, str):
            flat["scheduler"], scheduler = scheduler, None

        unknown = set(flat) - set(_FLAT_KEYS)
        if unknown:
            raise TypeError(
                f"unknown FLConfig kwargs {sorted(unknown)}; flat kwargs are "
                f"{sorted(_FLAT_KEYS)} (or pass nested "
                f"{sorted(_GROUP_TYPES)} sub-configs)"
            )
        given = {"selection": selection, "personalization": personalization,
                 "codec": codec, "train": train, "scheduler": scheduler,
                 "execution": execution, "faults": faults}
        grouped: dict[str, dict[str, Any]] = {g: {} for g in _GROUP_TYPES}
        for key, value in flat.items():
            group, attr = _FLAT_KEYS[key]
            grouped[group][attr] = value
        for group, cls in _GROUP_TYPES.items():
            if given[group] is not None:
                if grouped[group]:
                    raise ValueError(
                        f"pass either {group}={cls.__name__}(...) or its flat "
                        f"kwargs, not both (got both for {sorted(grouped[group])})"
                    )
                if not isinstance(given[group], cls):
                    raise TypeError(
                        f"{group} must be a {cls.__name__}, got {type(given[group]).__name__}"
                    )
                object.__setattr__(self, group, given[group])
            else:
                object.__setattr__(self, group, cls(**grouped[group]))

    # --- flat read access (seed compatibility) -----------------------------
    @property
    def strategy(self) -> str:
        return self.selection.strategy

    @property
    def fraction(self) -> float:
        return self.selection.fraction

    @property
    def decay(self) -> float:
        return self.selection.decay

    @property
    def pms_layers(self) -> int:
        return self.personalization.pms_layers

    @property
    def codec_bits(self) -> int:
        return self.codec.bits

    @property
    def topk_fraction(self) -> float:
        return self.codec.topk_fraction

    @property
    def rounds(self) -> int:
        return self.train.rounds

    @property
    def epochs(self) -> int:
        return self.train.epochs

    @property
    def batch_size(self) -> int:
        return self.train.batch_size

    @property
    def lr(self) -> float:
        return self.train.lr

    @property
    def momentum(self) -> float:
        return self.train.momentum

    @property
    def seed(self) -> int:
        return self.train.seed

    @property
    def buffer_k(self) -> int:
        return self.scheduler.buffer_k

    @property
    def max_concurrency(self) -> int:
        return self.scheduler.max_concurrency

    @property
    def cohort_size(self) -> int:
        return self.execution.cohort_size

    @property
    def eval_every(self) -> int:
        return self.execution.eval_every

    @property
    def scan_chunk(self) -> int:
        return self.execution.scan_chunk

    @property
    def cohort_devices(self) -> int:
        return self.execution.cohort_devices

    @property
    def host_population(self) -> int:
        return self.execution.host_population

    @property
    def eval_chunk(self) -> int:
        return self.execution.eval_chunk

    @property
    def edge_groups(self) -> int:
        return self.execution.edge_groups

    @property
    def dropout_rate(self) -> float:
        return self.faults.dropout_rate

    @property
    def deadline_s(self) -> float:
        return self.faults.deadline_s

    @property
    def corrupt_rate(self) -> float:
        return self.faults.corrupt_rate

    @property
    def max_retries(self) -> int:
        return self.faults.max_retries

    def strategy_obj(self):
        return self.selection.strategy_obj()

    def codec_obj(self):
        return self.codec.codec_obj()



# ---------------------------------------------------------------------------
# RoundPipeline — the composed phases
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundPipeline:
    """One federated round as an explicit phase sequence. Swap any field
    (``dataclasses.replace``) to compose a custom round."""

    personalizer: phases.Personalizer
    trainer: phases.LocalTrainer
    transmit: phases.TransmitPhase
    aggregator: phases.Aggregator
    evaluator: phases.Evaluator
    selector: phases.SelectorPhase
    layer_policy: phases.LayerPolicy


def pipeline_from_config(cfg: FLConfig) -> RoundPipeline:
    """Map a (nested) FLConfig onto phase objects via the registries."""
    mode = cfg.personalization.mode
    personalizer = phases.get_phase(
        "personalizer", mode if mode in ("none", "ft") else "compose"
    )
    if mode == "dld":
        layer_policy = phases.get_phase("layer-policy", "dld")
    elif mode == "pms":
        layer_policy = phases.get_phase("layer-policy", "static", layers=cfg.personalization.pms_layers)
    else:
        layer_policy = phases.get_phase("layer-policy", "full")
    sched = cfg.scheduler
    if sched.mode == "async":
        # async always merges through the staleness-weighted buffered
        # aggregator (it honours the share mask, so PMS/DLD compose)
        aggregator = phases.get_phase(
            "aggregator", "staleness",
            staleness_fn=sched.staleness_fn,
            exponent=sched.staleness_exponent,
            threshold=sched.staleness_threshold,
            edge_groups=cfg.execution.edge_groups,
        )
    else:
        aggregator = phases.get_phase(
            "aggregator", "masked-partial" if mode in ("pms", "dld") else "fedavg",
            edge_groups=cfg.execution.edge_groups,
        )
    return RoundPipeline(
        personalizer=personalizer,
        trainer=phases.get_phase(
            "trainer", "sgd",
            epochs=cfg.train.epochs, batch_size=cfg.train.batch_size,
            lr=cfg.train.lr, remainder=cfg.train.remainder,
        ),
        transmit=phases.TransmitPhase(cfg.codec_obj()),
        aggregator=aggregator,
        evaluator=phases.get_phase(
            "evaluator", "distributed", eval_every=cfg.execution.eval_every
        ),
        selector=phases.SelectorPhase(cfg.strategy_obj()),
        layer_policy=layer_policy,
    )


# ---------------------------------------------------------------------------
# round-step composition
# ---------------------------------------------------------------------------


class RoundState(NamedTuple):
    """Carried server-loop state: tensors on the run's device."""

    global_params: Any            # layered list, leaves (...)
    local_params: Any             # layered list, leaves (C, ...); None when
                                  # the personalizer is stateless
    accuracy: torch.Tensor        # (C,) float32
    select: torch.Tensor          # (C,) bool
    pms: torch.Tensor             # (C,) int32 — layers each client will share
    rng: torch.Tensor             # (2,) threefry key
    residual: Any = None          # EF residuals (lossy codec only), (C, ...)
    participation: Any = None     # (C,) int32 — cumulative selection counts
    loss: Any = None              # (C,) last eval loss
    update_norm: Any = None       # (C,) last compressed-delta norm


def build_env(
    data: FederatedDataset,
    seed: int,
    device,
    loss_fn: Callable = mlp_loss,
    acc_fn: Callable = mlp_accuracy,
) -> phases.RoundEnv:
    """The static round environment on ``device``: data slabs (labels as
    int64 for indexing), sample counts, and Oort's per-client delay lane
    ``uniform(PRNGKey(seed + 99), (C,), 0.5, 2.0)`` — the JAX package's draw."""
    dev = torch.device(device)
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    return phases.RoundEnv(
        x_tr=as_t(data.x_train, torch.float32),
        y_tr=as_t(data.y_train, torch.int64),
        m_tr=as_t(data.m_train, torch.bool),
        x_te=as_t(data.x_test, torch.float32),
        y_te=as_t(data.y_test, torch.int64),
        m_te=as_t(data.m_test, torch.bool),
        n_samples=as_t(data.n_samples, torch.float32),
        delay=prng.uniform(prng.PRNGKey(seed + 99, device=dev), (data.n_clients,),
                           minval=0.5, maxval=2.0),
        n_clients=data.n_clients,
        loss_fn=loss_fn,
        acc_fn=acc_fn,
        population=data.n_clients,
    )


def _tree_where(mask: torch.Tensor, new, old):
    """Per-lane select over (lanes, ...) trees; None passes through."""
    if new is None:
        return None
    return tree_map(
        lambda n, o: torch.where(mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, o), new, old
    )


def compute_lanes(pipeline: RoundPipeline, cctx: phases.RoundContext, cenv: phases.RoundEnv,
                  prev_norm: torch.Tensor, kinds: torch.Tensor | None = None,
                  max_norm: float = 0.0, corrupt_scale: float = 0.0):
    """The compute phases on a round's lanes (a sync cohort or the async
    dispatch slots; ``cctx.select`` marks the lanes that commit): the
    personalizer's train model, local training, the corruption ``kinds``
    (fault mode; rewritten after the trainer and before transmit, so
    corrupted lanes still pay wire and the guard is what rejects them), the
    new local models (the fallback off the committing lanes), the wire
    codec, the finite-delta guard (always on: a rejected lane leaves the
    aggregation, keeps its local model and residual, and its update norm
    reverts to ``prev_norm``), and the aggregator. Returns ``(cctx,
    n_rejected)``."""
    stateful = pipeline.personalizer.stateful
    lanes = cctx.select
    cctx = cctx._replace(train_model=pipeline.personalizer.train_model(cctx, cenv))
    cctx = pipeline.trainer.fit(cctx, cenv)
    if kinds is not None:
        cctx = cctx._replace(trained=apply_corruption(cctx.trained, kinds, corrupt_scale))
    if stateful:
        cctx = cctx._replace(new_local=_tree_where(
            lanes, cctx.trained, pipeline.personalizer.local_fallback(cctx, cenv)))
    local_before = cctx.local_params if stateful else None
    res_before = cctx.residual
    cctx = pipeline.transmit.transmit(cctx, cenv)
    ok, n_rejected = finite_update_guard(lanes, cctx.update_norm, max_norm)
    cctx = cctx._replace(
        select=lanes & ok,
        residual=_tree_where(ok, cctx.residual, res_before),
        update_norm=torch.where(ok, cctx.update_norm, prev_norm),
    )
    if stateful:
        cctx = cctx._replace(new_local=_tree_where(ok, cctx.new_local, local_before))
    return pipeline.aggregator.aggregate(cctx, cenv), n_rejected


def build_round_step(
    env: phases.RoundEnv,
    pipeline: RoundPipeline,
    execution: ExecutionConfig | None = None,
    faults: FaultConfig | None = None,
):
    """Compose a RoundPipeline into the round step ``(RoundState, t) ->
    (RoundState, out)``; ``out`` holds the round's history records. ``t``
    is a Python int or an int32 0-d tensor on the state's device.

    Gather -> compute -> scatter, as in the JAX package: the (C,) selection
    resolves to the cohort ``idx`` of K = ``execution.resolved_cohort(C)``
    lanes (selected clients first in ascending id order, then unselected
    ones to fill; past K selected clients the rest neither train nor pay
    wire), the cohort's slabs are gathered, the compute phases run on K
    lanes, and results scatter back into the (C, ...) state; then
    evaluation, selection and the layer policy run on the population. The
    finite-delta guard masks lanes with a non-finite update norm out of
    aggregation and reverts their local/residual state. Random draws follow
    the JAX step's key splits exactly (3 keys a round, 4 with a lossy codec).

    The step reads nothing back to the host and copies nothing from it: the
    round index stays on the device (selection's decay and the evaluator's
    thinning read it there), so ``build_chunk_step`` can capture rounds in a
    CUDA graph.

    ``execution.cohort_devices != 0`` delegates to
    ``repro_torch.fl.shard.build_sharded_round_step``: the same step with the
    compute phases on this rank's K/D lanes of a process group and the
    aggregation as rank partial sums, one all-reduce and a rank-order
    combine (the JAX package's delegation); fault injection does not
    compose with it (``ValueError``).

    With an enabled ``faults`` config the step maps ``(state, t, alive (C,)
    bool, corrupt (C,) int) -> (state, out)``, as the JAX package's: the
    crash/deadline survivors ``alive`` (resolved on the host from the
    round's ``repro_torch.fl.faults.compile_fault_plan``) are intersected
    into the selection before the cohort is drawn, the ``corrupt`` kinds
    rewrite the trained parameters after the trainer and before transmit
    (so the finite guard is what rejects them), and
    ``faults.max_update_norm`` caps the guard. A fault-free step holds no
    fault operation.
    """
    execution = execution or ExecutionConfig()
    faulty = faults is not None and faults.enabled
    if execution.cohort_devices != 0:
        if faulty:
            raise ValueError(
                "fault injection composes with the cohort runtime but not with "
                "cohort_devices sharding; set cohort_devices=0 or disable FaultConfig"
            )
        from repro_torch.fl.shard import build_sharded_round_step

        return build_sharded_round_step(env, pipeline, execution)
    return compose_round_step(env, pipeline, execution, faults)


def compose_round_step(env: phases.RoundEnv, pipeline: RoundPipeline, execution: ExecutionConfig,
                       faults: FaultConfig | None = None, lanes=None):
    """``build_round_step``'s body, for one process or for one rank of a
    sharded cohort. ``lanes`` (``repro_torch.fl.shard``) names the block of
    the K cohort lanes this rank computes (``lanes.block``, a slice) and
    gathers every rank's results back to K lanes (``lanes.gather(new_local,
    residual, update_norm, n_rejected)``); the gather, the scatter and the
    population phases then run the same on every rank. None computes all K
    lanes here."""
    faulty = faults is not None and faults.enabled
    cohort_k = execution.resolved_cohort(env.n_clients)
    stateful = pipeline.personalizer.stateful
    lossy = pipeline.transmit.lossy
    max_norm = float(faults.max_update_norm) if faulty else 0.0
    corrupt_scale = float(faults.corrupt_scale) if faulty else 0.0

    def _as_t(state: RoundState, t):
        if not torch.is_tensor(t):
            t = torch.full((), int(t), dtype=torch.int32, device=state.select.device)
        return t

    def round_step(state: RoundState, t):
        with torch.no_grad():
            return _round_body(state, _as_t(state, t), None, None)

    def fault_round_step(state: RoundState, t, alive: torch.Tensor, corrupt: torch.Tensor):
        with torch.no_grad():
            return _round_body(state, _as_t(state, t), alive, corrupt)

    def _round_body(state: RoundState, t: torch.Tensor, alive, corrupt):
        g = state.global_params
        n_layers = len(g)
        dev = state.select.device
        share = layer_share_mask(n_layers, state.pms)  # (C, L)
        keys = prng.split(state.rng, 4 if lossy else 3)
        rng, r_fit, r_sel = keys[0], keys[1], keys[2]
        r_codec = keys[3] if lossy else None

        # --- gather: selection mask -> cohort (K,); crashed or late clients
        # (fault mode) never enter it ---
        select_in = state.select if alive is None else state.select & alive
        idx = cohort_indices(select_in, cohort_k)
        cmask = select_in.index_select(0, idx)
        executed = torch.zeros_like(select_in).index_copy(0, idx, cmask)
        prev_part = (
            state.participation
            if state.participation is not None
            else torch.zeros(select_in.shape, dtype=torch.int32, device=dev)
        )
        participation = prev_part + executed.to(torch.int32)
        # the lanes computed here: all K, or this rank's block of them
        lane_idx, lane_mask = (idx, cmask) if lanes is None else (idx[lanes.block],
                                                                  cmask[lanes.block])
        cenv = env.take(lane_idx)
        cctx = phases.RoundContext(
            t=t,
            global_params=g,
            local_params=tree_take(state.local_params, lane_idx) if stateful else None,
            select=lane_mask,
            pms=state.pms.index_select(0, lane_idx),
            share=share.index_select(0, lane_idx),
            residual=tree_take(state.residual, lane_idx),
            participation=participation.index_select(0, lane_idx),
            cohort_idx=lane_idx,
            cohort_mask=lane_mask,
            rng_fit=r_fit,
            rng_codec=r_codec,
            rng_sel=r_sel,
        )

        # --- personalize, train, transmit, guard and aggregate on the lanes ---
        prev_norm = (
            state.update_norm
            if state.update_norm is not None
            else torch.zeros(select_in.shape, dtype=torch.float32, device=dev)
        )
        kinds_k = (None if corrupt is None
                   else torch.where(cmask, corrupt.index_select(0, idx), torch.zeros_like(idx)))
        cctx, n_rejected = compute_lanes(pipeline, cctx, cenv,
                                         prev_norm.index_select(0, lane_idx),
                                         kinds_k, max_norm, corrupt_scale)
        new_local_k, res_k, norm_k = cctx.new_local, cctx.residual, cctx.update_norm
        if lanes is not None:  # every rank's lanes, on every rank
            new_local_k, res_k, norm_k, n_rejected = lanes.gather(
                new_local_k if stateful else None, res_k, norm_k, n_rejected)

        # --- scatter: cohort results back into the (C, ...) state ---
        new_local = tree_scatter(state.local_params, idx, new_local_k) if stateful else None
        new_residual = tree_scatter(state.residual, idx, res_k)
        update_norm = prev_norm.index_copy(0, idx, norm_k)
        wire_prospective, wire_paid = pipeline.transmit.wire_costs(g, share, executed)

        # --- population phases: eval, selection, layer policy on (C,) ---
        pctx = cctx._replace(
            local_params=state.local_params,
            select=executed,
            pms=state.pms,
            share=share,
            residual=new_residual,
            participation=participation,
            cohort_idx=None,
            cohort_mask=None,
            new_local=new_local,
            wire_bytes=wire_prospective,
            wire_paid=wire_paid,
            update_norm=update_norm,
            prev_accuracy=state.accuracy,
            prev_loss=state.loss,
        )
        pctx = pctx._replace(eval_model=pipeline.personalizer.eval_model(pctx, env))
        pctx = pipeline.evaluator.evaluate(pctx, env)
        pctx = pipeline.selector.select(pctx, env)
        pctx = pctx._replace(next_pms=pipeline.layer_policy.next_pms(pctx, env, n_layers))

        tx = transmitted_parameters(executed, share, layer_param_sizes(g))
        new_state = RoundState(
            global_params=pctx.new_global,
            local_params=new_local,
            accuracy=pctx.accuracy,
            select=pctx.next_select,
            pms=pctx.next_pms,
            rng=rng,
            residual=new_residual,
            participation=participation,
            loss=pctx.loss,
            update_norm=update_norm,
        )
        out = {
            "acc": pctx.accuracy,
            "selected": executed,
            "tx_params": tx,
            "pms": state.pms,
            "wire_per_client": wire_paid,
            "update_norm": update_norm,
            "rejected": n_rejected,
        }
        return new_state, out

    return fault_round_step if faulty else round_step


# ---------------------------------------------------------------------------
# chunks of rounds: one call (on CUDA one CUDA-graph replay) for many rounds
# ---------------------------------------------------------------------------


class StackedOuts(dict):
    """The ``out`` records of a chunk's rounds stacked to ``(length, ...)``:
    views into one byte buffer, so ``numpy()`` fetches them all with one
    device-to-host copy."""

    def __init__(self, outs: list):
        layout, offset = [], 0
        for key, leaf in outs[0].items():
            shape = (len(outs), *leaf.shape)
            n_bytes = leaf.element_size() * math.prod(shape)
            layout.append((key, leaf.dtype, shape, offset, n_bytes))
            offset += -(-n_bytes // 8) * 8  # every view starts on an 8-byte boundary
        device = next(iter(outs[0].values())).device
        packed = torch.empty((offset,), dtype=torch.uint8, device=device)
        for key, dtype, shape, a, n_bytes in layout:
            view = packed[a:a + n_bytes].view(dtype).view(shape)
            torch.stack([out[key] for out in outs], out=view)
            self[key] = view
        self.packed = packed

    def numpy(self) -> dict:
        """The records as numpy arrays, through one copy of the buffer."""
        host = self.packed.cpu()
        return {key: host[view.storage_offset() * view.element_size():][:view.nbytes]
                .view(view.dtype).view(view.shape).numpy() for key, view in self.items()}


def _state_leaves(state: RoundState) -> list:
    return tree_leaves(list(state))


def _state_like(state: RoundState, leaves) -> RoundState:
    """``state``'s structure (None fields kept) filled with ``leaves``."""
    it = iter(leaves)
    return RoundState(*[None if f is None else tree_unflatten(f, [next(it) for _ in tree_leaves(f)])
                        for f in state])


class _ChunkStep:
    """``build_chunk_step``'s callable; its buffers hold the carried state."""

    def __init__(self, round_step, length: int):
        self.round_step = round_step
        self.length = length
        self._state = None  # RoundState whose leaves are the step's buffers
        self._bufs: list = []
        self._ts = None
        self._graph = None
        self._outs = None
        self._counts: dict[str, int] = {}  # kernel launches one replay makes

    def _bind(self, state: RoundState, ts: torch.Tensor) -> None:
        """Load ``state`` and ``ts`` into the buffers (the first call adopts
        the state's own tensors as the buffers, cloning only a leaf that is
        not contiguous or shares its storage with another)."""
        leaves = _state_leaves(state)
        if self._state is None:
            seen = set()
            for leaf in leaves:
                if not leaf.is_contiguous() or leaf.untyped_storage().data_ptr() in seen:
                    leaf = leaf.clone(memory_format=torch.contiguous_format)
                seen.add(leaf.untyped_storage().data_ptr())
                self._bufs.append(leaf)
            self._state = _state_like(state, self._bufs)
            self._ts = torch.empty((self.length,), dtype=torch.int32, device=self._bufs[0].device)
        else:
            if len(leaves) != len(self._bufs):
                raise ValueError("the state's structure differs from the one this chunk step "
                                 "was first called with")
            for buf, leaf in zip(self._bufs, leaves):
                if leaf.shape != buf.shape or leaf.dtype != buf.dtype:
                    raise ValueError(f"state leaf {tuple(leaf.shape)} {leaf.dtype} differs from "
                                     f"its buffer {tuple(buf.shape)} {buf.dtype}")
                if leaf.data_ptr() != buf.data_ptr():
                    buf.copy_(leaf)
        if tuple(ts.shape) != (self.length,):
            raise ValueError(f"ts must hold {self.length} round indices, got {tuple(ts.shape)}")
        self._ts.copy_(ts)

    def _rounds(self) -> StackedOuts:
        """``length`` round steps from the buffers, the final state written
        back into them; returns the stacked records."""
        state, outs = self._state, []
        for r in range(self.length):
            state, out = self.round_step(state, self._ts[r])
            outs.append(out)
        stacked = StackedOuts(outs)
        new = _state_leaves(state)
        if len(new) != len(self._bufs):
            raise ValueError("the round step changed the state's structure (a None field became "
                             "a tensor or back); give the chunk step a full state")
        # a new leaf that shares storage with a buffer is cloned before any
        # buffer is overwritten
        held = {buf.untyped_storage().data_ptr() for buf in self._bufs}
        new = [leaf if leaf is buf or leaf.untyped_storage().data_ptr() not in held
               else leaf.clone() for leaf, buf in zip(new, self._bufs)]
        for buf, leaf in zip(self._bufs, new):
            if leaf is not buf:
                buf.copy_(leaf)
        return stacked

    def _capture(self) -> None:
        """Warm the round up once on a side stream (its results and kernel
        launches are dropped: it is no round of the run), then capture the
        chunk in a CUDA graph on that stream."""
        dev = self._bufs[0].device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        before = kernels.launch_counts()
        with torch.cuda.stream(stream):
            self.round_step(self._state, self._ts[0])
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        counted = kernels.launch_counts()
        # a sharded round's collectives run on the process group's own
        # stream: capture in thread-local mode, so that stream's bookkeeping
        # on other threads cannot void the capture
        mode = "global" if getattr(self.round_step, "mesh", None) is None else "thread_local"
        with torch.cuda.graph(graph, stream=stream, capture_error_mode=mode):
            self._outs = self._rounds()
        after = kernels.launch_counts()
        # a capture records launches without running them: replays count them
        self._counts = {k: after[k] - counted[k] for k in after}
        kernels.add_launch_counts({k: before[k] - after[k] for k in after})
        self._graph = graph

    def __call__(self, state: RoundState, ts: torch.Tensor, on_capture=contextlib.nullcontext):
        self._bind(state, ts)
        if self._bufs[0].device.type != "cuda":
            return self._state, self._rounds()
        if self._graph is None:
            with on_capture():
                self._capture()
        self._graph.replay()
        kernels.add_launch_counts(self._counts)
        return self._state, self._outs


def build_chunk_step(round_step, length: int):
    """Fuse ``length`` consecutive rounds of a ``build_round_step`` round
    step into one call ``(RoundState, ts) -> (RoundState, outs)``: ``ts``
    is the ``(length,)`` int32 tensor of the round indices, ``outs`` the
    rounds' ``out`` records stacked to ``(length, ...)``
    (``StackedOuts``: ``outs.numpy()`` fetches them with one device-to-host
    copy). The counterpart of the JAX package's ``build_chunk_step``.

    The carried state lives in the step's own buffers, updated in place: the
    first call adopts the given state's tensors as those buffers, later
    calls copy a state in only where it is not already the buffers. So the
    state a call returns is the buffers themselves, and a state passed in is
    invalid after the call (it holds the new state, or is stale) — the
    counterpart of ``donate_argnums=0``; the scheduler reassigns its state
    every chunk and never reads an old one.

    On CUDA the first call runs one warm-up round on a side stream (dropped:
    its results and kernel launches count for nothing), then captures the
    ``length`` rounds in a ``torch.cuda.CUDAGraph`` reading the buffers and
    the round indices from device memory; every call replays the graph (one
    launch from the host for the whole chunk). A capture that fails raises.
    A call may pass ``on_capture``, a context-manager factory the warm-up
    and capture run inside (the profiler's ``capture`` phase).
    The kernels' launch counters count a replay as the launches its capture
    recorded (``repro_torch.kernels.add_launch_counts``). The returned
    ``outs`` are the graph's own output buffers: read them (``numpy()``)
    before the next call. Replay runs the eager round's kernels on the same
    inputs, so every chunk length, tails included, gives the history of the
    per-round loop bit for bit. On the CPU a call runs the rounds in a loop.

    A sharded round step (``repro_torch.fl.shard``) is captured with its
    all-reduces under NCCL (the warm-up round runs them once first); on
    CUDA tensors under gloo, whose collectives pass through the host, it
    raises ``CollectiveCaptureError`` rather than run eagerly.
    """
    if length < 1:
        raise ValueError(f"chunk length must be >= 1, got {length!r}")
    mesh = getattr(round_step, "mesh", None)
    if mesh is not None and mesh.device.type == "cuda" and not mesh.capturable:
        raise CollectiveCaptureError(
            f"a {mesh.backend} process group cannot run inside a CUDA graph (it copies CUDA "
            f"tensors through the host): run the sharded rounds with scan_chunk=1, or start "
            f"the group with the nccl backend")
    return _ChunkStep(round_step, length)


class CollectiveCaptureError(RuntimeError):
    """A sharded round step whose collectives a CUDA graph cannot capture
    (gloo on CUDA tensors) was asked for chunks of rounds."""
