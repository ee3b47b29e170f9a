"""Composable round-pipeline API of the port — the port of the JAX
package's ``fl/api.py``.

A federated round is a ``RoundPipeline`` of phases (``repro_torch.fl.phases``):

  Personalizer -> LocalTrainer -> TransmitPhase (wire codec + EF)
               -> Aggregator -> Evaluator -> SelectorPhase -> LayerPolicy

``FLConfig`` is the declarative form (seven nested validated sub-configs,
or the seed's flat kwargs), the same class as the JAX package's.
``pipeline_from_config`` maps a config onto phases through the registries;
``build_round_step`` composes a pipeline into the round step
``(RoundState, t) -> (RoundState, out)`` that the synchronous scheduler
runs once per round. The JAX package jit-compiles that step and can fuse
chunks of rounds (``build_chunk_step``); the port runs it eagerly, one
round per call (fusion comes with ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

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
from repro_torch.models.mlp import mlp_accuracy, mlp_loss
from repro_torch.tree import tree_map

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
    if cfg.scheduler.mode == "async":
        aggregator = phases.get_phase("aggregator", "staleness")
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


def build_round_step(
    env: phases.RoundEnv,
    pipeline: RoundPipeline,
    execution: ExecutionConfig | None = None,
    faults: FaultConfig | None = None,
):
    """Compose a RoundPipeline into the round step ``(RoundState, t) ->
    (RoundState, out)``; ``out`` holds the round's history records.

    Gather -> compute -> scatter, as in the JAX package: the (C,) selection
    resolves to the cohort ``idx`` (K = C: every client, selected first in
    ascending id order), the cohort's slabs are gathered, the compute phases
    run on K lanes, and results scatter back into the (C, ...) state; then
    evaluation, selection and the layer policy run on the population. The
    finite-delta guard masks lanes with a non-finite update norm out of
    aggregation and reverts their local/residual state. Random draws follow
    the JAX step's key splits exactly (3 keys a round, 4 with a lossy codec).
    """
    execution = execution or ExecutionConfig()
    if execution.cohort_devices != 0:
        raise NotImplementedError(
            "cohort_devices (sharded round step) is not ported yet: ROADMAP.md queue 1 item 12"
        )
    if execution.cohort_size != 0:
        raise NotImplementedError(
            "cohort_size > 0 (K < C cohort rounds) is not ported yet: ROADMAP.md queue 1 item 7"
        )
    if faults is not None and faults.enabled:
        raise NotImplementedError(
            "fault injection is not ported yet: ROADMAP.md queue 1 item 9"
        )
    cohort_k = env.n_clients
    stateful = pipeline.personalizer.stateful
    lossy = pipeline.transmit.lossy

    def round_step(state: RoundState, t: int):
        with torch.no_grad():
            return _round_body(state, int(t))

    def _round_body(state: RoundState, t: int):
        g = state.global_params
        n_layers = len(g)
        dev = state.select.device
        share = layer_share_mask(n_layers, state.pms)  # (C, L)
        keys = prng.split(state.rng, 4 if lossy else 3)
        rng, r_fit, r_sel = keys[0], keys[1], keys[2]
        r_codec = keys[3] if lossy else None

        # --- gather: selection mask -> cohort (K,) ---
        select_in = state.select
        idx = cohort_indices(select_in, cohort_k)
        cmask = select_in.index_select(0, idx)
        executed = torch.zeros_like(select_in).index_copy(0, idx, cmask)
        prev_part = (
            state.participation
            if state.participation is not None
            else torch.zeros(select_in.shape, dtype=torch.int32, device=dev)
        )
        participation = prev_part + executed.to(torch.int32)
        cenv = env.take(idx)
        cctx = phases.RoundContext(
            t=t,
            global_params=g,
            local_params=tree_take(state.local_params, idx) if stateful else None,
            select=cmask,
            pms=state.pms.index_select(0, idx),
            share=share.index_select(0, idx),
            residual=tree_take(state.residual, idx),
            participation=participation.index_select(0, idx),
            cohort_idx=idx,
            cohort_mask=cmask,
            rng_fit=r_fit,
            rng_codec=r_codec,
            rng_sel=r_sel,
        )

        # --- personalization, then local training on K lanes ---
        cctx = cctx._replace(train_model=pipeline.personalizer.train_model(cctx, cenv))
        cctx = pipeline.trainer.fit(cctx, cenv)
        if stateful:
            cctx = cctx._replace(new_local=_tree_where(
                cmask, cctx.trained, pipeline.personalizer.local_fallback(cctx, cenv)))
        # --- wire codec: each cohort lane's shared delta (uplink) ---
        local_before = cctx.local_params if stateful else None
        res_before = cctx.residual
        cctx = pipeline.transmit.transmit(cctx, cenv)
        # --- finite-delta guard (always on) ---
        prev_norm = (
            state.update_norm
            if state.update_norm is not None
            else torch.zeros(select_in.shape, dtype=torch.float32, device=dev)
        )
        ok, n_rejected = finite_update_guard(cmask, cctx.update_norm)
        cctx = cctx._replace(
            select=cmask & ok,
            residual=_tree_where(ok, cctx.residual, res_before),
            update_norm=torch.where(ok, cctx.update_norm, prev_norm.index_select(0, idx)),
        )
        if stateful:
            cctx = cctx._replace(new_local=_tree_where(ok, cctx.new_local, local_before))
        # --- aggregation of the shared pieces (Eq. 1, masked/partial) ---
        cctx = pipeline.aggregator.aggregate(cctx, cenv)

        # --- scatter: cohort results back into the (C, ...) state ---
        new_local = tree_scatter(state.local_params, idx, cctx.new_local) if stateful else None
        new_residual = tree_scatter(state.residual, idx, cctx.residual)
        update_norm = prev_norm.index_copy(0, idx, cctx.update_norm)
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

    return round_step
