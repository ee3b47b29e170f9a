"""Swappable round phases — the port of the JAX package's ``fl/phases.py``.

A federated round is a sequence of small frozen-dataclass phases, each
transforming a shared ``RoundContext``:

  Personalizer -> LocalTrainer -> TransmitPhase (wire codec + EF)
               -> Aggregator -> Evaluator -> SelectorPhase -> LayerPolicy

``RoundEnv`` is the static per-experiment environment (data shards on the
device, sample counts, loss/accuracy functions). Lanes: the compute phases
(personalizer's train model, trainer, transmit, aggregator) see a cohort
``env.take(idx)`` of K lanes; evaluation, selection and the layer policy
see the population's C lanes. Where the JAX package vmaps over lanes, the
port computes with the lane axis written out (batched matmuls; a round's
leaves of all lanes in one codec call and one launch of each kernel).
Per-client keys are split over the
population and gathered by ``ctx.cohort_idx`` (``client_keys``), so a
client's random stream does not depend on its lane.

Phases are scheduler-agnostic: ``SyncScheduler`` drives them with the
broadcast global model (``ctx.dispatch_params is None``), while
``AsyncScheduler`` supplies per-slot dispatch snapshots and the
``staleness`` lane (its cohort lanes are the (M,) in-flight dispatch
slots) and swaps the aggregator for ``StalenessAggregator`` (registry name
``'staleness'``), FedBuff's buffered delta merge discounted by
``staleness_weight``: one launch of masked_aggregate's kernel an event.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import random as prng
from repro_torch.comm import Codec, ef_steps, tree_wire_bytes
from repro_torch.core import (
    compose_model,
    dynamic_layer_definition,
    fedavg_aggregate,
    masked_partial_aggregate,
    personalize_ft,
    staleness_weighted_merge,
)
from repro_torch.core.selection import ClientObservations, SelectionStrategy
from repro_torch.device import fill_vector
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _lane_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


@dataclasses.dataclass(frozen=True)
class RoundEnv:
    """Static per-experiment environment every phase can read. ``n_clients``
    is the number of lanes (C, or K after ``take``); ``population`` always
    names the true population so per-client keys stay lane-independent."""

    x_tr: torch.Tensor
    y_tr: torch.Tensor      # int64 labels
    m_tr: torch.Tensor
    x_te: torch.Tensor
    y_te: torch.Tensor
    m_te: torch.Tensor
    n_samples: torch.Tensor  # (lanes,) float32 — |d_i|
    delay: torch.Tensor      # (lanes,) float32 — analytic delay (Oort)
    n_clients: int
    loss_fn: Callable
    acc_fn: Callable
    population: int = 0

    @property
    def pop(self) -> int:
        return self.population or self.n_clients

    @property
    def device(self) -> torch.device:
        """The device of the slabs (an environment without data slabs, the
        host plane's population step, names it by its sample counts)."""
        return next(t for t in (self.x_tr, self.x_te, self.n_samples) if t is not None).device

    def take(self, idx: torch.Tensor) -> "RoundEnv":
        """Cohort view: the ``idx`` client lanes of every data slab."""
        sel = lambda t: t.index_select(0, idx)  # noqa: E731
        return dataclasses.replace(
            self,
            x_tr=sel(self.x_tr), y_tr=sel(self.y_tr), m_tr=sel(self.m_tr),
            x_te=sel(self.x_te), y_te=sel(self.y_te), m_te=sel(self.m_te),
            n_samples=sel(self.n_samples), delay=sel(self.delay),
            n_clients=int(idx.shape[0]), population=self.pop,
        )


class RoundContext(NamedTuple):
    """Dynamic state threaded through the phase pipeline; phases return
    updated copies (``_replace``) and never mutate it."""

    t: Any = None                 # round index: int32 0-d tensor on the device
    global_params: Any = None     # layered list, leaves (...)
    local_params: Any = None      # layered list, leaves (lanes, ...)
    select: Any = None            # (lanes,) bool
    pms: Any = None               # (lanes,) int32
    share: Any = None             # (lanes, L) bool
    residual: Any = None          # EF residuals, leaves (lanes, ...)
    participation: Any = None     # (lanes,) int32
    cohort_idx: Any = None        # (lanes,) client id behind each lane
    cohort_mask: Any = None       # (lanes,) bool
    dispatch_params: Any = None   # async: per-slot snapshot each client trained
                                  # from, leaves (lanes, ...); deltas and EF
                                  # are taken against it; None under sync
    staleness: Any = None         # async: (lanes,) int32 events since dispatch
    rng_fit: Any = None
    rng_codec: Any = None
    rng_sel: Any = None
    prev_accuracy: Any = None
    prev_loss: Any = None
    train_model: Any = None       # Personalizer
    trained: Any = None           # LocalTrainer
    new_local: Any = None         # engine
    agg_src: Any = None           # TransmitPhase
    wire_bytes: Any = None        # (lanes,) prospective uplink bytes
    wire_paid: Any = None         # (lanes,) uplink bytes paid this round
    update_norm: Any = None       # (lanes,) l2 norm of the compressed delta
    new_global: Any = None        # Aggregator
    eval_model: Any = None        # Personalizer.eval_model
    accuracy: Any = None          # Evaluator
    loss: Any = None              # Evaluator
    next_select: Any = None       # SelectorPhase
    next_pms: Any = None          # LayerPolicy
    merge_weight: Any = None      # Aggregator: (lanes,) staleness discount each
                                  # landing update was merged with


def client_keys(rng: torch.Tensor, ctx: RoundContext, env: RoundEnv) -> torch.Tensor:
    """(lanes, 2) per-client keys: split over the population, gathered by
    ``ctx.cohort_idx``."""
    keys = prng.split(rng, env.pop)
    if ctx.cohort_idx is not None:
        keys = keys.index_select(0, ctx.cohort_idx)
    return keys


def _stack_clients(params, n_clients: int):
    """The unstacked model seen from every lane (an expanded view, no copy)."""
    return tree_map(lambda gl: gl.expand((n_clients,) + tuple(gl.shape)), params)


def _client_global(ctx: RoundContext, env: RoundEnv):
    """Each lane's view of the global model at training time: the broadcast
    server model under sync, the slot's dispatch snapshot under async."""
    if ctx.dispatch_params is not None:
        return ctx.dispatch_params
    return _stack_clients(ctx.global_params, env.n_clients)


# ---------------------------------------------------------------------------
# Personalizer
# ---------------------------------------------------------------------------


class Personalizer:
    """Decides what model each client trains and is evaluated on;
    ``stateful`` says whether it carries per-client local parameters."""

    stateful: bool = True

    def train_model(self, ctx: RoundContext, env: RoundEnv):
        raise NotImplementedError

    def eval_model(self, ctx: RoundContext, env: RoundEnv):
        raise NotImplementedError

    def local_fallback(self, ctx: RoundContext, env: RoundEnv):
        """What unselected cohort lanes keep as their local model."""
        return ctx.local_params


@dataclasses.dataclass(frozen=True)
class NoPersonalizer(Personalizer):
    """Everyone trains and evaluates the broadcast global model (under the
    async scheduler: trains from the dispatch snapshot)."""

    stateful: bool = False

    def train_model(self, ctx, env):
        return _client_global(ctx, env)

    def eval_model(self, ctx, env):
        return _stack_clients(ctx.new_global, env.n_clients)

    def local_fallback(self, ctx, env):
        return ctx.train_model


@dataclasses.dataclass(frozen=True)
class FTPersonalizer(Personalizer):
    """Fine-tuning choice (Eq. 8): each client keeps whichever whole model
    (local vs global) has the lower loss on its test shard; under the async
    scheduler the global side of training is each slot's snapshot."""

    def _pick(self, local, global_, env):
        loss_loc = env.loss_fn(local, env.x_te, env.y_te, env.m_te)
        loss_glob = env.loss_fn(global_, env.x_te, env.y_te, env.m_te)
        return personalize_ft(local, global_, loss_loc, loss_glob)

    def train_model(self, ctx, env):
        if ctx.dispatch_params is not None:
            return self._pick(ctx.local_params, ctx.dispatch_params, env)
        return self._pick(ctx.local_params, ctx.global_params, env)

    def eval_model(self, ctx, env):
        return self._pick(ctx.new_local, ctx.new_global, env)


@dataclasses.dataclass(frozen=True)
class ComposePersonalizer(Personalizer):
    """PMS/DLD: shared global layers composed with personalized local ones
    along the (C, L) share mask (the async scheduler's stacked snapshots
    compose like the broadcast model)."""

    def train_model(self, ctx, env):
        if ctx.dispatch_params is not None:
            return compose_model(ctx.dispatch_params, ctx.local_params, ctx.share)
        return compose_model(ctx.global_params, ctx.local_params, ctx.share)

    def eval_model(self, ctx, env):
        return compose_model(ctx.new_global, ctx.new_local, ctx.share)


# ---------------------------------------------------------------------------
# LocalTrainer — Algorithm 2
# ---------------------------------------------------------------------------


def _batched(x, y, m, batch_size: int, remainder: str = "drop"):
    """Lane slabs (K, N, ...) -> (K, nb, B, ...) minibatches: ``'drop'``
    trims to whole batches (a slab shorter than one batch is one ragged
    batch), ``'pad'`` adds a masked tail batch."""
    n = x.shape[1]
    if remainder == "pad":
        nb = -(-n // batch_size)
        pad = nb * batch_size - n
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            y = torch.nn.functional.pad(y, (0, pad))
            m = torch.nn.functional.pad(m, (0, pad))
    else:
        nb = max(1, n // batch_size)
        take = nb * batch_size
        if take > n:
            nb, take, batch_size = 1, n, n
        x, y, m = x[:, :take], y[:, :take], m[:, :take]
    k = x.shape[0]
    return (
        x.reshape(k, nb, batch_size, *x.shape[2:]),
        y.reshape(k, nb, batch_size),
        m.reshape(k, nb, batch_size),
    )


class LocalTrainer:
    """Produces ``ctx.trained`` from ``ctx.train_model`` (Algorithm 2)."""

    def fit(self, ctx: RoundContext, env: RoundEnv) -> RoundContext:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SGDTrainer(LocalTrainer):
    """Algorithm 2 LocalTrain: ``epochs`` of minibatch SGD on every lane at
    once. The lanes' losses are summed before the backward pass; each
    lane's parameters feed only its own loss, so the gradient of the sum is
    every lane's own gradient (the JAX package's ``vmap(grad)``)."""

    epochs: int = 1
    batch_size: int = 32
    lr: float = 0.1
    remainder: str = "drop"

    def fit(self, ctx: RoundContext, env: RoundEnv) -> RoundContext:
        xb, yb, mb = _batched(env.x_tr, env.y_tr, env.m_tr, self.batch_size, self.remainder)
        model = ctx.train_model
        leaves = [leaf.detach() for leaf in tree_leaves(model)]
        with torch.enable_grad():
            for _ in range(self.epochs):
                for b in range(xb.shape[1]):
                    ps = [p.requires_grad_(True) for p in leaves]
                    loss = env.loss_fn(tree_unflatten(model, ps), xb[:, b], yb[:, b], mb[:, b])
                    grads = torch.autograd.grad(loss.sum(), ps)
                    leaves = [p.detach() - self.lr * g for p, g in zip(ps, grads)]
        return ctx._replace(trained=tree_unflatten(model, leaves))


# ---------------------------------------------------------------------------
# TransmitPhase — the wire codec with error feedback
# ---------------------------------------------------------------------------


def _client_sq_norms(stacked, reference):
    """(lanes,) sum of squared differences between stacked leaves and the
    (unstacked) reference, over every non-lane axis."""
    total = None
    for lc, lg in zip(tree_leaves(stacked), tree_leaves(reference)):
        d = lc - lg
        s = torch.sum(d * d, dim=tuple(range(1, d.ndim)))
        total = s if total is None else total + s
    return total


@dataclasses.dataclass(frozen=True)
class TransmitPhase:
    """Wire-codec phase: the uplink every selected client's shared delta
    takes. Lossy codecs run one error-feedback step per layer for all lanes
    at once (residuals touched only for layers a lane actually sent);
    lossless ones pass the update through. Also deposits the cost signals:
    prospective and paid wire bytes, and the compressed delta's l2 norm.
    The delta is taken against each lane's view of the global model: the
    broadcast model under sync, the dispatch snapshot under async."""

    codec: Codec

    @property
    def lossy(self) -> bool:
        return self.codec.lossy

    def transmit(self, ctx: RoundContext, env: RoundEnv) -> RoundContext:
        g, trained = ctx.global_params, ctx.trained
        ref = g if ctx.dispatch_params is None else ctx.dispatch_params
        if self.codec.lossy and ctx.residual is None:
            raise ValueError("lossy codec requires RoundState.residual (run_federated sets it)")
        if self.codec.lossy:
            # every layer's error-feedback step in one call: one quantize
            # launch a round for the int codecs
            keys = [client_keys(prng.fold_in(ctx.rng_codec, j), ctx, env) for j in range(len(g))]
            deltas = [tree_map(lambda t, gl: t - gl, tr_j, r_j) for tr_j, r_j in zip(trained, ref)]
            steps = ef_steps(self.codec, deltas, ctx.residual, keys)
            agg_src, new_residual = [], []
            for j, (g_j, res_j, (dec, new_r)) in enumerate(zip(ref, ctx.residual, steps)):
                sent_j = ctx.select & ctx.share[:, j]
                agg_src.append(tree_map(lambda gl, d: gl + d, g_j, dec))
                new_residual.append(tree_map(
                    lambda n, o: torch.where(_lane_mask(sent_j, n), n, o), new_r, res_j))
        else:
            agg_src, new_residual = trained, ctx.residual

        wire_prospective, wire_paid = self.wire_costs(g, ctx.share, ctx.select)
        share_f = ctx.share.to(torch.float32)
        norm_sq = torch.zeros(share_f.shape[0], dtype=torch.float32, device=share_f.device)
        for j in range(len(g)):
            norm_sq = norm_sq + share_f[:, j] * _client_sq_norms(agg_src[j], ref[j])
        return ctx._replace(
            agg_src=agg_src,
            residual=new_residual,
            wire_bytes=wire_prospective,
            wire_paid=wire_paid,
            update_norm=torch.sqrt(norm_sq),
        )

    def layer_wire(self, global_params) -> list[float]:
        """Static wire bytes one client pays per layer through the codec."""
        return [tree_wire_bytes(self.codec, layer) for layer in global_params]

    def wire_costs(self, global_params, share: torch.Tensor, select: torch.Tensor):
        """(prospective, paid) per-client bytes from the (C, L) share mask and
        the (C,) selection."""
        lw = fill_vector(self.layer_wire(global_params), torch.float32, share.device)
        share_f = share.to(torch.float32)
        return share_f @ lw, (share_f * select.to(torch.float32)[:, None]) @ lw

    def silo_transmit(self, xs: list, residuals: list, rngs: list):
        """Cross-silo lane (``fl/cross_silo.py``): EF-compress each silo's
        contribution. ``xs``/``residuals`` are leaves with a leading silo
        axis (S, ...), ``rngs`` one key a leaf. Silo s of leaf i goes
        through ``ef_step`` on its own codec blocks and scales with key
        ``split(rngs[i], S)[s]``, as the JAX package's vmap gives it; every
        leaf goes through one ``ef_steps`` call (one quantize and one
        dequantize launch for up to 64 leaves). Returns ``(decoded,
        new_residuals)``, lists of (S, ...) leaves."""
        steps = ef_steps(self.codec, xs, residuals,
                         [prng.split(k, x.shape[0]) for k, x in zip(rngs, xs)])
        return [d for d, _ in steps], [e for _, e in steps]


# ---------------------------------------------------------------------------
# Aggregator — Eq. 1
# ---------------------------------------------------------------------------


class Aggregator:
    """Reduces the lane axis into the new global model.

    ``edge_groups`` routes the reduction through two-level (edge-server)
    aggregation: the population is cut into E contiguous client-id blocks,
    each edge partial-sums its members and the server sums the E partials
    (masked_aggregate's edge mode). ``edge_groups <= 1`` keeps the flat sum
    exactly; E > 1 reassociates the sum (within a few ulp of the flat
    one).

    ``axis_name`` (a ``repro_torch.launch.mesh.CohortMesh``; None, the
    default, is local) reduces across the ranks of a sharded cohort
    (``repro_torch.fl.shard``): each rank sums its own lanes (through its
    edges first) to partials, one all-reduce gathers them, and the combine
    gives every rank the same new global model."""

    edge_groups = 0   # subclasses declare the dataclass field
    axis_name = None  # subclasses declare the dataclass field (kept last)

    def _edges(self, ctx: RoundContext, env: RoundEnv):
        """``(edge_ids, n_edges)`` of the current lanes, or ``(None, 0)``
        when aggregation is flat. Membership is by true client id
        (``ctx.cohort_idx``), so a client reduces through its own edge in
        whichever lane or slot it lands; computed on the device."""
        if self.edge_groups <= 1:
            return None, 0
        group = -(-env.pop // self.edge_groups)
        cid = (ctx.cohort_idx if ctx.cohort_idx is not None
               else torch.arange(env.n_clients, device=ctx.select.device))
        ids = torch.clamp(torch.div(cid, group, rounding_mode="floor"), 0, self.edge_groups - 1)
        return ids.to(torch.int32), self.edge_groups

    def aggregate(self, ctx: RoundContext, env: RoundEnv) -> RoundContext:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FedAvgAggregator(Aggregator):
    """Plain Eq. 1 over selected clients, full model."""

    edge_groups: int = 0
    axis_name: Any = None

    def aggregate(self, ctx, env):
        edge_ids, n_edges = self._edges(ctx, env)
        return ctx._replace(new_global=fedavg_aggregate(
            ctx.agg_src, ctx.select, env.n_samples, axis_name=self.axis_name,
            edge_ids=edge_ids, n_edges=n_edges))


@dataclasses.dataclass(frozen=True)
class MaskedPartialAggregator(Aggregator):
    """ACSP-FL masked aggregation: only layers a client shares contribute;
    layers nobody shared keep the previous global value."""

    edge_groups: int = 0
    axis_name: Any = None

    def aggregate(self, ctx, env):
        edge_ids, n_edges = self._edges(ctx, env)
        return ctx._replace(new_global=masked_partial_aggregate(
            ctx.agg_src, ctx.global_params, ctx.select, env.n_samples, ctx.share,
            axis_name=self.axis_name, edge_ids=edge_ids, n_edges=n_edges))


# --- staleness weighting (FedBuff, Nguyen et al. 2022) ----------------------

def _stale_constant(s, exponent, threshold):
    return torch.ones_like(s)


def _stale_polynomial(s, exponent, threshold):
    x = 1.0 + s
    if exponent == 0.5:
        # XLA rewrites pow(x, -0.5) to rsqrt, which gives the float32
        # rounding of the exact value on the staleness range (tested on
        # s = 0..64); torch's float32 pow is 1 ulp off on 12 of those, 1 /
        # sqrt in float64 rounded once is not
        return (1.0 / torch.sqrt(x.to(torch.float64))).to(torch.float32)
    return torch.pow(x, -exponent)


def _stale_hinge(s, exponent, threshold):
    ones = torch.ones_like(s)
    return torch.where(s <= threshold, ones, 1.0 / (exponent * (s - threshold) + 1.0))


STALENESS_FNS = {
    "constant": _stale_constant,
    "polynomial": _stale_polynomial,
    "hinge": _stale_hinge,
}


def staleness_weight(fn: str, staleness: torch.Tensor, exponent: float = 0.5,
                     threshold: float = 4.0) -> torch.Tensor:
    """(lanes,) float32 merge discount for updates ``staleness`` aggregation
    events old: ``constant`` 1, ``polynomial`` FedBuff's ``(1+s)^-a``,
    ``hinge`` 1 up to ``threshold`` then ``1/(a(s-b)+1)``. All give 1.0 at
    s = 0."""
    if fn not in STALENESS_FNS:
        raise KeyError(f"unknown staleness_fn {fn!r}; have {sorted(STALENESS_FNS)}")
    return STALENESS_FNS[fn](torch.as_tensor(staleness).to(torch.float32), exponent, threshold)


@dataclasses.dataclass(frozen=True)
class StalenessAggregator(Aggregator):
    """Buffered staleness-weighted merge (FedBuff): each landing update's
    delta against its dispatch snapshot folds into the current global
    model, ``g + sum_i v_i d_i / sum_i v_i`` per shared layer with ``v_i =
    select_i * |d_i| * s(staleness_i)``; a layer nobody shared keeps g.
    With ``constant`` weights, zero staleness and full participation it is
    FedAvg. Under the sync barrier (no snapshots) the deltas are against
    the broadcast model and the staleness is 0."""

    staleness_fn: str = "polynomial"
    exponent: float = 0.5
    threshold: float = 4.0
    edge_groups: int = 0
    axis_name: Any = None

    def __post_init__(self):
        if self.staleness_fn not in STALENESS_FNS:
            raise KeyError(f"unknown staleness_fn {self.staleness_fn!r}; "
                           f"have {sorted(STALENESS_FNS)}")

    def aggregate(self, ctx, env):
        stale = (ctx.staleness if ctx.staleness is not None
                 else torch.zeros(ctx.select.shape, dtype=torch.int32, device=ctx.select.device))
        discount = staleness_weight(self.staleness_fn, stale, self.exponent, self.threshold)
        w = ctx.select.to(torch.float32) * env.n_samples.to(torch.float32) * discount
        snaps = ctx.dispatch_params
        if snaps is None:  # the sync barrier: every lane trained from the global
            snaps = [tree_map(lambda g, a: g.expand_as(a), g_j, a_j)
                     for g_j, a_j in zip(ctx.global_params, ctx.agg_src)]
        # the deltas agg_src - snapshot are formed in the kernel's loads
        edge_ids, n_edges = self._edges(ctx, env)
        new_global = staleness_weighted_merge(ctx.agg_src, ctx.global_params, w, ctx.share,
                                              axis_name=self.axis_name, edge_ids=edge_ids,
                                              n_edges=n_edges, snapshots=snaps)
        return ctx._replace(new_global=new_global, merge_weight=discount)


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


class Evaluator:
    def evaluate(self, ctx: RoundContext, env: RoundEnv) -> RoundContext:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DistributedEvaluator(Evaluator):
    """Distributed eval (paper §4.3): each client scores its composed model
    on its own test shard; accuracy and loss feed the selector.

    ``eval_every=n`` reports fresh values on rounds with ``t % n == 0`` and
    carries the last-known ones (``ctx.prev_accuracy``/``prev_loss``) in
    between, as the JAX package does. The JAX package branches with
    ``lax.cond`` and skips the evaluation on carried rounds; here ``t`` is a
    device tensor (a CUDA graph replays each round with its own index), so
    the round evaluates and ``torch.where`` picks the fresh or the carried
    values on the device: the same values as the taken branch, but no
    evaluation saved."""

    eval_every: int = 1

    def __post_init__(self):
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {self.eval_every!r}")

    def evaluate(self, ctx, env):
        model = ctx.eval_model
        acc = env.acc_fn(model, env.x_te, env.y_te, env.m_te)
        loss = env.loss_fn(model, env.x_te, env.y_te, env.m_te)
        if self.eval_every > 1:
            fresh = (ctx.t % self.eval_every) == 0
            zeros = torch.zeros_like(acc)
            acc = torch.where(fresh, acc, zeros if ctx.prev_accuracy is None else ctx.prev_accuracy)
            loss = torch.where(fresh, loss, zeros if ctx.prev_loss is None else ctx.prev_loss)
        return ctx._replace(accuracy=acc, loss=loss)


# ---------------------------------------------------------------------------
# SelectorPhase — Algorithm 1 l.12
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SelectorPhase:
    """Wraps a SelectionStrategy with the full observations (including the
    codec phase's cost signals) and picks next round's clients."""

    strategy: SelectionStrategy

    def select(self, ctx: RoundContext, env: RoundEnv) -> RoundContext:
        obs = ClientObservations(
            accuracy=ctx.accuracy,
            loss=ctx.loss,
            n_samples=env.n_samples,
            delay=env.delay,
            wire_bytes=ctx.wire_bytes,
            update_norm=ctx.update_norm,
            participation_count=ctx.participation,
        )
        return ctx._replace(next_select=self.strategy.select(obs, ctx.t, ctx.rng_sel))


# ---------------------------------------------------------------------------
# LayerPolicy — how many layers each client shares next round
# ---------------------------------------------------------------------------


class LayerPolicy:
    def next_pms(self, ctx: RoundContext, env: RoundEnv, n_layers: int):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FullShare(LayerPolicy):
    """Everyone always shares the whole model."""

    def next_pms(self, ctx, env, n_layers):
        return torch.full((env.n_clients,), n_layers, dtype=torch.int32, device=env.device)


@dataclasses.dataclass(frozen=True)
class StaticPMS(LayerPolicy):
    """Fixed shared-prefix length (the paper's PMS k variants)."""

    layers: int = 2

    def next_pms(self, ctx, env, n_layers):
        return torch.full((env.n_clients,), self.layers, dtype=torch.int32, device=env.device)


@dataclasses.dataclass(frozen=True)
class DLDPolicy(LayerPolicy):
    """Dynamic layer definition (Eq. 9): per-client PMS from accuracy."""

    def next_pms(self, ctx, env, n_layers):
        return dynamic_layer_definition(ctx.accuracy, n_layers)


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

_PHASE_REGISTRY: dict[str, dict[str, Callable]] = {
    "personalizer": {
        "none": NoPersonalizer,
        "ft": FTPersonalizer,
        "compose": ComposePersonalizer,
    },
    "trainer": {"sgd": SGDTrainer},
    "aggregator": {
        "fedavg": FedAvgAggregator,
        "masked-partial": MaskedPartialAggregator,
        "staleness": StalenessAggregator,
    },
    "evaluator": {"distributed": DistributedEvaluator},
    "layer-policy": {"full": FullShare, "static": StaticPMS, "dld": DLDPolicy},
}


def get_phase(kind: str, name: str, **kwargs):
    """Build a phase component by (kind, name); unknown names raise
    ``KeyError`` listing what is available."""
    if kind not in _PHASE_REGISTRY:
        raise KeyError(f"unknown phase kind {kind!r}; have {sorted(_PHASE_REGISTRY)}")
    reg = _PHASE_REGISTRY[kind]
    key = name.lower()
    if key not in reg:
        raise KeyError(f"unknown {kind} {name!r}; have {sorted(reg)}")
    return reg[key](**kwargs)


def register_phase(kind: str, name: str, factory: Callable) -> None:
    """Register a custom phase factory under (kind, name)."""
    if kind not in _PHASE_REGISTRY:
        raise KeyError(f"unknown phase kind {kind!r}; have {sorted(_PHASE_REGISTRY)}")
    _PHASE_REGISTRY[kind][name.lower()] = factory
