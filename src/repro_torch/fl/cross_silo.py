"""Cross-silo federated training of an LM — the port of the JAX package's
``fl/cross_silo.py``: the paper's technique (ACSP-FL Eq. 1 with partial
model sharing) applied to the model zoo.

Each silo trains its own copy of the model on its own batch; a round is

  1. local step: every silo's train step (``bundle.make_train_step``, one
     silo after another where JAX vmaps over the silo axis);
  2. masked partial aggregation (Eq. 1 + PMS's cut): a weighted mean over
     the silos of ONLY the shared prefix — ``embed``, ``vision_proj``,
     every prologue block and the first ``shared_periods`` periods of the
     stack (``transformer.layer_plan``); for whisper ``embed`` and every
     ``encoder`` layer. ``final_norm``, ``head``, the rest of the stack
     and, for whisper, ``enc_pos``, ``enc_norm`` and the decoder stay per
     silo (the JAX function names neither ``enc_pos`` nor ``enc_norm``).

The silo layout. JAX stacks every leaf on a leading silo axis; here a
``SiloParams`` holds one ``(S, ...)`` tensor per name of ``param_tree``
and S models (``DecoderLM`` or ``WhisperModel``) whose parameters are
views of slice s, so silo s's train step writes its own slice in place,
the aggregation reads each shared leaf as its ``(S, cols)`` rows with no
copy, and the mean is written back into every slice. Each silo keeps its
own optimizer state (``init_silo_opt``; JAX's ``vmap(opt.init)``).

The wire formats of ``_agg_over_silo`` (``agg``, or the
``REPRO_FL_AGG_DTYPE`` lever; fp32 by default):

- ``fp32``: masked_aggregate's kernel over every shared leaf's rows, up to
  64 leaves a launch (float32 sums in ascending silo order, one rounding
  a product and a sum, the result in the leaf's dtype: bitwise JAX's
  jnp mean). JAX divides by ``max(sum w, 1e-9)``, the kernel by the sum
  where it is positive and gives zeros (its fallback) where it is 0: the
  two differ only where the weights sum to more than 0 and less than
  1e-9;
- ``bf16``: no kernel; bf16 products, a bf16 add after every silo and a
  bf16 divide, as XLA computes JAX's ``sum(0, dtype=bf16)`` on the CPU
  (bitwise on the tests' inputs);
- ``int8``/``int4``: each silo's contribution quantized round to nearest
  and dequantized (the quantize kernel pair), then the fp32 mean. Where
  JAX returns the float32 mean (``mean.astype`` of the dequantized
  dtype), the port rounds it to the leaf's dtype: a parameter keeps its
  dtype (ROADMAP.md queue 3);
- error feedback (``make_quantized_fl_round_step(error_feedback=True)``):
  ``TransmitPhase.silo_transmit`` with a per-silo residual carried across
  rounds, the parameters themselves on the wire (as in JAX), then the
  fp32 mean.

The int formats quantize one row a silo per JAX leaf: a stack entry's
``(S, sp, ...)`` slice is one row, so here layers ``n_pro + i p + j`` for
``i < sp`` are concatenated in period order (``shared_groups``), and the
512-element blocks and their scales run across the period boundary as
JAX's do. The error-feedback keys are ``fold_in(rng, counter)`` with the
counter in JAX's leaf order: ``embed``, ``vision_proj``, the prologue (or
the encoder) and the stack entries, each in ``jax.tree.leaves`` order.
The int and EF wires go in calls of at most 64 leaves and
``WIRE_CHUNK_ELEMS`` elements (one launch of each kernel a call), which
bounds the float32 copies a call makes; at the tests' sizes a round is
one call.
"""

from __future__ import annotations

import math
import os as _os

import torch

from repro_torch import random as prng
from repro_torch.checkpoint.checkpoint import _listify
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.masked_aggregate import masked_aggregate_leaves
from repro_torch.kernels.masked_aggregate import ops as _agg_ops
from repro_torch.kernels.quantize import dequantize_leaves, quantize_leaves
from repro_torch.kernels.quantize import ops as _quant_ops
from repro_torch.models.api import make_batch_specs
from repro_torch.models.transformer import DecoderLM, layer_plan, param_tree
from repro_torch.models.whisper import WhisperModel

__all__ = ["SiloParams", "silo_params_from_model", "init_silo_opt", "shared_groups",
           "wire_chunks", "partial_aggregate_silo_params", "partial_aggregate_silo_params_ef",
           "init_ef_residual", "make_fl_round_step", "make_quantized_fl_round_step",
           "launch_groups", "silo_context", "mesh_silo_mean", "make_mesh_fl_round_step",
           "build_fl_dryrun"]

# Leaves a wire call or a silo-mean launch takes (the kernels' parameter tables).
MAX_LEAVES = min(_agg_ops.MAX_LEAVES, _quant_ops.MAX_LEAVES)
# Silo-row elements an int or EF wire call takes (a larger leaf goes alone):
# a call's copies, ~20 B an element, must fit beside four silos' AdamW
# moments on an 80 GB card (granite-3-8b at 4 layers: 68 GiB at peak).
WIRE_CHUNK_ELEMS = 2 ** 30


def _agg_mode():
    """The JAX package's lever: REPRO_FL_AGG_DTYPE=bf16 halves the
    cross-silo wire bytes, int8/int4 quantize them; fp32 is the
    paper-faithful default."""
    return _os.environ.get("REPRO_FL_AGG_DTYPE", "fp32")


# ---------------------------------------------------------------------------
# the silo layout
# ---------------------------------------------------------------------------


def _nest(flat: dict) -> dict:
    """Dotted names -> the nested dict/list tree a model is built from
    (a component of digits is a list index, as a checkpoint's key paths)."""
    root: dict = {}
    for name, value in flat.items():
        node = root
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return _listify(root)


class SiloParams:
    """S silos' copies of one model: ``params`` maps each ``param_tree``
    name to an (S, ...) tensor, and ``models[s]`` is a model whose
    parameters are views of slice s of those tensors (a train step of
    ``models[s]`` updates silo s in place)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        sizes = {t.shape[0] for t in params.values()}
        if len(sizes) != 1:
            raise ValueError(f"every leaf needs the same leading silo axis, got {sorted(sizes)}")
        self.cfg = cfg
        self.params = dict(params)
        self.n_silos = sizes.pop()
        cls = WhisperModel if cfg.encoder_decoder else DecoderLM
        self.models = [cls(cfg, _nest({k: v[s] for k, v in self.params.items()}))
                       for s in range(self.n_silos)]
        if set(param_tree(self.models[0])) != set(self.params):
            raise ValueError(f"{cfg.name}: parameter names do not match the model's")

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device


def silo_params_from_model(model, n_silos: int) -> SiloParams:
    """``n_silos`` copies of ``model``'s parameters (the JAX package's
    ``broadcast_to(leaf, (S,) + leaf.shape).copy()``), on its device."""
    stacked = {name: p.detach().expand(n_silos, *p.shape).clone(
        memory_format=torch.contiguous_format) for name, p in param_tree(model).items()}
    return SiloParams(model.cfg, stacked)


def init_silo_opt(optimizer, silo: SiloParams) -> list:
    """One optimizer state a silo, each with its own step counter (JAX's
    ``vmap(opt.init)``)."""
    return [optimizer.init(param_tree(m)) for m in silo.models]


def _path(name: str) -> tuple:
    """A name's components, in the order ``jax.tree.leaves`` walks a
    block's dict (keys sorted at every level)."""
    return tuple(name.split("."))


def shared_groups(cfg: ModelConfig, names, shared_periods: int) -> list[list[str]]:
    """The shared set, one list of names per JAX leaf, in the JAX package's
    leaf order (its EF counter's): ``embed``, ``vision_proj``, each prologue
    block's leaves (whisper: each encoder layer's), then, for each stack
    entry j and each of its leaves, the names of that leaf in layers
    ``n_pro + i p + j`` for ``i < min(shared_periods, n_periods)``, which
    JAX holds as one (S, sp, ...) leaf."""
    names = list(names)
    groups = [[k] for k in ("embed", "vision_proj") if k in names]

    def block(prefix: str) -> list[str]:
        return sorted((n[len(prefix):] for n in names if n.startswith(prefix)), key=_path)

    if cfg.encoder_decoder:
        for i in range(cfg.n_encoder_layers):
            groups += [[f"encoder.{i}.{leaf}"] for leaf in block(f"encoder.{i}.")]
        return groups
    n_pro, p, n_periods = layer_plan(cfg)
    for k in range(n_pro):
        groups += [[f"blocks.{k}.{leaf}"] for leaf in block(f"blocks.{k}.")]
    sp = min(shared_periods, n_periods) if shared_periods > 0 else 0
    for j in range(p if sp else 0):
        groups += [[f"blocks.{n_pro + i * p + j}.{leaf}" for i in range(sp)]
                   for leaf in block(f"blocks.{n_pro + j}.")]
    return groups


def wire_chunks(groups: list, sizes: list[int], n_silos: int) -> list[list[int]]:
    """Consecutive runs of group indices for the int and EF wires: at most
    ``MAX_LEAVES`` groups and ``WIRE_CHUNK_ELEMS`` silo-row elements a run
    (a group larger than that alone); ``sizes[i]`` is group i's elements a
    silo."""
    chunks, elems = [], 0
    for i, n in enumerate(sizes):
        if chunks and len(chunks[-1]) < MAX_LEAVES and elems + n * n_silos <= WIRE_CHUNK_ELEMS:
            chunks[-1].append(i)
            elems += n * n_silos
        else:
            chunks.append([i])
            elems = n * n_silos
    return chunks


def _rows(tensors: dict, group: list[str], n_silos: int) -> torch.Tensor:
    """A group's (S, n) rows: a view for one name, else the names'
    rows concatenated in order (one copy)."""
    rows = [tensors[n].reshape(n_silos, -1) for n in group]
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)


def _split(row: torch.Tensor, group: list[str], like: dict) -> dict:
    """Inverse of ``_rows`` on the last axis: each name's slice of ``row``
    (leading axes kept) shaped as ``like[name]`` past the silo axis."""
    out, at = {}, 0
    for n in group:
        shape = like[n].shape[1:]
        size = math.prod(shape)
        out[n] = row[..., at:at + size].reshape(*row.shape[:-1], *shape)
        at += size
    return out


# ---------------------------------------------------------------------------
# the wire formats and the silo mean (Eq. 1)
# ---------------------------------------------------------------------------


def launch_groups(tensors: list) -> list[list[int]]:
    """The indices of ``tensors`` a masked_aggregate launch takes together:
    one dtype a launch (the kernel's table), in first-seen dtype order, up
    to ``MAX_LEAVES`` each."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    return [g[a:a + MAX_LEAVES] for g in by_dtype.values() for a in range(0, len(g), MAX_LEAVES)]


def _fp32_means(rows: list, weights: torch.Tensor) -> list:
    """Eq. 1 of every (S, n) row: masked_aggregate's float32 sums in
    ascending silo order, zeros where the weights sum to 0, in the rows'
    dtype; up to 64 rows of one dtype a launch."""
    w = weights.to(torch.float32).reshape(1, -1)
    out = [None] * len(rows)
    for group in launch_groups(rows):
        for i, mean in zip(group, masked_aggregate_leaves([rows[i] for i in group], w)):
            out[i] = mean
    return out


def _bf16_mean(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The bf16 wire of one (S, ...) leaf, plain PyTorch: ``sum_s
    bf16(x_s) * bf16(w_s)`` with a bf16 rounding after every add (XLA's
    reduce on the CPU), over ``bf16(max(sum w, 1e-9))``; the sum of the
    weights in float32, in order."""
    w = weights.to(torch.float32)
    wb = w.to(torch.bfloat16)
    acc = torch.zeros(x.shape[1:], dtype=torch.bfloat16, device=x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(x.shape[0]):
        acc = acc + x[s].to(torch.bfloat16) * wb[s]
        total = total + w[s]
    return acc / torch.clamp_min(total, 1e-9).to(torch.bfloat16)


def _int_means(rows: list, weights: torch.Tensor, bits: int) -> list:
    """The int8/int4 wire: each (S, n) row's silos quantized round to
    nearest and dequantized (one launch of each kernel), then the fp32
    mean, in float32."""
    flats = [r.to(torch.float32) for r in rows]
    decoded = dequantize_leaves(quantize_leaves(flats, None, bits=bits))
    del flats
    return _fp32_means(decoded, weights)


def _agg_over_silo(x: torch.Tensor, weights: torch.Tensor, agg: str | None = None) -> torch.Tensor:
    """Weighted mean of one (S, ...) leaf over its silo axis, broadcast back
    (Eq. 1); ``agg`` picks the wire format (fp32 | bf16 | int8 | int4), None
    defers to ``REPRO_FL_AGG_DTYPE``. The result keeps ``x``'s dtype (the
    int formats: JAX's float32 mean rounded to it)."""
    mode = agg or _agg_mode()
    s = x.shape[0]
    if mode in ("int8", "int4"):
        mean = _int_means([x.reshape(s, -1)], weights, int(mode[3:]))[0].to(x.dtype)
    elif mode == "bf16":
        mean = _bf16_mean(x, weights).to(x.dtype)
    else:
        mean = _fp32_means([x.reshape(s, -1)], weights)[0]
    return mean.reshape(x.shape[1:]).expand(x.shape)


def _write_means(params: dict, group: list[str], mean: torch.Tensor) -> None:
    """Write a group's mean row (n,) into every silo's slice of its names,
    rounded to each name's dtype."""
    for n, m in _split(mean, group, params).items():
        params[n].copy_(m.to(params[n].dtype).expand_as(params[n]))


@torch.no_grad()
def partial_aggregate_silo_params(silo: SiloParams, weights: torch.Tensor,
                                  shared_periods: int, agg: str | None = None) -> SiloParams:
    """ACSP-FL partial aggregation of the silos in place: the weighted mean
    of every shared leaf (``shared_groups``) written back into every silo;
    the personal leaves untouched. ``weights`` (S,) = select * |d_i|;
    ``agg`` selects the wire format (module docstring). Returns ``silo``."""
    mode = agg or _agg_mode()
    groups = shared_groups(silo.cfg, silo.params, shared_periods)
    s, params = silo.n_silos, silo.params
    if mode in ("int8", "int4"):
        sizes = [sum(params[n][0].numel() for n in g) for g in groups]
        for chunk in wire_chunks(groups, sizes, s):
            rows = [_rows(params, groups[i], s) for i in chunk]
            for i, mean in zip(chunk, _int_means(rows, weights, int(mode[3:]))):
                _write_means(params, groups[i], mean)
            del rows
    elif mode == "bf16":
        for g in groups:
            for n in g:
                params[n].copy_(_bf16_mean(params[n], weights).expand_as(params[n]))
    else:
        names = [n for g in groups for n in g]
        for n, mean in zip(names, _fp32_means([params[n].reshape(s, -1) for n in names], weights)):
            _write_means(params, [n], mean)
    return silo


def _quantize_phase(bits: int, stochastic: bool = False):
    """The cross-silo wire format as the same phase object the FL engine
    composes (``fl.phases.TransmitPhase`` over ``comm.QuantizeCodec``);
    deterministic rounding by default."""
    from repro_torch.comm import QuantizeCodec
    from repro_torch.fl.phases import TransmitPhase

    return TransmitPhase(QuantizeCodec(bits=bits, stochastic=stochastic))


@torch.no_grad()
def partial_aggregate_silo_params_ef(silo: SiloParams, residual: dict, weights: torch.Tensor,
                                     shared_periods: int, bits: int = 8,
                                     rng: torch.Tensor | None = None,
                                     stochastic: bool = False):
    """The error-feedback form of ``partial_aggregate_silo_params``: each
    silo's shared leaves (the parameters themselves, as in JAX) go through
    the quantize codec with that silo's residual (``TransmitPhase
    .silo_transmit``), JAX leaf i with key ``fold_in(rng, i)``, then the
    fp32 mean is written into every silo. ``residual`` maps every name to
    an (S, ...) tensor (``init_ef_residual``); the personal names keep
    theirs. ``rng`` (default ``PRNGKey(0)``) matters only with
    ``stochastic=True``. Returns ``(silo, new_residual)``."""
    phase = _quantize_phase(bits, stochastic=stochastic)
    rng = prng.PRNGKey(0, device=silo.device) if rng is None else rng
    groups = shared_groups(silo.cfg, silo.params, shared_periods)
    s, params = silo.n_silos, silo.params
    new_res = dict(residual)
    sizes = [sum(params[n][0].numel() for n in g) for g in groups]
    for chunk in wire_chunks(groups, sizes, s):
        xs = [_rows(params, groups[i], s) for i in chunk]
        es = [_rows(residual, groups[i], s) for i in chunk]
        decoded, new_es = phase.silo_transmit(xs, es, [prng.fold_in(rng, i) for i in chunk])
        del xs, es
        means = _fp32_means(decoded, weights)
        del decoded
        for i, mean, new_e in zip(chunk, means, new_es):
            _write_means(params, groups[i], mean)
            new_res.update(_split(new_e, groups[i], params))
    return silo, new_res


def init_ef_residual(silo: SiloParams) -> dict:
    """Zero error-feedback residuals, one (S, ...) tensor a name in the
    parameters' dtypes. They are expanded views of one zero and take no
    memory: a round replaces a shared name's residual with a new tensor and
    never writes the personal names'."""
    return {n: torch.zeros((), dtype=p.dtype, device=p.device).expand(p.shape)
            for n, p in silo.params.items()}


# ---------------------------------------------------------------------------
# the round steps
# ---------------------------------------------------------------------------


def _local_steps(base_step, silo: SiloParams, silo_opt: list, batch: dict):
    """Every silo's train step on its slice of ``batch`` (leaves (S,
    local_batch, ...)), each silo's new optimizer state put in
    ``silo_opt`` in place of its old one (so the old moments are freed
    before the next silo steps: at full width four silos' float32 AdamW
    moments leave no room for a second copy). Returns (``silo_opt``, the
    S losses stacked)."""
    losses = []
    for s, model in enumerate(silo.models):
        _, silo_opt[s], loss = base_step(model, silo_opt[s], {k: v[s] for k, v in batch.items()})
        losses.append(loss)
    return silo_opt, torch.stack(losses)


def make_fl_round_step(cfg: ModelConfig, bundle, optimizer, shared_periods: int, window: int = 0,
                       agg: str | None = None):
    base_step = bundle.make_train_step(optimizer, window=window)

    def fl_round(silo: SiloParams, silo_opt: list, batch: dict, weights: torch.Tensor):
        """silo: ``SiloParams`` (updated in place); silo_opt: the list of
        one optimizer state a silo (its entries replaced in place);
        batch leaves (S, local_batch, ...); weights (S,) = select * |d_i|.
        Returns (silo, silo_opt, the mean of the S losses as a device
        tensor)."""
        silo_opt, losses = _local_steps(base_step, silo, silo_opt, batch)
        partial_aggregate_silo_params(silo, weights, shared_periods, agg)
        return silo, silo_opt, torch.mean(losses)

    return fl_round


def make_quantized_fl_round_step(cfg: ModelConfig, bundle, optimizer, shared_periods: int,
                                 window: int = 0, bits: int = 8, error_feedback: bool = False):
    """Quantized-wire form of ``make_fl_round_step``: the shared leaves
    cross the silos as int8/int4 codes + scales. With
    ``error_feedback=True`` the step carries per-silo residuals across
    rounds: ``fl_round(silo, silo_opt, residual, batch, weights) -> (silo,
    silo_opt, new_residual, loss)``, ``residual`` from
    ``init_ef_residual``."""
    if bits not in (4, 8):
        raise ValueError(f"cross-silo quantized all-reduce supports bits in (4, 8), got {bits}")
    if not error_feedback:
        return make_fl_round_step(cfg, bundle, optimizer, shared_periods, window=window,
                                  agg=f"int{bits}")

    base_step = bundle.make_train_step(optimizer, window=window)

    def fl_round(silo: SiloParams, silo_opt: list, residual: dict, batch: dict,
                 weights: torch.Tensor):
        silo_opt, losses = _local_steps(base_step, silo, silo_opt, batch)
        silo, new_res = partial_aggregate_silo_params_ef(silo, residual, weights, shared_periods,
                                                         bits=bits)
        return silo, silo_opt, new_res, torch.mean(losses)

    return fl_round


# ---------------------------------------------------------------------------
# the round over a (data, model) mesh of ranks
# ---------------------------------------------------------------------------


def silo_context(mesh, seq_parallel: bool = False):
    """The mesh context a silo is built and trained in on ``mesh``: no data
    axes (the data ranks are the silos: each trains its own model on its
    own rows, none splits a batch or sums a gradient over the others) and
    no expert parallelism (JAX's ``build_fl_dryrun`` shards each silo by the
    model-only rules, under ``moe_ep=False``), so on a ``model`` axis over 1
    the silo's model holds its tensor-parallel blocks (``launch/tp.py``).
    ``seq_parallel``: a silo's train step takes the sequence-parallel
    layout by the rule of any train step (``context.seq_split``)."""
    from repro_torch.launch import context as ctx

    return ctx.mesh_context(mesh, dp_axes=(), moe_ep=False, seq_parallel=seq_parallel)


@torch.no_grad()
def mesh_silo_mean(model, weights: torch.Tensor, shared_periods: int, mesh,
                   dp_axes=("data",)) -> None:
    """Eq. 1 over the silos of ``mesh`` in place: this rank holds silo i =
    its index over ``dp_axes`` (of S), and every shared leaf of its
    ``model`` (``shared_groups``; the rank's tensor-parallel block of it)
    becomes the weighted mean of the S silos' copies, ``weights`` (S,) =
    select * |d_i| alike on every rank. masked_aggregate's partial mode
    writes the rank's one lane ``w_i x_i`` and ``w_i`` into slot i of an
    (S, width) float32 buffer (-0.0 elsewhere), one all-reduce over
    ``dp_axes`` fills every slot, and the combine mode sums the slots from 0
    in ascending silo order and divides, in the leaf's dtype: the float32
    sums of the single-process round's flat kernel, term for term, so the
    result is bitwise ``partial_aggregate_silo_params``' fp32 wire. Up to
    ``MAX_LEAVES`` leaves of one dtype a launch and an all-reduce
    (``launch_groups``)."""
    i, n_silos = mesh.index(dp_axes), mesh.axis_size(dp_axes)
    params = param_tree(model)
    names = [n for g in shared_groups(model.cfg, params, shared_periods) for n in g]
    w = weights.to(device=params[names[0]].device, dtype=torch.float32).reshape(-1)
    if w.numel() != n_silos:
        raise ValueError(f"mesh_silo_mean: {w.numel()} weights for {n_silos} silos")
    w_i = w[i:i + 1].reshape(1, 1)
    leaves = [params[n] for n in names]
    for group in launch_groups(leaves):
        chunk = [leaves[j] for j in group]
        buf = _agg_ops.masked_aggregate_partial([p.reshape(1, -1) for p in chunk], w_i, slot=i,
                                                n_slots=n_silos)
        mesh.all_reduce(buf, dp_axes)
        means = _agg_ops.masked_aggregate_combine(buf, [(p.numel(),) for p in chunk],
                                                  dtype=chunk[0].dtype)
        for p, mean in zip(chunk, means):
            p.copy_(mean.view(p.shape))


def make_mesh_fl_round_step(cfg: ModelConfig, bundle, optimizer, shared_periods: int, mesh,
                            dp_axes=("data",), window: int = 0, seq_parallel: bool = False):
    """The round of ``make_fl_round_step`` over ``mesh``, the silo axis
    over ``dp_axes`` (JAX's ``build_fl_dryrun`` layout): ``fl_round(model,
    opt_state, batch, weights)`` on every rank, ``model`` this rank's silo
    (built under ``silo_context(mesh)``), ``opt_state`` its own optimizer
    state, ``batch`` its ``local_batch`` rows, ``weights`` (S,) every
    silo's. The local step runs under ``silo_context``, then
    ``mesh_silo_mean``; returns (model, opt_state, the mean of the S silos'
    losses, gathered in silo order: the single-process round's mean bit for
    bit). The fp32 wire only: the int, bf16 and EF wires stay
    single-process. ``seq_parallel``: ``silo_context``'s."""
    base_step = bundle.make_train_step(optimizer, window=window)

    def fl_round(model, opt_state, batch: dict, weights: torch.Tensor):
        with silo_context(mesh, seq_parallel):
            model, opt_state, loss = base_step(model, opt_state, batch)
        mesh_silo_mean(model, weights, shared_periods, mesh, dp_axes)
        losses = mesh.all_gather(loss.detach().to(torch.float32).reshape(1), dp_axes)
        return model, opt_state, torch.mean(losses)

    return fl_round


def build_fl_dryrun(cfg, bundle, shape, mesh, dp, shared_periods: int, meta: dict):
    """The mesh round of ``make_mesh_fl_round_step`` as ``launch.dryrun``
    traces it (JAX's ``build_fl_dryrun``): the silo axis over the data axes
    ``dp`` of ``mesh``, one silo a data index, each with its own AdamW
    state and ``global_batch // n_silos`` rows, its model in the
    model-only layout (``silo_context``; sequence-parallel where the dry
    run's mesh context asks for it). Call it under the dry run's
    ``FakeTensorMode``. Returns (fn, held, meta): ``fn()`` runs the round
    on this rank and returns the loss; ``held`` the arguments' tensors."""
    from repro_torch.optim import adamw

    if mesh is None:
        raise ValueError("build_fl_dryrun: the round spreads its silos over a mesh's data axes")
    n_silos = math.prod(mesh.shape[a] for a in dp)
    local_batch = max(shape.global_batch // n_silos, 1)
    opt = adamw(3e-4)
    with silo_context(mesh):
        model = bundle.init(torch.Generator())
    opt_state = opt.init(param_tree(model))
    batch = {k: torch.zeros(s, dtype=d, device=model.device)
             for k, (s, d) in make_batch_specs(cfg, "train", local_batch, shape.seq_len).items()}
    weights = torch.ones((n_silos,), dtype=torch.float32, device=model.device)
    from repro_torch.launch import context as ctx

    step = make_mesh_fl_round_step(cfg, bundle, opt, shared_periods, mesh, dp,
                                   window=meta.get("window", 0),
                                   seq_parallel=ctx.seq_parallel_enabled())
    meta = {**meta, "mode": "fl_round", "n_silos": n_silos, "shared_periods": shared_periods,
            "local_batch": local_batch}
    held = {"params": list(model.parameters()), "opt": opt_state, "silo_batch": batch,
            "weights": weights}
    return (lambda: step(model, opt_state, batch, weights)[2]), held, meta
