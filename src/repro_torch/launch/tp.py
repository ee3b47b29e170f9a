"""Tensor parallelism over the ``model`` axis of a ``launch.mesh.RankMesh``
— port-only. The JAX package gets it from ``jax.jit`` under
``param_spec``'s ``model`` entries: a layout, whose collectives XLA picks.

A decoder built under ``launch.context.mesh_context`` on a mesh whose
``model`` axis has n > 1 ranks (``context.tensor_parallel()``) holds each
leaf as ``hold`` cuts it: this rank's ``sharding.model_block``, or the
whole leaf where that rule keeps it whole (a model built for training,
``zero=True``, holds that block's ZeRO block over the data axes,
``launch/zero.py``). Its layers read from a leaf's shape whether they
hold a block (``split``) and then compute Megatron's pairs: a
column-split product (``enter(x) @ w``, local: the rank's heads, d_ff
columns or d_inner channels), then a row-split one whose float32 partial
(``partial``) one all-reduce over ``model`` sums before a single cast
(``row``, ``reduce``). A layer whose leaves are whole runs as without a
mesh, so a (1, 1) mesh is bitwise the run without one. The embedding,
``vision_proj`` and the head split their output columns and all-gather
them (``gather``): exact.

Under autograd (training) the ``model`` ranks of one data shard hold the
same rows and compute the same objective, so no gradient is summed over
``model``; three collectives carry the backward:

  row, reduce   forward: all-reduce of the float32 partials
                (``mesh.psum``); backward: the identity
  enter         forward: the identity (``mesh.replicated``); backward: the
                all-reduce of the rank's partial input gradient, for a
                tensor every ``model`` rank holds alike that enters a
                rank's block (a norm's output into ``wq``/``wk``/``wv``,
                ``wg``/``wu`` or ``in_proj``, the residual into the head,
                Mamba's dt, B and C out of the ``x_proj`` sum, MLA's
                latent ``c_kv``/``k_rope``, a shared kv head's k and v)
  gather        forward: all-gather (``mesh.gather_slices``); backward:
                this rank's slice of the gradient, which every rank holds
                alike (a reduce-scatter would multiply it by n)
  sp_gather,    the sequence-parallel pair of ``enter`` and ``row``, at
  sp_row        the stream's way in and out of a block (below)

A leaf whole over ``model`` then gets the same gradient on every ``model``
rank, bit for bit, since every all-reduce hands all ranks the same bits.
Under ``torch.no_grad`` (serving) ``enter`` is nothing and the all-reduce
runs in place: a served step launches one collective a row product and
one a gather, none for ``enter``.

Sequence parallelism (JAX's ``seq_parallel``; ``context.seq_split``): in a
train step the residual stream between blocks is split over ``model``
along the sequence, (B_loc, S/n, D) a rank, so the norms and residual adds
run on the rank's tokens (``models.transformer.apply_block``). A layer
then takes the stream in and out through the stream-level pair, along S:

  sp_gather  forward: all-gather of the ranks' tokens; backward: with
             ``shares``, a reduce-scatter (``mesh.gather_blocks``), else
             this rank's tokens of the gradient (``mesh.gather_slices``)
  sp_row     forward: the float32 partials reduce-scattered, then cast
             once to the stream's dtype (``mesh.scatter_sum``); backward:
             all-gather of the gradient in the stream's dtype
             (``sp_scatter`` alone: the MoE's and a SwiGLU's partials)
  sp_split   forward: this rank's tokens of an output every rank computed
             alike (a layer of whole leaves); backward: all-gather

``enter`` and ``row`` stay as they are for tensors inside a block (Mamba's
``x_proj`` sum, a shared kv head's k and v, MLA's latent).

After the gather the stream feeds two kinds of work, and the backward
tells them apart: a rank's share of a sum (its q heads, d_ff columns,
experts, d_inner block), whose input gradients must be summed over
``model``, and work every rank does alike (the MoE's float32 router on
every token, a shared kv head's ``x @ wk``, MLA's ``x @ wdkv``, whole
shared experts, a layer of whole leaves), whose gradient is the same on
every rank and must be counted once. A gather whose backward reduce-scatters
would count the second kind n times. So the gather fuses with the sums
(``shares``: one reduce-scatter in the backward, no ``enter``) only where
every path of the gradient is a share: a GQA layer whose kv heads are
split with its q heads, a tensor-parallel SwiGLU, a tensor-parallel Mamba
block. Everywhere else it keeps ``gather_slices`` semantics, and the layer
keeps ``enter`` / ``replicated``, which sum the shares and hand every rank
the same whole gradient, of which the gather's backward keeps the rank's
tokens: an all-reduce in the backward where the fused layers have a
reduce-scatter. The embedding's ``gather`` is safe for the same reason:
the stream's ``sp_split`` all-gathers its gradient first, so every rank
holds the same whole gradient, as its backward assumes. The norms, which
each rank now runs on its own tokens, get their gradients summed over
``model`` after the backward (``launch/zero.reduce_grads``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.launch import context as ctx
from repro_torch.cost import is_fake, record_row_recompute
from repro_torch.launch.mesh import (gather_blocks, gather_slices, psum, replicated, scatter_sum,
                                     split as split_block)
from repro_torch.launch.sharding import model_block

__all__ = ["cut", "d_inner", "enter", "gather", "hold", "kv_heads", "kv_rows", "partial", "reduce",
           "row", "sp_gather", "sp_row", "sp_scatter", "sp_split", "split"]


def cut(t: torch.Tensor, block) -> torch.Tensor:
    """``t``'s block ``(dim, slices)`` (``model_block``'s), a copy: the
    slices of ``dim`` concatenated in order."""
    dim, slices = block
    parts = [t.narrow(dim, s.start, s.stop - s.start) for s in slices]
    return (parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)).clone()


def hold(tree, path: str, cfg, mesh):
    """``tree`` (a leaf, or nested dicts of leaves) at ``path`` of a decoder
    of ``cfg`` as this rank of ``mesh`` holds it: every leaf cut to its
    ``model_block`` (a copy, so the whole leaf can be freed at once) or
    whole, as a parameter; an expert leaf as given (``layers.init_moe`` and
    ``weights.lm_params_from_numpy`` keep the rank's experts)."""
    if isinstance(tree, dict):
        return {k: hold(v, f"{path}/{k}", cfg, mesh) for k, v in tree.items()}
    block = model_block(path, tuple(tree.shape), mesh, cfg)
    t = tree if block is None else cut(tree, block)
    return t if isinstance(t, nn.Parameter) else nn.Parameter(t, requires_grad=False)


def split(w: torch.Tensor, dim: int, whole: int) -> bool:
    """Whether ``w`` holds a block of its ``dim``, whose whole size is
    ``whole``."""
    return w.shape[dim] != whole


def _mesh():
    mesh = ctx.get_mesh()
    if mesh is None:
        raise RuntimeError("a tensor-parallel block of a model runs outside a mesh_context")
    return mesh


class _Partial(torch.autograd.Function):
    """``x2 @ w`` with a float32 output for a bf16 ``x2`` and ``w``; its
    backward takes the gradient in their dtype (exact: it comes from the
    cast of the summed product back to it) and computes both products
    there, as the backward of the unsplit bf16 product does."""

    @staticmethod
    def forward(fctx, x2, w):
        fctx.save_for_backward(x2, w)
        if torch._C._current_graph_task_id() != -1:  # a checkpoint's recompute, in the backward
            record_row_recompute(2.0 * x2.shape[0] * x2.shape[1] * w.shape[1])
        if x2.is_cuda or is_fake(x2):  # a dry run traces the card's path
            return torch.mm(x2, w, out_dtype=torch.float32)
        return x2.float() @ w.float()

    @staticmethod
    def backward(fctx, g):
        x2, w = fctx.saved_tensors
        g = g.to(x2.dtype)
        return (g @ w.t() if fctx.needs_input_grad[0] else None,
                x2.t() @ g if fctx.needs_input_grad[1] else None)


def partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """This rank's float32 share of a row-split product: ``x`` holds its
    block of the contraction dim and ``w`` the same rows; bf16 products are
    summed in float32 (cuBLAS with a float32 output on the card), not
    rounded to bf16 before the sum over ranks."""
    _mesh()
    x2 = x.reshape(-1, x.shape[-1])
    out = x2 @ w if x.dtype == torch.float32 else _Partial.apply(x2, w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a float32 partial) summed over the ``model`` ranks (one
    all-reduce, in place under ``torch.no_grad``); its backward is the
    identity."""
    return psum(_mesh(), t, "model")


def enter(x: torch.Tensor) -> torch.Tensor:
    """``x``, which every ``model`` rank holds alike, as it enters this
    rank's block: the identity, whose backward sums the ranks' partial
    gradients of ``x`` (one all-reduce; nothing under ``torch.no_grad``)."""
    return replicated(_mesh(), x, "model")


def row(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of a row-split pair: the float32 partials summed over the
    ``model`` ranks, then cast once to ``x``'s dtype."""
    return reduce(partial(x, w)).to(x.dtype)


def gather(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every ``model`` rank's block of ``t``'s ``dim``, concatenated in rank
    order (one all-gather): a column-split product made whole; its
    backward keeps this rank's block of the gradient."""
    return gather_slices(_mesh(), t, "model", dim % t.ndim)


def sp_gather(x: torch.Tensor, shares: bool) -> torch.Tensor:
    """A sequence-parallel stream as it enters a block: the rank's tokens
    ``x`` (B, S/n, D) -> every rank's (B, S, D), one all-gather along S.
    Its backward, with ``shares`` (every use of the result is the rank's
    share of a sum, so the layer skips ``enter``), reduce-scatters the
    gradient: the ranks' shares summed, this rank's tokens kept; without,
    keeps this rank's tokens of a gradient every rank holds alike (the
    layer sums its shares through ``enter`` / ``replicated``)."""
    return (gather_blocks if shares else gather_slices)(_mesh(), x, "model", 1)


def sp_scatter(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 partial (B, S, ...) summed over the ``model`` ranks, this
    rank's tokens (B, S/n, ...) kept (one reduce-scatter along S) and cast
    once to ``dtype``, the stream's; its backward all-gathers the gradient
    in ``dtype`` (``mesh.scatter_sum``)."""
    return scatter_sum(_mesh(), t, "model", 1, dtype)


def sp_row(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of a row-split pair into a sequence-parallel stream: the
    float32 partials reduce-scattered along S, then cast once to ``x``'s
    dtype, as ``row`` casts once (``sp_scatter``)."""
    return sp_scatter(partial(x, w), x.dtype)


def sp_split(t: torch.Tensor) -> torch.Tensor:
    """This rank's tokens (B, S/n, ...) of ``t`` (B, S, ...), which every
    ``model`` rank holds alike (the embedded stream, a layer of whole
    leaves' output); its backward all-gathers the gradient, so every rank
    hands what made ``t`` the same whole gradient."""
    return split_block(_mesh(), t, "model", 1)


def _held(cfg, path: str, shape: tuple[int, ...], unit: int) -> int:
    """The units of ``unit`` elements a leaf of ``shape`` at ``path``
    keeps along its split dim under the open mesh context, which is
    tensor-parallel."""
    block = model_block(path, shape, ctx.get_mesh(), cfg)
    if block is None:
        return shape[1] // unit
    return sum(s.stop - s.start for s in block[1]) // unit


def kv_rows(cfg) -> slice:
    """The kv heads that this rank's q heads read, of a GQA layer whose
    ``wq`` holds a block of the heads and whose ``wk`` and ``wv`` are held
    whole (a kv head shared by ranks in a model built for training,
    ``sharding.model_block``'s ``train``), as a slice of the heads."""
    mesh = _mesh()
    h, hkv, n = cfg.n_heads, cfg.n_kv_heads, mesh.shape["model"]
    g, q0 = h // hkv, mesh.coords["model"] * (h // n)
    return slice(q0 // g, (q0 + h // n - 1) // g + 1)


def kv_heads(cfg) -> int:
    """The kv heads of a GQA layer (and so of its cache) that a model built
    under the open mesh context holds."""
    if not ctx.tensor_parallel() or not cfg.n_kv_heads:
        return cfg.n_kv_heads
    return _held(cfg, "blocks/0/mixer/wk", (cfg.d_model, cfg.n_kv_heads * cfg.head_dim_),
                 cfg.head_dim_)


def d_inner(cfg) -> int:
    """The d_inner channels of a Mamba layer (and so of its cache) that a
    model built under the open mesh context holds."""
    if not ctx.tensor_parallel() or not cfg.ssm:
        return cfg.d_inner
    return _held(cfg, "blocks/0/mixer/conv_w", (cfg.d_conv, cfg.d_inner), 1)
