"""Tensor parallelism over the ``model`` axis of a ``launch.mesh.RankMesh``,
for serving — port-only. The JAX package gets it from ``jax.jit`` under
``param_spec``'s ``model`` entries: a layout, whose collectives XLA picks.

A decoder served under ``launch.context.mesh_context`` on a mesh whose
``model`` axis has n > 1 ranks (``context.tensor_parallel()``) holds each
leaf as ``hold`` cuts it: this rank's ``sharding.model_block``, or the
whole leaf where that rule keeps it whole. Its layers read from a leaf's
shape whether they hold a block (``split``) and then compute Megatron's
pairs: a column-split product (``x @ w``, local: the rank's heads, d_ff
columns or d_inner channels), then a row-split one whose float32 partial
(``partial``) one all-reduce over ``model`` sums before a single cast
(``row``, ``reduce``). A layer whose leaves are whole runs as without a
mesh, so a (1, 1) mesh is bitwise the run without one. The embedding,
``vision_proj`` and the head split their output columns and all-gather
them (``gather``): exact.

Every collective here raises ``NotImplementedError`` under autograd: they
have no backward yet (ROADMAP.md queue 1 item 5). A model built for
training (``zero=True``) keeps its leaves whole over ``model``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.launch import context as ctx
from repro_torch.launch.sharding import model_block

__all__ = ["cut", "d_inner", "gather", "hold", "kv_heads", "partial", "reduce", "row", "split"]

_TODO = "ROADMAP.md queue 1 item 5"


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
    if torch.is_grad_enabled():
        raise NotImplementedError(f"training a tensor-parallel model: its collectives have no "
                                  f"backward yet ({_TODO}); build it with zero=True to train "
                                  f"under a mesh")
    return mesh


def partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """This rank's float32 share of a row-split product: ``x`` holds its
    block of the contraction dim and ``w`` the same rows; bf16 products are
    summed in float32 (cuBLAS with a float32 output on the card), not
    rounded to bf16 before the sum over ranks."""
    _mesh()
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = x2 @ w
    elif x.is_cuda:
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*x.shape[:-1], w.shape[-1])


def reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a float32 partial) summed over the ``model`` ranks, in place
    (one all-reduce)."""
    return _mesh().all_reduce(t, "model")


def row(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of a row-split pair: the float32 partials summed over the
    ``model`` ranks, then cast once to ``x``'s dtype."""
    return reduce(partial(x, w)).to(x.dtype)


def gather(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every ``model`` rank's block of ``t``'s ``dim``, concatenated in rank
    order (one all-gather): a column-split product made whole."""
    return _mesh().all_gather(t, "model", dim % t.ndim)


def _held(cfg, path: str, shape: tuple[int, ...], unit: int) -> int:
    """The units of ``unit`` elements a leaf of ``shape`` at ``path``
    keeps along its split dim under the open mesh context, which is
    tensor-parallel."""
    block = model_block(path, shape, ctx.get_mesh(), cfg)
    if block is None:
        return shape[1] // unit
    return sum(s.stop - s.start for s in block[1]) // unit


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
