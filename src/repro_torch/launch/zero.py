"""ZeRO over the data axes of a ``launch.mesh.RankMesh`` — port-only. The
JAX package gets this layout from ``jax.jit``'s ``in_shardings``: its
``launch/dryrun.py`` shards parameters, AdamW moments and the batch by
``launch/sharding.tree_pspecs``, and XLA gathers and reduces as it needs.

A model built for training under ``launch.context.mesh_context``
(``models.transformer.init_params(..., zero=True)``,
``weights.lm_params_from_numpy(..., mesh=, zero=True)``,
``models.whisper.init_whisper(..., zero=True)``) holds each parameter leaf
as this rank's 2-D block: on a ``model`` axis over 1 its tensor-parallel
``sharding.model_block`` (``launch/tp.py``; whisper's leaves stay whole
over ``model``), and of that the block of the dim ``sharding.data_block``
names over the context's data axes (``context.dp_axes``, the one place
they are decided), cut within the model block where both name one dim; an
expert leaf holds only this rank's experts (``sharding.expert_block``).
So a rank holds 1 / (n_dp n_mp) of every leaf that ``param_spec`` splits
over both, but for the leaves ``model_block`` keeps whole over ``model``.
The optimizer maps the parameter tree, so the gradients and both AdamW
moments are the same blocks. A served model keeps its leaves whole over
the data axes (no ``zero``): it has no gradients or moments to split, and
its steps then gather nothing. A block is an ``nn.Parameter`` that carries

  zero_dim      the dim split over the data axes (None: whole over them)
  zero_axes     those data axes
  split_axes    every mesh axis the block is split over, in the mesh's
                order (``model`` for a model block or an expert leaf whose
                experts are split)
  full_shape    the whole leaf's shape
  model_blocks  every ``model`` rank's ``sharding.model_block``, in rank
                order (None: no model block)

and a ``models.transformer.ParamTree`` holding one is marked
``zero_split`` when it is built. ``gathered(tree)`` gives such a tree's
leaves whole at use through ``mesh.gather_blocks``, whose backward
reduce-scatters the leaf's gradient: summed over the data ranks, this
rank's block kept. ``models.transformer.apply_block`` calls it inside the
checkpointed block, so the whole weights are gathered again in the
backward rather than held for it. A leaf that stays whole over the data
axes gets its gradient summed over the data ranks after the backward
(``reduce_grads``: one all-reduce a dtype), and a norm of a
sequence-parallel step, which each ``model`` rank ran on its own tokens,
over the data ranks and ``model`` (one more a dtype). ``whole`` gathers a leaf over
every axis it is split over and puts the model blocks back in place
(checkpoints).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.launch import context as ctx
from repro_torch.launch.mesh import gather_blocks
from repro_torch.launch.sharding import data_block, model_blocks
from repro_torch.launch.tp import cut
from repro_torch.optim import SplitTree

__all__ = ["EXPERT_LEAVES", "full", "gathered", "reduce_grads", "shard", "split_axes", "whole"]

EXPERT_LEAVES = ("wg", "wu", "wd")  # an MoE's leaves with the E axis first


def _full_shape(path: str, t: torch.Tensor, n_experts: int) -> tuple[int, ...]:
    """The whole leaf's shape: an expert leaf may hold only this rank's
    experts."""
    if ("/moe/" in f"/{path}/" and path.rsplit("/", 1)[-1] in EXPERT_LEAVES and t.ndim == 3):
        return (n_experts, *t.shape[1:])
    return tuple(t.shape)


def shard(tree, path: str, cfg):
    """``tree`` (a leaf, or nested dicts of leaves), the leaves at ``path``
    of a model of ``cfg``, as parameters holding this rank's blocks under
    the open ``mesh_context`` (its ``model_block`` where the ``model`` axis
    is over 1, and of that its ``data_block``; an expert leaf as given,
    whole or this rank's experts), tagged as the module docstring says. A
    block is a copy, so the whole leaf can be freed at once."""
    mesh = ctx.get_mesh()
    if mesh is None:
        raise RuntimeError("ZeRO blocks of a parameter are made outside a mesh_context")
    return _shard(tree, path, cfg, mesh, ctx.dp_axes())


def _shard(tree, path, cfg, mesh, dp_axes):
    if isinstance(tree, dict):
        return {k: _shard(v, f"{path}/{k}", cfg, mesh, dp_axes) for k, v in tree.items()}
    full_shape = _full_shape(path, tree, cfg.n_experts)
    tp_split = ctx.tensor_parallel() and not cfg.encoder_decoder
    blocks = model_blocks(path, full_shape, mesh, cfg, train=True) if tp_split else None
    mine = None if blocks is None else blocks[mesh.coords["model"]]
    t = tree if mine is None else cut(tree, mine)
    block = data_block(path, full_shape, mesh, dp_axes, mine)
    if block is not None:
        t = t.narrow(block[0], block[1].start, block[1].stop - block[1].start).clone()
    p = nn.Parameter(t, requires_grad=False)
    model_split = mine is not None or full_shape[0] != tree.shape[0]
    p.zero_dim = None if block is None else block[0]
    p.zero_axes = tuple(dp_axes)
    p.split_axes = tuple(a for a in mesh.shape if (a == "model" and model_split)
                         or (block is not None and a in dp_axes))
    p.full_shape = full_shape
    p.model_blocks = blocks
    return p


def split_axes(p) -> tuple[str, ...]:
    """The mesh axes ``p``'s block is split over (() for a leaf held whole)."""
    return getattr(p, "split_axes", ())


def full(p: torch.Tensor) -> torch.Tensor:
    """A leaf whole over the data axes: ``p`` itself where it is, else its
    blocks all-gathered over them (differentiable: the gradient comes back
    reduce-scattered to ``p``'s block)."""
    dim = getattr(p, "zero_dim", None)
    if dim is None:
        return p
    mesh = ctx.get_mesh()
    if mesh is None:
        raise RuntimeError("a ZeRO block of a parameter is used outside a mesh_context")
    return gather_blocks(mesh, p, p.zero_axes, dim)


def gathered(tree):
    """A ``ParamTree`` with its leaves whole over the data axes: ``tree``
    itself unless it is marked ``zero_split`` (a served model, or no mesh),
    else nested dicts of the leaves (``full``), indexed as the tree is."""
    if not getattr(tree, "zero_split", False):
        return tree
    return _gathered(tree)


def _gathered(node):
    return {k: _gathered(v) if isinstance(v, nn.Module) else full(v) for k, v in node.items()}


def reduce_grads(grads: dict, params: dict, mesh, over_model=()) -> SplitTree:
    """The gradients of ``params`` (by name) after the backward, as a
    ``SplitTree``: the leaves held whole over the data axes summed over the
    data ranks in place, and those named in ``over_model`` (leaves whole
    over ``model`` that each ``model`` rank used on its own tokens: the
    norms of a sequence-parallel step) over the data axes and ``model``
    (one all-reduce of their concatenation a dtype and a set of axes); the
    blocks came reduce-scattered from ``full``. An all-reduce hands every
    rank the same bits, so a leaf whole over ``model`` stays bitwise equal
    across the ``model`` ranks."""
    dp = ctx.dp_axes() if ctx.n_data() > 1 else ()
    over_model = set(over_model)
    groups: dict = {}
    for n, p in params.items():  # in the params' order: the same on every rank
        if getattr(p, "zero_dim", None) is not None:
            continue
        axes = dp + (("model",) if n in over_model else ())
        if axes:
            groups.setdefault((grads[n].dtype, axes), []).append(n)
    for (_, axes), names in groups.items():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        mesh.all_reduce(flat, axes)
        for n, part in zip(names, flat.split([grads[n].numel() for n in names])):
            grads[n] = part.view_as(grads[n])
    return SplitTree(grads, {n: split_axes(p) for n, p in params.items()}, mesh)


def whole(p: torch.Tensor, mesh, block: torch.Tensor | None = None) -> torch.Tensor:
    """The whole leaf of which ``block`` (default ``p``; a gradient or a
    moment of ``p``) is this rank's block in ``p``'s layout: gathered over
    the data axes and, for a leaf split over ``model``, over it: an expert
    leaf's experts concatenated, a model block put back where each rank's
    lies in the whole leaf (several slices of a dim, for Mamba's
    ``in_proj``) (collectives every rank of the mesh must join)."""
    t = (p if block is None else block).detach()
    if getattr(p, "zero_dim", None) is not None:
        t = mesh.all_gather(t, p.zero_axes, p.zero_dim)
    if "model" not in split_axes(p):
        return t
    blocks = getattr(p, "model_blocks", None)
    if blocks is None:  # an expert leaf: the experts in rank order
        return mesh.all_gather(t, "model", 0)
    every = mesh.all_gather(t[None], "model", 0)
    out = t.new_empty(p.full_shape)
    for got, (dim, slices) in zip(every, blocks):
        sizes = [s.stop - s.start for s in slices]
        for part, s in zip(got.split(sizes, dim=dim), slices):
            out.narrow(dim, s.start, s.stop - s.start).copy_(part)
    return out
