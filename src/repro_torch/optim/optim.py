"""Minimal, production-shaped optimizer library on tensor trees — the port
of the JAX package's ``optim/optim.py``.

SGD(+momentum), AdamW, global-norm clipping, chaining, and a cosine LR
schedule, as ``(init, update)`` transformations of the port's trees
(nested lists/dicts of tensors, ``repro_torch.tree``). The arithmetic is the
JAX package's, operation for operation and in its order (float32 moments,
the bias corrections ``1 - b ** step`` before ``m / bc1`` and ``sqrt(v /
bc2) + eps``), so the model zoo's train steps
(``models/transformer.make_train_step``, ``launch/train.py``) are held to
the JAX package's; ``torch.optim``'s AdamW orders its
bias correction and eps otherwise. Steps and learning rates are float32
tensors on the parameters' device.

Optimizer states mirror the parameter tree leaf for leaf, so whatever
shards a parameter shards its moments too (``launch.sharding``,
``launch/zero.py``). Under a mesh of ranks the train step passes its
gradients as a ``SplitTree``, which names the mesh axes each leaf's block
is split over; ``global_norm`` then sums each leaf's squares once over
those axes. ``Optimizer.apply_`` runs an optimizer in place, leaf by leaf:
the same arithmetic as ``update`` and ``apply_updates``, bit for bit, with
the state's tensors overwritten, so that a step holds one copy of the
moments and one leaf's temporaries (the train step takes it under a mesh).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "SplitTree", "adamw", "apply_updates", "chain", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "sgd"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]  # (grads, state, params) -> (updates, state)
    # (grads, state, params) -> state: in place, leaf by leaf; a gradient
    # transformation rewrites grads, the last transformation of a chain
    # writes its moments into the state's tensors and adds the update to
    # params (rounded to their dtype). None: not offered.
    apply_: Callable[..., Any] | None = None


class SplitTree(dict):
    """A flat {name: leaf} tree of a model held over a mesh of ranks:
    ``split[name]`` is the tuple of mesh axes that leaf's block is split
    over (() where this rank holds it whole), ``mesh`` the
    ``launch.mesh.RankMesh``."""

    def __init__(self, leaves: dict, split: dict, mesh):
        super().__init__(leaves)
        self.split = split
        self.mesh = mesh


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    """The square root of the sum of every element's square. Of a
    ``SplitTree``: each leaf's block summed, the sums of the leaves split
    over the same axes all-reduced over them (one collective for each such
    set of axes), a leaf held whole counted once."""
    split = getattr(tree, "split", None)
    if split is None:
        leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    by_axes: dict = {}
    for name in sorted(tree):
        by_axes.setdefault(tuple(split[name]), []).append(
            torch.sum(torch.square(tree[name].to(torch.float32))))
    total = None
    for axes in sorted(by_axes):  # the same collectives in the same order on every rank
        part = torch.sum(torch.stack(by_axes[axes]))
        if axes:
            part = tree.mesh.all_reduce(part.reshape(1), axes).reshape(())
        total = part if total is None else total + part
    return torch.sqrt(total)


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _f32(value, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def _as_schedule(lr) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(lr):
        return lr
    return lambda step: _f32(lr, step.device)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak_lr``."""

    def schedule(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD with optional (Nesterov) momentum — the paper's client optimizer."""
    sched = _as_schedule(lr)

    class State(NamedTuple):
        step: torch.Tensor
        mu: Any

    def init(params):
        mu = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
              if momentum else None)
        return State(torch.zeros((), dtype=torch.int32, device=_device(params)), mu)

    def update(grads, state, params=None):
        lr_t = sched(state.step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32), state.mu, grads)
            if nesterov:
                upd = tree_map(lambda m, g: -(lr_t * (momentum * m + g.to(torch.float32))),
                               mu, grads)
            else:
                upd = tree_map(lambda m: -(lr_t * m), mu)
            return upd, State(state.step + 1, mu)
        upd = tree_map(lambda g: -(lr_t * g.to(torch.float32)), grads)
        return upd, State(state.step + 1, None)

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with fp32 first/second moments (standard LLM pretraining setup)."""
    sched = _as_schedule(lr)

    class State(NamedTuple):
        step: torch.Tensor
        mu: Any
        nu: Any

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return State(torch.zeros((), dtype=torch.int32, device=_device(params)),
                     tree_map(zeros, params), tree_map(zeros, params))

    def corrections(state):
        step = state.step + 1
        bc1 = 1 - torch.pow(_f32(b1, step.device), step.to(torch.float32))
        bc2 = 1 - torch.pow(_f32(b2, step.device), step.to(torch.float32))
        return step, sched(state.step), bc1, bc2

    def first(m, g):
        return b1 * m + (1 - b1) * g.to(torch.float32)

    def second(v, g):
        return b2 * v + (1 - b2) * torch.square(g.to(torch.float32))

    def delta(m, v, p, lr_t, bc1, bc2):
        upd = -(lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        if weight_decay:
            upd = upd - lr_t * weight_decay * p.to(torch.float32)
        return upd

    def update(grads, state, params):
        step, lr_t, bc1, bc2 = corrections(state)
        mu = tree_map(first, state.mu, grads)
        nu = tree_map(second, state.nu, grads)
        return (tree_map(lambda m, v, p: delta(m, v, p, lr_t, bc1, bc2), mu, nu, params),
                State(step, mu, nu))

    def apply_(grads, state, params):
        step, lr_t, bc1, bc2 = corrections(state)
        with torch.no_grad():
            for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                                  tree_leaves(state.nu), tree_leaves(params)):
                m.copy_(first(m, g))
                v.copy_(second(v, g))
                p.copy_((p + delta(m, v, p, lr_t, bc1, bc2)).to(p.dtype))
        return State(step, state.mu, state.nu)

    return Optimizer(init, update, apply_)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return ()

    def scale_of(grads):
        return torch.clamp_max(max_norm / torch.clamp_min(global_norm(grads), 1e-9), 1.0)

    def update(grads, state, params=None):
        scale = scale_of(grads)
        return tree_map(lambda g: g * scale, grads), state

    def apply_(grads, state, params=None):
        scale = scale_of(grads)
        for g in tree_leaves(grads):
            g.mul_(scale)
        return state

    return Optimizer(init, update, apply_)


def chain(*transforms: Optimizer) -> Optimizer:
    """Compose gradient transformations left-to-right (optax semantics)."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    def apply_(grads, state, params=None):
        return tuple(t.apply_(grads, s, params) for t, s in zip(transforms, state))

    offered = all(t.apply_ is not None for t in transforms)
    return Optimizer(init, update, apply_ if offered else None)
