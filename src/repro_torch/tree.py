"""Nested list/tuple/dict trees of tensors — the part of ``jax.tree`` the
port needs. Leaves come in ``jax.tree.leaves`` order (dict keys sorted), so a
leaf index means the same leaf in both packages (the codec folds it into the
key of each leaf's noise)."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """Leaves of a nested list/tuple/dict tree in ``jax.tree.leaves`` order
    (dict keys sorted), so leaf indices match the JAX package's."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """Rebuild a tree shaped like ``like`` from ``leaves`` given in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over nested lists/tuples/dicts of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)
