"""Cohort gather/scatter for the round step — the port of the JAX package's
``fl/cohort.py``.

Selection resolves to a fixed-size index set ``idx`` (K,) of client ids
(selected first, ascending id); the round gathers the cohort's slabs with
``index_select``, runs the compute phases on (K, ...) lanes and scatters the
results back into the (C, ...) server state with ``index_copy``. The
ascending order keeps the nonzero summands of every masked aggregation in
the dense order. Both helpers return new tensors and leave their inputs as
they were, like the JAX package's functional updates.
"""

from __future__ import annotations

import torch

from repro_torch.core.selection import cohort_from_mask
from repro_torch.tree import tree_map

__all__ = ["cohort_indices", "tree_take", "tree_scatter"]


def cohort_indices(select: torch.Tensor, k: int) -> torch.Tensor:
    """(K,) client ids of this round's cohort from a (C,) selection mask."""
    return cohort_from_mask(select, k).idx


def tree_take(tree, idx: torch.Tensor):
    """Gather cohort lanes: every leaf (C, ...) -> (K, ...); None passes."""
    if tree is None:
        return None
    return tree_map(lambda leaf: leaf.index_select(0, idx), tree)


def tree_scatter(tree, idx: torch.Tensor, update):
    """Scatter cohort lanes back: a copy of every leaf with rows ``idx``
    replaced by ``update``; None passes."""
    if tree is None:
        return None
    return tree_map(lambda leaf, u: leaf.index_copy(0, idx, u), tree, update)
