"""Cohort gather/scatter for the round step — the port of the JAX package's
``fl/cohort.py``.

Selection resolves to a fixed-size index set ``idx`` (K,) of client ids
(selected first, ascending id); the round gathers the cohort's slabs with
``index_select``, runs the compute phases on (K, ...) lanes and scatters the
results back into the (C, ...) server state with ``index_copy``. The
ascending order keeps the nonzero summands of every masked aggregation in
the dense order. Both helpers return new tensors and leave their inputs as
they were, like the JAX package's functional updates.

``mode="drop"`` is the JAX package's ``.at[idx].set(..., mode="drop")``:
the async step points the lanes that must not write (non-landing dispatch
slots, which may repeat a client id) at the out-of-range sentinel C.
``index_copy`` refuses such an index, so ``scatter_rows`` writes into a
buffer of C + 1 rows and drops the sentinel row: what the dropped lanes
hold never reaches the result, and no host read is needed to filter them.
"""

from __future__ import annotations

import torch

from repro_torch.core.selection import cohort_from_mask
from repro_torch.tree import tree_map

__all__ = ["cohort_indices", "tree_take", "tree_scatter", "scatter_rows"]


def cohort_indices(select: torch.Tensor, k: int) -> torch.Tensor:
    """(K,) client ids of this round's cohort from a (C,) selection mask."""
    return cohort_from_mask(select, k).idx


def tree_take(tree, idx: torch.Tensor):
    """Gather cohort lanes: every leaf (C, ...) -> (K, ...); None passes."""
    if tree is None:
        return None
    return tree_map(lambda leaf: leaf.index_select(0, idx), tree)


def scatter_rows(leaf: torch.Tensor, idx: torch.Tensor, update: torch.Tensor,
                 mode: str | None = None) -> torch.Tensor:
    """A copy of ``leaf`` (C, ...) with rows ``idx`` replaced by ``update``;
    with ``mode="drop"`` the lanes whose index is C write nothing."""
    if mode is None:
        return leaf.index_copy(0, idx, update)
    if mode != "drop":
        raise ValueError(f"scatter mode must be None or 'drop', got {mode!r}")
    c = leaf.shape[0]
    padded = torch.cat([leaf, leaf.new_zeros((1,) + tuple(leaf.shape[1:]))])
    return padded.index_copy_(0, idx, update)[:c]


def tree_scatter(tree, idx: torch.Tensor, update, mode: str | None = None):
    """Scatter cohort lanes back: a copy of every leaf with rows ``idx``
    replaced by ``update`` (``mode="drop"``: lanes at index C write
    nothing); None passes."""
    if tree is None:
        return None
    return tree_map(lambda leaf, u: scatter_rows(leaf, idx, u, mode), tree, update)
