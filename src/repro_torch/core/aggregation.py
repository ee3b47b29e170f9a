"""Federated aggregation (paper Eq. 1) with selection and layer masks — the
port of the JAX package's ``core/aggregation.py``.

Every weighted mean goes through the ``masked_aggregate`` op
(``repro_torch.kernels.masked_aggregate``), all the leaves of a round (or
of an async merge event) in one call (``masked_aggregate_leaves``): one
launch of its CUDA kernel on the card, its plain version on the CPU. (The
JAX package reduces in jnp here, leaf by leaf, and only tests its Pallas
kernel.)

Client parameters are *stacked*: leaves carry a leading client axis (C, ...);
a layered model is a list of such trees. ``edge_ids``/``n_edges`` route a
reduction through two-level (edge-server) aggregation, the kernel's edge
mode: each edge group partial-sums its lanes, the server sums the E
partials in ascending edge order; ``n_edges <= 1`` keeps the flat
expression exactly.

``axis_name`` (a ``repro_torch.launch.mesh.CohortMesh``) extends a reduction
across the ranks of a sharded cohort (``repro_torch.fl.shard``), the JAX
package's ``axis_name`` path: the rank's lanes reduce to partial numerators
and totals (the kernel's partial mode, local edge partials first), one
all-reduce of the rank-slotted buffer gathers every rank's partials, and
the kernel's combine mode sums them in rank order, divides, and tests the
fallback on the global total, so every rank holds the same new global
model. With lanes in rank blocks this is bitwise the edge mode with
``edge_ids = lane // (K // D)`` and ``n_edges = D``.
"""

from __future__ import annotations

import torch

from repro_torch.device import fill_vector
from repro_torch.kernels.masked_aggregate import (
    masked_aggregate_combine,
    masked_aggregate_leaves,
    masked_aggregate_partial,
)
from repro_torch.tree import tree_leaves, tree_unflatten


def _reduce_leaves(xs, weights, rows=None, fallbacks=None, snapshots=None, bases=None,
                   edge_ids=None, n_edges: int = 0, axis_name=None) -> list:
    """``masked_aggregate_leaves`` over this process's lanes, or with a mesh
    (``axis_name``) the partial launch, one all-reduce and the combine
    launch."""
    if axis_name is None:
        return masked_aggregate_leaves(xs, weights, rows, fallbacks, snapshots, bases,
                                       edge_ids=edge_ids, n_edges=n_edges)
    mesh = axis_name
    if not hasattr(mesh, "all_reduce"):
        raise TypeError(f"axis_name must be the cohort mesh whose ranks hold the other lanes "
                        f"(repro_torch.launch.mesh.CohortMesh), got {mesh!r}")
    buf = masked_aggregate_partial(xs, weights, rows, snapshots, edge_ids=edge_ids,
                                   n_edges=n_edges, slot=mesh.rank, n_slots=mesh.world)
    mesh.all_reduce(buf)
    return masked_aggregate_combine(buf, [x.shape[1:] for x in xs], rows, fallbacks, bases,
                                    xs[0].dtype)


def fedavg_aggregate(client_params, select_mask, n_samples, axis_name=None, edge_ids=None,
                     n_edges: int = 0):
    """Eq. (1): w <- sum_i (|d_i|/|D|) w_i over *selected* clients; a leaf
    nobody contributed to becomes zeros. ``axis_name``: the mesh whose
    ranks hold the other lanes (see the module docstring)."""
    weights = select_mask.to(torch.float32) * n_samples.to(torch.float32)
    return tree_unflatten(client_params, _reduce_leaves(
        tree_leaves(client_params), weights[None], edge_ids=edge_ids, n_edges=n_edges,
        axis_name=axis_name))


def masked_partial_aggregate(client_params, prev_global, select_mask, n_samples, share_mask,
                             axis_name=None, edge_ids=None, n_edges: int = 0):
    """ACSP-FL aggregation: layer j averages the clients with
    ``select_mask[i] & share_mask[i, j]``; a layer nobody shared keeps the
    previous global value (tested on the total over every rank with
    ``axis_name``). ``share_mask`` is (C, L) or (L,)."""
    n_layers = len(client_params)
    share_mask = torch.as_tensor(share_mask)
    if share_mask.ndim == 1:
        share_mask = share_mask[None, :].expand(select_mask.shape[0], n_layers)
    base = select_mask.to(torch.float32) * n_samples.to(torch.float32)
    weights = base[None, :] * share_mask.T.to(torch.float32)  # row j: layer j's weights
    xs, rows, fallbacks, spans = [], [], [], []
    for j in range(n_layers):  # every layer's leaves in one call
        layer = tree_leaves(client_params[j])
        spans.append((len(xs), len(xs) + len(layer)))
        xs += layer
        rows += [j] * len(layer)
        fallbacks += tree_leaves(prev_global[j])
    means = _reduce_leaves(xs, weights, rows, fallbacks, edge_ids=edge_ids, n_edges=n_edges,
                           axis_name=axis_name)
    return [tree_unflatten(client_params[j], means[a:b]) for j, (a, b) in enumerate(spans)]


def staleness_weighted_merge(client_deltas, prev_global, weights, share_mask=None,
                             axis_name=None, edge_ids=None, n_edges: int = 0, snapshots=None):
    """FedBuff's buffered merge, ``g + sum_i v_i d_i / sum_i v_i`` per
    layer with ``v_i = weights_i * share_mask[i, j]`` (the caller folds the
    landing mask, sample counts and staleness discount into ``weights``,
    (C,) float32); a layer with zero total weight keeps ``g`` (``g + 0``, one
    float32 add, as the JAX package computes it).

    ``client_deltas`` are the (C, ...) deltas; with ``snapshots`` (the
    layered (C, ...) dispatch snapshots) they are the clients' parameters
    instead and each delta is ``client - snapshot``, formed in the kernel's
    load loop with one float32 rounding, so for float32 leaves the result
    is bitwise the one from passing the deltas (bf16 deltas passed in are
    rounded to bf16 first; the fused ones are not). Every layer's leaves go through one
    ``masked_aggregate_leaves`` call (on CUDA one kernel launch), the weight
    rows one per layer, the global leaves as the bases (with ``axis_name``: a partial and a combine
    launch around one all-reduce)."""
    n_layers = len(client_deltas)
    w = weights.to(torch.float32)
    if share_mask is None:
        table = w[None, :].expand(n_layers, w.shape[0])
    else:
        table = w[None, :] * torch.as_tensor(share_mask).T.to(torch.float32)
    xs, rows, snaps, bases, spans = [], [], [], [], []
    for j in range(n_layers):  # every layer's leaves in one call
        layer = tree_leaves(client_deltas[j])
        spans.append((len(xs), len(xs) + len(layer)))
        xs += layer
        rows += [j] * len(layer)
        bases += tree_leaves(prev_global[j])
        snaps += [None] * len(layer) if snapshots is None else tree_leaves(snapshots[j])
    means = _reduce_leaves(xs, table.contiguous(), rows, snapshots=snaps, bases=bases,
                           edge_ids=edge_ids, n_edges=n_edges, axis_name=axis_name)
    return [tree_unflatten(client_deltas[j], means[a:b]) for j, (a, b) in enumerate(spans)]


def finite_update_guard(select_mask, update_norm, max_norm: float = 0.0):
    """``(ok, n_rejected)``: lanes whose transmitted update norm is finite
    (and, with ``max_norm > 0``, at most ``max_norm``), and the int32 count
    of selected lanes that failed."""
    ok = torch.isfinite(update_norm)
    if max_norm > 0.0:
        ok = ok & (update_norm <= max_norm)
    n_rejected = torch.sum(select_mask & ~ok).to(torch.int32)
    return ok, n_rejected


def transmitted_parameters(select_mask, share_mask, layer_sizes) -> torch.Tensor:
    """Analytic one-way transmitted parameter count for a round: over
    selected clients, the sizes of the layers each shares (float32, as the
    JAX package computes it)."""
    share = torch.as_tensor(share_mask)
    if share.ndim == 1:
        share = share[None, :].expand(select_mask.shape[0], share.shape[0])
    sizes = fill_vector(layer_sizes, torch.float32, share.device)
    per_client = share.to(torch.float32) @ sizes
    return torch.sum(per_client * select_mask.to(torch.float32))
