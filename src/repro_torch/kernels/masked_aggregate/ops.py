"""masked_aggregate — the paper's Eq. 1 server reduction over stacked leaves.

Replaces the JAX package's Pallas kernel
``src/repro/kernels/masked_aggregate/kernel.py`` (``masked_aggregate_kernel``/
``_agg_kernel``) with the hand-written CUDA kernel in
``repro_torch/csrc/masked_aggregate.cu``; that file's header states its bound
on the H100 (bytes: x read once, ~4 B per client element) and its design.
One launch aggregates a whole list of leaves, each with its own row of a
weight matrix and its own fallback, so a round costs one launch. In the JAX
package this function is computed in jnp by
``core/aggregation._weighted_mean`` and the Pallas kernel is only tested;
in the port it is the aggregators' path.

- ``masked_aggregate_plain``: the plain PyTorch version of one leaf —
  clients summed in ascending order in float32, one rounding per product
  and per sum, as the kernel does, so the kernel is bitwise equal to it on
  every leaf; with a ``snapshot`` each client's row is ``x - snapshot``
  (one rounding) before its product, and with a ``base`` the result is
  ``base + (mean where the weights sum to > 0, else 0)`` — the staleness
  merge of ``core/aggregation.staleness_weighted_merge``;
- ``masked_aggregate_leaves_plain``: that, leaf by leaf;
- ``masked_aggregate_leaves``: the wrapper over a list of leaves,
  dispatching on the tensors' device (CPU -> plain, CUDA -> one kernel
  launch, or raise); at most 64 leaves, the kernel's parameter table.
  With ``edge_ids``/``n_edges`` (E > 1) every leaf reduces through two
  levels, each edge group's partial sums first, then the E partials in
  ascending edge order (the JAX package's ``_weighted_mean`` with
  ``edge_ids``); the kernel's edge mode walks the lanes in a stable sort
  by edge id made on the device, so a round stays graph-capturable;
- ``masked_aggregate``: one leaf, the one-leaf case of the above;
- ``masked_aggregate_leaves.launches``: the kernel's launch counter.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["masked_aggregate", "masked_aggregate_leaves", "masked_aggregate_leaves_plain",
           "masked_aggregate_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEAVES = 64    # leaves a launch (the kernel's parameter table)
_BLOCK_COLS = 256   # columns a block (64 threads x 4)


_MODE_FALLBACK, _MODE_BASE = 0, 1  # the kernel's epilogues


class _Leaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("snap", ctypes.c_void_p), ("other", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("cols", ctypes.c_int64), ("block0", ctypes.c_int64),
                ("row", ctypes.c_int32), ("mode", ctypes.c_int32)]


class _Table(ctypes.Structure):
    _fields_ = [("leaf", _Leaf * _MAX_LEAVES), ("w", ctypes.c_void_p), ("n_leaves", ctypes.c_int),
                ("c_rows", ctypes.c_int), ("order", ctypes.c_void_p), ("edge", ctypes.c_void_p),
                ("n_edges", ctypes.c_int), ("pad", ctypes.c_int)]


assert ctypes.sizeof(_Table) == 3624  # the kernel's static_assert: under the 4 KB limit


def _edged(edge_ids, n_edges: int) -> bool:
    """Whether a call reduces through edge groups (E > 1); E <= 1 is the
    flat sum, bit for bit."""
    return edge_ids is not None and n_edges > 1


def masked_aggregate_plain(x: torch.Tensor, weights: torch.Tensor,
                           fallback: torch.Tensor | None = None,
                           snapshot: torch.Tensor | None = None,
                           base: torch.Tensor | None = None,
                           edge_ids: torch.Tensor | None = None,
                           n_edges: int = 0) -> torch.Tensor:
    """``sum_c w_c d[c] / max(sum w, 1e-12)`` with ``d = x`` (or ``x -
    snapshot`` with a snapshot of x's shape), for a stacked leaf ``x`` (C,
    ...); float32 accumulation, result in x's dtype. Where ``sum w == 0``
    the result is ``fallback`` (zeros when None); with a ``base`` (shape
    ``x.shape[1:]``; no fallback then) it is ``base + mean``, or ``base + 0``
    where ``sum w == 0``, one float32 add. With ``edge_ids`` (C,) and
    ``n_edges`` > 1 the sums go edge by edge: edge e sums its lanes in
    ascending order into partials, and the partials join the running sums
    in ascending e (masks on the device: no host read)."""
    if base is not None and fallback is not None:
        raise ValueError("masked_aggregate: a leaf takes a fallback or a base, not both")
    w = weights.to(torch.float32)

    def row(c):
        d = x[c].to(torch.float32)
        if snapshot is not None:
            d = d - snapshot[c].to(torch.float32)
        return d

    num = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    if _edged(edge_ids, n_edges):
        for e in range(n_edges):
            member = edge_ids == e
            part, part_total = torch.zeros_like(num), torch.zeros_like(total)
            for c in range(x.shape[0]):
                part_total = torch.where(member[c], part_total + w[c], part_total)
                part = torch.where(member[c], part + w[c] * row(c), part)
            total = total + part_total
            num = num + part
    else:
        for c in range(x.shape[0]):
            total = total + w[c]
            num = num + w[c] * row(c)
    mean = num / torch.clamp_min(total, 1e-12)
    if base is not None:
        return (base.to(torch.float32) + torch.where(total > 0, mean, torch.zeros_like(mean))
                ).to(x.dtype)
    fb = torch.zeros_like(mean) if fallback is None else fallback.to(torch.float32)
    return torch.where(total > 0, mean, fb).to(x.dtype)


def masked_aggregate_leaves_plain(xs, weights: torch.Tensor, rows=None, fallbacks=None,
                                  snapshots=None, bases=None, edge_ids=None,
                                  n_edges: int = 0) -> list:
    """``masked_aggregate_plain(xs[i], weights[rows[i]], fallbacks[i],
    snapshots[i], bases[i], edge_ids, n_edges)`` for every leaf (rows
    default to 0, the others to None)."""
    n = len(xs)
    rows = [0] * n if rows is None else rows
    fallbacks = [None] * n if fallbacks is None else fallbacks
    snapshots = [None] * n if snapshots is None else snapshots
    bases = [None] * n if bases is None else bases
    return [masked_aggregate_plain(x, weights[r], fb, s, b, edge_ids, n_edges)
            for x, r, fb, s, b in zip(xs, rows, fallbacks, snapshots, bases)]


def _lib():
    lib = build.load("masked_aggregate")
    if not getattr(lib, "_repro_typed", False):
        lib.repro_masked_aggregate.argtypes = [ctypes.POINTER(_Table), ctypes.c_int64,
                                               ctypes.c_int, ctypes.c_void_p]
        lib.repro_masked_aggregate.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check(xs, weights, rows, fallbacks, snapshots, bases, edge_ids) -> None:
    dev = xs[0].device
    if weights.ndim != 2 or weights.dtype != torch.float32 or weights.device != dev:
        raise ValueError(f"weights must be a float32 (R, C) matrix on {dev}, got "
                         f"{weights.dtype} {tuple(weights.shape)} on {weights.device}")
    n_rows, c = weights.shape
    if not len(rows) == len(fallbacks) == len(snapshots) == len(bases) == len(xs):
        raise ValueError("masked_aggregate_leaves: one row, fallback, snapshot and base per leaf")
    if edge_ids is not None and (edge_ids.shape != (c,) or edge_ids.device != dev
                                 or edge_ids.dtype.is_floating_point):
        raise ValueError(f"edge_ids must be integer ids of shape ({c},) on {dev}, got "
                         f"{edge_ids.dtype} {tuple(edge_ids.shape)} on {edge_ids.device}")
    if xs[0].dtype not in _DTYPES or any(x.dtype != xs[0].dtype for x in xs):
        raise TypeError(f"masked_aggregate takes float32 or bfloat16 leaves of one dtype, got "
                        f"{sorted({str(x.dtype) for x in xs})}")
    for x, r, fb, sn, b in zip(xs, rows, fallbacks, snapshots, bases):
        if x.device != dev or x.ndim < 1 or x.shape[0] != c:
            raise ValueError(f"every leaf must be ({c}, ...) on {dev}, got {tuple(x.shape)} "
                             f"on {x.device}")
        if not 0 <= r < n_rows:
            raise ValueError(f"weight row {r} outside the {n_rows} rows")
        if fb is not None and b is not None:
            raise ValueError("masked_aggregate: a leaf takes a fallback or a base, not both")
        for name, t, shape in (("fallback", fb, x.shape[1:]), ("base", b, x.shape[1:]),
                               ("snapshot", sn, x.shape)):
            if t is not None and (t.shape != shape or t.dtype != x.dtype or t.device != dev):
                raise ValueError(f"{name} must be {x.dtype} of shape {tuple(shape)} on {dev}, "
                                 f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def masked_aggregate_leaves(xs, weights: torch.Tensor, rows=None, fallbacks=None,
                            snapshots=None, bases=None, edge_ids=None, n_edges: int = 0) -> list:
    """Weighted means of stacked leaves ``xs[i]`` (C, ...) over their client
    axis, leaf i weighted by row ``rows[i]`` (default 0) of ``weights``
    (R, C) float32, with ``fallbacks[i]`` (shape ``xs[i].shape[1:]``, its
    dtype; None = zeros) where that row sums to 0. ``snapshots[i]`` (xs[i]'s
    shape; None = none) is subtracted from each client row before it is
    weighted; a leaf with ``bases[i]`` (no fallback then) gets ``base +
    mean``, ``base`` where its row sums to 0 (the staleness merge). At most
    64 float32 or bfloat16 leaves of one dtype, which the results have.
    ``edge_ids`` (C,) with ``n_edges`` > 1 reduces every leaf through its
    edge groups (``masked_aggregate_plain``); E <= 1 is the flat sum. CPU
    tensors run the plain version; on CUDA one kernel launch covers every
    leaf, and the outputs are views of one buffer."""
    xs = list(xs)
    n = len(xs)
    rows = [0] * n if rows is None else [int(r) for r in rows]
    fallbacks = [None] * n if fallbacks is None else list(fallbacks)
    snapshots = [None] * n if snapshots is None else list(snapshots)
    bases = [None] * n if bases is None else list(bases)
    if len(xs) > _MAX_LEAVES:
        raise ValueError(f"masked_aggregate_leaves takes at most {_MAX_LEAVES} leaves (the "
                         f"kernel's parameter table), got {len(xs)}")
    if not xs:
        return []
    dev = xs[0].device
    if not _edged(edge_ids, n_edges):
        edge_ids, n_edges = None, 0
    if dev.type == "cpu":
        return masked_aggregate_leaves_plain(xs, weights, rows, fallbacks, snapshots, bases,
                                             edge_ids, n_edges)
    if dev.type != "cuda":
        raise ValueError(f"masked_aggregate: tensors on {dev} have no kernel here")
    _check(xs, weights, rows, fallbacks, snapshots, bases, edge_ids)
    wc = weights.contiguous()
    dtype = xs[0].dtype
    align = 16 // dtype.itemsize  # each leaf's output view starts on a 16-byte boundary
    sizes = [x.shape[1:].numel() for x in xs]
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // align) * align)
    buf = torch.empty(offsets[-1], dtype=dtype, device=dev)
    table, keep, outs, block = _Table(), [], [], 0  # keep: contiguous copies live until the launch
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    for i, (x, fb, sn, b, size, off) in enumerate(zip(xs, fallbacks, snapshots, bases, sizes,
                                                      offsets)):
        x, fb, sn, b = (None if t is None else t.contiguous() for t in (x, fb, sn, b))
        other = fb if b is None else b
        out = buf[off:off + size]
        keep += [x, sn, other]
        outs.append(out.view(xs[i].shape[1:]))
        table.leaf[i] = _Leaf(x.data_ptr(), ptr(sn), ptr(other), out.data_ptr(), size, block,
                              rows[i], _MODE_FALLBACK if b is None else _MODE_BASE)
        block += -(-size // _BLOCK_COLS)
    table.w, table.n_leaves, table.c_rows = wc.data_ptr(), len(xs), wc.shape[1]
    if edge_ids is not None:
        # the lanes in a stable sort by edge id, and their ids in that order
        order = torch.argsort(edge_ids, stable=True)
        keep += [order.to(torch.int32), edge_ids.index_select(0, order).to(torch.int32)]
        table.order, table.edge, table.n_edges = keep[-2].data_ptr(), keep[-1].data_ptr(), n_edges
    if block == 0:  # only empty leaves: nothing to launch
        return outs
    err = _lib().repro_masked_aggregate(ctypes.byref(table), block, _DTYPES[dtype],
                                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_aggregate kernel launch failed: cudaError {err}")
    masked_aggregate_leaves.launches += 1
    return outs


masked_aggregate_leaves.launches = 0


def masked_aggregate(x: torch.Tensor, weights: torch.Tensor,
                     fallback: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted mean of one stacked leaf ``x`` (C, ...) over its client axis,
    with ``fallback`` (shape ``x.shape[1:]``, x's dtype; None = zeros) where
    the weights (C,) sum to 0: the one-leaf case of
    ``masked_aggregate_leaves``. CPU tensors run ``masked_aggregate_plain``;
    CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return masked_aggregate_plain(x, weights, fallback)
    if x.device.type != "cuda":
        raise ValueError(f"masked_aggregate: tensors on {x.device} have no kernel here")
    c = x.shape[0]
    if weights.shape != (c,) or weights.dtype != torch.float32 or weights.device != x.device:
        raise ValueError(f"weights must be float32 of shape ({c},) on {x.device}")
    return masked_aggregate_leaves([x], weights[None], [0], [fallback])[0]
