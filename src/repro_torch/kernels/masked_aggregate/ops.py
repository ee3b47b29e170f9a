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
- ``masked_aggregate_partial`` / ``masked_aggregate_combine`` (and their
  ``_plain`` versions): the two halves of a reduction whose lanes are
  sharded over the D ranks of a process group (``repro_torch.fl.shard``;
  the JAX package's ``_weighted_mean`` with ``axis_name``). The partial
  mode runs the same sums over a rank's lanes, flat or by edge, stops
  before the divide and writes every leaf's float32 numerator and every
  weight row's total into this rank's row of a ``(D, width)`` float32
  buffer (``partial_layout``; the other rows hold -0.0, so an all-reduce
  sum fills every row bitwise); the combine mode sums each leaf's D slots
  in ascending rank order, divides and applies the fallback or the base.
  One launch each over all the leaves; partial then combine is bitwise the
  edge mode with ``edge_ids = lane // (K // D)`` and ``n_edges = D``;
- ``.launches`` on ``masked_aggregate_leaves``, ``masked_aggregate_partial``
  and ``masked_aggregate_combine``: the kernel's launch counters, one a
  mode.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.cost import is_fake, record_launch

__all__ = ["masked_aggregate", "masked_aggregate_combine", "masked_aggregate_combine_plain",
           "masked_aggregate_leaves", "masked_aggregate_leaves_plain", "masked_aggregate_partial",
           "masked_aggregate_partial_plain", "masked_aggregate_plain", "partial_layout"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEAVES = 64    # leaves a launch (the kernel's parameter table)
_BLOCK_COLS = 256   # columns a block (64 threads x 4)


_MODE_FALLBACK, _MODE_BASE, _MODE_PARTIAL = 0, 1, 2  # the kernel's epilogues
_SLOT_ALIGN = 4     # float32 elements: each leaf's slot starts on a 16-byte boundary


class _Leaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("snap", ctypes.c_void_p), ("other", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("cols", ctypes.c_int64), ("block0", ctypes.c_int64),
                ("row", ctypes.c_int32), ("mode", ctypes.c_int32)]


class _Table(ctypes.Structure):
    _fields_ = [("leaf", _Leaf * MAX_LEAVES), ("w", ctypes.c_void_p), ("n_leaves", ctypes.c_int),
                ("c_rows", ctypes.c_int), ("order", ctypes.c_void_p), ("edge", ctypes.c_void_p),
                ("n_edges", ctypes.c_int), ("pad", ctypes.c_int), ("slot_stride", ctypes.c_int64)]


assert ctypes.sizeof(_Table) == 3632  # the kernel's static_assert: under the 4 KB limit


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
    num, total = _plain_sums(x, weights, snapshot, edge_ids, n_edges)
    return _plain_epilogue(num, total, x.dtype, fallback, base)


def _plain_sums(x, weights, snapshot=None, edge_ids=None, n_edges: int = 0):
    """``(num, total)``: the float32 numerator ``sum_c w_c d[c]`` (shape
    ``x.shape[1:]``) and the weight total, in the kernel's order (ascending
    lanes; edge by edge with ``edge_ids``), before the divide."""
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
    return num, total


def _plain_epilogue(num, total, dtype, fallback=None, base=None):
    """The kernel's epilogues on float32 sums: the mean where ``total >
    0``, else the fallback (zeros when None); with a base, ``base + mean``
    (``base + 0`` where ``total == 0``); in ``dtype``."""
    mean = num / torch.clamp_min(total, 1e-12)
    if base is not None:
        return (base.to(torch.float32) + torch.where(total > 0, mean, torch.zeros_like(mean))
                ).to(dtype)
    fb = torch.zeros_like(mean) if fallback is None else fallback.to(torch.float32)
    return torch.where(total > 0, mean, fb).to(dtype)


def masked_aggregate_leaves_plain(xs, weights: torch.Tensor, rows=None, fallbacks=None,
                                  snapshots=None, bases=None, edge_ids=None,
                                  n_edges: int = 0) -> list:
    """``masked_aggregate_plain(xs[i], weights[rows[i]], fallbacks[i],
    snapshots[i], bases[i], edge_ids, n_edges)`` for every leaf (rows
    default to 0, the others to None)."""
    rows, fallbacks, snapshots, bases = _norm_args(xs, rows, fallbacks, snapshots, bases)
    return [masked_aggregate_plain(x, weights[r], fb, s, b, edge_ids, n_edges)
            for x, r, fb, s, b in zip(xs, rows, fallbacks, snapshots, bases)]


def _norm_args(xs, rows, *per_leaf):
    """``rows`` as ints (default 0) and each per-leaf list (default None),
    one entry a leaf of ``xs``."""
    n = len(xs)
    rows = [0] * n if rows is None else [int(r) for r in rows]
    return (rows,) + tuple([None] * n if a is None else list(a) for a in per_leaf)


def _set_edges(table: "_Table", edge_ids: torch.Tensor, n_edges: int) -> list:
    """Put the edge mode's operands in the table: the lanes in a stable
    sort by edge id, and their ids in that order (on the device). Returns
    the tensors to keep alive until the launch."""
    order = torch.argsort(edge_ids, stable=True)
    keep = [order.to(torch.int32), edge_ids.index_select(0, order).to(torch.int32)]
    table.order, table.edge, table.n_edges = keep[0].data_ptr(), keep[1].data_ptr(), n_edges
    return keep


def _record(name: str, xs, others) -> None:
    """A dry run's launch over the stacked leaves ``xs`` (C, ...): its
    weighted sums' products, 2 C n a leaf, and its bytes (``xs`` and
    ``others`` read or written once)."""
    record_launch(name, float(sum(2 * x.numel() for x in xs)), *xs, *others)


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
    rows, fallbacks, snapshots, bases = _norm_args(xs, rows, fallbacks, snapshots, bases)
    if len(xs) > MAX_LEAVES:
        raise ValueError(f"masked_aggregate_leaves takes at most {MAX_LEAVES} leaves (the "
                         f"kernel's parameter table), got {len(xs)}")
    if not xs:
        return []
    dev = xs[0].device
    fake = is_fake(xs[0])  # a dry run: the launch's outputs and its costs, nothing run
    if not _edged(edge_ids, n_edges):
        edge_ids, n_edges = None, 0
    if dev.type == "cpu" and not fake:
        return masked_aggregate_leaves_plain(xs, weights, rows, fallbacks, snapshots, bases,
                                             edge_ids, n_edges)
    if dev.type != "cuda" and not fake:
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
        if not fake:
            table.leaf[i] = _Leaf(x.data_ptr(), ptr(sn), ptr(other), out.data_ptr(), size, block,
                                  rows[i], _MODE_FALLBACK if b is None else _MODE_BASE)
        block += -(-size // _BLOCK_COLS)
    if fake:
        if block:
            _record("masked_aggregate", xs, [wc, *fallbacks, *snapshots, *bases, *outs])
        return outs
    table.w, table.n_leaves, table.c_rows = wc.data_ptr(), len(xs), wc.shape[1]
    if edge_ids is not None:
        keep += _set_edges(table, edge_ids, n_edges)
    if block == 0:  # only empty leaves: nothing to launch
        return outs
    _launch(table, block, dtype, dev)
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
    if x.device.type == "cpu" and not is_fake(x):
        return masked_aggregate_plain(x, weights, fallback)
    if x.device.type != "cuda" and not is_fake(x):
        raise ValueError(f"masked_aggregate: tensors on {x.device} have no kernel here")
    c = x.shape[0]
    if weights.shape != (c,) or weights.dtype != torch.float32 or weights.device != x.device:
        raise ValueError(f"weights must be float32 of shape ({c},) on {x.device}")
    return masked_aggregate_leaves([x], weights[None], [0], [fallback])[0]


# ---------------------------------------------------------------------------
# partial and combine modes: a reduction whose lanes are sharded over ranks
# ---------------------------------------------------------------------------


def partial_layout(sizes, n_rows: int) -> tuple[list, int, int]:
    """``(offsets, totals_at, width)`` of a rank's row of the partial buffer
    for leaves of ``sizes`` elements (a lane's) and ``n_rows`` weight rows:
    leaf i's numerator at ``offsets[i]``, row r's total at ``totals_at +
    r``, every start on a 16-byte boundary, ``width`` float32 elements in
    all."""
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += -(-int(n) // _SLOT_ALIGN) * _SLOT_ALIGN
    width = at + -(-int(n_rows) // _SLOT_ALIGN) * _SLOT_ALIGN
    return offsets, at, max(width, _SLOT_ALIGN)


def _row_owners(sizes, rows) -> list:
    """For each leaf, whether it writes its weight row's total: the first
    leaf of the row with any elements (a row with none keeps -0.0)."""
    seen, owners = set(), []
    for n, r in zip(sizes, rows):
        owners.append(n > 0 and r not in seen)
        if n > 0:
            seen.add(r)
    return owners


def masked_aggregate_partial_plain(xs, weights: torch.Tensor, rows=None, snapshots=None,
                                   edge_ids=None, n_edges: int = 0, slot: int = 0,
                                   n_slots: int = 1) -> torch.Tensor:
    """The partial mode's plain version: ``(n_slots, width)`` float32, -0.0
    but row ``slot``, which holds each leaf's numerator (``_plain_sums``:
    ``masked_aggregate_plain``'s loop stopped before the divide) at its
    ``partial_layout`` offset and each weight row's total."""
    xs = list(xs)
    rows, snapshots = _norm_args(xs, rows, snapshots)
    if not _edged(edge_ids, n_edges):
        edge_ids, n_edges = None, 0
    sizes = [x.shape[1:].numel() for x in xs]
    offsets, totals_at, width = partial_layout(sizes, weights.shape[0])
    dev = weights.device
    buf = torch.full((n_slots, width), -0.0, dtype=torch.float32, device=dev)
    for x, r, sn, n, off, own in zip(xs, rows, snapshots, sizes, offsets,
                                     _row_owners(sizes, rows)):
        num, total = _plain_sums(x, weights[r], sn, edge_ids, n_edges)
        buf[slot, off:off + n] = num.reshape(-1)
        if own:
            buf[slot, totals_at + r] = total
    return buf


def masked_aggregate_combine_plain(buf: torch.Tensor, shapes, rows=None, fallbacks=None,
                                   bases=None, dtype: torch.dtype = torch.float32) -> list:
    """The combine mode's plain version: for leaf i of shape ``shapes[i]``,
    its D numerator slots and its row's D totals summed from 0 in ascending
    rank order, then ``masked_aggregate_plain``'s epilogue (fallback or
    base) in ``dtype``."""
    shapes = [tuple(s) for s in shapes]
    rows, fallbacks, bases = _norm_args(shapes, rows, fallbacks, bases)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    offsets, totals_at, _ = partial_layout(sizes, max(rows, default=0) + 1)
    outs = []
    for shape, r, fb, b, n, off in zip(shapes, rows, fallbacks, bases, sizes, offsets):
        num = torch.zeros((n,), dtype=torch.float32, device=buf.device)
        total = torch.zeros((), dtype=torch.float32, device=buf.device)
        for d in range(buf.shape[0]):
            total = total + buf[d, totals_at + r]
            num = num + buf[d, off:off + n]
        outs.append(_plain_epilogue(num.view(shape), total, dtype, fb, b))
    return outs


def _launch(table: _Table, blocks: int, dtype: torch.dtype, dev: torch.device) -> None:
    err = _lib().repro_masked_aggregate(ctypes.byref(table), blocks, _DTYPES[dtype],
                                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_aggregate kernel launch failed: cudaError {err}")


def masked_aggregate_partial(xs, weights: torch.Tensor, rows=None, snapshots=None,
                             edge_ids=None, n_edges: int = 0, slot: int = 0,
                             n_slots: int = 1) -> torch.Tensor:
    """The partial mode: this rank's lanes ``xs[i]`` (L, ...) reduced with
    row ``rows[i]`` of ``weights`` (R, L) (``snapshots``, ``edge_ids`` and
    ``n_edges`` as in ``masked_aggregate_leaves``) to float32 numerators and
    row totals, written into row ``slot`` of a new ``(n_slots, width)``
    float32 buffer whose other rows are -0.0 (``partial_layout``). CPU
    tensors run the plain version; on CUDA one kernel launch covers every
    leaf."""
    xs = list(xs)
    rows, snapshots = _norm_args(xs, rows, snapshots)
    if len(xs) > MAX_LEAVES:
        raise ValueError(f"masked_aggregate_partial takes at most {MAX_LEAVES} leaves, "
                         f"got {len(xs)}")
    if not 0 <= slot < n_slots:
        raise ValueError(f"slot {slot} outside the {n_slots} slots")
    if not xs:
        raise ValueError("masked_aggregate_partial needs at least one leaf")
    dev = xs[0].device
    fake = is_fake(xs[0])  # a dry run: the launch's outputs and its costs, nothing run
    if not _edged(edge_ids, n_edges):
        edge_ids, n_edges = None, 0
    if dev.type == "cpu" and not fake:
        return masked_aggregate_partial_plain(xs, weights, rows, snapshots, edge_ids, n_edges,
                                              slot, n_slots)
    if dev.type != "cuda" and not fake:
        raise ValueError(f"masked_aggregate: tensors on {dev} have no kernel here")
    n = len(xs)
    _check(xs, weights, rows, [None] * n, snapshots, [None] * n, edge_ids)
    wc = weights.contiguous()
    sizes = [x.shape[1:].numel() for x in xs]
    offsets, totals_at, width = partial_layout(sizes, wc.shape[0])
    buf = torch.full((n_slots, width), -0.0, dtype=torch.float32, device=dev)
    row = buf[slot]
    table, keep, block = _Table(), [], 0
    for i, (x, sn, size, off, own) in enumerate(zip(xs, snapshots, sizes, offsets,
                                                    _row_owners(sizes, rows))):
        x, sn = (None if t is None else t.contiguous() for t in (x, sn))
        keep += [x, sn]
        if not fake:
            tot = row[totals_at + rows[i]].data_ptr() if own else None
            table.leaf[i] = _Leaf(x.data_ptr(), None if sn is None else sn.data_ptr(), tot,
                                  row[off:].data_ptr(), size, block, rows[i], _MODE_PARTIAL)
        block += -(-size // _BLOCK_COLS)
    if fake:
        if block:
            _record("masked_aggregate_partial", xs, [wc, *snapshots, row])
        return buf
    table.w, table.n_leaves, table.c_rows = wc.data_ptr(), n, wc.shape[1]
    if edge_ids is not None:
        keep += _set_edges(table, edge_ids, n_edges)
    if block == 0:
        return buf
    _launch(table, block, xs[0].dtype, dev)
    masked_aggregate_partial.launches += 1
    return buf


masked_aggregate_partial.launches = 0


def masked_aggregate_combine(buf: torch.Tensor, shapes, rows=None, fallbacks=None, bases=None,
                             dtype: torch.dtype = torch.float32) -> list:
    """The combine mode: the leaves of shapes ``shapes`` from the filled
    ``(D, width)`` partial buffer (every rank's row, ``partial_layout``),
    each its D slots summed in ascending rank order, divided by its row's
    summed total, with ``fallbacks[i]`` where that total is 0 or ``base +
    mean`` for a leaf with ``bases[i]``, in ``dtype`` (float32 or
    bfloat16). CPU tensors run the plain version; on CUDA one kernel launch
    covers every leaf, and the outputs are views of one buffer."""
    shapes = [tuple(s) for s in shapes]
    rows, fallbacks, bases = _norm_args(shapes, rows, fallbacks, bases)
    if len(shapes) > MAX_LEAVES:
        raise ValueError(f"masked_aggregate_combine takes at most {MAX_LEAVES} leaves, "
                         f"got {len(shapes)}")
    dev = buf.device
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    offsets, totals_at, _ = partial_layout(sizes, max(rows, default=0) + 1)
    if (buf.ndim != 2 or buf.dtype != torch.float32
            or buf.shape[1] <= totals_at + max(rows, default=0)):
        raise ValueError(f"the partial buffer must be a float32 (D, width) matrix with "
                         f"width > {totals_at + max(rows, default=0)}, got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    fake = is_fake(buf)  # a dry run: the launch's outputs and its costs, nothing run
    if dev.type == "cpu" and not fake:
        return masked_aggregate_combine_plain(buf, shapes, rows, fallbacks, bases, dtype)
    if dev.type != "cuda" and not fake:
        raise ValueError(f"masked_aggregate: tensors on {dev} have no kernel here")
    if dtype not in _DTYPES:
        raise TypeError(f"masked_aggregate_combine writes float32 or bfloat16, got {dtype}")
    for shape, fb, b in zip(shapes, fallbacks, bases):
        if fb is not None and b is not None:
            raise ValueError("masked_aggregate: a leaf takes a fallback or a base, not both")
        for name, t in (("fallback", fb), ("base", b)):
            if t is not None and (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev):
                raise ValueError(f"{name} must be {dtype} of shape {shape} on {dev}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
    src = buf.contiguous()
    align = 16 // dtype.itemsize
    out_at = [0]
    for n in sizes:
        out_at.append(out_at[-1] + -(-n // align) * align)
    out_buf = torch.empty(out_at[-1], dtype=dtype, device=dev)
    table, keep, outs, block = _Table(), [src], [], 0
    for i, (shape, fb, b, size, off, o) in enumerate(zip(shapes, fallbacks, bases, sizes,
                                                         offsets, out_at)):
        other = fb if b is None else b
        other = None if other is None else other.contiguous()
        keep.append(other)
        out = out_buf[o:o + size]
        outs.append(out.view(shape))
        if not fake:
            table.leaf[i] = _Leaf(src[0, off:].data_ptr(), src[0, totals_at + rows[i]].data_ptr(),
                                  None if other is None else other.data_ptr(), out.data_ptr(),
                                  size, block, rows[i],
                                  _MODE_FALLBACK if b is None else _MODE_BASE)
        block += -(-size // _BLOCK_COLS)
    if fake:
        if block:
            record_launch("masked_aggregate_combine", float(src.shape[0] * sum(sizes)),
                          src, *fallbacks, *bases, *outs)
        return outs
    table.n_leaves, table.c_rows, table.slot_stride = len(shapes), src.shape[0], src.shape[1]
    if block == 0:
        return outs
    _launch(table, block, dtype, dev)
    masked_aggregate_combine.launches += 1
    return outs


masked_aggregate_combine.launches = 0
