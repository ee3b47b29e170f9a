"""Per-block absmax int8/int4 quantize/dequantize — the codec's kernel pair.

Replaces the JAX package's Pallas pair in
``src/repro/kernels/quantize/kernel.py`` (``quantize_kernel``/``_quant_kernel``
and ``dequantize_kernel``/``_dequant_kernel``) with the hand-written CUDA
kernels in ``repro_torch/csrc/quantize.cu``; that file's header states their
bound on the H100 (bytes: ~9 B/element for quantize, ~5 for dequantize) and
what the design does about it.

Each op has three parts here:

- a plain PyTorch version (``quantize_plain``/``dequantize_plain``, and
  ``quantize_leaves_plain``/``dequantize_leaves_plain`` over a list of
  leaves) with the arithmetic of the JAX ``ref.py`` oracle: the CPU path,
  and what the card's kernel is held to bitwise;
- a wrapper (``quantize_leaves`` and ``dequantize_leaves``, with
  ``quantize`` and ``dequantize`` their one-leaf cases) that dispatches on
  the tensor's device: CPU tensors take the plain version, CUDA tensors
  launch the kernel (or raise), nothing falls back;
- a launch counter, ``quantize_leaves.launches``/
  ``dequantize_leaves.launches``, a plain integer the wrapper bumps where it
  launches the kernel and nowhere else.

The ops take a batch: ``x`` of shape ``(..., n)`` is ``R`` rows of ``n``
elements and every row is cut into blocks on its own (``quant_blocks``), as
the JAX package's per-client vmap cuts each client's leaf — so all K client
lanes of a leaf go through one launch, and each op takes a round's leaves
in one launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.cost import is_fake, record_launch

__all__ = ["quant_blocks", "quantize", "quantize_leaves", "dequantize", "dequantize_leaves",
           "quantize_plain", "quantize_leaves_plain", "dequantize_plain",
           "dequantize_leaves_plain"]

MAX_LEAVES = 64  # leaves a launch (the kernels' parameter tables)
_DQ_BLOCKS = 4    # quant blocks a dequantize thread block covers (when bp <= _DQ_STRIDE)
_DQ_STRIDE = 512  # elements a dequantize thread block's threads take at once


class _Leaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("u", ctypes.c_void_p), ("q", ctypes.c_void_p),
                ("scales", ctypes.c_void_p), ("n", ctypes.c_int64), ("block0", ctypes.c_int64),
                ("bp", ctypes.c_int), ("nb", ctypes.c_int)]


class _Table(ctypes.Structure):
    _fields_ = [("leaf", _Leaf * MAX_LEAVES), ("n_leaves", ctypes.c_int),
                ("qmax", ctypes.c_float), ("inv_qmax", ctypes.c_float)]


class _DqLeaf(ctypes.Structure):
    _fields_ = [("q", ctypes.c_void_p), ("scales", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_int64), ("block0", ctypes.c_int64), ("bp", ctypes.c_int),
                ("nb", ctypes.c_int), ("bpc", ctypes.c_int), ("per_row", ctypes.c_int)]


class _DqTable(ctypes.Structure):
    _fields_ = [("leaf", _DqLeaf * MAX_LEAVES), ("n_leaves", ctypes.c_int)]


def quant_blocks(n: int, block_p: int = 512) -> tuple[int, int]:
    """(block, n_blocks) for an n-element row — shared with the codec's wire
    accounting (the JAX wrapper's ``quant_blocks``)."""
    bp = min(block_p, max(n, 8))
    return bp, -(-n // bp)


def _qmax(bits: int) -> tuple[float, float]:
    """``(qmax, float32(1 / qmax))``. The scale is ``amax * (1 / qmax)``:
    XLA rewrites the JAX oracle's division by the constant ``qmax`` into
    that product, and the goldens were made with it (a true division
    differs in the last bit of many scales: 4.5% of int8 and 62% of int4
    scales of random 512-blocks)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    return qmax, ctypes.c_float(1.0 / qmax).value  # the double quotient rounded once to float32


def quantize_plain(x: torch.Tensor, noise: torch.Tensor | None = None, bits: int = 8,
                   block_p: int = 512):
    """``(q, scales)`` for ``x`` of shape (..., n): int8 codes (..., n) and
    float32 scales (..., nb). ``noise`` None rounds to nearest (u = 0.5).
    Codes of a block whose scale is NaN are 0 (the kernel's convention)."""
    qmax, inv_qmax = _qmax(bits)
    lead, n = x.shape[:-1], x.shape[-1]
    bp, nb = quant_blocks(n, block_p)
    xf = x.to(torch.float32).reshape(-1, n)
    u = (torch.full_like(xf, 0.5) if noise is None
         else noise.to(torch.float32).reshape(-1, n))
    pad = nb * bp - n
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
        u = torch.nn.functional.pad(u, (0, pad))
    xb = xf.reshape(-1, nb, bp)
    ub = u.reshape(-1, nb, bp)
    scales = torch.clamp_min(torch.amax(torch.abs(xb), dim=-1), 1e-12) * inv_qmax
    q = torch.clamp(torch.floor(xb / scales[..., None] + ub), -qmax, qmax)
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8).reshape(-1, nb * bp)[:, :n]
    return q.reshape(*lead, n), scales.reshape(*lead, nb)


def quantize_leaves_plain(xs, noises=None, bits: int = 8, block_p: int = 512) -> list:
    """``quantize_plain(xs[i], noises[i])`` for every leaf (noises default to
    None: round to nearest)."""
    noises = [None] * len(xs) if noises is None else noises
    return [quantize_plain(x, u, bits=bits, block_p=block_p) for x, u in zip(xs, noises)]


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor, block_p: int = 512) -> torch.Tensor:
    """float32 ``q * scale[block]`` for codes (..., n) and scales (..., nb)."""
    n = q.shape[-1]
    bp, nb = quant_blocks(n, block_p)
    qf = q.to(torch.float32).reshape(-1, n)
    pad = nb * bp - n
    if pad:
        qf = torch.nn.functional.pad(qf, (0, pad))
    out = qf.reshape(-1, nb, bp) * scales.reshape(-1, nb, 1)
    return out.reshape(-1, nb * bp)[:, :n].reshape(q.shape)


def dequantize_leaves_plain(codes, block_p: int = 512) -> list:
    """``dequantize_plain(q, scales)`` for every ``(q, scales)`` leaf."""
    return [dequantize_plain(q, scales, block_p=block_p) for q, scales in codes]


def _lib():
    lib = build.load("quantize")
    if not getattr(lib, "_repro_typed", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.repro_quantize_leaves.argtypes = [ctypes.POINTER(_Table), i64, p]
        lib.repro_quantize_leaves.restype = i32
        lib.repro_dequantize_leaves.argtypes = [ctypes.POINTER(_DqTable), i64, p]
        lib.repro_dequantize_leaves.restype = i32
        lib._repro_typed = True
    return lib


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda" and not is_fake(t):
        raise ValueError(f"{what}: tensors on {t.device} have no kernel here")


def _too_many_leaves(what: str, n: int) -> ValueError:
    return ValueError(f"{what} takes at most {MAX_LEAVES} leaves (the kernel's parameter "
                      f"table), got {n}")


def quantize_leaves(xs, noises=None, bits: int = 8, block_p: int = 512) -> list:
    """Quantize every leaf ``xs[i]`` (..., n_i) float32 row by row, with its
    noise ``noises[i]`` (x's shape, float32; None rounds to nearest):
    ``[(q (..., n_i) int8, scales (..., nb_i) float32), ...]``, at most 64
    leaves (the kernel's parameter table). CPU tensors run
    ``quantize_leaves_plain``; on CUDA one kernel launch covers every leaf."""
    xs = list(xs)
    noises = [None] * len(xs) if noises is None else list(noises)
    if len(noises) != len(xs):
        raise ValueError("quantize_leaves: one noise (or None) per leaf")
    if len(xs) > MAX_LEAVES:
        raise _too_many_leaves("quantize_leaves", len(xs))
    if not xs:
        return []
    dev = xs[0].device
    fake = is_fake(xs[0])  # a dry run: the launch's outputs and its costs, nothing run
    if dev.type == "cpu" and not fake:
        return quantize_leaves_plain(xs, noises, bits=bits, block_p=block_p)
    _require_cuda(xs[0], "quantize")
    qmax, inv_qmax = _qmax(bits)
    table, keep, outs, block = _Table(), [], [], 0  # keep: contiguous copies live until the launch
    for x, u in zip(xs, noises):
        if x.dtype != torch.float32 or x.device != dev:
            raise TypeError(f"quantize takes float32 leaves on {dev}, got {x.dtype} on {x.device}")
        if u is not None and (u.shape != x.shape or u.dtype != torch.float32 or u.device != dev):
            raise ValueError("noise must be float32 of x's shape on x's device")
        lead, n = x.shape[:-1], x.shape[-1]
        bp, nb = quant_blocks(n, block_p)
        xc = x.contiguous()
        uc = None if u is None else u.contiguous()
        keep += [xc, uc]
        q = torch.empty(x.shape, dtype=torch.int8, device=dev)
        scales = torch.empty((*lead, nb), dtype=torch.float32, device=dev)
        outs.append((q, scales))
        blocks = (xc.numel() // n if n else 0) * nb
        if blocks and not fake:
            table.leaf[table.n_leaves] = _Leaf(xc.data_ptr(), None if uc is None else uc.data_ptr(),
                                               q.data_ptr(), scales.data_ptr(), n, block, bp, nb)
            table.n_leaves += 1
        block += blocks
    if block == 0:  # only empty leaves: nothing to launch
        return outs
    if fake:
        record_launch("quantize", 0.0, *xs, *noises, *(t for o in outs for t in o))
        return outs
    table.qmax, table.inv_qmax = qmax, inv_qmax
    err = _lib().repro_quantize_leaves(ctypes.byref(table), block, _stream(xs[0]))
    _check_launch(err, "quantize")
    quantize_leaves.launches += 1
    return outs


def quantize(x: torch.Tensor, noise: torch.Tensor | None = None, bits: int = 8,
             block_p: int = 512):
    """Quantize ``x`` (..., n) float32 row by row: ``(q (..., n) int8,
    scales (..., nb) float32)``, the one-leaf case of ``quantize_leaves``.
    CPU tensors run ``quantize_plain``; CUDA tensors launch the kernel."""
    return quantize_leaves([x], [noise], bits=bits, block_p=block_p)[0]


def dequantize_leaves(codes, block_p: int = 512) -> list:
    """float32 ``q * scale[block]`` for every leaf ``(q (..., n_i) int8,
    scales (..., nb_i) float32)``, at most 64 leaves (the kernel's parameter
    table). CPU tensors run ``dequantize_leaves_plain``; on CUDA one kernel
    launch covers every leaf."""
    codes = list(codes)
    if len(codes) > MAX_LEAVES:
        raise _too_many_leaves("dequantize_leaves", len(codes))
    if not codes:
        return []
    dev = codes[0][0].device
    fake = is_fake(codes[0][0])  # a dry run: the launch's outputs and its costs, nothing run
    if dev.type == "cpu" and not fake:
        return dequantize_leaves_plain(codes, block_p=block_p)
    _require_cuda(codes[0][0], "dequantize")
    table, keep, outs, block = _DqTable(), [], [], 0  # keep: contiguous copies live until the launch
    for q, scales in codes:
        if q.dtype != torch.int8 or scales.dtype != torch.float32:
            raise TypeError(f"dequantize takes int8 codes and float32 scales, got {q.dtype}, "
                            f"{scales.dtype}")
        n = q.shape[-1]
        bp, nb = quant_blocks(n, block_p)
        if scales.shape != (*q.shape[:-1], nb) or q.device != dev or scales.device != dev:
            raise ValueError(f"scales must be {(*q.shape[:-1], nb)} float32 on {dev} beside "
                             f"codes {tuple(q.shape)} on {q.device}")
        qc, sc = q.contiguous(), scales.contiguous()
        keep += [qc, sc]
        out = torch.empty(q.shape, dtype=torch.float32, device=dev)
        outs.append(out)
        rows = qc.numel() // n if n else 0
        bpc = _DQ_BLOCKS if bp <= _DQ_STRIDE else 1
        per_row = -(-nb // bpc)
        if rows and not fake:
            table.leaf[table.n_leaves] = _DqLeaf(qc.data_ptr(), sc.data_ptr(), out.data_ptr(), n,
                                                 block, bp, nb, bpc, per_row)
            table.n_leaves += 1
        block += rows * per_row
    if block == 0:  # only empty leaves: nothing to launch
        return outs
    if fake:
        record_launch("dequantize", 0.0, *(t for c in codes for t in c), *outs)
        return outs
    err = _lib().repro_dequantize_leaves(ctypes.byref(table), block, _stream(codes[0][0]))
    _check_launch(err, "dequantize")
    dequantize_leaves.launches += 1
    return outs


def dequantize(q: torch.Tensor, scales: torch.Tensor, block_p: int = 512) -> torch.Tensor:
    """float32 ``q * scale[block]`` for codes (..., n) int8 and scales
    (..., nb), the one-leaf case of ``dequantize_leaves``. CPU tensors run
    ``dequantize_plain``; CUDA tensors launch the kernel."""
    return dequantize_leaves([(q, scales)], block_p=block_p)[0]


quantize_leaves.launches = 0
dequantize_leaves.launches = 0
