"""masked_aggregate — the paper's Eq. 1 server reduction on one stacked leaf.

Replaces the JAX package's Pallas kernel
``src/repro/kernels/masked_aggregate/kernel.py`` (``masked_aggregate_kernel``/
``_agg_kernel``) with the hand-written CUDA kernel in
``repro_torch/csrc/masked_aggregate.cu``; that file's header states its bound
on the H100 (bytes: x read once, ~4 B per client element) and its design.
In the JAX package this function is computed in jnp by
``core/aggregation._weighted_mean`` and the Pallas kernel is only tested;
in the port it is the aggregators' path.

- ``masked_aggregate_plain``: the plain PyTorch version — clients summed
  in ascending order in float32, one rounding per product and per sum, as
  the kernel does, so the kernel is held to it within 1 ulp (bitwise in
  practice);
- ``masked_aggregate``: the wrapper, dispatching on the tensor's device (CPU
  -> plain, CUDA -> kernel or raise);
- ``masked_aggregate.launches``: the kernel's launch counter.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["masked_aggregate", "masked_aggregate_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def masked_aggregate_plain(x: torch.Tensor, weights: torch.Tensor,
                           fallback: torch.Tensor | None = None) -> torch.Tensor:
    """``sum_c w_c x[c] / max(sum w, 1e-12)``, or ``fallback`` (zeros when
    None) where ``sum w == 0``, for a stacked leaf ``x`` (C, ...); float32
    accumulation, result in x's dtype."""
    w = weights.to(torch.float32)
    num = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(x.shape[0]):
        total = total + w[c]
        num = num + w[c] * x[c].to(torch.float32)
    mean = num / torch.clamp_min(total, 1e-12)
    fb = torch.zeros_like(mean) if fallback is None else fallback.to(torch.float32)
    return torch.where(total > 0, mean, fb).to(x.dtype)


def _lib():
    lib = build.load("masked_aggregate")
    if not getattr(lib, "_repro_typed", False):
        p = ctypes.c_void_p
        lib.repro_masked_aggregate.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int64,
                                               ctypes.c_int, p]
        lib.repro_masked_aggregate.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def masked_aggregate(x: torch.Tensor, weights: torch.Tensor,
                     fallback: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted mean of a stacked leaf ``x`` (C, ...) over its client axis,
    with ``fallback`` (shape ``x.shape[1:]``, x's dtype; None = zeros) where
    the weights sum to 0. float32 or bfloat16 ``x``; the result has x's
    dtype. CPU tensors run ``masked_aggregate_plain``; CUDA tensors launch
    the kernel."""
    if x.device.type == "cpu":
        return masked_aggregate_plain(x, weights, fallback)
    if x.device.type != "cuda":
        raise ValueError(f"masked_aggregate: tensors on {x.device} have no kernel here")
    if x.dtype not in _DTYPES:
        raise TypeError(f"masked_aggregate takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[0]
    if weights.shape != (c,) or weights.dtype != torch.float32 or weights.device != x.device:
        raise ValueError(f"weights must be float32 of shape ({c},) on {x.device}")
    if fallback is not None and (fallback.shape != x.shape[1:] or fallback.dtype != x.dtype
                                 or fallback.device != x.device):
        raise ValueError(f"fallback must be {x.dtype} of shape {tuple(x.shape[1:])} on {x.device}")
    xc = x.contiguous()
    wc = weights.contiguous()
    fc = fallback.contiguous() if fallback is not None else None
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    p_cols = out.numel()
    err = _lib().repro_masked_aggregate(
        xc.data_ptr(), wc.data_ptr(), fc.data_ptr() if fc is not None else None,
        out.data_ptr(), c, p_cols, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_aggregate kernel launch failed: cudaError {err}")
    masked_aggregate.launches += 1
    return out


masked_aggregate.launches = 0
