"""Selective scan with a memory-lean gradient — the port of the JAX
package's ``models/ssm_vjp.py``.

The JAX module's custom VJP saves only the state at the start of each
``CHUNK``-step chunk in its forward and recomputes each chunk's states in
its backward, instead of keeping the (S, B, di, ds) trajectory that
autodiff of a scan would. ``selective_scan`` here is that VJP as a
``torch.autograd.Function`` over the port's two kernels: the forward is
``kernels.ssm_scan`` with ``chunk_states=True`` (the kernel writes the
chunk start states as it goes), the backward ``kernels.ssm_scan_bwd``
(``csrc/ssm_scan_bwd.cu``, ``ssm_vjp._bwd``'s chunk-by-chunk recompute and
reverse recurrence). CPU tensors run both through their plain versions.

The recurrence (Mamba-1), from h = 0:

    h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t
    y_t = <h_t, C_t> + D x_t

Casts follow the JAX model (``layers.mamba_block``): the scan's inputs
stream in bf16 and are upcast to float32 in the step, and their cotangents
come back rounded to the streams' type, as JAX's ``astype`` VJPs round
them. The JAX block's environment switches ``REPRO_MAMBA_VJP`` and
``REPRO_MAMBA_SCAN_DTYPE`` (A/B levers of the reference) are not ported:
the port always trains through this Function on bf16 streams.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
from repro_torch.kernels.ssm_scan.ops import CHUNK

__all__ = ["CHUNK", "selective_scan"]


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, a, bmat, cmat, x, d, y_dtype):
        y, h, h_starts = ssm_scan(dt, a, bmat, cmat, x, d, y_dtype=y_dtype, chunk_states=True)
        ctx.save_for_backward(dt, a, bmat, cmat, x, d, h_starts)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        dt, a, bmat, cmat, x, d, h_starts = ctx.saved_tensors
        return (*ssm_scan_bwd(dt, a, bmat, cmat, x, d, h_starts, gy, gh), None)


def selective_scan(dt, a, bmat, cmat, x, d, y_dtype=torch.float32):
    """``(y (B, S, di), h (B, di, ds))`` of the selective scan from h = 0,
    differentiable in all six inputs. dt and x (B, S, di) and bmat and cmat
    (B, S, ds) of one stream type (float32 or bfloat16), a (di, ds) and d
    (di,) float32; y in ``y_dtype`` (float32, as the JAX function returns
    it, or the model's dtype, the cast the JAX block applies next), h
    float32. The gradients come back in the inputs' dtypes."""
    return _SelectiveScan.apply(dt, a, bmat, cmat, x, d, y_dtype)
