"""ssm_scan — the Mamba-1 selective scan of a prefill, from h = 0.

Replaces the JAX package's Pallas kernel
``src/repro/kernels/ssm_scan/kernel.py`` (``ssm_scan_kernel``/``_ssm_kernel``)
with the hand-written CUDA kernel in ``repro_torch/csrc/ssm_scan.cu``; that
file's header states its bound on the H100 (the exps on the special-function
unit) and its design (a channel's states split over lanes, the sequence in
registers, chunks staged in shared memory with cp.async).
In the JAX package the model's prefill runs a chunked ``lax.scan``
(``models/layers.py:mamba_block``) and the Pallas kernel is its TPU
equivalent; in the port the kernel is the prefill's path.

- ``ssm_scan_plain``: the plain PyTorch version — the layer's own step,
  ``h = exp(dt*A)*h + (dt*B)*x`` and ``y = sum(h*C) + D*x`` in float32 (or
  ``acc_dtype``), one step at a time (the Pallas kernel computes
  ``(dt*x)*B``, which differs from the layer's order in the last bit of
  some elements). In float64 it is the reference of the kernel's contract
  (``contract.py``): the kernel takes exp on the special-function unit and
  fuses multiply-adds, so it does not follow the float32 version bitwise;
- ``ssm_scan``: the wrapper, dispatching on the tensor's device (CPU ->
  plain, CUDA -> kernel or raise);
- ``ssm_scan.launches``: the kernel's launch counter.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["ssm_scan", "ssm_scan_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATE_SIZES = (8, 16)


def ssm_scan_plain(dt, a, bmat, cmat, x, d, y_dtype=None, acc_dtype=torch.float32):
    """``(y (B, S, di), h (B, di, ds))`` of the selective scan from h = 0.
    dt/x (B, S, di), bmat/cmat (B, S, ds) of any float type (upcast to
    ``acc_dtype``, float32 or float64, in the step), a (di, ds), d (di,).
    y has ``y_dtype`` (default x's dtype), h is ``acc_dtype``."""
    bsz, s, di = x.shape
    a_acc, d_acc = a.to(acc_dtype), d.to(acc_dtype)
    h = torch.zeros((bsz, di, a.shape[1]), dtype=acc_dtype, device=x.device)
    ys = []
    for t in range(s):
        dt_t, b_t = dt[:, t].to(acc_dtype), bmat[:, t].to(acc_dtype)
        c_t, x_t = cmat[:, t].to(acc_dtype), x[:, t].to(acc_dtype)
        da = torch.exp(dt_t[..., None] * a_acc[None])
        h = da * h + dt_t[..., None] * b_t[:, None, :] * x_t[..., None]
        ys.append((h * c_t[:, None, :]).sum(-1) + d_acc * x_t)
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bsz, 0, di), dtype=acc_dtype)
    return y.to(y_dtype or x.dtype), h


def _lib():
    lib = build.load("ssm_scan")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssm_scan.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.repro_ssm_scan.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def ssm_scan(dt, a, bmat, cmat, x, d, y_dtype=None):
    """The selective scan of ``ssm_scan_plain``. CPU tensors run the plain
    version; CUDA tensors launch the kernel (held to ``contract.py``, not
    bitwise to the plain version), which takes dt, bmat, cmat and x of one
    stream type (float32 or bfloat16), a and d in float32, d_state 8 or 16,
    and writes y in ``y_dtype`` (float32 or bfloat16; default x's dtype)."""
    if x.device.type == "cpu":
        return ssm_scan_plain(dt, a, bmat, cmat, x, d, y_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: tensors on {x.device} have no kernel here")
    y_dtype = y_dtype or x.dtype
    if x.dtype not in _DTYPES or y_dtype not in _DTYPES:
        raise TypeError(f"ssm_scan streams float32 or bfloat16, got x {x.dtype}, y {y_dtype}")
    bsz, s, di = x.shape
    ds = a.shape[-1]
    if ds not in _STATE_SIZES:
        raise NotImplementedError(f"ssm_scan kernel takes d_state in {_STATE_SIZES}, got {ds}")
    for name, t, shape, dtype in (("dt", dt, (bsz, s, di), x.dtype),
                                  ("bmat", bmat, (bsz, s, ds), x.dtype),
                                  ("cmat", cmat, (bsz, s, ds), x.dtype),
                                  ("a", a, (di, ds), torch.float32),
                                  ("d", d, (di,), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"ssm_scan: {name} must be {dtype} of shape {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    args = [t.contiguous() for t in (dt, a, bmat, cmat, x, d)]
    y = torch.empty((bsz, s, di), dtype=y_dtype, device=x.device)
    h = torch.empty((bsz, di, ds), dtype=torch.float32, device=x.device)
    err = _lib().repro_ssm_scan(
        *(t.data_ptr() for t in args), y.data_ptr(), h.data_ptr(), bsz, s, di, ds,
        _DTYPES[x.dtype], _DTYPES[y_dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {err}")
    ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0
