"""ssm_scan — the Mamba-1 selective scan of a prefill, from h = 0 or from
a carried state ``h0`` (a prefill that continues a cache).

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
  plain, CUDA -> kernel or raise); ``chunk_states=True`` also returns the
  state at the start of every ``CHUNK`` steps (training's residuals);
- ``ssm_scan.launches``: the kernel's launch counter.

Training (the JAX package's ``models/ssm_vjp.py`` custom VJP; its Pallas
kernel has no backward; ``repro_torch.models.ssm_vjp.selective_scan`` is
the autograd Function over these):

- ``ssm_scan_backward_plain``: ``ssm_vjp._bwd`` step for step — for each
  chunk, last to first, its states recomputed from its start state, then
  the reverse recurrence — in float32, or float64 for the contract;
- ``ssm_scan_bwd``: the wrapper (CPU -> plain; CUDA -> the kernel in
  ``repro_torch/csrc/ssm_scan_bwd.cu``, held to ``contract.bwd_check``);
  ``ssm_scan_bwd.launches`` counts its calls (one call enqueues its two
  grids); ``ssm_scan_bwd_occupancy`` reads its main grid's registers,
  spills, shared memory and resident blocks an SM from the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.cost import is_fake, record_launch

__all__ = ["CHUNK", "ssm_scan", "ssm_scan_backward_plain", "ssm_scan_bwd",
           "ssm_scan_bwd_occupancy", "ssm_scan_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATE_SIZES = (8, 16)
CHUNK = 128  # steps between the states training keeps (ssm_vjp.CHUNK)
BWD_BLOCK_CHANNELS = 64  # channels a block of the backward's main grid holds (its kChannels)


def ssm_scan_plain(dt, a, bmat, cmat, x, d, y_dtype=None, acc_dtype=torch.float32,
                   chunk_states: bool = False, h0=None):
    """``(y (B, S, di), h (B, di, ds))`` of the selective scan from ``h0``
    (B, di, ds), the state before step 0 (None: zeros).
    dt/x (B, S, di), bmat/cmat (B, S, ds) of any float type (upcast to
    ``acc_dtype``, float32 or float64, in the step), a (di, ds), d (di,).
    y has ``y_dtype`` (default x's dtype), h is ``acc_dtype``.
    ``chunk_states``: also the state before steps 0, CHUNK, 2 CHUNK, ...,
    (ceil(S / CHUNK), B, di, ds) in ``acc_dtype``."""
    bsz, s, di = x.shape
    a_acc, d_acc = a.to(acc_dtype), d.to(acc_dtype)
    h = (torch.zeros((bsz, di, a.shape[1]), dtype=acc_dtype, device=x.device) if h0 is None
         else h0.to(device=x.device, dtype=acc_dtype))
    ys, starts = [], []
    for t in range(s):
        if t % CHUNK == 0:
            starts.append(h)
        dt_t, b_t = dt[:, t].to(acc_dtype), bmat[:, t].to(acc_dtype)
        c_t, x_t = cmat[:, t].to(acc_dtype), x[:, t].to(acc_dtype)
        da = torch.exp(dt_t[..., None] * a_acc[None])
        h = da * h + dt_t[..., None] * b_t[:, None, :] * x_t[..., None]
        ys.append((h * c_t[:, None, :]).sum(-1) + d_acc * x_t)
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bsz, 0, di), dtype=acc_dtype)
    if chunk_states:
        hs = torch.stack(starts) if starts else h.new_zeros((0, *h.shape))
        return y.to(y_dtype or x.dtype), h, hs
    return y.to(y_dtype or x.dtype), h


def ssm_scan_backward_plain(dt, a, bmat, cmat, x, d, h_starts, gy, gh=None,
                            acc_dtype=torch.float32):
    """The gradients ``(d_dt, d_a, d_b, d_c, d_x, d_d)`` of the scan's ``(y,
    h)`` with cotangents ``gy`` (B, S, di) and ``gh`` (B, di, ds; None =
    0), from the chunk start states ``h_starts`` (ceil(S / CHUNK), B, di,
    ds): ``ssm_vjp._bwd`` step for step in ``acc_dtype``. For each chunk,
    last to first, its states again from its start state (``(dt x) B``, the
    JAX function's order), then from its last step down: g += gy C; d_dt =
    sum_n g A da h_{t-1} + (sum_n g B) x; d_b = sum_c g dt x; d_c = sum_c h
    gy; d_x = dt sum_n g B (+ D gy at the end); d_A += dt g da h_{t-1};
    g *= da. All six in ``acc_dtype``."""
    f = lambda t: t.to(acc_dtype)  # noqa: E731
    bsz, s, di = x.shape
    dt_, b_, c_, x_, gy_, a_ = f(dt), f(bmat), f(cmat), f(x), f(gy), f(a)
    g = f(gh) if gh is not None else torch.zeros((bsz, di, a.shape[1]), dtype=acc_dtype,
                                                  device=x.device)
    d_dt, d_xs = torch.zeros_like(dt_), torch.zeros_like(x_)
    d_b, d_c = torch.zeros_like(b_), torch.zeros_like(c_)
    d_a = torch.zeros_like(a_)
    for ci in reversed(range(-(-s // CHUNK))):
        steps = range(ci * CHUNK, min(s, (ci + 1) * CHUNK))
        h, hs = f(h_starts[ci]), []
        for t in steps:  # the chunk's states: (h_{t-1}, h_t)
            da = torch.exp(dt_[:, t, :, None] * a_[None])
            hs.append((h, da * h + (dt_[:, t] * x_[:, t])[..., None] * b_[:, t, None, :]))
            h = hs[-1][1]
        da_sum = torch.zeros_like(g)
        for t in reversed(steps):
            h_tm1, h_t = hs[t - steps.start]
            dt_t, x_t, b_t, gy_t = dt_[:, t], x_[:, t], b_[:, t], gy_[:, t]
            da = torch.exp(dt_t[..., None] * a_[None])
            g = g + gy_t[..., None] * c_[:, t, None, :]
            gb_sum = (g * b_t[:, None, :]).sum(-1)
            d_dt[:, t] = (g * (a_[None] * da * h_tm1)).sum(-1) + gb_sum * x_t
            d_b[:, t] = (g * (dt_t * x_t)[..., None]).sum(1)
            d_c[:, t] = (h_t * gy_t[..., None]).sum(1)
            d_xs[:, t] = dt_t * gb_sum
            da_sum = da_sum + dt_t[..., None] * g * da * h_tm1
            g = g * da
        d_a = d_a + da_sum.sum(0)
    return d_dt, d_a, d_b, d_c, d_xs + f(d) * gy_, (gy_ * x_).sum((0, 1))


def _lib():
    lib = build.load("ssm_scan")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssm_scan.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.repro_ssm_scan.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check(name: str, dt, a, bmat, cmat, x, d) -> None:
    """Raise for what the CUDA kernels do not take (a dry run's fake
    tensors stand for the card's, whatever their device)."""
    if x.device.type != "cuda" and not is_fake(x):
        raise ValueError(f"{name}: tensors on {x.device} have no kernel here")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} streams float32 or bfloat16, got x {x.dtype}")
    bsz, s, di = x.shape
    ds = a.shape[-1]
    if ds not in _STATE_SIZES:
        raise NotImplementedError(f"{name} kernel takes d_state in {_STATE_SIZES}, got {ds}")
    for arg, t, shape, dtype in (("dt", dt, (bsz, s, di), x.dtype),
                                 ("bmat", bmat, (bsz, s, ds), x.dtype),
                                 ("cmat", cmat, (bsz, s, ds), x.dtype),
                                 ("a", a, (di, ds), torch.float32),
                                 ("d", d, (di,), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name}: {arg} must be {dtype} of shape {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def ssm_scan(dt, a, bmat, cmat, x, d, y_dtype=None, chunk_states: bool = False, h0=None):
    """The selective scan of ``ssm_scan_plain``, from ``h0`` (B, di, ds)
    float32 (None: zeros). CPU tensors run the plain
    version; CUDA tensors launch the kernel (held to ``contract.py``, not
    bitwise to the plain version), which takes dt, bmat, cmat and x of one
    stream type (float32 or bfloat16), a and d in float32, d_state 8 or 16,
    and writes y in ``y_dtype`` (float32 or bfloat16; default x's dtype).
    ``chunk_states``: also the float32 state before every ``CHUNK`` steps,
    (ceil(S / CHUNK), B, di, ds), which the kernel writes as it goes."""
    bsz, s, di = x.shape
    if h0 is not None and (tuple(h0.shape) != (bsz, di, a.shape[-1]) or h0.dtype != torch.float32
                           or h0.device != x.device):
        raise ValueError(f"ssm_scan: h0 must be float32 of shape {(bsz, di, a.shape[-1])} on "
                         f"{x.device}, got {h0.dtype} {tuple(h0.shape)} on {h0.device}")
    if x.device.type == "cpu" and not is_fake(x):
        return ssm_scan_plain(dt, a, bmat, cmat, x, d, y_dtype, chunk_states=chunk_states, h0=h0)
    _check("ssm_scan", dt, a, bmat, cmat, x, d)
    y_dtype = y_dtype or x.dtype
    if y_dtype not in _DTYPES:
        raise TypeError(f"ssm_scan writes y in float32 or bfloat16, got {y_dtype}")
    ds = a.shape[-1]
    args = [t.contiguous() for t in (dt, a, bmat, cmat, x, d)]
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((bsz, s, di), dtype=y_dtype, device=x.device)
    h = torch.empty((bsz, di, ds), dtype=torch.float32, device=x.device)
    hs = (torch.empty((-(-s // CHUNK), bsz, di, ds), dtype=torch.float32, device=x.device)
          if chunk_states else None)
    if is_fake(x):  # a dry run: the launch's outputs and its costs, nothing run
        record_launch("ssm_scan", 0.0, *args, h0, y, h, hs)
        return (y, h, hs) if chunk_states else (y, h)
    err = _lib().repro_ssm_scan(
        *(t.data_ptr() for t in args), y.data_ptr(), h.data_ptr(),
        hs.data_ptr() if chunk_states else None, None if h0 is None else h0.data_ptr(), bsz, s,
        di, ds, _DTYPES[x.dtype],
        _DTYPES[y_dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {err}")
    ssm_scan.launches += 1
    return (y, h, hs) if chunk_states else (y, h)


ssm_scan.launches = 0


def _bwd_lib():
    lib = build.load("ssm_scan_bwd")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssm_scan_bwd.argtypes = [p] * 19 + [i] * 5 + [p]
        lib.repro_ssm_scan_bwd.restype = ctypes.c_int
        lib.repro_ssm_scan_bwd_block_channels.argtypes = []
        lib.repro_ssm_scan_bwd_block_channels.restype = ctypes.c_int
        lib.repro_ssm_scan_bwd_occupancy.argtypes = [i, i, p]
        lib.repro_ssm_scan_bwd_occupancy.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def ssm_scan_bwd_occupancy(d_state: int, dtype: torch.dtype) -> dict:
    """The backward kernel's main grid for streams of ``dtype`` (float32 or
    bfloat16) and ``d_state`` (8 or 16), as the card reports it:
    ``registers`` and ``spill_bytes`` a thread, ``smem_bytes`` a block,
    ``blocks_per_sm`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_int * 4)()
    err = _bwd_lib().repro_ssm_scan_bwd_occupancy(d_state, _DTYPES[dtype], out)
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd occupancy query failed: cudaError {err}")
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), out))


def ssm_scan_bwd(dt, a, bmat, cmat, x, d, h_starts, gy, gh=None):
    """The gradients ``(d_dt, d_a, d_b, d_c, d_x, d_d)`` of ``ssm_scan``'s
    ``(y, h)`` for the cotangents ``gy`` and ``gh`` (None = 0), from the
    chunk start states ``h_starts`` that ``ssm_scan(..., chunk_states=True)``
    returned; each in its input's dtype. CPU tensors run
    ``ssm_scan_backward_plain`` in float32; CUDA tensors launch the kernel
    (``csrc/ssm_scan_bwd.cu``; float32 or bfloat16 streams, d_state 8 or
    16), held to ``contract.bwd_check``."""
    if x.device.type == "cpu" and not is_fake(x):
        grads = ssm_scan_backward_plain(dt, a, bmat, cmat, x, d, h_starts, gy, gh)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (dt, a, bmat, cmat, x, d)))
    _check("ssm_scan_bwd", dt, a, bmat, cmat, x, d)
    bsz, s, di = x.shape
    ds = a.shape[-1]
    if (tuple(h_starts.shape) != (-(-s // CHUNK), bsz, di, ds) or h_starts.dtype != torch.float32
            or tuple(gy.shape) != (bsz, s, di) or any(
                t is not None and t.device != x.device for t in (h_starts, gy, gh))
            or (gh is not None and tuple(gh.shape) != (bsz, di, ds))):
        raise ValueError(f"ssm_scan_bwd: h_starts must be float32 (ceil(S/{CHUNK}), B, di, ds), "
                         f"gy (B, S, di) and gh None or (B, di, ds), on {x.device}")
    args = [t.contiguous() for t in (dt, a, bmat, cmat, x, d, h_starts)]
    gy = gy.to(torch.float32).contiguous()
    gh = None if gh is None else gh.to(torch.float32).contiguous()
    grads = [torch.empty_like(t) for t in args[:6]]  # d_dt, d_a, d_b, d_c, d_x, d_d
    fake = is_fake(x)
    lib = None if fake else _bwd_lib()
    channels = BWD_BLOCK_CHANNELS if fake else lib.repro_ssm_scan_bwd_block_channels()
    n_blocks = -(-di // channels)
    scratch = [torch.empty(shape, dtype=torch.float32, device=x.device)
               for shape in ((n_blocks, bsz, s, ds), (n_blocks, bsz, s, ds), (bsz, di, ds),
                             (bsz, di))]
    if fake:  # a dry run: the launch's outputs and scratch, its costs
        record_launch("ssm_scan_bwd", 0.0, *args, gy, gh, *grads)
        return tuple(grads)
    d_dt, d_a, d_b, d_c, d_x, d_d = grads
    err = lib.repro_ssm_scan_bwd(
        *(t.data_ptr() for t in args), gy.data_ptr(), None if gh is None else gh.data_ptr(),
        *(t.data_ptr() for t in (d_dt, d_x, d_b, d_c, d_a, d_d)),
        *(t.data_ptr() for t in scratch), bsz, s, di, ds, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd kernel launch failed: cudaError {err}")
    ssm_scan_bwd.launches += 1
    return tuple(grads)


ssm_scan_bwd.launches = 0
