"""flash_attention — causal GQA attention of a prefill, online softmax.

Replaces the JAX package's Pallas kernel
``src/repro/kernels/flash_attention/kernel.py`` (``flash_attention_kernel``/
``_fa_kernel``, wrapper ``ops.flash_attention``) with the hand-written CUDA
kernel in ``repro_torch/csrc/flash_attention.cu``; that file's header states
its bound on the H100 (operations: the visible half of the scores at the
bf16 tensor-core rate) and its design. In the JAX package the model's
prefill runs ``models/layers.py:chunked_attention`` and the Pallas kernel is
its TPU version; in the port the kernel is the prefill's path.

Both take the model's layout, q (B, S, H, D) and k, v (B, T, Hkv, D), with
kv head ``h // (H / Hkv)`` for q head h; key t is visible to query s when
t <= s (causal) and t > s - window (window > 0). As in the Pallas kernel,
scores, P and the P.V accumulator are float32 (JAX's ``chunked_attention``
rounds P to v's dtype before P.V instead).

- ``flash_attention_plain``: the plain PyTorch version — the kernel's online
  softmax over 64-key tiles, step for step;
- ``flash_attention``: the wrapper, dispatching on the tensor's device (CPU
  -> plain, CUDA -> kernel or raise);
- ``flash_attention.launches``: the kernel's launch counter.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

__all__ = ["flash_attention", "flash_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
BLOCK_K = 64  # keys per tile, as in the kernel
_NEG = -1e30


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0):
    """Attention of q (B, S, H, D) over k, v (B, T, Hkv, D), scores scaled
    by 1/sqrt(D), in q's dtype."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.to(torch.float32).reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)  # (b,hkv,g,s,d)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]                  # (b,hkv,1,t,d)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    rows = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, hkv, g, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, s, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, BLOCK_K):
        kt, vt = kf[..., k0:k0 + BLOCK_K, :], vf[..., k0:k0 + BLOCK_K, :]
        keys = torch.arange(k0, k0 + kt.shape[-2], device=q.device)[None, :]
        vis = torch.ones((s, keys.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            vis = vis & (keys <= rows)
        if window:
            vis = vis & (keys > rows - window)
        sc = torch.where(vis, torch.matmul(qg, kt.transpose(-1, -2)) * scale, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.where(vis, torch.exp(sc - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vt)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                              ctypes.c_float, i, p]
        lib.repro_flash_attention.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Attention of q (B, S, H, D) over k, v (B, T, Hkv, D), scores scaled
    by 1/sqrt(D), in q's dtype.
    CPU tensors run ``flash_attention_plain``; CUDA tensors launch the
    kernel, which takes float32 or bfloat16 and head dims 64 and 128."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device} have no kernel here")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention kernel takes head_dim in {_HEAD_DIMS}, got {d} (160 and 192 come "
            f"with stablelm-12b and deepseek-v2-lite, ROADMAP.md queue 1 item 14)")
    if k.shape != (b, t, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"flash_attention: k and v must be (B, T, Hkv, D) with H % Hkv == 0, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    qc, kc, vc = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(qc)
    err = _lib().repro_flash_attention(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b, h, hkv, s, t, d,
        int(bool(causal)), int(window), 1.0 / math.sqrt(d), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
