"""flash_attention — GQA attention with an online softmax: a decoder's causal
prefill, and whisper's non-causal encoder and cross-attention (S decoder
queries, one at a decode step, over T != S encoder frames).

Replaces the JAX package's Pallas kernel
``src/repro/kernels/flash_attention/kernel.py`` (``flash_attention_kernel``/
``_fa_kernel``, wrapper ``ops.flash_attention``) with two hand-written CUDA
kernels, one per dtype, whose headers state their bounds on the H100 and
their designs:

- bfloat16: ``repro_torch/csrc/flash_attention_wgmma.cu`` — QK^T and P.V on
  Hopper's tensor cores (wgmma), K/V tiles fed by TMA through a 2-stage
  shared-memory ring, two consumer warpgroups taking turns; 128-key tiles,
  64-key tiles at stablelm-12b's head dim 160;
- float32 (the reduced parity configs): ``repro_torch/csrc/flash_attention.cu``
  — the CUDA cores; 64-key tiles.

In the JAX package the model's prefill runs ``models/layers.py:
chunked_attention`` and the Pallas kernel is its TPU version; in the port
the kernels are the prefill's path.

Both take the model's layout, q (B, S, H, Dqk), k (B, T, Hkv, Dqk) and v
(B, T, Hkv, Dv) (T = S but for whisper's cross-attention), with kv head
``h // (H / Hkv)`` for q head h (Dqk = Dv
but for MLA, whose q and k carry the decoupled RoPE dims:
deepseek-v2-lite's (192, 128); G = H / Hkv any integer, chatglm3-6b's 16
and qwen2-vl-2b's 6 among them); key t is visible to query s when
t <= s (causal) and t > s - window (window > 0). Scores, the running max
and sum, and the P.V accumulator are float32. In float32, P stays float32,
as in the Pallas kernel. In bfloat16, P is rounded to bfloat16 before P.V
(wgmma takes bf16 operands) while l sums the float32 P: the arithmetic of
JAX's ``chunked_attention`` (``p.astype(v.dtype)``), not the Pallas
kernel's.

- ``flash_attention_plain``: the plain PyTorch version — the kernels'
  online softmax over their key tiles (``softmax_tiles``: ``key_tile``'s
  keys), step for step;
- ``flash_attention``: the wrapper, dispatching on the tensor's device (CPU
  -> plain, CUDA -> the kernel of its dtype, or raise);
- ``flash_attention.launches``: the kernels' launch counter.

``contract.py`` states how closely a bf16 result must match the plain
version, and checks it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

__all__ = ["flash_attention", "flash_attention_plain"]

# the (Dqk, Dv) pairs each kernel is instantiated for: the zoo's head dims in
# bf16, and the reduced parity configs' in float32 (MLA's reduced (48, 32))
HEAD_DIMS = {torch.bfloat16: ((64, 64), (128, 128), (192, 128), (160, 160)),
             torch.float32: ((64, 64), (128, 128), (48, 32))}
BLOCK_K = 128     # keys per tile of the bf16 (wgmma) kernel
BLOCK_K_160 = 64  # ... at (160, 160), where 128-key tiles do not fit
BLOCK_K_F32 = 64  # keys per tile of the float32 kernel
_NEG = -1e30


def key_tile(dtype: torch.dtype, dqk: int, dv: int) -> int:
    """Keys per tile of the kernel that takes ``dtype`` at (Dqk, Dv)."""
    if dtype != torch.bfloat16:
        return BLOCK_K_F32
    return BLOCK_K_160 if (dqk, dv) == (160, 160) else BLOCK_K


def _layout(x, q):
    """(b, hkv, g, s, d) -> q's (b, s, h) layout, (b, s, h, d)."""
    b, s, h = q.shape[:3]
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, h, x.shape[-1])


def softmax_tiles(q, k, v, causal: bool, window: int):
    """The kernels' online softmax over key tiles (``key_tile`` keys), in
    float32: for each tile, its P
    (b, hkv, g, s, keys) against the running max so far, the factor that
    rescales what came before (b, hkv, g, s), and its V (b, hkv, 1, keys,
    Dv). Scores are scaled by 1/sqrt(Dqk). What the kernels accumulate from
    them is ``flash_attention_plain``."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.to(torch.float32).reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)  # (b,hkv,g,s,d)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]                  # (b,hkv,1,t,d)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    block = key_tile(q.dtype, d, v.shape[-1])
    rows = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, hkv, g, s), _NEG, dtype=torch.float32, device=q.device)
    for k0 in range(0, t, block):
        kt, vt = kf[..., k0:k0 + block, :], vf[..., k0:k0 + block, :]
        keys = torch.arange(k0, k0 + kt.shape[-2], device=q.device)[None, :]
        vis = torch.ones((s, keys.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            vis = vis & (keys <= rows)
        if window:
            vis = vis & (keys > rows - window)
        sc = torch.where(vis, torch.matmul(qg, kt.transpose(-1, -2)) * scale, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        yield torch.where(vis, torch.exp(sc - m_new[..., None]), 0.0), torch.exp(m - m_new), vt
        m = m_new


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0):
    """Attention of q (B, S, H, Dqk) over k (B, T, Hkv, Dqk) and v (B, T,
    Hkv, Dv), scores scaled by 1/sqrt(Dqk); (B, S, H, Dv) in q's dtype."""
    bf16 = q.dtype == torch.bfloat16
    l = acc = 0.0
    for p, corr, vt in softmax_tiles(q, k, v, causal, window):
        l = l * corr + p.sum(dim=-1)
        pv = p.to(torch.bfloat16).to(torch.float32) if bf16 else p  # wgmma's bf16 P
        acc = acc * corr[..., None] + torch.matmul(pv, vt)
    return _layout(acc / torch.clamp_min(l, 1e-30)[..., None], q).to(q.dtype)


def _entry(dtype):
    """The C entry of the kernel library for ``dtype``, typed once."""
    name, entry = (("flash_attention_wgmma", "repro_flash_attention_bf16")
                   if dtype == torch.bfloat16 else ("flash_attention", "repro_flash_attention_f32"))
    fn = getattr(build.load(name), entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the f32 kernel's vector
    loads; TMA's global addresses)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Attention of q (B, S, H, Dqk) over k (B, T, Hkv, Dqk) and v (B, T,
    Hkv, Dv), scores scaled by 1/sqrt(Dqk); (B, S, H, Dv) in q's dtype.
    CPU tensors run ``flash_attention_plain``; CUDA tensors launch the
    kernel of their dtype (bfloat16: wgmma; float32: CUDA cores), which
    takes the (Dqk, Dv) pairs of ``HEAD_DIMS``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device} have no kernel here")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, dq = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if (dq, dv) not in HEAD_DIMS[q.dtype]:
        raise NotImplementedError(
            f"flash_attention's {q.dtype} kernel takes (Dqk, Dv) in {HEAD_DIMS[q.dtype]}, got "
            f"({dq}, {dv})")
    if k.shape != (b, t, hkv, dq) or v.shape != (b, t, hkv, dv) or h % hkv:
        raise ValueError(f"flash_attention: k must be (B, T, Hkv, Dqk) and v (B, T, Hkv, Dv) "
                         f"with H % Hkv == 0, got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    qc, kc, vc = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    err = _entry(q.dtype)(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b, h, hkv, s, t, dq, dv,
        int(bool(causal)), int(window), 1.0 / math.sqrt(dq),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        what = "a TMA tensor map was refused" if err < 0 else f"cudaError {err}"
        raise RuntimeError(f"flash_attention {q.dtype} kernel launch failed: {what}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
