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
t <= s (causal) and t > s - window (window > 0). With position vectors
``q_pos`` (S,) and ``k_pos`` (T,) (int32, shared by every row and head;
M-RoPE's t stream, whose image tokens share one position) the mask is
JAX's ``chunked_attention``'s instead: key t is visible to query s when
k_pos[t] >= 0, k_pos[t] <= q_pos[s] (causal) and k_pos[t] > q_pos[s] -
window (window > 0); the kernels then skip a key tile only where no pair
of it can be visible and leave one unmasked only where every pair is. A
query that sees no key gets 0 (JAX's -1e30 fill gives the mean of V over
the masked keys there; self-attention over non-negative positions always
sees its own key). Scores, the running max
and sum, and the P.V accumulator are float32. In float32, P stays float32,
as in the Pallas kernel. In bfloat16, P is rounded to bfloat16 before P.V
(wgmma takes bf16 operands) while l sums the float32 P: the arithmetic of
JAX's ``chunked_attention`` (``p.astype(v.dtype)``), not the Pallas
kernel's.

- ``flash_attention_plain``: the plain PyTorch version — the kernels'
  online softmax over their key tiles (``softmax_tiles``: ``key_tile``'s
  keys), step for step;
- ``flash_attention``: the wrapper, dispatching on the tensor's device (CPU
  -> plain, CUDA -> the kernel of its dtype, or raise); where autograd
  needs a gradient of q, k or v it goes through ``FlashAttentionFn``;
- ``flash_attention.launches``: the kernels' launch counter.

Training (the JAX package differentiates ``chunked_attention``; its Pallas
kernel has no backward):

- ``FlashAttentionFn``: the autograd Function. Its forward launches the
  kernel of the dtype with its ``lse`` output, the float32 row logsumexp of
  the scaled scores (B, H, S); its backward is ``flash_attention_bwd``;
- ``flash_attention_bwd``: dQ, dK, dV from (q, k, v, o, lse, dO) — CPU
  tensors run ``flash_attention_backward_plain``, CUDA tensors launch the
  kernel of their dtype, each for every (Dqk, Dv) of ``HEAD_DIMS``:
  bfloat16 ``repro_torch/csrc/flash_attention_bwd_wgmma.cu`` (every
  product on wgmma, q/dO and K/V tiles by TMA; P and dS rounded to bf16
  as they enter their products), float32
  ``repro_torch/csrc/flash_attention_bwd.cu`` (the CUDA cores); their
  headers state their bounds and designs; neither uses atomics, so two
  calls give equal bits. ``flash_attention_bwd.launches`` counts its calls
  (one call enqueues three grids);
- ``flash_attention_backward_plain``: the same formulas in float32 (with
  the bf16 kernel's rounding points for bf16 inputs), or in float64 for the
  contract; ``backward_terms``, ``backward_grads`` and ``stack_grads`` are
  its parts, which the contract reuses.

``contract.py`` states how closely a bf16 result must match the plain
version, and how closely the backward must match the float64 plain
backward, and checks both.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.cost import is_fake, record_launch

__all__ = ["FlashAttentionFn", "backward_grads", "backward_terms", "bf16_round",
           "flash_attention", "flash_attention_backward_plain", "flash_attention_bwd",
           "flash_attention_plain", "stack_grads"]

# the (Dqk, Dv) pairs each kernel is instantiated for: the zoo's head dims in
# bf16, and the reduced parity configs' in float32 (MLA's reduced (48, 32))
HEAD_DIMS = {torch.bfloat16: ((64, 64), (128, 128), (192, 128), (160, 160)),
             torch.float32: ((64, 64), (128, 128), (48, 32))}
BLOCK_K = 128     # keys per tile of the bf16 (wgmma) kernel
BLOCK_K_160 = 64  # ... at (160, 160), where 128-key tiles do not fit
BLOCK_K_F32 = 64  # keys per tile of the float32 kernel
BWD_PAD_ROWS = 128  # the bf16 backward's staged lse and D rows: S rounded up to this
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


def _visible(s: int, k0: int, k1: int, causal: bool, window: int, q_pos, k_pos, device):
    """The (S, k1 - k0) mask of keys k0 .. k1-1: by index (``q_pos`` None),
    or by the positions' rule."""
    if q_pos is None:
        rows = torch.arange(s, device=device)[:, None]
        keys = torch.arange(k0, k1, device=device)[None, :]
        vis = torch.ones((s, k1 - k0), dtype=torch.bool, device=device)
        if causal:
            vis = vis & (keys <= rows)
        if window:
            vis = vis & (keys > rows - window)
        return vis
    qp = q_pos.to(device=device, dtype=torch.int64)[:, None]
    kp = k_pos[k0:k1].to(device=device, dtype=torch.int64)[None, :]
    vis = (kp >= 0).expand(s, k1 - k0)
    if causal:
        vis = vis & (kp <= qp)
    if window:
        vis = vis & (kp > qp - window)
    return vis


def softmax_tiles(q, k, v, causal: bool, window: int, q_pos=None, k_pos=None):
    """The kernels' online softmax over key tiles (``key_tile`` keys), in
    float32, masked by index or by ``q_pos``/``k_pos``: for each tile, its P
    (b, hkv, g, s, keys) against the running max so far, the factor that
    rescales what came before (b, hkv, g, s), its V (b, hkv, 1, keys,
    Dv), and the running max after it (b, hkv, g, s). Scores are scaled by
    1/sqrt(Dqk). What the kernels accumulate from them is
    ``flash_attention_plain``."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.to(torch.float32).reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)  # (b,hkv,g,s,d)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]                  # (b,hkv,1,t,d)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    block = key_tile(q.dtype, d, v.shape[-1])
    m = torch.full((b, hkv, g, s), _NEG, dtype=torch.float32, device=q.device)
    for k0 in range(0, t, block):
        kt, vt = kf[..., k0:k0 + block, :], vf[..., k0:k0 + block, :]
        vis = _visible(s, k0, k0 + kt.shape[-2], causal, window, q_pos, k_pos, q.device)
        sc = torch.where(vis, torch.matmul(qg, kt.transpose(-1, -2)) * scale, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        yield (torch.where(vis, torch.exp(sc - m_new[..., None]), 0.0), torch.exp(m - m_new), vt,
               m_new)
        m = m_new


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          return_lse: bool = False, *, q_pos=None, k_pos=None):
    """Attention of q (B, S, H, Dqk) over k (B, T, Hkv, Dqk) and v (B, T,
    Hkv, Dv), scores scaled by 1/sqrt(Dqk); (B, S, H, Dv) in q's dtype.
    Masked by index, or with ``q_pos`` (S,) and ``k_pos`` (T,) by their
    rule. ``return_lse``: also the rows' float32 logsumexp, m + log(max(l,
    1e-30)), (B, H, S), as the kernels write it for training."""
    bf16 = q.dtype == torch.bfloat16
    l = acc = 0.0
    for p, corr, vt, m in softmax_tiles(q, k, v, causal, window, q_pos, k_pos):
        l = l * corr + p.sum(dim=-1)
        pv = p.to(torch.bfloat16).to(torch.float32) if bf16 else p  # wgmma's bf16 P
        acc = acc * corr[..., None] + torch.matmul(pv, vt)
    den = torch.clamp_min(l, 1e-30)
    out = _layout(acc / den[..., None], q).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(den)).reshape(q.shape[0], q.shape[2], q.shape[1])


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back to its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def backward_terms(q, k, v, out, lse, dout, causal: bool = True, window: int = 0,
                   acc_dtype=torch.float32, q_pos=None, k_pos=None):
    """What the backward is formed from, batch entry by batch entry (a
    (Hkv, G, S, T) score matrix at a time), in ``acc_dtype``: (qi, ki, vi,
    oi, doi, p, dp, dd) with q, o, dO as (Hkv, G, S, D), k and v as (Hkv, 1,
    T, D), P = exp(scale q.k - lse) on the visible keys (0 elsewhere; by
    index, or by ``q_pos``/``k_pos``) and dP = dO V^T as (Hkv, G, S, T), and
    D = rowsum(dO * o) as (Hkv, G, S, 1)."""
    b, s, h, dqk = q.shape
    t, hkv, dv_dim = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    scale = 1.0 / math.sqrt(dqk)
    vis = _visible(s, 0, t, causal, window, q_pos, k_pos, q.device)
    for i in range(b):
        def heads(x, d):  # (b, s, h, d) -> (hkv, g, s, d)
            return x[i].to(acc_dtype).reshape(s, hkv, g, d).permute(1, 2, 0, 3)

        def kv(x):  # (b, t, hkv, d) -> (hkv, 1, t, d)
            return x[i].to(acc_dtype).permute(1, 0, 2)[:, None]

        qi, oi, doi = heads(q, dqk), heads(out, dv_dim), heads(dout, dv_dim)
        ki, vi = kv(k), kv(v)
        li = lse[i].to(acc_dtype).reshape(hkv, g, s)[..., None]
        sc = torch.matmul(qi, ki.transpose(-1, -2)) * scale
        p = torch.exp(torch.where(vis, sc - li, -torch.inf))
        yield (qi, ki, vi, oi, doi, p, torch.matmul(doi, vi.transpose(-1, -2)),
               (doi * oi).sum(-1, keepdim=True))


def backward_grads(qi, ki, doi, p, ds):
    """dQ (S, H, Dqk), dK (T, Hkv, Dqk) and dV (T, Hkv, Dv) of one batch
    entry of ``backward_terms`` from P and dS as they enter the products:
    dQ = scale dS K, dK = scale dS^T Q and dV = P^T dO, dK and dV summed
    over each kv head's G query heads."""
    hkv, g, s, dqk = qi.shape
    scale = 1.0 / math.sqrt(dqk)
    return ((torch.matmul(ds, ki) * scale).permute(2, 0, 1, 3).reshape(s, hkv * g, dqk),
            (torch.matmul(ds.transpose(-1, -2), qi).sum(1) * scale).transpose(0, 1),
            torch.matmul(p.transpose(-1, -2), doi).sum(1).transpose(0, 1))


def stack_grads(per_entry, like, dtype):
    """The batch entries' (dQ, dK, dV) stacked to the shapes of ``like`` =
    (q, k, v) in ``dtype`` (zeros at B = 0)."""
    if not per_entry:
        return tuple(torch.zeros_like(x, dtype=dtype) for x in like)
    return tuple(torch.stack(gr).to(dtype) for gr in zip(*per_entry))


def flash_attention_backward_plain(q, k, v, out, lse, dout, causal: bool = True,
                                   window: int = 0, acc_dtype=torch.float32, dtype=None,
                                   rounding: bool | None = None, *, q_pos=None, k_pos=None):
    """dQ, dK, dV of attention (the forward's arguments, ``q_pos`` and
    ``k_pos`` included) from its output
    ``out`` (B, S, H, Dv), row logsumexp ``lse`` (B, H, S) and the output's
    cotangent ``dout``, in ``acc_dtype`` (float32, or float64 for the
    contract), returned in ``dtype`` (default q's): D = rowsum(dO * o); P =
    exp(scale q.k - lse) on the visible keys; dV = P^T dO; dS = P (dO V^T -
    D); dQ = scale dS K; dK = scale dS^T Q, dK and dV summed over each kv
    head's G query heads. With ``rounding`` (default: q is bfloat16), P is
    rounded to bfloat16 before dV and dS before dK and dQ, where the bf16
    kernel's wgmma takes them as bf16 operands (dS is formed from the
    unrounded P); float32 inputs keep every term unrounded."""
    rounding = q.dtype == torch.bfloat16 if rounding is None else rounding
    per_entry = []
    for qi, ki, _, _, doi, p, dp, dd in backward_terms(q, k, v, out, lse, dout, causal, window,
                                                       acc_dtype, q_pos, k_pos):
        ds = p * (dp - dd)
        if rounding:
            p, ds = bf16_round(p), bf16_round(ds)
        per_entry.append(backward_grads(qi, ki, doi, p, ds))
    return stack_grads(per_entry, (q, k, v), dtype or q.dtype)


def _entry(dtype):
    """The C entry of the kernel library for ``dtype``, typed once."""
    name, entry = (("flash_attention_wgmma", "repro_flash_attention_bf16")
                   if dtype == torch.bfloat16 else ("flash_attention", "repro_flash_attention_f32"))
    fn = getattr(build.load(name), entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 9 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the f32 kernel's vector
    loads; TMA's global addresses)."""
    t = t.contiguous()
    return t if is_fake(t) or t.data_ptr() % 16 == 0 else t.clone()


def _check_positions(name: str, q, k, q_pos, k_pos) -> None:
    """Raise unless ``q_pos`` and ``k_pos`` are both None, or int32 vectors
    (S,) and (T,) on q's device."""
    if (q_pos is None) != (k_pos is None):
        raise ValueError(f"{name}: q_pos and k_pos come together or not at all")
    if q_pos is None:
        return
    for arg, pos, n in (("q_pos", q_pos, q.shape[1]), ("k_pos", k_pos, k.shape[1])):
        if pos.dtype != torch.int32 or tuple(pos.shape) != (n,) or pos.device != q.device:
            raise ValueError(f"{name}: {arg} must be int32 of shape ({n},) on {q.device}, got "
                             f"{pos.dtype} {tuple(pos.shape)} on {pos.device}")


@functools.lru_cache(maxsize=256)
def index_pairs(s_len: int, t_len: int, causal: bool, window: int) -> int:
    """(query, key) pairs the index mask leaves visible: key t to query s
    when t <= s (causal) and t > s - window (window > 0). A dry run counts
    a position-masked launch by this rule too (its positions hold no
    values there)."""
    rows = np.arange(s_len, dtype=np.int64)
    hi = np.minimum(t_len - 1, rows) if causal else np.full(s_len, t_len - 1, dtype=np.int64)
    lo = np.maximum(0, rows - window + 1) if window else np.zeros(s_len, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _ptr(t: torch.Tensor | None):
    """A tensor's pointer for a C entry, or null."""
    return None if t is None else t.data_ptr()


def _check(name: str, q, k, v) -> None:
    """Raise for what the CUDA kernels do not take (a dry run's fake
    tensors stand for the card's, whatever their device)."""
    if q.device.type != "cuda" and not is_fake(q):
        raise ValueError(f"{name}: tensors on {q.device} have no kernel here")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, dq = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if (dq, dv) not in HEAD_DIMS[q.dtype]:
        raise NotImplementedError(
            f"{name}'s {q.dtype} kernel takes (Dqk, Dv) in {HEAD_DIMS[q.dtype]}, got ({dq}, {dv})")
    if k.shape != (b, t, hkv, dq) or v.shape != (b, t, hkv, dv) or h % hkv:
        raise ValueError(f"{name}: k must be (B, T, Hkv, Dqk) and v (B, T, Hkv, Dv) "
                         f"with H % Hkv == 0, got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k and v must be on one device")


def _failure(err: int) -> str:
    """What a kernel entry's nonzero return means."""
    if err == -3:
        return "the position-masked tile list exceeds shared memory"
    return "a TMA tensor map was refused" if err < 0 else f"cudaError {err}"


def _attention(q, k, v, causal: bool, window: int, with_lse: bool, q_pos=None, k_pos=None):
    """The forward: the plain version on the CPU, else the kernel of the
    dtype; with ``with_lse``, (out, lse)."""
    _check_positions("flash_attention", q, k, q_pos, k_pos)
    if q.device.type == "cpu" and not is_fake(q):
        return flash_attention_plain(q, k, v, causal, window, return_lse=with_lse, q_pos=q_pos,
                                     k_pos=k_pos)
    _check("flash_attention", q, k, v)
    b, s, h, dq = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    qc, kc, vc = _aligned(q), _aligned(k), _aligned(v)
    if q_pos is not None:
        q_pos, k_pos = _aligned(q_pos), _aligned(k_pos)
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    if is_fake(q):  # a dry run: the launch's outputs and its costs, nothing run
        record_launch("flash_attention",
                      2.0 * b * h * (dq + dv) * index_pairs(s, t, causal, window),
                      q, k, v, out, lse)
        return (out, lse) if with_lse else out
    err = _entry(q.dtype)(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(q_pos),
        _ptr(k_pos), b, h, hkv, s, t, dq, dv, int(bool(causal)), int(window),
        1.0 / math.sqrt(dq), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {q.dtype} kernel launch failed: {_failure(err)}")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, causal: bool = True, window: int = 0, *, q_pos=None, k_pos=None):
    """Attention of q (B, S, H, Dqk) over k (B, T, Hkv, Dqk) and v (B, T,
    Hkv, Dv), scores scaled by 1/sqrt(Dqk); (B, S, H, Dv) in q's dtype;
    masked by index, or by the int32 positions ``q_pos`` (S,) and ``k_pos``
    (T,) on q's device (the module's rule).
    CPU tensors run ``flash_attention_plain``; CUDA tensors launch the
    kernel of their dtype (bfloat16: wgmma; float32: CUDA cores), which
    takes the (Dqk, Dv) pairs of ``HEAD_DIMS``. Where autograd records and
    q, k or v needs a gradient, the call goes through ``FlashAttentionFn``
    (the same kernel, writing lse too); otherwise (serving) nothing else
    is launched or kept."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_pos, k_pos)
    return _attention(q, k, v, causal, window, False, q_pos, k_pos)


flash_attention.launches = 0


def _bwd_entry(dtype):
    """The C entry of the backward library for ``dtype``, typed once."""
    name, entry = (("flash_attention_bwd_wgmma", "repro_flash_attention_bwd_bf16")
                   if dtype == torch.bfloat16
                   else ("flash_attention_bwd", "repro_flash_attention_bwd_f32"))
    fn = getattr(build.load(name), entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 9 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True, window: int = 0, *,
                        q_pos=None, k_pos=None):
    """(dQ, dK, dV) of ``flash_attention(q, k, v, causal, window, q_pos=,
    k_pos=)`` from its
    output ``out``, its row logsumexp ``lse`` (B, H, S) float32 and the
    output's cotangent ``dout``, each in its input's dtype. CPU tensors run
    ``flash_attention_backward_plain``; CUDA tensors launch the kernel of
    their dtype (bfloat16: ``csrc/flash_attention_bwd_wgmma.cu``, on the
    tensor cores; float32: ``csrc/flash_attention_bwd.cu``), held to
    ``contract.bwd_check``, or raise."""
    _check_positions("flash_attention_bwd", q, k, q_pos, k_pos)
    if q.device.type == "cpu" and not is_fake(q):
        return flash_attention_backward_plain(q, k, v, out, lse, dout, causal, window,
                                              q_pos=q_pos, k_pos=k_pos)
    _check("flash_attention_bwd", q, k, v)
    b, s, h, dq = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if (tuple(out.shape) != (b, s, h, dv) or tuple(dout.shape) != (b, s, h, dv)
            or tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32
            or out.dtype != q.dtype or any(x.device != q.device for x in (out, lse, dout))):
        raise ValueError(f"flash_attention_bwd: out and dout must be {q.dtype} (B, S, H, Dv) "
                         f"and lse float32 (B, H, S) on {q.device}")
    args = [_aligned(x) for x in (q, k, v, out, lse, dout.to(q.dtype))]
    if q_pos is not None:
        q_pos, k_pos = _aligned(q_pos), _aligned(k_pos)
    grads = [torch.empty_like(x) for x in args[:3]]
    if q.dtype == torch.bfloat16:  # D and lse log2 e, rows padded to BWD_PAD_ROWS
        scratch = (2, b, h, -(-s // BWD_PAD_ROWS) * BWD_PAD_ROWS)
    else:  # D
        scratch = (b, h, s)
    aux = torch.empty(scratch, dtype=torch.float32, device=q.device)
    if is_fake(q):  # a dry run: the launch's outputs and scratch, its costs
        record_launch("flash_attention_bwd",
                      2.0 * b * h * (3 * dq + 2 * dv) * index_pairs(s, t, causal, window),
                      *args, *grads)
        return tuple(grads)
    err = _bwd_entry(q.dtype)(
        *(x.data_ptr() for x in args), *(x.data_ptr() for x in grads), aux.data_ptr(),
        _ptr(q_pos), _ptr(k_pos), b, h, hkv, s, t, dq, dv, int(bool(causal)), int(window),
        1.0 / math.sqrt(dq), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd {q.dtype} kernel launch failed: "
                           f"{_failure(err)}")
    flash_attention_bwd.launches += 1
    return tuple(grads)


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward kernel with its lse
    output, then ``flash_attention_bwd``. Saves q, k, v, the output, lse
    and the position vectors (if any)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_pos=None, k_pos=None):
        out, lse = _attention(q, k, v, causal, window, True, q_pos, k_pos)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal, ctx.window, q_pos=q_pos,
                                    k_pos=k_pos)
        return (*grads, None, None, None, None)
