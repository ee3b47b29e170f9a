"""Transformer / SSM building blocks of the port's serving slice.

The subset of the JAX package's ``models/layers.py`` that falcon-mamba-7b
and granite-3-8b run: RMSNorm, SiLU, full RoPE, GQA attention (prefill and
cached decode), SwiGLU, and the Mamba-1 block (prefill and decode). Plain
functions on tensors; ``p`` is any mapping of parameter tensors (a dict, or
a ``ParameterDict`` of the model). Same conventions as the JAX module:

  x          : (B, S, D) activations in the config's dtype
  q, k, v    : (B, S, H, Dh)
  caches     : dicts of tensors; decode writes the new slot in place and
               returns the same dict (the JAX package returns new arrays)

The prefills go through the port's CUDA kernels where JAX runs jnp code:
``gqa_attention`` calls ``kernels.flash_attention`` (JAX:
``chunked_attention``) and ``mamba_block`` calls ``kernels.ssm_scan`` (JAX:
a chunked ``lax.scan``). The decode steps stay plain torch, as they are
plain jnp in JAX. The half and M-RoPE variants, MLA and MoE raise
``NotImplementedError`` (ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention, ssm_scan

_TODO = "ROADMAP.md queue 1 item 14 (model zoo)"


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(gen: torch.Generator, shape, std: float, dtype: torch.dtype) -> torch.Tensor:
    """N(0, std^2) draws from ``gen`` on its device, cast to ``dtype`` (the
    JAX init's shapes and scales; its bits come from another generator)."""
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


# ---------------------------------------------------------------------------
# norms & basics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (torch's softplus switches to ``x`` above 20)."""
    return torch.where(torch.isnan(x), x,
                       torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x))))


# ---------------------------------------------------------------------------
# RoPE (full)
# ---------------------------------------------------------------------------


def _rope_cos_sin(positions: torch.Tensor, dim: int, base: float = 10000.0):
    """positions (...,) -> cos, sin of shape (..., dim//2), float32."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (even, odd) of the last dim. x (..., d), cos/sin (..., d//2)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full RoPE on x (B, S, H, Dh) at positions (B, S). The half and M-RoPE
    variants are not ported."""
    if cfg.rope_variant != "full":
        raise NotImplementedError(f"rope_variant {cfg.rope_variant!r}: {_TODO}")
    cos, sin = _rope_cos_sin(positions, x.shape[-1])
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# attention: cached decode (prefill goes through kernels.flash_attention)
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, kv_positions, pos: int,
                     window: int = 0) -> torch.Tensor:
    """Single-token cached attention. q (B, 1, H, Dq), caches (B, T, Hkv, D),
    kv_positions (T,) with -1 for an empty slot. Returns (B, 1, H, Dv).
    Scores and the P.V sum in float32, P rounded to v's dtype first, as in
    the JAX function."""
    b, _, h, dq = q.shape
    hkv, dv = k_cache.shape[2], v_cache.shape[-1]
    g = h // hkv
    scale = 1.0 / math.sqrt(dq)
    qg = q.reshape(b, hkv, g, dq)
    sc = torch.einsum("bhgd,bthd->bhgt", qg.to(torch.float32),
                      k_cache.to(torch.float32)) * scale
    valid = (kv_positions >= 0) & (kv_positions <= pos)
    if window:
        valid = valid & (kv_positions > pos - window)
    sc = torch.where(valid[None, None, None], sc, -1e30)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp_min(l, 1e-30)
    out = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, 1, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (init / prefill / decode)
# ---------------------------------------------------------------------------


def init_gqa(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = torch_dtype(cfg)
    return {
        "wq": _normal(gen, (d, h * dh), 0.02, dt),
        "wk": _normal(gen, (d, hkv * dh), 0.02, dt),
        "wv": _normal(gen, (d, hkv * dh), 0.02, dt),
        "wo": _normal(gen, (h * dh, d), 0.02 / math.sqrt(2 * cfg.n_layers), dt),
    }


def gqa_attention(p, x, positions, cfg: ModelConfig, *, cache=None, window: int = 0,
                  mode: str = "prefill"):
    """mode: prefill (``positions`` = ``arange(S)``) | decode (``positions``
    = the int position of the one token). Returns (out, new_cache).

    Prefill runs ``kernels.flash_attention`` over the sequence, whose masks
    count positions from 0, as the JAX function's masks over ``arange(S)``
    do. Decode writes the new K/V in place at slot ``pos`` (``pos % T`` with
    a window)."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"gqa_attention mode {mode!r}: training is {_TODO}")
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, hkv, dh)
    v = (x @ p["wv"]).reshape(b, s, hkv, dh)
    if mode == "decode":
        pos = int(positions)
        rope_pos = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    else:
        rope_pos = positions[None].expand(b, -1)
    lin_pos = rope_pos[0].to(torch.int32)
    q = apply_rope(q, rope_pos, cfg)
    k = apply_rope(k, rope_pos, cfg)

    if mode == "prefill":
        out = flash_attention(q, k, v, causal=True, window=window)
        if window:
            w = min(window, s)
            new_cache = {"k": k[:, -w:], "v": v[:, -w:], "kv_pos": lin_pos[-w:]}
        else:
            new_cache = {"k": k, "v": v, "kv_pos": lin_pos}
    else:  # decode: s == 1
        t = cache["k"].shape[1]
        # The reference writes with jax.lax.dynamic_update_slice, which clamps
        # the start index to T-1: after a full prefill (T = S) the first
        # decode overwrites the last prompt token's slot, and every later step
        # writes slot T-1 again. The port reproduces that (a reference fault,
        # ROADMAP.md queue 3).
        slot = pos % t if window else min(pos, t - 1)
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["kv_pos"][slot] = pos
        out = decode_attention(q, cache["k"], cache["v"], cache["kv_pos"], pos, window=window)
        new_cache = cache
    return out.reshape(b, s, h * dh) @ p["wo"], new_cache


def init_gqa_cache(cfg: ModelConfig, batch: int, seq: int, window: int = 0, device=None):
    hkv, dh = cfg.n_kv_heads, cfg.head_dim_
    t = min(window, seq) if window else seq
    dt = torch_dtype(cfg)
    return {
        "k": torch.zeros((batch, t, hkv, dh), dtype=dt, device=device),
        "v": torch.zeros((batch, t, hkv, dh), dtype=dt, device=device),
        "kv_pos": torch.full((t,), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# FFN: SwiGLU
# ---------------------------------------------------------------------------


def init_swiglu(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg)
    return {
        "wg": _normal(gen, (d, dff), 0.02, dt),
        "wu": _normal(gen, (d, dff), 0.02, dt),
        "wd": _normal(gen, (dff, d), 0.02 / math.sqrt(2 * cfg.n_layers), dt),
    }


def swiglu(p, x):
    return (silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


# ---------------------------------------------------------------------------
# Mamba-1 block (falcon-mamba)
# ---------------------------------------------------------------------------


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, di, ds, dtr, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank_, cfg.d_conv
    dt = torch_dtype(cfg)
    dev = gen.device
    # S4D-real A init: A[n] = n+1 per state dim
    a_init = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(di, ds)
    return {
        "in_proj": _normal(gen, (d, 2 * di), 0.02, dt),
        "conv_w": _normal(gen, (dc, di), 0.02, dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": _normal(gen, (di, dtr + 2 * ds), 0.02, dt),
        "dt_proj": _normal(gen, (dtr, di), 0.02, dt),
        "dt_bias": torch.full((di,), -4.6, dtype=torch.float32, device=dev),  # softplus^-1(0.01)
        "A_log": torch.log(a_init).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": _normal(gen, (di, d), 0.02 / math.sqrt(2 * cfg.n_layers), dt),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv along seq. x (B, S, di), w (dc, di). ``state``
    (B, dc-1, di) holds the trailing context (decode). Returns (y,
    new_state). The taps are summed in order from 0 in x's dtype, as the
    JAX function's Python ``sum`` does."""
    dc, s = w.shape[0], x.shape[1]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, dc - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = 0
    for i in range(dc):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(dc - 1):] if dc > 1 else None
    return y + b, new_state


def mamba_block(p, x, cfg: ModelConfig, *, cache=None, mode: str = "prefill"):
    """Selective-scan SSM (Mamba-1). Returns (out, new_cache).

    prefill: ``kernels.ssm_scan`` over the sequence from h = 0; decode: the
    O(1) state update. The scan inputs (dt, B, C, x) are rounded to
    bfloat16 whatever the config's dtype, as the JAX block streams them
    (its ``_scan_dt``); the recurrence itself runs in float32."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mamba_block mode {mode!r}: training with ssm_vjp is {_TODO}")
    if mode == "prefill" and cache is not None:
        raise NotImplementedError("mamba_block prefill from a carried state: the scan starts at h = 0")
    di, ds, dtr = cfg.d_inner, cfg.d_state, cfg.dt_rank_

    u = x @ p["in_proj"]
    xs, z = u[..., :di], u[..., di:]
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = silu(xs)

    xdb = xs @ p["x_proj"]
    dt_raw, bmat, cmat = torch.split(xdb, [dtr, ds, ds], dim=-1)
    dt = softplus((dt_raw @ p["dt_proj"]).to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])

    scan_dt = torch.bfloat16
    dt, bmat, cmat, xs_scan = (t.to(scan_dt) for t in (dt, bmat, cmat, xs))

    if mode == "decode":  # s == 1: single update
        dt1, b1, c1, x1 = (t[:, 0].to(torch.float32) for t in (dt, bmat, cmat, xs_scan))
        da = torch.exp(dt1[..., None] * a[None])
        h = da * cache["ssm"] + dt1[..., None] * b1[:, None, :] * x1[..., None]
        y = ((h * c1[:, None, :]).sum(-1) + p["D"] * x1)[:, None, :]
    else:
        y, h = ssm_scan(dt, a, bmat, cmat, xs_scan, p["D"], y_dtype=x.dtype)
    out = (y.to(x.dtype) * silu(z)) @ p["out_proj"]
    return out, {"conv": new_conv, "ssm": h}


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=torch_dtype(cfg),
                            device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32,
                           device=device),
    }
