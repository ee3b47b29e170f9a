"""Transformer / SSM building blocks of the port's serving slice.

The subset of the JAX package's ``models/layers.py`` that falcon-mamba-7b,
the dense GQA models (granite-3-8b, chatglm3-6b, stablelm-12b, qwen2-vl-2b),
the MoE family (deepseek-moe-16b, moonshot-v1-16b-a3b,
deepseek-v2-lite-16b), jamba-v0.1-52b and whisper-tiny's decoder run: RMSNorm, SiLU, RoPE in its three variants (full,
optionally on the first ``rope_dim`` dims; half, chatglm3's; M-RoPE,
qwen2-vl's), GQA and MLA attention (prefill and cached decode), SwiGLU, the
token-choice top-k MoE, and the Mamba-1 block (prefill and decode). Plain
functions on tensors; ``p`` is any mapping of parameter tensors (a dict, or
a block's ``ParamTree``). Same conventions as the JAX module:

  x          : (B, S, D) activations in the config's dtype
  q, k, v    : (B, S, H, Dh)
  caches     : dicts of tensors; decode writes the new slot in place and
               returns the same dict (the JAX package returns new arrays)

The prefills go through the port's CUDA kernels where JAX runs jnp code:
``gqa_attention`` and ``mla_attention`` call ``kernels.flash_attention``
(JAX: ``chunked_attention``; MLA with a q/k head dim of nd + rd and a v
head dim of vd) and ``mamba_block`` calls ``kernels.ssm_scan`` (JAX: a
chunked ``lax.scan``). ``mode="train"`` is the prefill's path without a
cache, differentiable: attention through ``kernels.flash_attention``'s
autograd Function (its forward kernel with the row logsumexp, then
``flash_attention_bwd``), the Mamba scan through
``models.ssm_vjp.selective_scan`` (JAX: its custom VJP; here the scan
kernel keeping its chunk start states, then ``ssm_scan_bwd``). The decode
steps and the MoE stay plain torch, as they are plain jnp in JAX (the
experts are batched matrix products, which XLA computes outside any Pallas
kernel); the MoE trains through ``moe_apply_local`` under plain autograd,
capacity counted over the whole call. Under ``launch.context.mesh_context``
the MoE is expert-parallel (``moe_apply_ep``: this rank's experts on this
rank's tokens, the partial outputs summed over the mesh's ``model``
group); it serves and trains (its collectives' backwards are
``launch/mesh.py``'s). A model on a mesh whose ``model`` axis is over 1 is
tensor-parallel (``launch/tp.py``), for serving and training alike: a
layer whose leaves hold the rank's ``launch.sharding.model_block`` (read
from their shapes) runs its heads, d_ff columns or d_inner channels on
its input as it enters the block (``tp.enter``), and sums its row
product's float32 partial over ``model`` (under the expert-parallel MoE,
the shared experts' partial joins the experts' in their one all-reduce);
a layer of whole leaves runs as without a mesh. In a sequence-parallel
train step (``seq=True``: ``launch.context.seq_split``) a layer takes the
rank's tokens of the residual stream, (B, S/n, D), gathers them along S
as they enter (``tp.sp_gather``) and returns its output on the rank's
tokens: a row product's float32 partials reduce-scattered
(``tp.sp_row``), a whole layer's output split (``tp.sp_split``);
``launch/tp.py`` says which gather each layer takes.
"""

from __future__ import annotations

import math
import os

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention, ssm_scan
from repro_torch.launch import context as ctx
from repro_torch.launch import tp
from repro_torch.launch.mesh import psum, replicated
from repro_torch.models.ssm_vjp import selective_scan

_MODES = ("train", "prefill", "decode")


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
# RoPE (full / half / M-RoPE)
# ---------------------------------------------------------------------------


def _rope_cos_sin(positions: torch.Tensor, dim: int, base: float = 10000.0):
    """positions (...,) -> cos, sin of shape (..., dim//2), float32."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _mrope_cos_sin(positions: torch.Tensor, sections, rope_dim: int, base: float = 10000.0):
    """M-RoPE (Qwen2-VL section 3.1): positions (B, S, 3), the (t, h, w)
    streams; section i of the ``rope_dim // 2`` frequencies, ``(arange(off,
    off + sec) * 2) / rope_dim``, turns with stream i. -> cos, sin (B, S,
    rope_dim // 2), float32."""
    if sum(sections) != rope_dim // 2:
        raise ValueError(f"mrope_sections {tuple(sections)} must sum to rope_dim // 2 = "
                         f"{rope_dim // 2}")
    cos, sin, off = [], [], 0
    for i, sec in enumerate(sections):
        freq = torch.arange(off, off + sec, dtype=torch.float32, device=positions.device) * 2
        inv = 1.0 / (base ** (freq / rope_dim))
        ang = positions[..., i].to(torch.float32)[..., None] * inv
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
        off += sec
    return torch.cat(cos, dim=-1), torch.cat(sin, dim=-1)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (even, odd) of the last dim. x (..., d), cos/sin (..., d//2)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               rope_dim: int | None = None) -> torch.Tensor:
    """The config's RoPE variant on the first ``rope_dim`` dims of x (B, S,
    H, Dh); the other dims pass through. positions (B, S), or (B, S, 3)
    under M-RoPE. ``rope_dim`` defaults to Dh, and to Dh // 2 under half
    RoPE (chatglm3's rotary on half the head dims); MLA passes its
    decoupled RoPE dims."""
    dh = x.shape[-1]
    if cfg.rope_variant == "half" and rope_dim is None:
        rope_dim = dh // 2
    rope_dim = rope_dim or dh
    if cfg.rope_variant == "mrope":
        cos, sin = _mrope_cos_sin(positions, cfg.mrope_sections, rope_dim)
    elif cfg.rope_variant in ("full", "half"):
        cos, sin = _rope_cos_sin(positions, rope_dim)
    else:
        raise ValueError(f"unknown rope_variant {cfg.rope_variant!r}")
    rot = _rotate(x[..., :rope_dim], cos[:, :, None, :], sin[:, :, None, :]).to(x.dtype)
    return rot if rope_dim == dh else torch.cat([rot, x[..., rope_dim:]], dim=-1)


# ---------------------------------------------------------------------------
# attention: cached decode (prefill goes through kernels.flash_attention)
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, kv_positions, pos: int,
                     window: int = 0) -> torch.Tensor:
    """Single-token cached attention. q (B, 1, H, Dq), k cache (B, T, Hkv,
    Dq), v cache (B, T, Hkv, Dv), kv_positions (T,) with -1 for an empty
    slot; scores scaled by 1/sqrt(Dq). Returns (B, 1, H, Dv). Scores and the
    P.V sum in float32, P rounded to v's dtype first, as in the JAX
    function."""
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
                  mode: str = "prefill", by_position: bool = False, seq: bool = False):
    """mode: train | prefill (``positions`` = ``arange(S)``, or under M-RoPE
    the (B, S, 3) position streams) | decode (``positions`` = the int
    position of the one token). Returns (out, new_cache); train returns no
    cache.

    Prefill runs ``kernels.flash_attention`` over the sequence, masked as
    the JAX function masks by ``lin_pos`` (``arange(S)``; under M-RoPE the t
    stream ``positions[0, :, 0]``): by index where ``lin_pos`` is
    ``arange(S)``, and with ``by_position`` (the caller read on the host
    that the t stream is not, ``transformer._prefill_positions``) by
    ``lin_pos`` itself as both position vectors, the kernels' position
    mask; the cache keeps ``lin_pos`` as ``kv_pos`` either way.
    Decode writes the new K/V in place at slot ``pos`` (``pos % T`` with a
    window); under M-RoPE its three streams are all ``pos``, as the JAX
    decode step builds them.

    Tensor-parallel (``wq`` holds a block of the heads, ``launch/tp.py``):
    the rank's q heads and the kv heads they read, through
    ``flash_attention`` at prefill and ``decode_attention`` at decode, the
    cache holding those kv heads, then the row product by ``wo``'s rows,
    summed over ``model``. Where ``wk`` and ``wv`` are whole beside a
    block of ``wq`` (a kv head shared by ranks, in training), every kv
    head is projected from ``x`` and the rank's own enters its block
    (``tp.kv_rows``): its gradient then sums every rank's share.

    ``seq`` (train only): ``x`` is the rank's tokens of a sequence-parallel
    stream, gathered as it enters (its backward a reduce-scatter where the
    kv heads are split with the q heads, every path a share), and the
    output is the rank's tokens (``tp.sp_row``; a whole layer's split)."""
    if mode not in _MODES:
        raise ValueError(f"gqa_attention mode {mode!r}: one of {_MODES}")
    dh = cfg.head_dim_
    split = tp.split(p["wq"], 1, cfg.n_heads * dh)
    shared_kv = split and not tp.split(p["wk"], 1, cfg.n_kv_heads * dh)
    fused = seq and split and not shared_kv  # the gather's backward sums the shares
    if seq:
        x = tp.sp_gather(x, shares=fused)
    b, s, _ = x.shape
    xe = tp.enter(x) if split and not fused else x
    h = p["wq"].shape[1] // dh  # the rank's heads
    q = (xe @ p["wq"]).reshape(b, s, h, dh)
    if shared_kv:
        rows = tp.kv_rows(cfg)
        k = tp.enter((x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, dh))[:, :, rows]
        v = tp.enter((x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, dh))[:, :, rows]
    else:
        hkv = p["wk"].shape[1] // dh
        k = (xe @ p["wk"]).reshape(b, s, hkv, dh)
        v = (xe @ p["wv"]).reshape(b, s, hkv, dh)
    mrope = cfg.rope_variant == "mrope"
    if mode == "decode":
        pos = int(positions)
        rope_pos = torch.full((b, 1, 3) if mrope else (b, 1), pos, dtype=torch.int32,
                              device=x.device)
    else:
        rope_pos = positions if mrope else positions[None].expand(b, -1)
    # the cache's own copy: decode writes kv_pos in place, and under M-RoPE
    # rope_pos is the caller's batch tensor
    lin_pos = (rope_pos[0, :, 0] if mrope else rope_pos[0]).to(torch.int32).clone()
    q = apply_rope(q, rope_pos, cfg)
    k = apply_rope(k, rope_pos, cfg)

    mask = dict(q_pos=lin_pos, k_pos=lin_pos) if by_position and mode != "decode" else {}
    if mode == "train":
        out, new_cache = flash_attention(q, k, v, causal=True, window=window, **mask), None
    elif mode == "prefill":
        out = flash_attention(q, k, v, causal=True, window=window, **mask)
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
    return _out_proj(out.reshape(b, s, h * dh), p["wo"], split, seq), new_cache


def _out_proj(out: torch.Tensor, wo: torch.Tensor, split: bool, seq: bool) -> torch.Tensor:
    """A mixer's output product: a row product summed over ``model`` where
    ``wo`` holds a block of rows (reduce-scattered into the rank's tokens
    under ``seq``), else whole (and split into the rank's tokens under
    ``seq``)."""
    if split:
        return (tp.sp_row if seq else tp.row)(out, wo)
    return tp.sp_split(out @ wo) if seq else out @ wo


def init_gqa_cache(cfg: ModelConfig, batch: int, seq: int, window: int = 0, device=None,
                   n_kv: int | None = None):
    """An empty cache of ``n_kv`` kv heads (default the config's; a
    tensor-parallel rank's, ``tp.kv_heads``)."""
    hkv, dh = n_kv or cfg.n_kv_heads, cfg.head_dim_
    t = min(window, seq) if window else seq
    dt = torch_dtype(cfg)
    return {
        "k": torch.zeros((batch, t, hkv, dh), dtype=dt, device=device),
        "v": torch.zeros((batch, t, hkv, dh), dtype=dt, device=device),
        "kv_pos": torch.full((t,), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLA attention block (DeepSeek-V2): compressed KV cache
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r, rd, nd, vd = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    dt = torch_dtype(cfg)
    return {
        "wq": _normal(gen, (d, h * (nd + rd)), 0.02, dt),
        "wdkv": _normal(gen, (d, r), 0.02, dt),
        "wkr": _normal(gen, (d, rd), 0.02, dt),
        "wuk": _normal(gen, (r, h * nd), 0.02, dt),
        "wuv": _normal(gen, (r, h * vd), 0.02, dt),
        "wo": _normal(gen, (h * vd, d), 0.02 / math.sqrt(2 * cfg.n_layers), dt),
    }


def mla_attention(p, x, positions, cfg: ModelConfig, *, cache=None, window: int = 0,
                  mode: str = "prefill", seq: bool = False):
    """Multi-head Latent Attention with decoupled RoPE (arXiv:2405.04434).
    mode: train | prefill (``positions`` = ``arange(S)``) | decode (the int
    position of the one token). Returns (out, new_cache); train returns no
    cache.

    The cache holds the compressed ``c_kv`` (B, T, r) and the shared RoPE
    key (B, T, rd). Prefill expands c_kv through ``wuk``/``wuv`` and runs
    ``kernels.flash_attention`` with q and k of nd + rd dims (the RoPE key
    broadcast over heads) and v of vd: scores scaled by 1/sqrt(nd + rd).
    Decode writes slot ``pos`` in place (``pos % T`` with a window; clamped
    to T - 1 without, as JAX's ``dynamic_update_slice`` clamps) and either
    re-expands the cache (``naive``, the default) or folds ``wuk`` into the
    query and ``wuv`` into the output (``absorbed``), as the environment
    variable ``REPRO_MLA_DECODE`` picks, the JAX package's switch.
    Tensor-parallel (``wq`` holds a block of the heads): the rank's heads
    of ``wq``, ``wuk``, ``wuv`` and ``wo``'s rows, summed over ``model``;
    ``wdkv``, ``wkr`` and the compressed cache whole on every rank, the
    latent ``c_kv`` and ``k_rope`` computed whole and entering the rank's
    heads (``tp.enter``). ``seq`` (train only): ``x`` is the rank's tokens
    of a sequence-parallel stream, gathered as it enters with the backward
    that keeps its tokens (the whole ``wdkv``/``wkr`` products are alike on
    every rank, so ``enter`` sums the heads' shares), and the output is the
    rank's tokens."""
    if mode not in _MODES:
        raise ValueError(f"mla_attention mode {mode!r}: one of {_MODES}")
    if seq:
        x = tp.sp_gather(x, shares=False)
    b, s, _ = x.shape
    r, rd, nd, vd = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    split = tp.split(p["wq"], 1, cfg.n_heads * (nd + rd))
    enter = tp.enter if split else (lambda t: t)
    h = p["wq"].shape[1] // (nd + rd)  # the rank's heads

    q = (enter(x) @ p["wq"]).reshape(b, s, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    c_kv = enter(x @ p["wdkv"])                    # (B, S, r)
    k_rope = enter(x @ p["wkr"]).reshape(b, s, 1, rd)
    if mode == "decode":
        pos = int(positions)
        rope_pos = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    else:
        rope_pos = positions[None].expand(b, -1)
    lin_pos = rope_pos[0].to(torch.int32)
    q_rope = apply_rope(q_rope, rope_pos, cfg, rope_dim=rd)
    k_rope = apply_rope(k_rope, rope_pos, cfg, rope_dim=rd)

    def expand(c):  # c (B, T, r) -> k_nope (B, T, H, nd), v (B, T, H, vd)
        t = c.shape[1]
        return (c @ p["wuk"]).reshape(b, t, h, nd), (c @ p["wuv"]).reshape(b, t, h, vd)

    if mode in ("train", "prefill"):
        k_nope, v = expand(c_kv)
        k_full = torch.cat([k_nope, k_rope.expand(b, s, h, rd)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(q_full, k_full, v, causal=True, window=window)
        w = min(window, s) if window else s
        new_cache = (None if mode == "train" else
                     {"c_kv": c_kv[:, -w:], "k_rope": k_rope[:, -w:, 0], "kv_pos": lin_pos[-w:]})
    else:  # decode: s == 1
        t_buf = cache["c_kv"].shape[1]
        slot = pos % t_buf if window else min(pos, t_buf - 1)
        cache["c_kv"][:, slot] = c_kv[:, 0]
        cache["k_rope"][:, slot] = k_rope[:, 0, 0]
        cache["kv_pos"][slot] = pos
        cc, kr, kv_pos = cache["c_kv"], cache["k_rope"], cache["kv_pos"]
        if os.environ.get("REPRO_MLA_DECODE", "naive") == "absorbed":
            # attention against the compressed cache: W_uk folded into the
            # query, W_uv into the output (DeepSeek-V2 section 2.1.2)
            scale = 1.0 / math.sqrt(nd + rd)
            q_eff = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], p["wuk"].reshape(r, h, nd))
            sc = (torch.einsum("bhr,btr->bht", q_eff.to(torch.float32), cc.to(torch.float32))
                  + torch.einsum("bhd,btd->bht", q_rope[:, 0].to(torch.float32),
                                 kr.to(torch.float32))) * scale
            valid = (kv_pos >= 0) & (kv_pos <= pos)
            if window:
                valid = valid & (kv_pos > pos - window)
            pr = torch.softmax(torch.where(valid[None, None], sc, -1e30), dim=-1)
            out_lat = torch.einsum("bht,btr->bhr", pr.to(cc.dtype), cc)
            out = torch.einsum("bhr,rhv->bhv", out_lat, p["wuv"].reshape(r, h, vd))[:, None]
        else:
            k_nope, v = expand(cc)
            k_full = torch.cat([k_nope, kr[:, :, None, :].expand(-1, -1, h, -1)], dim=-1)
            q_full = torch.cat([q_nope, q_rope], dim=-1)
            out = decode_attention(q_full, k_full, v, kv_pos, pos, window=window)
        new_cache = cache
    return _out_proj(out.reshape(b, s, h * vd), p["wo"], split, seq), new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int, window: int = 0, device=None):
    t = min(window, seq) if window else seq
    dt = torch_dtype(cfg)
    return {
        "c_kv": torch.zeros((batch, t, cfg.kv_lora_rank), dtype=dt, device=device),
        "k_rope": torch.zeros((batch, t, cfg.qk_rope_dim), dtype=dt, device=device),
        "kv_pos": torch.full((t,), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# FFN: SwiGLU
# ---------------------------------------------------------------------------


def init_swiglu(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, dff = cfg.d_model, d_ff or cfg.d_ff
    dt = torch_dtype(cfg)
    return {
        "wg": _normal(gen, (d, dff), 0.02, dt),
        "wu": _normal(gen, (d, dff), 0.02, dt),
        "wd": _normal(gen, (dff, d), 0.02 / math.sqrt(2 * cfg.n_layers), dt),
    }


def swiglu(p, x, d_ff: int | None = None, seq: bool = False):
    """The SwiGLU FFN; tensor-parallel where ``wd`` holds a block of the
    ``d_ff`` rows (``x`` entering the rank's columns of ``wg``/``wu``, then
    the row product summed over ``model``). Without ``d_ff`` the leaves are
    taken whole. ``seq``: ``x`` is the rank's tokens of a
    sequence-parallel stream, gathered as it enters (tensor-parallel: the
    backward reduce-scatters, every path a share), the output the rank's
    tokens."""
    if d_ff is not None and tp.split(p["wd"], 0, d_ff):
        if seq:
            return tp.sp_scatter(swiglu_partial(p, tp.sp_gather(x, shares=True)), x.dtype)
        return tp.reduce(swiglu_partial(p, tp.enter(x))).to(x.dtype)
    if seq:
        return tp.sp_split(swiglu(p, tp.sp_gather(x, shares=False)))
    return (silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def swiglu_partial(p, x):
    """This rank's float32 share of a tensor-parallel SwiGLU (its d_ff
    columns; ``tp.partial``)."""
    return tp.partial(silu(x @ p["wg"]) * (x @ p["wu"]), p["wd"])


def shared_d_ff(cfg: ModelConfig) -> int:
    """The width of an MoE's shared experts, taken as one SwiGLU."""
    return (cfg.d_ff_expert or cfg.d_ff) * cfg.n_shared_experts


# ---------------------------------------------------------------------------
# FFN: token-choice top-k MoE (capacity-bounded scatter dispatch)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The router in float32 whatever the config's dtype; E experts' SwiGLU
    weights stacked on a leading axis; the shared experts as one SwiGLU of
    width ``d_ff_expert * n_shared_experts`` under ``shared``. Under an
    expert-parallel mesh every leaf is drawn as without one (the same
    draws from ``gen``) and an expert leaf keeps only this rank's experts
    (``launch.context.expert_rows``)."""
    d, e = cfg.d_model, cfg.n_experts
    dff = cfg.d_ff_expert or cfg.d_ff
    dt = torch_dtype(cfg)
    rows = ctx.expert_rows(e)

    def experts(shape, std):
        t = _normal(gen, shape, std, dt)
        return t if rows is None else t[rows].clone()  # the rest is freed at once

    p = {
        "router": _normal(gen, (d, e), 0.02, torch.float32),
        "wg": experts((e, d, dff), 0.02),
        "wu": experts((e, d, dff), 0.02),
        "wd": experts((e, dff, d), 0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_swiglu(gen, cfg, d_ff=dff * cfg.n_shared_experts)
    return p


def moe_apply(p, x, cfg: ModelConfig, seq: bool = False):
    """Token-choice top-k MoE. Dispatches as the JAX function does: to the
    expert-parallel ``moe_apply_ep`` under a mesh context whose ``model``
    axis divides the experts, else ``moe_apply_local``. Returns (y,
    aux_loss). ``seq``: ``x`` is the rank's tokens of a sequence-parallel
    stream and so is y; ``moe_apply_local`` (whole experts, its capacity
    over every token of the call) runs alike on every rank on the gathered
    tokens."""
    if ctx.expert_parallel(cfg.n_experts):
        return moe_apply_ep(p, x, cfg, seq)
    if seq:
        y, aux = moe_apply_local(p, tp.sp_gather(x, shares=False), cfg)
        return tp.sp_split(y), aux
    return moe_apply_local(p, x, cfg)


def moe_route(p, xf: torch.Tensor, cfg: ModelConfig):
    """Routing of the N tokens xf (N, D), as the JAX function routes them.
    Returns (gate (N, k) float32, idx (N, k) int64, aux, pos (N*k,), keep
    (N*k,) bool, cap):

    - a float32 router softmax; top-k by a stable descending sort, so equal
      probabilities keep the lower expert first (``jax.lax.top_k``'s
      order); the gates renormalised by max(sum, 1e-9);
    - the Switch load-balance loss E * sum_e f_e P_e;
    - each expert's capacity max(1, ceil(N k capacity_factor / E)) over the
      N tokens of the call;
    - ``pos``: each route's place in its expert's queue, the routes taken in
      token-major order (JAX: a cumsum over an (N*k, E) one-hot; here a
      stable sort by expert, which gives the same integers); a route at
      ``pos >= cap`` is dropped (``keep`` False)."""
    e, k = cfg.n_experts, cfg.top_k
    n = xf.shape[0]
    probs = torch.softmax(xf.to(torch.float32) @ p["router"], dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    fidx = idx.reshape(-1)
    counts = torch.zeros((e,), dtype=fidx.dtype, device=xf.device)
    counts.scatter_add_(0, fidx, torch.ones_like(fidx))  # routes to each expert (no host sync)
    fe = counts.to(torch.float32) / n / k                # JAX: mean of the (N, k, E) one-hot
    aux = e * torch.sum(fe * probs.mean(dim=0))

    cap = max(1, int(math.ceil(n * k * cfg.capacity_factor / e)))
    order = torch.argsort(fidx, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(fidx)
    pos[order] = torch.arange(n * k, device=xf.device) - starts[fidx[order]]
    return gate, idx, aux, pos, pos < cap, cap


def moe_dispatch(xf, idx, pos, keep, cap: int, n_experts: int) -> torch.Tensor:
    """The (E, cap, D) expert buffer: route i's token at (idx_i, pos_i) when
    kept. A dropped route writes to a spare row that is cut off (JAX adds a
    zero at (idx_i, cap - 1)), so the buffer holds the same values."""
    d = xf.shape[1]
    k = idx.shape[1]
    slot = torch.where(keep, idx.reshape(-1) * cap + pos, n_experts * cap)
    buf = torch.zeros((n_experts * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, slot, xf.repeat_interleave(k, dim=0))
    return buf[:-1].view(n_experts, cap, d)


def moe_experts(p, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its (cap, D) rows: batched products over
    (E, cap, D)."""
    return torch.bmm(silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"]), p["wd"])


def moe_combine(expert_out, gate, idx, pos, keep, cap: int,
                acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Each token's k expert outputs gathered at (idx, min(pos, cap - 1)),
    weighted by gate * keep (a dropped route adds zero) and summed over k
    in ``acc_dtype`` (default: the outputs' dtype): (N, D)."""
    n, k = idx.shape
    acc = acc_dtype or expert_out.dtype
    gathered = expert_out[idx.reshape(-1), torch.clamp_max(pos, cap - 1)].to(acc)
    w = (gate.reshape(-1) * keep.to(torch.float32))[:, None].to(acc)
    return (gathered * w).reshape(n, k, -1).sum(dim=1)


def moe_apply_local(p, x, cfg: ModelConfig):
    """Token-choice top-k MoE with per-expert capacity: ``moe_route``,
    ``moe_dispatch``, ``moe_experts``, ``moe_combine``, then the shared
    experts added. Returns (y, aux_loss)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gate, idx, aux, pos, keep, cap = moe_route(p, xf, cfg)
    expert_out = moe_experts(p, moe_dispatch(xf, idx, pos, keep, cap, cfg.n_experts))
    y = moe_combine(expert_out, gate, idx, pos, keep, cap)
    if cfg.n_shared_experts:
        y = y + swiglu(p["shared"], xf, shared_d_ff(cfg))
    return y.reshape(b, s, d), aux


def moe_ep_routes(idx, keep, first: int, e_local: int):
    """The routes that this rank's experts ``[first, first + e_local)``
    take: (rel (N, k), each route's local expert, ``e_local - 1`` for
    another rank's expert as JAX's ``safe_e``; keep (N*k,), ``keep`` and
    the route's expert is this rank's). A route's place in its expert's
    queue does not depend on the other experts' routes, so ``moe_route``'s
    ``pos`` is the JAX function's count among the local experts."""
    rel = idx - first
    mine = (rel >= 0) & (rel < e_local)
    return torch.where(mine, rel, e_local - 1), keep & mine.reshape(-1)


def _local_experts(w: torch.Tensor, rows: slice, n_experts: int) -> torch.Tensor:
    """This rank's experts of an expert leaf: the leaf itself where it holds
    only them (``init_params`` or ``lm_params_from_numpy`` under the mesh),
    a view of them where it holds every expert."""
    if w.shape[0] == n_experts:
        return w[rows]
    if w.shape[0] != rows.stop - rows.start:
        raise ValueError(f"an expert leaf of {w.shape[0]} experts on a rank that holds "
                         f"experts {rows.start}..{rows.stop - 1} of {n_experts}")
    return w


def moe_apply_ep(p, x, cfg: ModelConfig, seq: bool = False):
    """Expert-parallel MoE over the mesh context's ``model`` group (the JAX
    package's ``moe_apply_ep``, its shard_map body on each rank).

    ``x`` (B, S, D) is this rank's tokens: its data shard of the batch
    where the steps split it (``launch.context.data_rows``), the whole
    batch where JAX replicates the tokens. The rank routes every one of
    them (``moe_route``: the float32 router, aux over these tokens, the
    capacity counted over them), keeps the routes to its own E/n_mp
    experts (``moe_ep_routes``), dispatches them and runs its experts
    (``moe_dispatch``, ``moe_experts``), gathers and gates the k outputs
    of each token and sums them in float32 (``moe_combine``), all-reduces
    the float32 (N, D) partial over ``model`` and casts it to x's dtype;
    the shared experts are added after, on the whole x, or, where they are
    tensor-parallel, their float32 partial (of the tokens as they enter
    the experts) joins the experts' before the all-reduce (one collective
    a layer). Returns (y, aux); aux is this rank's (JAX returns one data
    shard's).

    Under autograd it trains as JAX's shard_map does: the all-reduce's
    backward is the identity (``mesh.psum``), and the tokens and gates this
    rank's experts take are ``mesh.replicated`` over ``model``, so their
    gradients are summed over the model ranks (JAX sums the cotangent of an
    input its spec leaves unsplit over ``model``); the router's own path
    and aux are the same on every model rank and are not summed. The expert
    leaves must then hold only this rank's experts.

    ``seq`` (a sequence-parallel train step): ``x`` is the rank's tokens
    (B, S/n, D), gathered as they enter with the backward that keeps its
    tokens (the router's path is alike on every rank; ``replicated`` sums
    the experts' shares), and the float32 partial is reduce-scattered
    along S in place of the all-reduce: y is the rank's tokens."""
    mesh = ctx.get_mesh()
    e = cfg.n_experts
    rows = ctx.expert_rows(e)
    if rows is None:
        raise ValueError("moe_apply_ep runs inside an expert-parallel mesh_context whose "
                         f"'model' axis divides the {e} experts")
    e_local = rows.stop - rows.start
    if (e_local != e and p["wg"].shape[0] == e and torch.is_grad_enabled()
            and p["wg"].requires_grad):
        raise ValueError("training under the expert-parallel MoE needs expert leaves that "
                         "hold this rank's experts (init_params under the mesh_context, or "
                         "lm_params_from_numpy(mesh=)), else the other experts' gradients "
                         "are lost")
    if seq:
        x = tp.sp_gather(x, shares=False)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gate, idx, aux, pos, keep, cap = moe_route(p, xf, cfg)
    rel, keep = moe_ep_routes(idx, keep, rows.start, e_local)
    local = {name: _local_experts(p[name], rows, e) for name in ("wg", "wu", "wd")}
    xd, gd = replicated(mesh, xf, "model"), replicated(mesh, gate, "model")
    expert_out = moe_experts(local, moe_dispatch(xd, rel, pos, keep, cap, e_local))
    y = moe_combine(expert_out, gd, rel, pos, keep, cap, acc_dtype=torch.float32)
    shared_tp = cfg.n_shared_experts and tp.split(p["shared"]["wd"], 0, shared_d_ff(cfg))
    if shared_tp:
        y = y + swiglu_partial(p["shared"], xd)
    if seq:
        y = tp.sp_scatter(y.reshape(b, s, d), x.dtype)
        if cfg.n_shared_experts and not shared_tp:
            y = y + tp.sp_split(swiglu(p["shared"], x))
        return y, aux
    y = psum(mesh, y, "model").to(x.dtype)
    if cfg.n_shared_experts and not shared_tp:
        y = y + swiglu(p["shared"], xf)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Mamba-1 block (falcon-mamba, jamba)
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
    if new_state is not None and s > 1:  # a prefill: a view would keep all of xp alive
        new_state = new_state.clone()
    return y + b, new_state


def mamba_block(p, x, cfg: ModelConfig, *, cache=None, mode: str = "prefill", seq: bool = False):
    """Selective-scan SSM (Mamba-1). Returns (out, new_cache).

    prefill: ``kernels.ssm_scan`` over the sequence, from h = 0, or, given
    a ``cache``, continuing it as the JAX block does: the conv from
    ``cache["conv"]`` and the scan from ``cache["ssm"]`` (the kernel's start
    state); train: the scan through ``ssm_vjp.selective_scan``
    (differentiable, from h = 0; no cache); decode: the O(1) state update. The scan inputs (dt, B, C, x) are
    rounded to bfloat16 whatever the config's dtype, as the JAX block
    streams them (its ``_scan_dt``); the recurrence itself runs in
    float32.

    Tensor-parallel (``in_proj`` holds the x and z columns of a d_inner
    block, ``launch/tp.py``): the conv, the scan over the rank's channels
    and its rows of ``A`` and ``D``, and the decode update on them; ``x_proj``
    and ``out_proj`` are row products summed over ``model`` (dt, B and C
    come whole out of the first and enter the rank's channels: their
    gradients are summed over ``model`` too). ``seq`` (train only): ``x``
    is the rank's tokens of a sequence-parallel stream, gathered along S as
    it enters (tensor-parallel: the backward reduce-scatters, ``in_proj``'s
    columns a share) so the conv and the scan see the whole sequence; the
    output is the rank's tokens."""
    if mode not in _MODES:
        raise ValueError(f"mamba_block mode {mode!r}: one of {_MODES}")
    if mode == "train" and cache is not None:
        raise ValueError("mamba_block trains from h = 0, without a cache")
    ds, dtr = cfg.d_state, cfg.dt_rank_
    split = tp.split(p["in_proj"], 1, 2 * cfg.d_inner)
    di = p["in_proj"].shape[1] // 2  # the rank's channels

    if seq:
        x = tp.sp_gather(x, shares=split)
    u = (tp.enter(x) if split and not seq else x) @ p["in_proj"]
    xs, z = u[..., :di], u[..., di:]
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = silu(xs)

    xdb = tp.enter(tp.row(xs, p["x_proj"])) if split else xs @ p["x_proj"]
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
    elif mode == "train":
        y, h = selective_scan(dt, a, bmat, cmat, xs_scan, p["D"], y_dtype=x.dtype)
    else:
        y, h = ssm_scan(dt, a, bmat, cmat, xs_scan, p["D"], y_dtype=x.dtype,
                        h0=None if cache is None else cache["ssm"])
    out = _out_proj(y.to(x.dtype) * silu(z), p["out_proj"], split, seq)
    return out, None if mode == "train" else {"conv": new_conv, "ssm": h}


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None, d_inner: int | None = None):
    """An empty cache of ``d_inner`` channels (default the config's; a
    tensor-parallel rank's, ``tp.d_inner``)."""
    di = d_inner or cfg.d_inner
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=torch_dtype(cfg), device=device),
        "ssm": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32, device=device),
    }
