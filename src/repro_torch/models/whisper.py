"""Whisper-style encoder-decoder backbone of the port (whisper-tiny).

The counterpart of the JAX package's ``models/whisper.py``. The
mel-spectrogram + conv frontend is a stub: ``frames`` (B, encoder_seq,
d_model) arrive precomputed. The backbone: a bidirectional encoder over the
frames with a learned positional embedding (``enc_pos``), and a causal
decoder (GQA self-attention with RoPE, ``layers.gqa_attention``) that
cross-attends the encoder's output after each self-attention; pre-norm
RMSNorm and SwiGLU throughout.

The model is an ``nn.Module``, ``WhisperModel``, over ``ParamTree``s named
as the JAX tree: ``enc_pos``, ``encoder[i].{norm1, attn, norm2, ffn}``,
``enc_norm``, ``embed``, ``decoder[i].{norm1, self_attn, norm_cross,
cross_attn, norm2, ffn}``, ``final_norm``, ``head``. Its parameters carry no
gradients until a train step asks for them (``make_train_step``).

Every attention without a cache goes through ``kernels.flash_attention``
where JAX runs ``chunked_attention``: non-causal in the encoder (T = S =
encoder_seq) and in the cross-attention (S decoder queries over T =
encoder_seq frames at prefill, one query at a decode step), causal in the
decoder's self-attention at prefill. A decode step projects ``enc_out`` to
K/V again in every layer, as the JAX step does (it keeps no cross-K/V
cache), and its self-attention is ``layers.decode_attention`` on the cache
the prefill wrote. The cache:

    cache = {"layers": [gqa_cache, ...], "pos": int, "enc_out": (B, T, D)}

Training: ``decode_forward(mode="train")`` is the prefill's path without a
cache under autograd, and ``encode`` differentiates as its caller records;
the encoder and the cross-attention train through flash_attention's
non-causal backward (T = S = encoder_seq, and S decoder queries over T
frames), the decoder's self-attention through the causal one. As in the
JAX package, nothing is checkpointed (its ``whisper_loss`` takes ``remat``
and does not use it). ``whisper_loss`` and ``make_train_step`` are the JAX
package's.

Under a mesh of ranks (``launch.context.mesh_context``) a model built for
training (``init_whisper(zero=True)``, ``weights.whisper_params_from_numpy(
mesh=, zero=True)``) holds each leaf's ZeRO block over the data axes
(``launch/zero.py``), gathered at use: each encoder and decoder layer's
blocks as the layer starts (``zero.gathered``), the top-level leaves
where they are read (``zero.full``). Nothing being checkpointed, a
gathered layer lives until the backward, which reduce-scatters its
gradient (a layer of whisper-tiny is a few MB). Its leaves
stay whole over ``model`` (its H = 6 heads divide no ``model`` axis of 4;
JAX's ``param_spec`` splits its 384-wide leaves over ``model``, a layout
alone): its ``model`` ranks compute alike and nothing is summed over
``model``. The train step differentiates ``whisper_objective``: the rank's
rows (``context.data_rows``) by the rule of ``transformer.shard_objective``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention
from repro_torch.launch import context as ctx
from repro_torch.launch import zero as Z
from repro_torch.models import layers as L
from repro_torch.models.transformer import (ParamTree, _param, apply_train_step, shard_objective,
                                            token_nll)


class WhisperModel(nn.Module):
    """The encoder-decoder: ``enc_pos`` (encoder_seq, D), ``encoder``,
    ``enc_norm`` (D,), ``embed`` (V_padded, D), ``decoder``, ``final_norm``
    (D,), ``head`` (D, V_padded)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        if not cfg.encoder_decoder:
            raise ValueError(f"{cfg.name}: a decoder-only config is models/transformer.py's")
        if len(tree["encoder"]) != cfg.n_encoder_layers or len(tree["decoder"]) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(tree['encoder'])} encoder and "
                             f"{len(tree['decoder'])} decoder layers for {cfg.n_encoder_layers} "
                             f"and {cfg.n_layers}")
        self.cfg = cfg
        for name in ("enc_pos", "enc_norm", "embed", "final_norm", "head"):
            self.register_parameter(name, _param(tree[name]))
        self.encoder = nn.ModuleList(ParamTree(lyr) for lyr in tree["encoder"])
        self.decoder = nn.ModuleList(ParamTree(lyr) for lyr in tree["decoder"])

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_attn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The encoder's and the cross-attention's projections: normal * 0.02
    for all four (``layers.init_gqa`` scales ``wo`` by 1/sqrt(2 L))."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = L.torch_dtype(cfg)
    return {"wq": L._normal(gen, (d, h * dh), 0.02, dt),
            "wk": L._normal(gen, (d, hkv * dh), 0.02, dt),
            "wv": L._normal(gen, (d, hkv * dh), 0.02, dt),
            "wo": L._normal(gen, (h * dh, d), 0.02, dt)}


def init_whisper(gen: torch.Generator, cfg: ModelConfig, zero: bool = False) -> WhisperModel:
    """A model with random weights drawn from ``gen`` on its device: the
    JAX init's shapes, dtypes and scales (``enc_pos`` normal * 0.01, the
    embedding and head * 0.02, norms 1), not its bits. With ``zero``
    (training under a mesh) the draws are the same and each leaf is cut to
    this rank's ZeRO block as soon as its layer is drawn
    (``launch/zero.shard``)."""
    if zero and ctx.get_mesh() is None:
        raise ValueError("init_whisper(zero=True) splits the leaves over the data axes of the "
                         "open mesh_context, and none is open")
    held = (lambda path, t: Z.shard(t, path, cfg)) if zero else (lambda path, t: t)
    dt = L.torch_dtype(cfg)
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=dt, device=gen.device)  # noqa: E731
    encoder = [held(f"encoder/{i}", {"norm1": ones(), "attn": _init_attn(gen, cfg),
                                     "norm2": ones(), "ffn": L.init_swiglu(gen, cfg)})
               for i in range(cfg.n_encoder_layers)]
    decoder = [held(f"decoder/{i}", {"norm1": ones(), "self_attn": L.init_gqa(gen, cfg),
                                     "norm_cross": ones(), "cross_attn": _init_attn(gen, cfg),
                                     "norm2": ones(), "ffn": L.init_swiglu(gen, cfg)})
               for i in range(cfg.n_layers)]
    return WhisperModel(cfg, {
        "enc_pos": held("enc_pos", L._normal(gen, (cfg.encoder_seq, d), 0.01, dt)),
        "encoder": encoder,
        "enc_norm": held("enc_norm", ones()),
        "embed": held("embed", L._normal(gen, (cfg.vocab_padded, d), 0.02, dt)),
        "decoder": decoder,
        "final_norm": held("final_norm", ones()),
        "head": held("head", L._normal(gen, (d, cfg.vocab_padded), 0.02, dt)),
    })


def init_whisper_cache(cfg: ModelConfig, batch: int, seq: int, window: int = 0, device=None):
    layers = [L.init_gqa_cache(cfg, batch, seq, window, device) for _ in range(cfg.n_layers)]
    return {"layers": layers, "pos": 0,
            "enc_out": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                   dtype=L.torch_dtype(cfg), device=device)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _attn(p, q_in: torch.Tensor, kv_in: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Non-causal attention of q_in (B, S, D) over kv_in (B, T, D) through
    ``kernels.flash_attention`` (T may differ from S): every query sees
    every key, as JAX's ``chunked_attention(causal=False)`` over positions
    that are all real."""
    b, s, _ = q_in.shape
    t = kv_in.shape[1]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = (q_in @ p["wq"]).reshape(b, s, h, dh)
    k = (kv_in @ p["wk"]).reshape(b, t, hkv, dh)
    v = (kv_in @ p["wv"]).reshape(b, t, hkv, dh)
    return flash_attention(q, k, v, causal=False).reshape(b, s, h * dh) @ p["wo"]


def encode(params: WhisperModel, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T_enc, D), cast to the model's dtype, -> the encoder's
    output (B, T_enc, D). Records a graph only where the caller's grad
    mode does and the parameters need gradients (training); the prefill
    step runs it under ``torch.no_grad``."""
    t = frames.shape[1]
    x = frames.to(device=params.device, dtype=params.embed.dtype) + Z.full(params.enc_pos)[:t]
    for lyr in params.encoder:
        lyr = Z.gathered(lyr)
        h = L.rms_norm(x, lyr["norm1"], cfg.norm_eps)
        x = x + _attn(lyr["attn"], h, h, cfg)
        h = L.rms_norm(x, lyr["norm2"], cfg.norm_eps)
        x = x + L.swiglu(lyr["ffn"], h)
    return L.rms_norm(x, Z.full(params.enc_norm), cfg.norm_eps)


def decode_forward(params: WhisperModel, cfg: ModelConfig, tokens: torch.Tensor,
                   enc_out: torch.Tensor, *, cache=None, window: int = 0, mode: str = "prefill"):
    """The decoder over tokens (B, S), cross-attending ``enc_out`` (B, T,
    D). mode: prefill (positions 0..S-1, no cache) | decode (one token at
    ``cache["pos"]``, the cache written in place) | train (the prefill's
    positions under autograd; new_cache None). Returns (logits (B, S,
    V_padded) float32, new_cache), the cache carrying ``enc_out``. prefill
    and decode run under ``torch.no_grad``."""
    if mode == "train":
        return _decode(params, cfg, tokens, enc_out, None, window, mode)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"decode_forward mode {mode!r}: one of train, prefill, decode")
    with torch.no_grad():
        return _decode(params, cfg, tokens, enc_out, cache, window, mode)


def _decode(params, cfg, tokens, enc_out, cache, window, mode):
    x = Z.full(params.embed)[tokens.to(device=params.device, dtype=torch.int64)]
    s = x.shape[1]
    positions = cache["pos"] if mode == "decode" else torch.arange(s, dtype=torch.int32,
                                                                    device=x.device)
    new_layers = []
    for i, lyr in enumerate(params.decoder):
        lyr = Z.gathered(lyr)
        c = cache["layers"][i] if cache is not None else None
        h = L.rms_norm(x, lyr["norm1"], cfg.norm_eps)
        sa, nc = L.gqa_attention(lyr["self_attn"], h, positions, cfg, cache=c, window=window,
                                 mode=mode)
        x = x + sa
        h = L.rms_norm(x, lyr["norm_cross"], cfg.norm_eps)
        x = x + _attn(lyr["cross_attn"], h, enc_out, cfg)  # every query sees every frame
        h = L.rms_norm(x, lyr["norm2"], cfg.norm_eps)
        x = x + L.swiglu(lyr["ffn"], h)
        new_layers.append(nc)
    x = L.rms_norm(x, Z.full(params.final_norm), cfg.norm_eps)
    logits = (x @ Z.full(params.head)).to(torch.float32)
    if mode == "train":
        return logits, None
    next_pos = cache["pos"] + 1 if mode == "decode" else s
    return logits, {"layers": new_layers, "pos": next_pos, "enc_out": enc_out}


def _train_logits(params, cfg, batch, window):
    enc_out = encode(params, cfg, batch["frames"])
    logits, _ = decode_forward(params, cfg, batch["tokens"], enc_out, window=window, mode="train")
    return logits, batch["labels"], torch.zeros((), dtype=torch.float32, device=logits.device)


def whisper_objective(params: WhisperModel, cfg: ModelConfig, batch: dict,
                      window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(what this rank differentiates, the loss the step returns) on the
    global ``batch``: without a mesh ``whisper_loss`` twice; under one,
    ``transformer.shard_objective``'s pair (the rank's rows' masked NLL sum
    over the global count of labels; no aux)."""
    if ctx.get_mesh() is None:
        loss = whisper_loss(params, cfg, batch, window)
        return loss, loss
    return shard_objective(cfg, batch, lambda b: _train_logits(params, cfg, b, window))


def whisper_loss(params: WhisperModel, cfg: ModelConfig, batch: dict, window: int = 0,
                 remat: bool = True) -> torch.Tensor:
    """The JAX package's loss: batch {"frames" (B, T_enc, D), "tokens" (B,
    S), "labels" (B, S) with -1 = ignore} -> the mean NLL of the labels
    under the decoder's logits over the padded vocabulary, a float32 scalar
    differentiable in the parameters. ``remat`` is taken and unused, as in
    the JAX function. Under a mesh, the global batch's loss JAX's sharded
    step returns, on every rank and detached (``whisper_objective``)."""
    if ctx.get_mesh() is not None:
        return whisper_objective(params, cfg, batch, window)[1]
    logits, labels, _ = _train_logits(params, cfg, batch, window)
    return token_nll(logits, labels)


def make_train_step(cfg: ModelConfig, optimizer, window: int = 0, remat: bool = True):
    def train_step(params: WhisperModel, opt_state, batch: dict):
        """One step on the global ``batch`` (``whisper_objective``'s): (params
        updated in place, opt_state, loss)."""
        return apply_train_step(params, opt_state, optimizer,
                                lambda: whisper_objective(params, cfg, batch, window))

    return train_step


def make_prefill_step(cfg: ModelConfig, window: int = 0):
    @torch.no_grad()
    def prefill_step(params: WhisperModel, batch: dict):
        """batch {"frames" (B, T_enc, D), "tokens" (B, S)} -> (last-position
        logits (B, V), cache)."""
        enc_out = encode(params, cfg, batch["frames"])
        logits, cache = decode_forward(params, cfg, batch["tokens"], enc_out, window=window,
                                       mode="prefill")
        return logits[:, -1].clone(), cache  # the clone frees the (B, S, V) logits

    return prefill_step


def make_decode_step(cfg: ModelConfig, window: int = 0):
    def decode_step(params: WhisperModel, cache: dict, token: torch.Tensor):
        """token (B, 1) -> (logits (B, V), new_cache); writes the
        self-attention caches in place."""
        logits, new_cache = decode_forward(params, cfg, token, cache["enc_out"], cache=cache,
                                           window=window, mode="decode")
        return logits[:, 0], new_cache

    return decode_step
