"""Decoder stack of the port's serving slice: falcon-mamba-7b (Mamba-1
blocks) and granite-3-8b (GQA + SwiGLU blocks).

The model is an ``nn.Module``, ``DecoderLM``: the embedding, one ``Block``
per layer in an ``nn.ModuleList``, the final norm and the head. Its
parameters carry no gradients (serving only). The JAX package stacks the
layers of each period and scans over them; here the blocks are kept per
layer and the stack is a Python loop, so a cache is one dict per layer:

    cache = {"layers": [block_cache, ...], "pos": int}

``mode="train"``, MoE, MLA, hybrid stacks and the vision and audio
frontends raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_TODO = "ROADMAP.md queue 1 item 14 (model zoo)"


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Each layer's mixer in order: 'mamba' or 'attn' (GQA)."""
    return ["mamba" if cfg.ssm and not cfg.is_attn_layer(i) else "attn"
            for i in range(cfg.n_layers)]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice does not port. What is left is a uniform
    stack, one kind of layer repeated: the JAX package stores it as one
    ``stack`` entry whose leaves carry a leading ``n_layers`` axis."""
    if cfg.encoder_decoder:
        raise NotImplementedError(f"encoder-decoder models (whisper): {_TODO}")
    if cfg.frontend != "none":
        raise NotImplementedError(f"frontend {cfg.frontend!r}: {_TODO}")
    if cfg.moe or cfg.first_dense:
        raise NotImplementedError(f"MoE layers: {_TODO}")
    if cfg.attn_type == "mla":
        raise NotImplementedError(f"MLA attention: {_TODO}")
    if cfg.ssm and cfg.attn_period:
        raise NotImplementedError(f"hybrid Mamba + attention stacks (jamba): {_TODO}")
    if cfg.rope_variant != "full" and not cfg.ssm:
        raise NotImplementedError(f"rope_variant {cfg.rope_variant!r}: {_TODO}")
    if cfg.tie_embeddings:
        raise NotImplementedError(f"tied embeddings: {_TODO}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One pre-norm residual layer's parameters: ``norm1``, ``mixer`` (a
    ``ParameterDict``) and, for attention layers, ``norm2`` and ``ffn``.
    Indexed like the JAX package's block dict (``blk["mixer"]``,
    ``"ffn" in blk``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, nn.ParameterDict({k: _param(v) for k, v in value.items()}))
            else:
                self.register_parameter(name, _param(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class DecoderLM(nn.Module):
    """A decoder-only LM: ``embed`` (V_padded, D), ``blocks``,
    ``final_norm`` (D,), ``head`` (D, V_padded)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        if len(tree["blocks"]) != len(self.kinds):
            raise ValueError(f"{cfg.name}: {len(tree['blocks'])} blocks for {len(self.kinds)} layers")
        self.embed = _param(tree["embed"])
        self.final_norm = _param(tree["final_norm"])
        self.head = _param(tree["head"])
        self.blocks = nn.ModuleList(Block(b) for b in tree["blocks"])

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# block init / apply
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    dt = L.torch_dtype(cfg)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=gen.device)  # noqa: E731
    p = {"norm1": ones()}
    if kind == "mamba":
        p["mixer"] = L.init_mamba(gen, cfg)
        return p
    p["mixer"] = L.init_gqa(gen, cfg)
    p["norm2"] = ones()
    p["ffn"] = L.init_swiglu(gen, cfg)
    return p


def apply_block(p, x, positions, cfg: ModelConfig, kind: str, *, cache=None,
                window: int = 0, mode: str = "prefill"):
    """Pre-norm residual block. Returns (x, new_cache)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "mamba":
        mixed, new_cache = L.mamba_block(p["mixer"], h, cfg, cache=cache, mode=mode)
    else:
        mixed, new_cache = L.gqa_attention(p["mixer"], h, positions, cfg, cache=cache,
                                           window=window, mode=mode)
    x = x + mixed
    if "ffn" in p:
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + L.swiglu(p["ffn"], h2)
    return x, new_cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq: int, window: int,
                     device=None):
    if kind == "mamba":
        return L.init_mamba_cache(cfg, batch, device)
    return L.init_gqa_cache(cfg, batch, seq, window, device)


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig) -> DecoderLM:
    """A model with random weights drawn from ``gen`` on its device: the
    JAX init's shapes, dtypes and scales (normal * 0.02, out-projections
    / sqrt(2 L), A_log, dt_bias = -4.6, ...), not its bits."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg)
    v, d = cfg.vocab_padded, cfg.d_model
    tree = {
        "embed": L._normal(gen, (v, d), 0.02, dt),
        "final_norm": torch.ones((d,), dtype=dt, device=gen.device),
        "head": L._normal(gen, (d, v), 0.02, dt),
        "blocks": [init_block(gen, cfg, kind) for kind in layer_kinds(cfg)],
    }
    return DecoderLM(cfg, tree)


def init_cache(cfg: ModelConfig, batch: int, seq: int, window: int = 0, device=None):
    layers = [init_block_cache(cfg, kind, batch, seq, window, device)
              for kind in layer_kinds(cfg)]
    return {"layers": layers, "pos": 0}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed_inputs(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.to(device=params.device, dtype=torch.int64)]


@torch.no_grad()
def forward(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor, *, cache=None,
            window: int = 0, mode: str = "prefill"):
    """tokens (B, S) -> (logits (B, S, V_padded) float32, new_cache, aux).
    mode: prefill (S tokens at positions 0..S-1, no cache) | decode (one
    token at ``cache["pos"]``). ``aux`` is the MoE auxiliary loss, always 0
    here."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"forward mode {mode!r}: training is {_TODO}")
    x = _embed_inputs(params, cfg, tokens)
    s = x.shape[1]
    if mode == "decode":
        positions = cache["pos"]
    else:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)

    new_layers = []
    for i, (blk, kind) in enumerate(zip(params.blocks, params.kinds)):
        c = cache["layers"][i] if cache is not None else None
        x, nc = apply_block(blk, x, positions, cfg, kind, cache=c, window=window, mode=mode)
        new_layers.append(nc)

    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = (x @ params.head).to(torch.float32)
    next_pos = cache["pos"] + 1 if (cache is not None and mode == "decode") else s
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, {"layers": new_layers, "pos": next_pos}, aux


def make_prefill_step(cfg: ModelConfig, window: int = 0):
    def prefill_step(params: DecoderLM, batch: dict):
        """batch {"tokens" (B, S)} -> (last-position logits (B, V), cache)."""
        logits, cache, _ = forward(params, cfg, batch["tokens"], window=window, mode="prefill")
        return logits[:, -1].clone(), cache  # the clone frees the (B, S, V) logits

    return prefill_step


def make_decode_step(cfg: ModelConfig, window: int = 0):
    def decode_step(params: DecoderLM, cache: dict, token: torch.Tensor):
        """token (B, 1) -> (logits (B, V), new_cache); writes the cache in
        place."""
        logits, new_cache, _ = forward(params, cfg, token, cache=cache, window=window,
                                       mode="decode")
        return logits[:, 0], new_cache

    return decode_step
