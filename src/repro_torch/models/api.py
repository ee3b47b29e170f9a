"""Uniform model API of the port over its decoder-only LMs
(``models/transformer.py``) and the encoder-decoder (whisper,
``models/whisper.py``).

    bundle = get_model(cfg)
    model  = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
    opt_state = opt.init(param_tree(model))
    step = bundle.make_train_step(opt)
    model, opt_state, loss = step(model, opt_state, batch)

The JAX package's facade. A train step updates the model's parameters in
place and returns the loss as a device tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import random as prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.transformer import param_tree

__all__ = ["ModelBundle", "get_model", "make_batch_specs", "make_concrete_batch", "param_tree"]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]  # (gen, zero=False): zero, ZeRO blocks (training under a mesh)
    loss_fn: Callable
    make_train_step: Callable
    make_prefill_step: Callable
    make_decode_step: Callable
    init_cache: Callable  # (batch, seq, window, device) -> cache


def get_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.encoder_decoder:
        return ModelBundle(
            cfg=cfg,
            init=lambda gen, zero=False: W.init_whisper(gen, cfg, zero=zero),
            loss_fn=lambda p, batch, window=0: W.whisper_loss(p, cfg, batch, window),
            make_train_step=lambda opt, window=0: W.make_train_step(cfg, opt, window),
            make_prefill_step=lambda window=0: W.make_prefill_step(cfg, window),
            make_decode_step=lambda window=0: W.make_decode_step(cfg, window),
            init_cache=lambda batch, seq, window=0, device=None: W.init_whisper_cache(
                cfg, batch, seq, window, device),
        )
    T.check_supported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda gen, zero=False: T.init_params(gen, cfg, zero=zero),
        loss_fn=lambda p, batch, window=0: T.lm_loss(p, cfg, batch, window=window),
        make_train_step=lambda opt, window=0: T.make_train_step(cfg, opt, window),
        make_prefill_step=lambda window=0: T.make_prefill_step(cfg, window),
        make_decode_step=lambda window=0: T.make_decode_step(cfg, window),
        init_cache=lambda batch, seq, window=0, device=None: T.init_cache(
            cfg, batch, seq, window, device),
    )


def make_batch_specs(cfg: ModelConfig, kind: str, batch: int, seq: int):
    """Shapes and dtypes of each input of a model's batch, in the JAX
    package's order: a prefill takes ``tokens`` (B, S); under the vision
    stub, ``vision_embeds`` (B, nv, D) bf16, ``tokens`` (B, max(S - nv, 1))
    and ``positions`` (B, nv + that, 3), the M-RoPE streams; an
    encoder-decoder takes ``frames`` (B, encoder_seq, D) bf16, the audio
    stub's frame embeddings, and ``tokens`` (B, min(S, max_decoder_seq)). A
    train batch adds ``labels`` of the tokens' shape, last. A decode step
    takes nothing beyond its token."""
    if kind not in ("train", "prefill"):
        return {}
    if cfg.encoder_decoder:
        dec_seq = min(seq, cfg.max_decoder_seq or seq)
        specs = {"frames": ((batch, cfg.encoder_seq, cfg.d_model), torch.bfloat16),
                 "tokens": ((batch, dec_seq), torch.int32)}
    elif cfg.frontend == "vision_stub":
        nv = cfg.n_vision_tokens
        txt = max(seq - nv, 1)
        specs = {"vision_embeds": ((batch, nv, cfg.d_model), torch.bfloat16),
                 "tokens": ((batch, txt), torch.int32),
                 "positions": ((batch, nv + txt, 3), torch.int32)}
    else:
        specs = {"tokens": ((batch, seq), torch.int32)}
    if kind == "train":
        specs["labels"] = specs["tokens"]
    return specs


def make_concrete_batch(cfg: ModelConfig, kind: str, batch: int, seq: int,
                        key: torch.Tensor) -> dict:
    """Random batch matching ``make_batch_specs``, drawn from a threefry
    ``key`` exactly as the JAX package draws it: one split per input in the
    specs' order; ``randint`` over the vocabulary for tokens and labels, a float32
    ``normal`` rounded to bf16 for the vision embeddings and the audio
    frames, and ``arange`` in
    all three streams for the positions (its split unused). Both packages
    make the same batch from the same seed, bit for bit, and so does a key
    on the card (the draws run on the key's device). The positions are
    made on the host whatever the key's device: the prefill checks their t
    stream there."""
    out = {}
    for name, (shape, dtype) in make_batch_specs(cfg, kind, batch, seq).items():
        key, sub = prng.split(key)
        if name == "positions":
            out[name] = torch.arange(shape[1], dtype=torch.int32)[None, :, None].expand(
                shape).contiguous()
        elif dtype == torch.int32:
            out[name] = prng.randint(sub, shape, 0, max(cfg.vocab_size, 2))
        else:
            out[name] = prng.normal(sub, shape).to(dtype)
    return out
