"""Uniform model API of the port (decoder-only LMs of the serving slice).

    bundle = get_model(cfg)
    model  = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()

The JAX package's facade over decoder-only and encoder-decoder families;
the encoder-decoder family (whisper), the vision frontend and training come
with ROADMAP.md queue 1 item 14 and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import random as prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

_TODO = "ROADMAP.md queue 1 item 14 (model zoo)"


def _no_training(*args, **kwargs):
    raise NotImplementedError(f"training (lm_loss, train steps, ssm_vjp): {_TODO}")


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]
    loss_fn: Callable
    make_train_step: Callable
    make_prefill_step: Callable
    make_decode_step: Callable
    init_cache: Callable  # (batch, seq, window, device) -> cache


def get_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.encoder_decoder:
        raise NotImplementedError(f"encoder-decoder models (whisper): {_TODO}")
    T.check_supported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda gen: T.init_params(gen, cfg),
        loss_fn=_no_training,
        make_train_step=_no_training,
        make_prefill_step=lambda window=0: T.make_prefill_step(cfg, window),
        make_decode_step=lambda window=0: T.make_decode_step(cfg, window),
        init_cache=lambda batch, seq, window=0, device=None: T.init_cache(
            cfg, batch, seq, window, device),
    )


def make_batch_specs(cfg: ModelConfig, kind: str, batch: int, seq: int):
    """Shapes and dtypes of each input of a token-only LM's batch: a
    prefill takes ``tokens``, a decode step nothing beyond its token."""
    if cfg.encoder_decoder or cfg.frontend != "none":
        raise NotImplementedError(f"inputs of the {cfg.frontend!r} frontend: {_TODO}")
    if kind == "train":
        _no_training()
    return {"tokens": ((batch, seq), torch.int32)} if kind == "prefill" else {}


def make_concrete_batch(cfg: ModelConfig, kind: str, batch: int, seq: int,
                        key: torch.Tensor) -> dict:
    """Random token batch matching ``make_batch_specs``, drawn from a
    threefry ``key`` exactly as the JAX package draws it (one split per
    input, ``randint`` over the vocabulary), so both packages make the same
    prompts from the same seed."""
    out = {}
    for name, (shape, _) in make_batch_specs(cfg, kind, batch, seq).items():
        key, sub = prng.split(key)
        out[name] = prng.randint(sub, shape, 0, max(cfg.vocab_size, 2))
    return out
