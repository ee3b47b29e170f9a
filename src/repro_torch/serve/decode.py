"""Prefill/decode serving loops for the port's decoder LMs.

``greedy_decode`` is the batched prefill -> autoregressive-decode loop:
prefill the batch, then step the decoder, sampling greedily (or by
temperature), retiring lanes on the model's EOS token, and counting
generated tokens per lane.

``DecodeProgram`` lifts the loop into ``ContinuousBatcher`` for token-only
LMs: lanes retire on EOS/max-new and are back-filled from the queue by
re-prefilling the joined batch (surviving lanes re-prefill on the tail of
their prompt + generated tokens, since the cache position is batch-global).
Tokens are counted once, when a lane appends them.

A port of the JAX package's ``serve/decode.py``: the same control flow and
accounting, sampling from the same threefry keys (``repro_torch.random``).
The step functions take token tensors on any device and run on the model's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.serve.batching import LaneProgram, ServeRequest

__all__ = ["greedy_decode", "DecodeLane", "DecodeProgram", "token_only_prefill"]


def _sample(logits: torch.Tensor, temperature: float, rng: torch.Tensor):
    """(B, V) float32 logits -> ((B, 1) int32 token, next rng)."""
    if temperature > 0.0:
        rng, sub = prng.split(rng)
        tok = prng.categorical(sub, logits / temperature)[:, None]
    else:
        tok = torch.argmax(logits, dim=-1)[:, None]
    return tok.to(torch.int32), rng


def greedy_decode(prefill: Callable, decode: Callable, params, batch: dict, max_new: int, *,
                  eos_id: int | None = None, temperature: float = 0.0,
                  rng: torch.Tensor | None = None):
    """Batched prefill + decode for one wave of requests.

    Returns ``(seqs, n_generated)``: per-lane generated token-id lists and
    the (B,) per-lane count; lanes that hit ``eos_id`` stop accruing (their
    EOS is the last counted token)."""
    if rng is None:
        rng = prng.PRNGKey(0)
    logits, cache = prefill(params, batch)
    tok, rng = _sample(logits, temperature, rng)
    b = int(tok.shape[0])
    host = tok[:, 0].cpu().numpy()
    seqs = [[int(host[i])] for i in range(b)]
    alive = np.ones(b, bool)
    if eos_id is not None:
        alive &= host != eos_id
    for _ in range(max_new - 1):
        if not alive.any():
            break
        logits, cache = decode(params, cache, tok)
        tok, rng = _sample(logits, temperature, rng)
        host = tok[:, 0].cpu().numpy()
        for i in range(b):
            if alive[i]:
                seqs[i].append(int(host[i]))
                if eos_id is not None and host[i] == eos_id:
                    alive[i] = False
    return seqs, np.asarray([len(s) for s in seqs], np.int64)


def token_only_prefill(cfg) -> bool:
    """True when the arch's prefill batch is just ``tokens``."""
    from repro_torch.models.api import make_batch_specs

    return set(make_batch_specs(cfg, "prefill", 1, 8)) == {"tokens"}


@dataclasses.dataclass
class DecodeLane:
    prompt: np.ndarray            # (S,) int32 — the request's prompt
    generated: list               # token ids appended so far
    budget: int                   # max_new for this request
    fresh: bool = True            # needs (re-)prefill before decoding


class DecodeProgram(LaneProgram):
    """Continuous-batching decode over B lanes of a token-only LM.

    Each ``step`` is either a joined re-prefill (whenever any occupied lane
    is fresh) or one decode step. A lane is done when it emits ``eos_id`` or
    exhausts its budget; a backfill marks every occupied lane fresh.
    ``tokens_out`` counts each generated token exactly once;
    ``prefill_calls`` counts the prefills."""

    def __init__(self, prefill, decode, params, batch_size: int, prompt_len: int, eos_id: int,
                 temperature: float = 0.0, rng: torch.Tensor | None = None):
        self.prefill, self.decode, self.params = prefill, decode, params
        self.b, self.s = batch_size, prompt_len
        self.eos_id, self.temperature = eos_id, temperature
        self.rng = rng if rng is not None else prng.PRNGKey(0)
        self.lanes: list[DecodeLane | None] = [None] * batch_size
        self._cache = None
        self._tok = None
        self.tokens_out = 0
        self.prefill_calls = 0

    def start(self, lane: int, req: ServeRequest) -> None:
        prompt = np.asarray(req.inputs, np.int32).reshape(-1)
        self.lanes[lane] = DecodeLane(prompt=prompt, generated=[], budget=req.steps)
        for ln in self.lanes:  # the joined batch re-prefills at a common position
            if ln is not None:
                ln.fresh = True

    def _context(self, ln: DecodeLane) -> np.ndarray:
        """(S,) re-prefill context: prompt + generated, last S tokens."""
        ctx = np.concatenate([ln.prompt, np.asarray(ln.generated, np.int32)])
        return ctx[-self.s:] if ctx.shape[0] >= self.s else np.pad(ctx, (self.s - ctx.shape[0], 0))

    def step(self, occupied: np.ndarray):
        any_fresh = any(occupied[i] and self.lanes[i] is not None and self.lanes[i].fresh
                        for i in range(self.b))
        if any_fresh or self._cache is None:
            toks = np.zeros((self.b, self.s), np.int32)
            for i in range(self.b):
                if occupied[i]:
                    toks[i] = self._context(self.lanes[i])
                    self.lanes[i].fresh = False
            self._cache = None  # free the old cache before the prefill builds a new one
            logits, self._cache = self.prefill(self.params, {"tokens": torch.from_numpy(toks)})
            self.prefill_calls += 1
        else:
            logits, self._cache = self.decode(self.params, self._cache, self._tok)
        self._tok, self.rng = _sample(logits, self.temperature, self.rng)
        host = self._tok[:, 0].cpu().numpy()
        done = np.zeros((self.b,), bool)
        outputs: list[Any] = [None] * self.b
        for i in range(self.b):
            if not occupied[i]:
                continue
            ln = self.lanes[i]
            ln.generated.append(int(host[i]))
            self.tokens_out += 1
            if host[i] == self.eos_id or len(ln.generated) >= ln.budget:
                done[i] = True
                outputs[i] = list(ln.generated)
                self.lanes[i] = None
        return done, outputs

    def finish_steps(self, lane: int, output) -> int:
        """Tokens generated by a finished lane (EOS can undershoot the
        budget): what the batcher records as the request's steps."""
        return len(output)
