"""Counter-based threefry2x32 PRNG in torch integer ops — jax.random's bits.

The JAX package draws every random number from ``jax.random`` with explicit
keys; the golden trajectories depend on those exact bits (init and loop keys,
per-client key lanes, stochastic-rounding noise, selection draws). This
module reproduces them: the same Threefry-2x32 hash (20 rounds, Salmon et al.
2011) and the same key derivations as jax, under either setting of jax's
``jax_threefry_partitionable`` flag, so

- ``PRNGKey``, ``split``, ``fold_in``, ``bits`` and ``uniform`` are bitwise
  equal to ``jax.random`` (``tests/test_torch_random.py``);
- ``randint`` is bitwise equal to ``jax.random.randint`` (int32);
- ``gumbel`` and ``normal`` go through ``log``/``erfinv``, whose float32
  implementations differ between XLA and torch by a few ulp, and so does
  ``categorical`` (``argmax(gumbel + logits)``) where two logits are that
  close.

Draws make their constants with device fills, never copies from host
memory, so the FL round that draws them can be captured in a CUDA graph.

The two settings give different streams from the same key. The port follows
the installed jax's default (partitionable, ``True``); the repository's
committed golden trajectories were drawn under the legacy stream, so code
that reproduces them runs inside ``threefry_partitionable(False)``, the
counterpart of ``jax.threefry_partitionable(False)``.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
(int64 because torch's uint32 lacks the shift/xor kernels on every device).
Leading dimensions are batches of keys: every draw maps a ``(..., 2)`` key
to a ``(...) + shape`` result, which is how ``jax.vmap`` over keys reads here.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

__all__ = ["PRNGKey", "split", "fold_in", "bits", "uniform", "randint", "gumbel",
           "categorical", "normal", "threefry_partitionable"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

_PARTITIONABLE = contextvars.ContextVar("threefry_partitionable", default=True)


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """Draw from jax's partitionable (``True``, jax's default) or legacy
    (``False``) threefry stream inside the block, as
    ``jax.threefry_partitionable(flag)`` does for jax."""
    token = _PARTITIONABLE.set(bool(flag))
    try:
        yield
    finally:
        _PARTITIONABLE.reset(token)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block cipher on uint32 words held in int64 tensors
    (all four broadcast together). Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32-range seed: ``[0, seed]``
    as uint32 words (jax converts the seed to int32 without x64, so the high
    word is 0)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _counter_words(key: torch.Tensor, n: int):
    """Partitionable stream: the two threefry output words for counters
    ``0..n-1``, each laid out as jax's ``iota_2x32_shape`` (high word
    ``i >> 32`` = 0, low word ``i``); shape ``key.shape[:-1] + (n,)``."""
    if n >= 2**31:
        raise NotImplementedError("2**31 or more draws from one key")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(lo), lo)


def _legacy_words(key: torch.Tensor, n: int) -> torch.Tensor:
    """Legacy stream: jax's ``threefry_2x32`` over ``iota(n)`` — the count
    padded with one 0 to an even length, its first half hashed in the first
    word and its second half in the second, the n output words in order."""
    if n >= 2**31:
        raise NotImplementedError("2**31 or more draws from one key")
    half = (n + 1) // 2
    counts = torch.arange(2 * half, dtype=torch.int64, device=key.device)
    counts[n:].fill_(0)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], counts[:half], counts[half:])
    return torch.cat([b1, b2], dim=-1)[..., :n]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2) -> (..., num, 2)``."""
    if _PARTITIONABLE.get():
        return torch.stack(_counter_words(key, num), dim=-1)
    return _legacy_words(key, 2 * num).reshape(key.shape[:-1] + (num, 2))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash ``data`` (as uint32) into the key (the
    same in both streams)."""
    d = torch.full((), int(data) & _M32, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): uint32 words, int64-held, of shape
    ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    n = _numel(shape)
    if _PARTITIONABLE.get():
        b1, b2 = _counter_words(key, n)
        words = b1 ^ b2
    else:
        words = _legacy_words(key, n)
    return words.reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under a
    unit exponent, minus one, then ``max(minval, u * (maxval - minval) +
    minval)`` with every step in float32, as jax computes it."""
    b = bits(key, shape)
    fbits = ((b >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` with jax's default int32 dtype: values in
    ``[minval, maxval)`` from two 32-bit draws of the key's two halves,
    reduced modulo the span in wrapping uint32 arithmetic, as jax computes
    them (its multiplier ``(2**16 % span)**2 % span`` wraps to 0 once the
    span exceeds 2**16)."""
    minval, maxval = int(minval), int(maxval)
    if not -(2**31) <= minval < 2**31 or not -(2**31) <= maxval < 2**31:
        raise ValueError(f"randint bounds must fit in int32, got [{minval}, {maxval})")
    shape = tuple(shape)
    keys = split(key)
    higher, lower = bits(keys[..., 0, :], shape), bits(keys[..., 1, :], shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = (((higher % span) * multiplier) & _M32) + lower % span
    offset = (offset & _M32) % span
    out = (offset + minval + 2**31) % 2**32 - 2**31  # int32 wrap-around add
    return out.to(torch.int32)


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel`` (default ``mode='low'``): ``-log(-log(u))`` with
    ``u`` uniform on ``[tiny, 1)``."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, minval=tiny, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of float32 ``logits``
    (one key for the whole array): ``argmax(gumbel + logits)``, the first
    index on ties as in jax. Returns int64 indices of shape
    ``logits.shape[:-1]``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, got {logits.dtype}")
    g = gumbel(key.to(logits.device), tuple(logits.shape))
    return torch.argmax(g + logits, dim=-1)


# Giles' single-precision erfinv polynomials ("Approximating the erfinv
# function", GPU Computing Gems 2011) — the float32 erf_inv XLA lowers to.
# torch.special.erfinv uses another approximation (~90 ulp apart near +-1).
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erfinv`` by Giles' polynomial, step for step as XLA
    evaluates it (within 3 ulp of ``jax.lax.erf_inv`` on the CPU)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for lo_c, hi_c in zip(_ERFINV_W_LT5, _ERFINV_W_GE5):
        c = torch.where(lt, torch.full((), lo_c, dtype=torch.float32, device=x.device),
                        torch.full((), hi_c, dtype=torch.float32, device=x.device))
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape, minval=lo, maxval=1.0)
    sqrt2 = torch.tensor(2.0, dtype=torch.float64).sqrt().to(torch.float32).item()
    return erfinv(u) * sqrt2
