"""Counter-based threefry2x32 PRNG in torch integer ops — jax.random's bits.

The JAX package draws every random number from ``jax.random`` with explicit
keys; the golden trajectories depend on those exact bits (init and loop keys,
per-client key lanes, stochastic-rounding noise, selection draws). This
module reproduces them: the same Threefry-2x32 hash (20 rounds, Salmon et al.
2011) and the same key derivations as jax, under either setting of jax's
``jax_threefry_partitionable`` flag, so

- ``PRNGKey``, ``split``, ``fold_in``, ``bits`` and ``uniform`` are bitwise
  equal to ``jax.random`` (``tests/test_torch_random.py``);
- ``randint`` is bitwise equal to ``jax.random.randint`` (int32), and
  ``permutation`` of an integer to ``jax.random.permutation``;
- ``normal`` is bitwise ``jax.random.normal`` on the CPU: its ``erfinv``
  repeats XLA's float32 arithmetic step for step;
- ``gumbel`` goes through torch's float32 ``log``, which differs from
  XLA's by a few ulp, and so does ``categorical`` (``argmax(gumbel +
  logits)``) where two logits are that close.

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
import math

import torch

__all__ = ["PRNGKey", "split", "fold_in", "bits", "uniform", "randint", "gumbel",
           "categorical", "normal", "permutation", "threefry_partitionable"]

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


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for an integer ``n``: jax's
    ``_shuffle`` of ``arange(n)`` (int32). ``ceil(3 ln(max(1, n)) /
    ln(2**32 - 1))`` rounds, each splitting the key in two, drawing 32-bit
    ``bits`` of the second half for every element and reordering the
    elements by a stable sort of those bits (ties keep their order, as
    XLA's stable ``sort_key_val`` does)."""
    n = int(n)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M32))
    x = torch.arange(n, dtype=torch.int32, device=key.device)
    for _ in range(rounds):
        keys = split(key)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = x[order]
    return x


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


# XLA's float32 erf_inv on the CPU, operation for operation as its optimized
# LLVM IR computes it: Giles' polynomials ("Approximating the erfinv
# function", GPU Computing Gems 2011) in w = -log1p(-x^2), log1p by XLA's
# Cephes rational function below sqrt(2) - 1 and by Eigen's Cephes log of
# 1 - x^2 above it. LLVM contracts each multiply that feeds one add into a
# fused multiply-add (``_fma``); the square root is rounded correctly. The
# result is bitwise ``jax.lax.erf_inv`` on the CPU
# (tests/test_torch_random.py). torch.special.erfinv uses another
# approximation (~90 ulp apart near +-1), and torch's float32 log1p and
# sqrt are not XLA's to the last bit.
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# log1p(y) for |y| < sqrt(2) - 1: y - y^2/2 + y^3 P(y)/Q(y)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
# log(m) on [sqrt(1/2), sqrt(2)), p0 .. p8, and log(2) split as q2 - q1
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.707106781186547524


def _f32(c: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 rounding of a constant, on ``like``'s device (a fill)."""
    return torch.full((), c, dtype=torch.float64, device=like.device).to(torch.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product is exact in float64,
    the sum is taken in float64 rounded to odd (its error, by TwoSum,
    decides the last bit), so the rounding to float32 is correct."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    inf = torch.full((), float("inf"), dtype=torch.float64, device=s.device)
    to_odd = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(to_odd, torch.nextafter(s, torch.where(err > 0, inf, -inf)), s).to(
        torch.float32)


def _log(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log (Eigen's Cephes ``plog``): y = m 2^e with m in
    [sqrt(1/2), sqrt(2)), then an Estrin-ordered polynomial in m - 1."""
    f = lambda c: _f32(c, y)  # noqa: E731
    bits = torch.maximum(y, f(torch.finfo(torch.float32).tiny)).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    small = m < f(_SQRT_HALF)
    e = e - small.to(torch.float32)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y1 = _fma(_fma(x, f(p[0]), f(p[1])), x, f(p[2]))
    y2 = _fma(_fma(x, f(p[3]), f(p[4])), x, f(p[5]))
    y3 = _fma(_fma(x, f(p[6]), f(p[7])), x, f(p[8]))
    r = _fma(_fma(_fma(y1, x3, y2), x3, y3), x3, e * f(_LOG_Q1))
    r = _fma(e, f(_LOG_Q2), (x - x2 * 0.5) + r)
    r = torch.where(y > 0, r, torch.where(y == 0, -float("inf"), float("nan")))
    return torch.where(y == float("inf"), y, r)


def _log1p(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: the rational function for |y| < sqrt(2) - 1,
    ``log(1 + y)`` above."""
    f = lambda c: _f32(c, y)  # noqa: E731
    num = torch.zeros_like(y) + f(_LOG1P_P[0])
    den = torch.zeros_like(y) + f(_LOG1P_Q[0])
    for c in _LOG1P_P[1:]:
        num = _fma(num, y, f(c))
    for c in _LOG1P_Q[1:]:
        den = _fma(den, y, f(c))
    y2 = y * y
    small = y + (y2 * -0.5 + (y * y2) * (num / den))
    return torch.where(y.abs() < f(0.41421356237309504880), small, _log(y + 1.0))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erfinv``, bitwise XLA's ``erf_inv`` on the CPU (see the
    note above)."""
    l1p = _log1p(x * -x)
    lt = l1p > -5.0  # w = -log1p(-x^2) < 5
    root = torch.sqrt(-l1p.to(torch.float64)).to(torch.float32)  # correctly rounded
    w = torch.where(lt, -2.5 - l1p, root - 3.0)
    p = None
    for lo_c, hi_c in zip(_ERFINV_W_LT5, _ERFINV_W_GE5):
        c = torch.where(lt, _f32(lo_c, x), _f32(hi_c, x))
        p = c if p is None else _fma(w, p, c)
    return x * torch.where(x.abs() == 1.0, float("inf"), p)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape, minval=lo, maxval=1.0)
    sqrt2 = torch.tensor(2.0, dtype=torch.float64).sqrt().to(torch.float32).item()
    return erfinv(u) * sqrt2
