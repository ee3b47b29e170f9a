"""Wire-format compression codecs for the federated uplink — the port of
the JAX package's ``comm/codec.py``.

A ``Codec`` maps float32 values to a ``(payload, carrier)`` pair plus static
wire accounting (``wire_bytes(n)`` is a Python function of the element
count). Codecs work on a *batch of rows*: ``encode(flat, rng)`` takes
``flat`` of shape (..., n) and one key per row (``rng`` of shape (..., 2)),
and treats every row as the JAX package treats one client's vector — so the
round encodes all K client lanes of a leaf in one call. ``encode_leaves``
and ``decode_leaves`` take a list of such leaves; ``QuantizeCodec`` encodes
the list in one quantize launch and decodes it in one dequantize launch, so
``ef_steps`` compresses a round's leaves, of every layer, in one launch of
each.

Codecs:
  Float32Identity — raw float32 (lossless)
  QuantizeCodec   — int8/int4 per-block absmax quantization with stochastic
                    rounding on the CUDA kernel pair of
                    ``repro_torch.kernels.quantize``; int4 packs two nibbles
                    per byte in the wire buffer
  TopKCodec       — magnitude top-k sparsification (values + int32 indices)
  ChainedCodec    — composition, e.g. top-k then int8 on the survivors

Lossy codecs run with error feedback (``ef_step``): the caller carries a
residual ``e``, encodes ``delta + e`` and keeps ``(delta + e) - decoded``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import random as prng
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels.quantize import dequantize_leaves, quant_blocks, quantize_leaves


class Codec:
    """Base interface. Subclasses override encode/decode + accounting."""

    name: str = "codec"
    lossy: bool = False
    float_carrier: bool = True

    def encode(self, flat: torch.Tensor, rng: torch.Tensor) -> tuple[Any, torch.Tensor]:
        """flat (..., n) float32, rng (..., 2) -> (payload, carrier)."""
        raise NotImplementedError

    def decode(self, payload: Any, carrier: torch.Tensor) -> torch.Tensor:
        """Inverse of encode: the (..., n) float32 rows."""
        raise NotImplementedError

    def encode_leaves(self, flats: list, rngs: list) -> list:
        """``encode(flats[i], rngs[i])`` for every leaf."""
        return [self.encode(flat, rng) for flat, rng in zip(flats, rngs)]

    def decode_leaves(self, wires: list) -> list:
        """``decode(payload, carrier)`` for every ``(payload, carrier)`` leaf."""
        return [self.decode(payload, carrier) for payload, carrier in wires]

    def meta_bytes(self, n: int) -> float:
        return 0.0

    def carrier_size(self, n: int) -> int:
        return n

    def carrier_bits(self) -> float:
        return 32.0

    def wire_bytes(self, n: int) -> float:
        """One-way wire bytes for an n-element tensor through this codec."""
        if n == 0:
            return 0.0
        return self.meta_bytes(n) + self.carrier_size(n) * self.carrier_bits() / 8.0

    def roundtrip(self, x: torch.Tensor, rng: torch.Tensor) -> torch.Tensor:
        """decode(encode(x)) with x's shape and dtype restored. The key's
        leading dims are row dims of ``x``: a (2,) key encodes all of x as
        one vector, a (K, 2) key encodes each x[k] as its own."""
        return self._roundtrip_leaves([x], [rng])[0]

    def _roundtrip_leaves(self, xs: list, rngs: list) -> list:
        """``roundtrip(xs[i], rngs[i])`` for every leaf, the leaves encoded
        in one ``encode_leaves`` call and decoded in one ``decode_leaves``
        call."""
        flats = [x.reshape(*x.shape[: rng.ndim - 1], -1).to(torch.float32)
                 for x, rng in zip(xs, rngs)]
        decoded = self.decode_leaves(self.encode_leaves(flats, rngs))
        return [d.reshape(x.shape).to(x.dtype) for d, x in zip(decoded, xs)]

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"{type(self).__name__}({self.name})"


class Float32Identity(Codec):
    """Raw float32 on the wire — lossless, 4 bytes/param."""

    name = "float32"
    lossy = False

    def encode(self, flat, rng):
        return None, flat

    def decode(self, payload, carrier):
        return carrier


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """(..., N) int8 codes in [-8, 7] -> (..., ceil(N/2)) uint8, two per byte,
    low nibble first."""
    u = (q.to(torch.int32) + 8).to(torch.uint8)
    if q.shape[-1] % 2:
        u = torch.nn.functional.pad(u, (0, 1))
    return u[..., 0::2] | (u[..., 1::2] << 4)


def _unpack_nibbles(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``_pack_nibbles``: (..., ceil(N/2)) uint8 -> (..., N) int8."""
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    u = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)[..., :n]
    return (u - 8).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class QuantizeCodec(Codec):
    """Per-block absmax integer quantization (int8, or int4 with ``bits=4``)
    with stochastic rounding; one float32 scale per block of each row. The
    noise is the JAX package's: ``uniform(rng, (n,))`` per row."""

    bits: int = 8
    block: int = 512
    stochastic: bool = True

    name = "quantize"
    lossy = True
    float_carrier = False

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"QuantizeCodec supports bits in (4, 8), got {self.bits}")
        object.__setattr__(self, "name", f"int{self.bits}")

    def encode(self, flat, rng):
        return self.encode_leaves([flat], [rng])[0]

    def encode_leaves(self, flats, rngs):
        """Every leaf's noise first, then one ``quantize_leaves`` call (one
        launch; at most 64 leaves); int4 packs each leaf's nibbles after
        it."""
        noises = [prng.uniform(rng, (flat.shape[-1],)) if self.stochastic else None
                  for flat, rng in zip(flats, rngs)]
        codes = quantize_leaves(flats, noises, bits=self.bits, block_p=self.block)
        if self.bits == 4:
            return [((scales, q.shape[-1]), _pack_nibbles(q)) for q, scales in codes]
        return [(scales, q) for q, scales in codes]

    def decode(self, payload, carrier):
        return self.decode_leaves([(payload, carrier)])[0]

    def decode_leaves(self, wires):
        """Every leaf's codes (int4 unpacks each leaf's nibbles first) in
        one ``dequantize_leaves`` call (one launch; at most 64 leaves)."""
        codes = []
        for payload, carrier in wires:
            if self.bits == 4:
                scales, n = payload
                codes.append((_unpack_nibbles(carrier, n), scales))
            else:
                codes.append((carrier, payload))
        return dequantize_leaves(codes, block_p=self.block)

    def meta_bytes(self, n):
        _, nb = quant_blocks(n, self.block)
        return 4.0 * nb

    def carrier_size(self, n):
        return (n + 1) // 2 if self.bits == 4 else n

    def carrier_bits(self):
        return 8.0


@dataclasses.dataclass(frozen=True)
class TopKCodec(Codec):
    """Magnitude top-k sparsification: the k = ceil(fraction*n) largest
    entries of each row as (value, int32 index) pairs. Ties keep the lower
    index first, as ``jax.lax.top_k`` does (a stable descending sort)."""

    fraction: float = 0.1
    index_bytes: float = 4.0

    name = "topk"
    lossy = True

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1], got {self.fraction}")
        object.__setattr__(self, "name", f"topk{self.fraction:g}")

    def _k(self, n: int) -> int:
        return max(1, min(n, math.ceil(self.fraction * n)))

    def encode(self, flat, rng):
        n = flat.shape[-1]
        order = torch.sort(torch.abs(flat), dim=-1, descending=True, stable=True).indices
        idx = order[..., : self._k(n)]
        return (idx, n), torch.gather(flat, -1, idx)

    def decode(self, payload, carrier):
        idx, n = payload
        out = torch.zeros((*carrier.shape[:-1], n), dtype=carrier.dtype, device=carrier.device)
        return out.scatter(-1, idx, carrier)

    def meta_bytes(self, n):
        return self.index_bytes * self._k(n)

    def carrier_size(self, n):
        return self._k(n)


class ChainedCodec(Codec):
    """Sequential composition: each stage compresses the previous stage's
    carrier; every stage but the last must ship a float32 carrier."""

    lossy = True

    def __init__(self, codecs: list[Codec]):
        if len(codecs) < 2:
            raise ValueError("ChainedCodec needs at least two stages")
        for c in codecs[:-1]:
            if not c.float_carrier:
                raise ValueError(
                    f"codec {c.name!r} ships a non-float carrier and can only be "
                    f"the last stage of a chain (got {[x.name for x in codecs]})"
                )
        self.codecs = list(codecs)
        self.name = "+".join(c.name for c in self.codecs)
        self.lossy = any(c.lossy for c in self.codecs)
        self.float_carrier = self.codecs[-1].float_carrier

    def encode(self, flat, rng):
        payloads = []
        carrier = flat
        for i, c in enumerate(self.codecs):
            payload, carrier = c.encode(carrier, prng.fold_in(rng, i))
            payloads.append(payload)
        return payloads, carrier

    def decode(self, payloads, carrier):
        for c, payload in zip(reversed(self.codecs), reversed(payloads)):
            carrier = c.decode(payload, carrier)
        return carrier

    def meta_bytes(self, n):
        total, size = 0.0, n
        for c in self.codecs:
            total += c.meta_bytes(size)
            size = c.carrier_size(size)
        return total

    def carrier_size(self, n):
        size = n
        for c in self.codecs:
            size = c.carrier_size(size)
        return size

    def carrier_bits(self):
        return self.codecs[-1].carrier_bits()


_CODEC_ATOMS = {
    "float32": lambda **kw: Float32Identity(),
    "identity": lambda **kw: Float32Identity(),
    "none": lambda **kw: Float32Identity(),
    "fp32": lambda **kw: Float32Identity(),
    "quantize": lambda **kw: QuantizeCodec(bits=kw.get("bits", 8)),
    "int8": lambda **kw: QuantizeCodec(bits=8),
    "int4": lambda **kw: QuantizeCodec(bits=4),
    "topk": lambda **kw: TopKCodec(fraction=kw.get("topk_fraction", 0.1)),
}


def make_codec(spec: str, bits: int = 8, topk_fraction: float = 0.1) -> Codec:
    """Build a codec from an FLConfig-style spec (``+`` chains atoms)."""

    def atom(s: str) -> Codec:
        s = s.strip().lower()
        if s not in _CODEC_ATOMS:
            raise ValueError(
                f"unknown codec atom {s!r} in spec {spec!r}; have {sorted(_CODEC_ATOMS)}"
            )
        return _CODEC_ATOMS[s](bits=bits, topk_fraction=topk_fraction)

    parts = [p for p in spec.split("+") if p.strip()]
    if not parts:
        raise ValueError(f"empty codec spec {spec!r}")
    if len(parts) == 1:
        return atom(parts[0])
    return ChainedCodec([atom(p) for p in parts])


def tree_wire_bytes(codec: Codec, tree) -> float:
    """Static one-way wire bytes for every leaf of a tree through codec."""
    return float(sum(codec.wire_bytes(int(leaf.numel())) for leaf in tree_leaves(tree)))


def _roundtrip_trees(codec: Codec, trees: list, rngs: list) -> list:
    """decode(encode(leaf)) for every leaf of every tree, leaf i of tree j
    with key ``fold_in(rngs[j], i)`` in ``jax.tree.leaves`` order (dict keys
    sorted); the leaves of all the trees go through one
    ``codec._roundtrip_leaves`` call."""
    leaves = [tree_leaves(tree) for tree in trees]
    keys = [prng.fold_in(rng, i) for ls, rng in zip(leaves, rngs) for i in range(len(ls))]
    out = iter(codec._roundtrip_leaves([leaf for ls in leaves for leaf in ls], keys))
    return [tree_unflatten(tree, [next(out) for _ in ls]) for tree, ls in zip(trees, leaves)]


def roundtrip_tree(codec: Codec, tree, rng: torch.Tensor):
    """``_roundtrip_trees`` of one tree."""
    return _roundtrip_trees(codec, [tree], [rng])[0]


def ef_steps(codec: Codec, deltas: list, residuals: list, rngs: list) -> list:
    """``ef_step(codec, deltas[j], residuals[j], rngs[j])`` for every j, the
    compressions in one ``_roundtrip_trees`` call."""
    compensated = [tree_map(lambda d, e: d + e, delta, residual)
                   for delta, residual in zip(deltas, residuals)]
    decoded = _roundtrip_trees(codec, compensated, rngs)
    return [(dec, tree_map(lambda c, d: c - d, comp, dec))
            for comp, dec in zip(compensated, decoded)]


def ef_step(codec: Codec, delta, residual, rng: torch.Tensor):
    """One error-feedback compression step on a tree: returns the decoded
    update and the new residual ``(delta + residual) - decoded``."""
    return ef_steps(codec, [delta], [residual], [rng])[0]
