"""The contracts of flash_attention: how closely a bf16 forward result must
match ``flash_attention_plain`` (``bf16_contract``), and how closely the
backward kernel's dQ, dK, dV must match the backward computed in float64
(``bwd_check``), and their checks.

Both round the float32 P of each key tile to bf16 before P.V. A second
correct implementation sums the scores in another order and takes exp
another way, so its float32 P differs from the plain version's in the last
bits, and the few P elements that lie that close to a bf16 rounding
boundary round to the neighbouring bf16 value. One such flip moves its
row's output by one bf16 ulp of p times |v| / l, which on a row with few
keys (small l) exceeds 1 bf16 ulp of the output. So a bf16 result meets
the contract when

- every element is within 1 bf16 ulp of the plain value + ``REL`` of
  max|plain| + ``p_rounding_slack`` (what flips of P elements within
  ``SLACK_EPS`` of a rounding boundary can move), and
- at most ``MAX_OVER_SHARE`` of the elements need the slack, that is
  exceed 1 bf16 ulp + ``REL`` of max alone. A systematic error, such as
  keeping P in float32 or a mask that drops one key, exceeds that bound on
  a far larger share and fails.

The backward kernel (``csrc/flash_attention_bwd.cu``) computes the
formulas of ``flash_attention_backward_plain`` in float32 but keeps P in
float32 where the bf16 forward rounded it, sums over 64-row and 64-key
tiles and the G query heads in its own order with fused multiply-adds, and
takes exp on its own; so it does not follow the float32 plain backward bit
for bit. Both are held instead to ``ref64``, the plain backward run in
float64 on the same inputs (q, k, v, the forward's output o and lse, dO).
The reference takes o and lse as the forward kernel wrote them: o carries
the forward's rounding (its bf16 P in bfloat16), and D = rowsum(dO * o)
must see the same o. For each of dQ, dK, dV:

- every element within ``BWD_FACTOR`` x max|plain32 - ref64| (the float32
  plain backward's own gap) + ``BWD_REL`` of max|ref64|, plus, for a
  bfloat16 result, 1 bf16 ulp of ref64 at that element (its rounding).

``bwd_controls`` builds two faults from the float32 plain backward that the
check must reject: D left out of dS (dS = P dP), and P off by a relative
2^-10 (lse shifted by 2^-10; 2^-6 for a bfloat16 result, whose 1-ulp
allowance, 2^-8 relative, covers a smaller shift).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import (
    _layout,
    flash_attention_backward_plain,
    softmax_tiles,
)

__all__ = ["BWD_FACTOR", "BWD_REL", "MAX_OVER_SHARE", "REL", "SLACK_EPS", "bf16_contract",
           "bwd_check", "bwd_controls", "bwd_references", "p_rounding_slack"]

REL = 1e-5
# the relative change of a float32 p the slack allows for: ~16x the score
# differences of two summation orders at D = 128 and ~128x the error of
# the wgmma kernel's ex2.approx against exp
SLACK_EPS = 2.0 ** -14
MAX_OVER_SHARE = 1e-3
BWD_FACTOR = 8.0
BWD_REL = 1e-5


def p_rounding_slack(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """float32 (B, S, H, Dv): for each P element of the plain version (bf16
    inputs; v's head dim Dv may differ from q's and k's, as in MLA) whose
    bf16 rounding a relative change of ``SLACK_EPS`` can flip, one bf16 ulp
    of p times |v|, summed over keys and divided by l as the output is."""
    tiny = torch.finfo(torch.float32).tiny
    l = slack = 0.0
    for p, corr, vt, _ in softmax_tiles(q, k, v, causal, window):
        l = l * corr + p.sum(dim=-1)
        flip = (p * (1 + SLACK_EPS)).to(torch.bfloat16) != (p * (1 - SLACK_EPS)).to(torch.bfloat16)
        ulp = torch.exp2(torch.floor(torch.log2(p.clamp_min(tiny))) - 7)
        slack = slack * corr[..., None] + torch.matmul(torch.where(flip, ulp, 0.0), vt.abs())
    return _layout(slack / torch.clamp_min(l, 1e-30)[..., None], q)


def bf16_contract(got, want, q, k, v, causal: bool = True, window: int = 0) -> dict:
    """``got`` (bf16) against ``want`` = ``flash_attention_plain(q, k, v,
    causal, window)``: ``over_ulp``, the largest excess of |got - want|
    over 1 bf16 ulp of want + ``REL`` of max|want|, in units of max|want|;
    ``n_over``, the elements over that bound, of ``n``; ``excess``, the
    largest excess over that bound + ``p_rounding_slack``; ``ok``, whether
    ``got`` is bf16, ``excess`` <= 0 and ``n_over`` <= ``MAX_OVER_SHARE``
    of ``n``."""
    is_bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float().to(got.device)
    tiny = torch.finfo(torch.float32).tiny
    scale = max(float(want.abs().max()), 1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(tiny))) - 7)
    over = (got - want).abs() - ulp - REL * scale
    n_over, n, over_ulp = int((over > 0).sum()), over.numel(), float(over.max()) / scale
    excess = float((over - p_rounding_slack(q, k, v, causal, window).to(over.device)).max()) / scale
    return dict(over_ulp=over_ulp, n_over=n_over, n=n, excess=excess,
                ok=is_bf16 and excess <= 0 and n_over <= MAX_OVER_SHARE * n)


def bwd_references(q, k, v, out, lse, dout, causal: bool = True, window: int = 0):
    """``(plain32, ref64)``: the (dQ, dK, dV) of
    ``flash_attention_backward_plain`` in float32 and in float64 on the
    same inputs."""
    args = (q, k, v, out, lse, dout, causal, window)
    return (flash_attention_backward_plain(*args, dtype=torch.float32),
            flash_attention_backward_plain(*args, acc_dtype=torch.float64, dtype=torch.float64))


def bwd_check(got, plain32, ref64) -> dict:
    """``got`` (dQ, dK, dV; float32 or bfloat16) against ``ref64`` and
    ``plain32`` from ``bwd_references``: for each, ``gap`` = max|got -
    ref64| and ``excess``, the largest excess of an element over what the
    contract allows, both over max|ref64| (``excess`` <= 0 passes); ``ok``:
    every excess <= 0 and every result float32 or bfloat16."""
    out, ok = {}, True
    tiny = torch.finfo(torch.float32).tiny
    for name, g, p32, r in zip(("dq", "dk", "dv"), got, plain32, ref64):
        g, p32 = g.to(r.device, torch.float64), p32.to(r.device, torch.float64)
        scale = max(float(r.abs().max()), 1e-300) if r.numel() else 1e-300
        allowed = BWD_FACTOR * float((p32 - r).abs().max()) + BWD_REL * scale
        if got[0].dtype == torch.bfloat16:
            allowed = allowed + torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(tiny))) - 7)
        diff = (g - r).abs()
        out[f"{name}_gap"] = float(diff.max()) / scale if r.numel() else 0.0
        out[f"{name}_excess"] = float((diff - allowed).max()) / scale if r.numel() else -1.0
        ok = ok and out[f"{name}_excess"] <= 0
    out["ok"] = bool(ok and got[0].dtype in (torch.float32, torch.bfloat16))
    return out


def bwd_controls(q, k, v, out, lse, dout, causal: bool = True, window: int = 0) -> dict:
    """Two faulty backwards, (dQ, dK, dV) in q's dtype each, that
    ``bwd_check`` must reject: D left out of dS, and P off by a relative
    2^-10 (2^-6 in bfloat16)."""
    shift = -10 if q.dtype == torch.float32 else -6

    def plain(o, l):
        return flash_attention_backward_plain(q, k, v, o, l, dout, causal, window)
    return {"D left out": plain(torch.zeros_like(out), lse),
            f"P off by 2^{shift}": plain(out, lse - 2.0 ** shift)}
