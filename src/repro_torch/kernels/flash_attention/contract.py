"""The bfloat16 contract of flash_attention: how closely a bf16 result must
match ``flash_attention_plain``, and its check.

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
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import _layout, softmax_tiles

__all__ = ["MAX_OVER_SHARE", "REL", "SLACK_EPS", "bf16_contract", "p_rounding_slack"]

REL = 1e-5
# the relative change of a float32 p the slack allows for: ~16x the score
# differences of two summation orders at D = 128 and ~128x the error of
# the wgmma kernel's ex2.approx against exp
SLACK_EPS = 2.0 ** -14
MAX_OVER_SHARE = 1e-3


def p_rounding_slack(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """float32 (B, S, H, Dv): for each P element of the plain version (bf16
    inputs; v's head dim Dv may differ from q's and k's, as in MLA) whose
    bf16 rounding a relative change of ``SLACK_EPS`` can flip, one bf16 ulp
    of p times |v|, summed over keys and divided by l as the output is."""
    tiny = torch.finfo(torch.float32).tiny
    l = slack = 0.0
    for p, corr, vt in softmax_tiles(q, k, v, causal, window):
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
