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

Every function here takes the forward's ``q_pos`` and ``k_pos`` where the
call masks by positions (M-RoPE's t stream), and holds it to the plain
version under that mask with the same rules.

The backward kernels compute the formulas of
``flash_attention_backward_plain`` in float32 (the bf16 kernel,
``csrc/flash_attention_bwd_wgmma.cu``, rounds P to bf16 before dV and dS
before dK and dQ, where wgmma takes them as operands; the float32 kernel
rounds nothing), sum over their tiles and the G query heads in their own
order and take exp on their own; so they do not follow the float32 plain
backward bit for bit. Both are held instead to ``ref64``, the plain
backward run in float64 on the same inputs (q, k, v, the forward's output o
and lse, dO) with the same rounding points (P and dS rounded to bf16 from
float64 for a bf16 result). The reference takes o and lse as the forward
kernel wrote them: o carries the forward's rounding (its bf16 P in
bfloat16), and D = rowsum(dO * o) must see the same o. For each of dQ, dK,
dV, every element must lie within

- ``BWD_FACTOR`` x ``noise``, the float32 arithmetic's own gap: max|plain32
  - exact64| of the formulas without rounding points (so it measures the
  float32 sums and exp, not rounding flips), + ``BWD_REL`` of max|ref64|;
- for a bfloat16 result, + 1 bf16 ulp of ref64 at that element (its
  rounding);
- for bf16 inputs, + the ``slack`` of rounding flips (``bwd_references``):
  an element of P or dS whose bf16 rounding the kernel's float32 error
  could flip moves the products it enters by one bf16 ulp of it times the
  other operand's |value|. P's float32 error is relative: ``BWD_P_EPS``
  (the scores' float32 sums, ex2.approx and the rounding of lse log2 e,
  about 2^-19 at D = 128, with a margin). dS = P (dP - D) also carries
  the absolute float32 error of dP - D, which cancellation does not
  shrink: ``BWD_DOT_EPS`` x (sum_d |dO_d V_d| + sum_d |dO_d o_d|), a
  float32 sum's error bound in units of its terms' magnitudes (about 8 u;
  a 128-term sum's typical error is under u of that, its worst case 127
  u), plus dS's relative ``BWD_P_EPS``. An element is a candidate when the
  bf16 roundings of the two ends of its interval differ, and its slack is
  the ulp at the upper end.

No share of elements may exceed its bound (unlike the forward's
``MAX_OVER_SHARE``). ``bwd_controls`` builds faults from the plain backward
that the check must reject: D left out of dS (dS = P dP), P off by a
relative 2^-10 (lse shifted by 2^-10; 2^-6 for a bfloat16 result, whose
1-ulp allowance, 2^-8 relative, covers a smaller shift), and, for bf16
inputs, dS rounded to bf16 before D is subtracted (dS = bf16(P dP) - P D,
then rounded again as it enters dK and dQ: a plausible kernel bug whose
errors are of a rounding's size but not at the kernel's rounding point).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention.ops import (
    _layout,
    backward_grads,
    backward_terms,
    bf16_round,
    flash_attention_backward_plain,
    softmax_tiles,
    stack_grads,
)

__all__ = ["BWD_DOT_EPS", "BWD_FACTOR", "BWD_P_EPS", "BWD_REL", "MAX_OVER_SHARE", "REL",
           "SLACK_EPS", "BwdReference", "bf16_contract", "bwd_check", "bwd_controls",
           "bwd_references", "p_rounding_slack"]

REL = 1e-5
# the relative change of a float32 p the slack allows for: ~16x the score
# differences of two summation orders at D = 128 and ~128x the error of
# the wgmma kernel's ex2.approx against exp
SLACK_EPS = 2.0 ** -14
MAX_OVER_SHARE = 1e-3
BWD_FACTOR = 8.0
BWD_REL = 1e-5
BWD_P_EPS = 2.0 ** -16
BWD_DOT_EPS = 2.0 ** -21


def p_rounding_slack(q, k, v, causal: bool = True, window: int = 0, *, q_pos=None,
                     k_pos=None) -> torch.Tensor:
    """float32 (B, S, H, Dv): for each P element of the plain version (bf16
    inputs; v's head dim Dv may differ from q's and k's, as in MLA) whose
    bf16 rounding a relative change of ``SLACK_EPS`` can flip, one bf16 ulp
    of p times |v|, summed over keys and divided by l as the output is."""
    tiny = torch.finfo(torch.float32).tiny
    l = slack = 0.0
    for p, corr, vt, _ in softmax_tiles(q, k, v, causal, window, q_pos, k_pos):
        l = l * corr + p.sum(dim=-1)
        flip = (p * (1 + SLACK_EPS)).to(torch.bfloat16) != (p * (1 - SLACK_EPS)).to(torch.bfloat16)
        ulp = torch.exp2(torch.floor(torch.log2(p.clamp_min(tiny))) - 7)
        slack = slack * corr[..., None] + torch.matmul(torch.where(flip, ulp, 0.0), vt.abs())
    return _layout(slack / torch.clamp_min(l, 1e-30)[..., None], q)


def bf16_contract(got, want, q, k, v, causal: bool = True, window: int = 0, *, q_pos=None,
                  k_pos=None) -> dict:
    """``got`` (bf16) against ``want`` = ``flash_attention_plain(q, k, v,
    causal, window, q_pos=, k_pos=)``: ``over_ulp``, the largest excess of |got - want|
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
    slack = p_rounding_slack(q, k, v, causal, window, q_pos=q_pos, k_pos=k_pos)
    excess = float((over - slack.to(over.device)).max()) / scale
    return dict(over_ulp=over_ulp, n_over=n_over, n=n, excess=excess,
                ok=is_bf16 and excess <= 0 and n_over <= MAX_OVER_SHARE * n)


class BwdReference(NamedTuple):
    """What ``bwd_check`` holds a backward to, each a (dQ, dK, dV) triple:
    ``ref64``, the float64 plain backward with the kernel's rounding points;
    ``noise``, max|plain32 - exact64| of the formulas without rounding
    points (floats); ``slack``, the rounding flips' allowance per element
    (float64; zeros for float32 inputs)."""

    ref64: tuple
    noise: tuple
    slack: tuple


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (float64; 0 at 0)."""
    return torch.exp2(torch.floor(torch.log2(x.abs())) - 7)


def _flips(x: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at the upper end of [x - width, x + width] where the
    bf16 roundings of its two ends differ, else 0."""
    flip = bf16_round(x - width) != bf16_round(x + width)
    return torch.where(flip, _ulp(x.abs() + width), 0.0)


def bwd_references(q, k, v, out, lse, dout, causal: bool = True,
                   window: int = 0, *, q_pos=None, k_pos=None) -> BwdReference:
    """The ``BwdReference`` of ``flash_attention_bwd`` on these inputs (the
    positions' mask where ``q_pos`` and ``k_pos`` are given): one
    float32 plain backward without rounding points, and one float64 pass
    giving the exact and (for bf16 inputs) the rounded backward and the
    flips' slack."""
    args = (q, k, v, out, lse, dout, causal, window)
    rounding = q.dtype == torch.bfloat16
    plain32 = flash_attention_backward_plain(*args, dtype=torch.float32, rounding=False,
                                             q_pos=q_pos, k_pos=k_pos)
    exact, ref, slack = [], [], []
    for qi, ki, vi, oi, doi, p, dp, dd in backward_terms(*args, acc_dtype=torch.float64,
                                                         q_pos=q_pos, k_pos=k_pos):
        ds = p * (dp - dd)
        exact.append(backward_grads(qi, ki, doi, p, ds))
        if not rounding:
            continue
        ref.append(backward_grads(qi, ki, doi, bf16_round(p), bf16_round(ds)))
        dot_err = BWD_DOT_EPS * (torch.matmul(doi.abs(), vi.abs().transpose(-1, -2))
                                 + (doi * oi).abs().sum(-1, keepdim=True))
        p_flip = _flips(p, p * BWD_P_EPS)
        ds_flip = _flips(ds, ds.abs() * BWD_P_EPS + p * dot_err)
        slack.append(backward_grads(qi.abs(), ki.abs(), doi.abs(), p_flip, ds_flip))
    like = (q, k, v)
    exact = stack_grads(exact, like, torch.float64)
    ref = stack_grads(ref, like, torch.float64) if rounding else exact
    slack = (stack_grads(slack, like, torch.float64) if rounding
             else tuple(torch.zeros_like(x) for x in exact))
    noise = tuple(float((p32.to(torch.float64) - e).abs().max()) if e.numel() else 0.0
                  for p32, e in zip(plain32, exact))
    return BwdReference(ref, noise, slack)


def bwd_check(got, ref: BwdReference) -> dict:
    """``got`` (dQ, dK, dV; float32 or bfloat16) against ``ref`` from
    ``bwd_references``: for each, ``gap`` = max|got - ref64| and
    ``excess``, the largest excess of an element over what the contract
    allows, both over max|ref64| (``excess`` <= 0 passes); ``ok``: every
    excess <= 0 and every result float32 or bfloat16."""
    out, ok = {}, True
    tiny = torch.finfo(torch.float32).tiny
    for name, g, r, noise, slack in zip(("dq", "dk", "dv"), got, ref.ref64, ref.noise,
                                        ref.slack):
        g = g.to(r.device, torch.float64)
        scale = max(float(r.abs().max()), 1e-300) if r.numel() else 1e-300
        allowed = BWD_FACTOR * noise + BWD_REL * scale + slack
        if got[0].dtype == torch.bfloat16:
            allowed = allowed + torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(tiny))) - 7)
        diff = (g - r).abs()
        out[f"{name}_gap"] = float(diff.max()) / scale if r.numel() else 0.0
        out[f"{name}_excess"] = float((diff - allowed).max()) / scale if r.numel() else -1.0
        ok = ok and out[f"{name}_excess"] <= 0
    out["ok"] = bool(ok and got[0].dtype in (torch.float32, torch.bfloat16))
    return out


def _ds_rounded_before_d(q, k, v, out, lse, dout, causal, window, q_pos, k_pos):
    """The bf16 plain backward with dS = bf16(P dP) - P D (rounded before D
    is subtracted), then rounded again as it enters dK and dQ; in q's
    dtype."""
    per_entry = []
    for qi, ki, _, _, doi, p, dp, dd in backward_terms(q, k, v, out, lse, dout, causal, window,
                                                       q_pos=q_pos, k_pos=k_pos):
        ds = bf16_round(p * dp) - p * dd
        per_entry.append(backward_grads(qi, ki, doi, bf16_round(p), bf16_round(ds)))
    return stack_grads(per_entry, (q, k, v), q.dtype)


def bwd_controls(q, k, v, out, lse, dout, causal: bool = True, window: int = 0, *,
                 q_pos=None, k_pos=None) -> dict:
    """Faulty backwards, (dQ, dK, dV) in q's dtype each, that ``bwd_check``
    must reject: D left out of dS, P off by a relative 2^-10 (2^-6 in
    bfloat16), and for bf16 inputs dS rounded to bf16 before D is
    subtracted."""
    shift = -10 if q.dtype == torch.float32 else -6

    def plain(o, l):
        return flash_attention_backward_plain(q, k, v, o, l, dout, causal, window, q_pos=q_pos,
                                              k_pos=k_pos)
    controls = {"D left out": plain(torch.zeros_like(out), lse),
                f"P off by 2^{shift}": plain(out, lse - 2.0 ** shift)}
    if q.dtype == torch.bfloat16:
        controls["dS rounded before D"] = _ds_rounded_before_d(q, k, v, out, lse, dout, causal,
                                                               window, q_pos, k_pos)
    return controls
