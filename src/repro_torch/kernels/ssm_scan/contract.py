"""The contracts of the ssm_scan kernels: how closely the forward's y and h
must match the selective scan computed in float64, and how closely the
backward's six gradients must match the backward computed in float64, and
their checks.

The kernel takes exp as 2^(dt * A log2 e) on the special-function unit
(``ex2.approx``) and fuses multiply-adds, in the Pallas kernel's
``(dt*x)*B`` order, so it does not follow ``ssm_scan_plain`` (accurate exp,
one rounding per product and per sum, the layer's ``(dt*B)*x`` order) step
for step. Both are held instead to ``ref64``, the plain version run in
float64 on the same inputs:

- float32 y and h: ``max|got - ref64| <= F32_FACTOR * max|plain32 - ref64|
  + F32_REL * max|ref64|``, where ``plain32`` is the plain version in
  float32: no less accurate than the plain version, to a small factor;
- bfloat16 y: every element within 1 bf16 ulp of ``ref64`` at that element,
  plus ``BF16_REL * max|ref64|``.

A check that passes everything proves nothing, so ``controls`` builds two
faults from the plain version that it must reject: h reset to 0 every
``CONTROL_CHUNK`` steps (a chunked scan that drops its carry) and the last
state left out of y's sum; for a scan from a start state ``h0`` (a prefill
that continues a cache) also the scan from h = 0. The references then run
from ``h0`` too.

The backward kernel (``csrc/ssm_scan_bwd.cu``) takes its exps on the
special-function unit too, fuses multiply-adds, and sums d_b and d_c over
the channels, and d_a and d_d over batch and time, in its own fixed order;
it is held to ``ssm_scan_backward_plain`` run in float64 on the same inputs
(the forward kernel's chunk start states included): for each of d_dt, d_a,
d_b, d_c, d_x, d_d, every element within ``BWD_FACTOR`` x the float32
plain backward's own gap + ``BWD_REL`` of max|ref64|, plus 1 bf16 ulp of
ref64 at that element for a gradient written in bfloat16. ``bwd_controls``
builds two faults it must reject: each chunk recomputed from h = 0 instead
of its saved start state, and g not carried from one chunk to the one
before it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan.ops import CHUNK, ssm_scan_backward_plain, ssm_scan_plain

__all__ = ["BF16_REL", "BWD_FACTOR", "BWD_REL", "CONTROL_CHUNK", "F32_FACTOR", "F32_REL",
           "bwd_check", "bwd_controls", "bwd_references", "check", "controls", "references"]

F32_FACTOR = 4.0
F32_REL = 1e-6
BF16_REL = 1e-5
CONTROL_CHUNK = 64
BWD_FACTOR = 8.0
BWD_REL = 1e-5
BWD_NAMES = ("d_dt", "d_a", "d_b", "d_c", "d_x", "d_d")


def references(dt, a, bmat, cmat, x, d, h0=None):
    """``(plain32, ref64)``: the ``(y, h)`` of ``ssm_scan_plain`` from
    ``h0`` (None: zeros) in float32 (y in float32) and in float64."""
    plain32 = ssm_scan_plain(dt, a, bmat, cmat, x, d, y_dtype=torch.float32, h0=h0)
    ref64 = ssm_scan_plain(dt, a, bmat, cmat, x, d, y_dtype=torch.float64,
                           acc_dtype=torch.float64, h0=h0)
    return plain32, ref64


def _gap(got, want) -> float:
    return float((got.to(torch.float64) - want).abs().max()) if want.numel() else 0.0


def _max(t) -> float:
    return max(float(t.abs().max()), 1e-300) if t.numel() else 1e-300


def _f32_rule(got, plain, ref) -> tuple[float, float]:
    """(gap, allowed), both over max|ref|."""
    scale = _max(ref)
    return _gap(got, ref) / scale, (F32_FACTOR * _gap(plain, ref) + F32_REL * scale) / scale


def check(y, h, plain32, ref64) -> dict:
    """``y`` (float32 or bfloat16) and ``h`` (float32) of a scan against
    ``ref64`` and ``plain32`` from ``references`` on the same inputs.
    ``h_gap`` and ``h_allowed``, and for a float32 y ``y_gap`` and
    ``y_allowed``, are the largest distances to ``ref64`` and what the
    contract allows, over the max magnitude of ``ref64``; for a bfloat16 y,
    ``y_excess`` is the largest excess of an element over 1 bf16 ulp of its
    ``ref64`` value + ``BF16_REL`` of max|ref64|, over that max (<= 0
    passes). ``ok``: y is float32 or bfloat16, h float32, and all rules
    hold."""
    (y32, h32), (y64, h64) = plain32, ref64
    dev = y64.device
    y, h = y.to(dev), h.to(dev)
    out = {}
    out["h_gap"], out["h_allowed"] = _f32_rule(h, h32.to(dev), h64)
    ok = h.dtype == torch.float32 and out["h_gap"] <= out["h_allowed"]
    if y.dtype == torch.bfloat16:
        tiny = torch.finfo(torch.float32).tiny
        ulp = torch.exp2(torch.floor(torch.log2(y64.abs().clamp_min(tiny))) - 7)
        scale = _max(y64)
        over = (y.to(torch.float64) - y64).abs() - ulp - BF16_REL * scale
        out["y_excess"] = float(over.max()) / scale if over.numel() else -BF16_REL
        ok = ok and out["y_excess"] <= 0
    else:
        out["y_gap"], out["y_allowed"] = _f32_rule(y, y32.to(dev), y64)
        ok = ok and y.dtype == torch.float32 and out["y_gap"] <= out["y_allowed"]
    out["ok"] = bool(ok)
    return out


def controls(dt, a, bmat, cmat, x, d, h0=None) -> dict:
    """Faulty scans, ``(y float32, h float32)`` each, that ``check`` must
    reject: the plain version with h reset to 0 every ``CONTROL_CHUNK``
    steps, and with the last state left out of y; from a start state
    ``h0``, also the scan from h = 0 (the start state dropped)."""
    s = x.shape[1]
    parts = [ssm_scan_plain(dt[:, t:t + CONTROL_CHUNK], a, bmat[:, t:t + CONTROL_CHUNK],
                            cmat[:, t:t + CONTROL_CHUNK], x[:, t:t + CONTROL_CHUNK], d,
                            y_dtype=torch.float32, h0=h0 if t == 0 else None)
             for t in range(0, s, CONTROL_CHUNK)]
    reset = (torch.cat([p[0] for p in parts], dim=1), parts[-1][1])
    c_drop = cmat.clone()
    c_drop[..., -1] = 0
    drop = ssm_scan_plain(dt, a, bmat, c_drop, x, d, y_dtype=torch.float32, h0=h0)
    out = {f"h reset every {CONTROL_CHUNK} steps": reset, "last state left out of y": drop}
    if h0 is not None:
        out["start state dropped"] = ssm_scan_plain(dt, a, bmat, cmat, x, d, y_dtype=torch.float32)
    return out


def bwd_references(dt, a, bmat, cmat, x, d, h_starts, gy, gh=None):
    """``(plain32, ref64)``: the six gradients of ``ssm_scan_backward_plain``
    in float32 and in float64 on the same inputs."""
    args = (dt, a, bmat, cmat, x, d, h_starts, gy, gh)
    return ssm_scan_backward_plain(*args), ssm_scan_backward_plain(*args,
                                                                   acc_dtype=torch.float64)


def bwd_check(got, plain32, ref64) -> dict:
    """The six gradients ``got`` against ``ref64`` and ``plain32`` from
    ``bwd_references``: for each, ``{name}_gap`` = max|got - ref64| and
    ``{name}_excess``, the largest excess of an element over what the
    contract allows, both over max|ref64| (<= 0 passes); ``ok``: every
    excess <= 0."""
    out, ok = {}, True
    tiny = torch.finfo(torch.float32).tiny
    for name, g, p32, r in zip(BWD_NAMES, got, plain32, ref64):
        dev = r.device
        scale = _max(r)
        allowed = BWD_FACTOR * _gap(p32.to(dev), r) + BWD_REL * scale
        if g.dtype == torch.bfloat16:
            allowed = allowed + torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(tiny))) - 7)
        diff = (g.to(dev, torch.float64) - r).abs()
        out[f"{name}_gap"] = float(diff.max()) / scale if r.numel() else 0.0
        out[f"{name}_excess"] = float((diff - allowed).max()) / scale if r.numel() else -1.0
        ok = ok and out[f"{name}_excess"] <= 0
    out["ok"] = bool(ok)
    return out


def bwd_controls(dt, a, bmat, cmat, x, d, h_starts, gy) -> dict:
    """Two faulty backwards (the six gradients in their inputs' dtypes) that
    ``bwd_check`` must reject: every chunk recomputed from h = 0, and g
    reset to 0 at every chunk's end (no carry to the chunk before)."""
    dtypes = [t.dtype for t in (dt, a, bmat, cmat, x, d)]
    cast = lambda grads: tuple(g.to(t) for g, t in zip(grads, dtypes))  # noqa: E731
    zero = ssm_scan_backward_plain(dt, a, bmat, cmat, x, d, torch.zeros_like(h_starts), gy)
    parts = [ssm_scan_backward_plain(dt[:, t:t + CHUNK], a, bmat[:, t:t + CHUNK],
                                     cmat[:, t:t + CHUNK], x[:, t:t + CHUNK], d,
                                     h_starts[t // CHUNK:t // CHUNK + 1], gy[:, t:t + CHUNK])
             for t in range(0, x.shape[1], CHUNK)]
    drop = tuple(torch.cat([p[i] for p in parts], dim=1) if i in (0, 2, 3, 4)
                 else sum(p[i] for p in parts) for i in range(6))
    return {"chunks from h = 0": cast(zero), "g not carried across chunks": cast(drop)}
