"""The ssm_scan contract (``repro_torch/kernels/ssm_scan/contract.py``) on
the CPU, at small shapes (B 2, S 100-300, di 32-64, ds 8 and 16, float32 and
bfloat16 streams, the S4D-real A of the serving check and a random A):

- the contract accepts the plain version in float32 against the float64
  reference, with y in float32 and rounded to bfloat16;
- it accepts an emulation of the kernel's arithmetic (exp as 2^(dt * A
  log2 e), fused multiply-adds in the ``(dt*x)*B`` order, y summed over
  groups of 4 states, then over the 2 lanes of a channel, then
  ``fma(D, x, y)``), so the contract leaves room for the kernel's
  rounding;
- it rejects both controls, h reset to 0 every 64 steps and the last state
  left out of y, in both rules;
- ``ssm_scan_plain`` with its default ``acc_dtype`` (float32) is bitwise
  what it was before the argument existed.

The kernel itself is held to the same contract on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
from repro_torch.kernels.ssm_scan.contract import check, controls, references

# (b, s, di, ds): S below, across and well past the controls' 64-step chunks
SHAPES = [(2, 100, 32, 8), (2, 193, 64, 16), (2, 300, 48, 16)]
STREAMS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, di, ds, seed, stream, a_kind):
    """dt near falcon-mamba's (softplus of N(-4.6, 0.5^2)), unit-normal B,
    C, x and D; A the S4D-real -(1..ds) per channel, or -exp(N(0, 1))."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) * 0.5 - 4.6))
    bm, cm = rng.standard_normal((2, b, s, ds))
    x = rng.standard_normal((b, s, di))
    d = rng.standard_normal(di)
    if a_kind == "s4d":
        a = -np.broadcast_to(np.arange(1, ds + 1), (di, ds))
    else:
        a = -np.exp(rng.standard_normal((di, ds)))
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v, np.float32))  # noqa: E731
    return ([t(v).to(STREAMS[stream]) for v in (dt, bm, cm, x)], t(a), t(d))


def _args(shape, stream, a_kind, seed):
    (dt, bm, cm, x), a, d = _inputs(*shape, seed=seed, stream=stream, a_kind=a_kind)
    return dt, a, bm, cm, x, d


def _fma(a, b, c):
    """float32 fma(a, b, c): the float64 product of two float32 values is
    exact, so one float64 add and one rounding to float32 (double rounding
    differs from a true fma only on exact float64 ties)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_emulation(dt, a, bmat, cmat, x, d, lanes=2):
    """The kernel's arithmetic on the CPU, in float32: A' = A log2(e),
    h = fma(2^(dt A'), h, (dt x) B), y = fma(h, C, .) over 4 states at a
    time, each lane's groups summed in order, the lanes' sums added, then
    fma(D, x, y)."""
    f = torch.float32
    a2 = a.to(f) * torch.tensor(1.4426950408889634, dtype=f)
    h = torch.zeros((x.shape[0], x.shape[2], a.shape[1]), dtype=f)
    ys = []
    for t in range(x.shape[1]):
        dt_t, x_t = dt[:, t].to(f), x[:, t].to(f)
        b_t, c_t = bmat[:, t].to(f), cmat[:, t].to(f)
        da = torch.exp2(dt_t[..., None] * a2[None])
        h = _fma(da, h, (dt_t * x_t)[..., None] * b_t[:, None, :])
        groups = []
        for g in range(0, a.shape[1], 4):
            acc = h[..., g] * c_t[:, None, g]
            for n in range(g + 1, g + 4):
                acc = _fma(h[..., n], c_t[:, None, n], acc)
            groups.append(acc)
        per_lane = len(groups) // lanes
        total = None
        for lane in range(lanes):
            part = groups[lane * per_lane]
            for acc in groups[lane * per_lane + 1:(lane + 1) * per_lane]:
                part = part + acc
            total = part if total is None else total + part
        ys.append(_fma(d.to(f), x_t, total))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("a_kind", ["s4d", "random"])
@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_contract_accepts_plain_float32(shape, stream, a_kind):
    args = _args(shape, stream, a_kind, seed=sum(shape))
    plain32, ref64 = references(*args)
    (y, h) = plain32
    assert y.dtype == h.dtype == torch.float32
    assert ref64[0].dtype == ref64[1].dtype == torch.float64
    for got in (y, y.to(torch.bfloat16)):
        result = check(got, h, plain32, ref64)
        assert result["ok"], result
    # the plain version is not exact: the float32 rule has a gap to hold
    assert 0 < check(y, h, plain32, ref64)["y_gap"] < 1e-5


@pytest.mark.parametrize("a_kind", ["s4d", "random"])
@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_contract_accepts_the_kernels_arithmetic(shape, stream, a_kind):
    args = _args(shape, stream, a_kind, seed=sum(shape) + 1)
    plain32, ref64 = references(*args)
    y, h = _kernel_emulation(*args)
    for got in (y, y.to(torch.bfloat16)):
        result = check(got, h, plain32, ref64)
        assert result["ok"], result


@pytest.mark.parametrize("a_kind", ["s4d", "random"])
@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_contract_rejects_both_controls(shape, stream, a_kind):
    args = _args(shape, stream, a_kind, seed=sum(shape) + 2)
    plain32, ref64 = references(*args)
    faults = controls(*args)
    assert len(faults) == 2
    for name, (y, h) in faults.items():
        assert y.shape == plain32[0].shape and h.shape == plain32[1].shape
        for got in (y, y.to(torch.bfloat16)):
            result = check(got, h, plain32, ref64)
            assert not result["ok"], (name, got.dtype, result)


def test_contract_rejects_wrong_dtypes():
    args = _args(SHAPES[0], "float32", "random", seed=5)
    plain32, ref64 = references(*args)
    y, h = plain32
    assert not check(y.double(), h, plain32, ref64)["ok"]
    assert not check(y, h.double(), plain32, ref64)["ok"]


def _plain_before(dt, a, bmat, cmat, x, d, y_dtype=None):
    """ssm_scan_plain as it was before ``acc_dtype`` (frozen copy)."""
    bsz, s, di = x.shape
    a32, d32 = a.to(torch.float32), d.to(torch.float32)
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dt_t, b_t = dt[:, t].to(torch.float32), bmat[:, t].to(torch.float32)
        c_t, x_t = cmat[:, t].to(torch.float32), x[:, t].to(torch.float32)
        da = torch.exp(dt_t[..., None] * a32[None])
        h = da * h + dt_t[..., None] * b_t[:, None, :] * x_t[..., None]
        ys.append((h * c_t[:, None, :]).sum(-1) + d32 * x_t)
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bsz, 0, di), dtype=torch.float32)
    return y.to(y_dtype or x.dtype), h


@pytest.mark.parametrize("y_dtype", [None, torch.float32], ids=["x-dtype", "float32"])
@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_float32_is_bitwise_unchanged(shape, stream, y_dtype):
    args = _args(shape, stream, "random", seed=sum(shape) + 3)
    want_y, want_h = _plain_before(*args, y_dtype=y_dtype)
    for got_y, got_h in (ssm_scan_plain(*args, y_dtype=y_dtype),
                         ssm_scan_plain(*args, y_dtype=y_dtype, acc_dtype=torch.float32),
                         ssm_scan(*args, y_dtype=y_dtype)):
        assert got_y.dtype == want_y.dtype and torch.equal(got_y, want_y)
        assert got_h.dtype == torch.float32 and torch.equal(got_h, want_h)
