"""The port's kernel ops against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions, which are held
here to the JAX ops on the same numpy inputs:

- quantize/dequantize: bitwise equal to ``repro.kernels.quantize`` (which
  off-TPU runs its ``ref.py`` oracle), for int8 and int4, stochastic and
  round-to-nearest, ragged sizes, and a batched ``(K, n)`` call against a
  loop of per-row JAX calls;
- masked_aggregate: within 2 ulp of the mean's magnitude scale of the
  interpret-mode Pallas kernel and of ``masked_aggregate_ref`` (the client
  sum runs in another order), 1 bf16 ulp for bfloat16 leaves, and the
  zero-weight fallback exactly; the multi-leaf entry that the aggregators
  call once a round (``masked_aggregate_leaves``) bitwise equal to the
  one-leaf plain version on every leaf, and within the same 2 ulp of the
  JAX package's fedavg and masked-partial aggregators.

The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.kernels.masked_aggregate import masked_aggregate as jax_masked_aggregate  # noqa: E402
from repro.kernels.masked_aggregate.ref import masked_aggregate_ref  # noqa: E402
from repro.kernels.quantize import dequantize as jax_dequantize  # noqa: E402
from repro.kernels.quantize import quantize as jax_quantize  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.masked_aggregate import (  # noqa: E402
    masked_aggregate,
    masked_aggregate_combine,
    masked_aggregate_leaves,
    masked_aggregate_partial,
    masked_aggregate_plain,
)
from repro_torch.kernels.quantize import (  # noqa: E402
    dequantize,
    dequantize_plain,
    quant_blocks,
    quantize,
    quantize_plain,
)

SIZES = [6, 256, 512, 513, 143616]


def _x(n, seed, rows=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if rows is None else (rows, n)
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 3.0)
    u = rng.random(shape, dtype=np.float32)
    return x, u


def _jax_quantize(x, u, bits):
    q, s = jax_quantize(jnp.asarray(x), None if u is None else jnp.asarray(u), bits=bits)
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("noise", ["uniform", "nearest"])
def test_quantize_plain_bitwise_vs_jax(n, bits, noise):
    x, u = _x(n, seed=n + bits)
    u = u if noise == "uniform" else None
    qj, sj = _jax_quantize(x, u, bits)
    qt, st = quantize(torch.from_numpy(x), None if u is None else torch.from_numpy(u), bits=bits)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)
    assert st.shape[-1] == quant_blocks(n)[1]
    dj = np.asarray(jax_dequantize(jnp.asarray(qj), jnp.asarray(sj)))
    np.testing.assert_array_equal(dequantize(qt, st).numpy(), dj)


@pytest.mark.parametrize("n", [6, 513, 1536])
@pytest.mark.parametrize("bits", [4, 8])
def test_batched_rows_equal_per_row_jax_calls(n, bits):
    """One (K, n) call cuts and scales every row on its own, as JAX's
    per-client vmap does."""
    x, u = _x(n, seed=3, rows=5)
    x[2] *= 100.0  # rows with very different scales
    qt, st = quantize(torch.from_numpy(x), torch.from_numpy(u), bits=bits)
    for r in range(5):
        qj, sj = _jax_quantize(x[r], u[r], bits)
        np.testing.assert_array_equal(qt[r].numpy(), qj)
        np.testing.assert_array_equal(st[r].numpy(), sj)
    dt = dequantize(qt, st)
    for r in range(5):
        np.testing.assert_array_equal(
            dt[r].numpy(), np.asarray(jax_dequantize(jnp.asarray(qt[r].numpy()), jnp.asarray(st[r].numpy())))
        )


def test_quantize_edge_values():
    """All-zero blocks scale by 1e-12/qmax; exact ties at code boundaries
    floor the same way; NaN blocks get a NaN scale and zero codes."""
    x = np.zeros((2, 600), np.float32)
    x[1, :512] = np.linspace(-1, 1, 512, dtype=np.float32)
    qt, st = quantize_plain(torch.from_numpy(x), None)
    for r in range(2):
        qj, sj = _jax_quantize(x[r], None, 8)
        np.testing.assert_array_equal(qt[r].numpy(), qj)
        np.testing.assert_array_equal(st[r].numpy(), sj)
    xn = x.copy()
    xn[0, 3] = np.nan
    qn, sn = quantize_plain(torch.from_numpy(xn), None)
    assert torch.isnan(sn[0, 0]) and (qn[0, :512] == 0).all()
    assert not torch.isnan(dequantize_plain(qn, sn)[0, 512:]).any()


def _agg_inputs(c, p, seed, zero=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, p)).astype(np.float32)
    sel = rng.random(c) < 0.6
    counts = rng.integers(20, 400, c).astype(np.float32)
    w = np.zeros(c, np.float32) if zero else (sel * counts).astype(np.float32)
    fb = rng.standard_normal(p).astype(np.float32)
    if dtype != np.float32:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
        fb = np.asarray(jnp.asarray(fb, jnp.bfloat16))
    return x, w, fb


def _to_torch(a):
    if a.dtype == np.float32:
        return torch.from_numpy(a)
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # exact: bf16 values


def _assert_mean_close(got, want, x, w):
    """2 ulp of the mean's magnitude scale ``sum|w x| / sum w``."""
    scale = (np.abs(x.astype(np.float32)) * w[:, None]).sum(0) / max(w.sum(), 1e-12)
    tol = 2 * np.spacing(np.maximum(scale, np.finfo(np.float32).tiny).astype(np.float32))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("c,p", [(8, 6), (8, 256), (30, 1024), (5, 1500)])
def test_masked_aggregate_plain_vs_jax_f32(c, p):
    x, w, fb = _agg_inputs(c, p, seed=c * p)
    got = masked_aggregate(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(fb)).numpy()
    kern = np.asarray(jax_masked_aggregate(jnp.asarray(x), jnp.asarray(w), jnp.asarray(fb), interpret=True))
    ref = np.asarray(masked_aggregate_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(fb)))
    _assert_mean_close(got, kern, x, w)
    _assert_mean_close(got, ref, x, w)


def test_masked_aggregate_plain_vs_jax_bf16():
    x, w, fb = _agg_inputs(12, 700, seed=5, dtype=jnp.bfloat16)
    got = masked_aggregate(_to_torch(x), torch.from_numpy(w), _to_torch(fb))
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    kern = np.asarray(jax_masked_aggregate(jnp.asarray(x), jnp.asarray(w), jnp.asarray(fb),
                                           interpret=True)).astype(np.float32)
    # one bf16 ulp: the float32 means may round to neighbouring bf16 values
    assert (np.abs(got - kern) <= np.spacing(np.abs(kern)) * 2**16 + 1e-30).all()


def test_masked_aggregate_zero_weights_fall_back_exactly():
    x, w, fb = _agg_inputs(6, 300, seed=9, zero=True)
    got = masked_aggregate(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(fb)).numpy()
    np.testing.assert_array_equal(got, fb)
    kern = np.asarray(jax_masked_aggregate(jnp.asarray(x), jnp.asarray(w), jnp.asarray(fb), interpret=True))
    np.testing.assert_array_equal(got, kern)
    zero = masked_aggregate(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(zero, np.zeros(300, np.float32))


def test_masked_aggregate_nd_leaf():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 9, 11)).astype(np.float32)
    w = np.asarray([3, 0, 1, 2, 0, 5], np.float32)
    fb = rng.standard_normal((9, 11)).astype(np.float32)
    got = masked_aggregate(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(fb)).numpy()
    assert got.shape == (9, 11)
    kern = np.asarray(jax_masked_aggregate(jnp.asarray(x), jnp.asarray(w), jnp.asarray(fb), interpret=True))
    _assert_mean_close(got.reshape(-1), kern.reshape(-1), x.reshape(6, -1), w)


# har-mlp's layer shapes at a narrow width: (fan_in, fan_out) per layer
_LAYERS = [(21, 16), (16, 16), (16, 6)]


def _layers(rng, c=None):
    lead = () if c is None else (c,)
    return [{"b": rng.standard_normal(lead + (o,)).astype(np.float32),
             "w": rng.standard_normal(lead + (i, o)).astype(np.float32)} for i, o in _LAYERS]


@pytest.mark.parametrize("c", [8, 30])
@pytest.mark.parametrize("strategy", ["fedavg", "masked-partial"])
def test_masked_aggregate_leaves_vs_jax_aggregators(strategy, c):
    """One call over every leaf of every layer: weight matrix R = 1 (fedavg)
    or R = L (masked-partial, the last layer shared by nobody: its row is
    all zero and the previous global layer comes back exactly)."""
    rng = np.random.default_rng(c)
    stacked, prev = _layers(rng, c), _layers(rng)
    sel = rng.random(c) < 0.7
    n = rng.integers(60, 90, c).astype(np.float32)
    base = (sel * n).astype(np.float32)
    if strategy == "fedavg":
        w = base[None]
        want = jagg.fedavg_aggregate([{k: jnp.asarray(v) for k, v in t.items()} for t in stacked],
                                     jnp.asarray(sel), jnp.asarray(n))
    else:
        share = rng.random((c, len(_LAYERS))) < 0.6
        share[:, -1] = False
        w = (base[None] * share.T).astype(np.float32)
        assert not w[-1].any()
        want = jagg.masked_partial_aggregate(
            [{k: jnp.asarray(v) for k, v in t.items()} for t in stacked],
            [{k: jnp.asarray(v) for k, v in t.items()} for t in prev], jnp.asarray(sel),
            jnp.asarray(n), jnp.asarray(share))
    names = ("b", "w")
    xs = [torch.from_numpy(t[k]) for t in stacked for k in names]
    rows = [0 if strategy == "fedavg" else j for j in range(len(_LAYERS)) for _ in names]
    fbs = (None if strategy == "fedavg" else [torch.from_numpy(t[k]) for t in prev for k in names])
    got = masked_aggregate_leaves(xs, torch.from_numpy(w), rows, fbs)
    for i, (x, r, g) in enumerate(zip(xs, rows, got)):
        j, name = divmod(i, 2)
        fb = None if fbs is None else fbs[i]
        assert torch.equal(g, masked_aggregate_plain(x, torch.from_numpy(w[r]), fb))
        _assert_mean_close(g.numpy().reshape(-1), np.asarray(want[j][names[name]]).reshape(-1),
                           x.numpy().reshape(c, -1), w[r])
        if strategy != "fedavg" and j == len(_LAYERS) - 1:
            np.testing.assert_array_equal(g.numpy(), prev[j][names[name]])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launch_counts()
    x, u = _x(300, seed=1, rows=3)
    q, s = quantize(torch.from_numpy(x), torch.from_numpy(u))
    dequantize(q, s)
    masked_aggregate(torch.from_numpy(x), torch.ones(3))
    masked_aggregate_leaves([torch.from_numpy(x)], torch.ones(1, 3))
    buf = masked_aggregate_partial([torch.from_numpy(x)], torch.ones(1, 3))
    masked_aggregate_combine(buf, [x.shape[1:]])
    assert kernels.launch_counts() == {"quantize": 0, "dequantize": 0, "masked_aggregate": 0,
                                       "masked_aggregate_partial": 0,
                                       "masked_aggregate_combine": 0,
                                       "ssm_scan": 0, "flash_attention": 0,
                                       "ssm_scan_bwd": 0, "flash_attention_bwd": 0}


def test_tensors_on_other_devices_raise():
    """Only CPU tensors take the plain version; anything else needs the
    kernel (a meta tensor stands in for a device without one)."""
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        quantize(x)
    with pytest.raises(ValueError, match="no kernel"):
        dequantize(torch.empty((2, 8), dtype=torch.int8, device="meta"),
                   torch.empty((2, 1), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        masked_aggregate(x, torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        masked_aggregate_leaves([x], torch.ones(1, 2, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        masked_aggregate_partial([x], torch.ones(1, 2, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        masked_aggregate_combine(torch.empty((1, 12), device="meta"), [(8,)])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_masked_aggregate_leaves_rejects_more_leaves_than_one_launch_takes(device):
    """Up to 64 leaves travel in one launch's parameter table; more raise on
    every device, so a round is always one launch."""
    xs = [torch.ones((2, 3), device=device) for _ in range(65)]
    with pytest.raises(ValueError, match="at most 64 leaves"):
        masked_aggregate_leaves(xs, torch.ones(1, 2, device=device))
