"""The port's ssm_scan and flash_attention plain versions against the JAX
package's kernels.

On the CPU the wrappers run their plain versions, held here to the JAX
oracles (``ssm_scan_ref``, ``flash_attention_ref``), to the Pallas kernels
in interpret mode, and to the JAX model's ``chunked_attention``, on the same
numpy inputs:

- ssm_scan: y within 1e-5 of max|y| and h within 1e-5 of max|h|, float32
  and bfloat16 streams, ragged S and S below the Pallas chunk. The plain
  version follows the model layer's order ``(dt*B)*x``; the Pallas kernel
  computes ``(dt*x)*B``, which rounds each product in another order (at
  most 1 ulp apart) and leaves y and h about 1e-7 of their max apart over
  these sequences. A bfloat16 y is within 1 bf16 ulp of the Pallas
  kernel's plus 1e-5 of max|y| (both round a float32 result; near zero,
  an element's ulp is smaller than the float32 gap).
- flash_attention, float32: within 1e-5 of max|out| of the oracle and the
  Pallas kernel (both keep P in float32, as the plain version does).
- flash_attention, bfloat16: the plain version rounds P to bf16 before
  P.V (the wgmma kernel's arithmetic, and ``chunked_attention``'s). Against
  ``chunked_attention`` with the same 128-key chunks: the bf16 contract of
  ``kernels/flash_attention/contract.py`` (the two packages' ``exp`` and
  score sums differ in the last float32 bit, which rounds a few P elements
  to the neighbouring bf16 value), which keeping P in float32 or a window
  one key short fails. Against the oracle and the Pallas kernel, which
  keep P in float32: within 1 bf16 ulp plus 1e-5 of max|out| plus 2^-8 of
  the attention of |v| (rounding p to bf16 moves it by at most 2^-8 p, so
  an output by at most 2^-8 sum_t p_t |v_t| / l). G in {1, 2, 4}, causal
  and not, window 0 and 32, ragged S, D 64 and 128.
- flash_attention at T != S (whisper's cross-attention: S decoder queries,
  one at a decode step, over T encoder frames), non-causal: S = 1, S < T
  and S > T, T ragged against the 64- and 128-key tiles; the same holds
  against the oracle, the Pallas kernel in interpret mode and
  ``chunked_attention`` (over positions ``arange(S)`` and ``arange(T)``).
- ssm_scan from a carried start state h0 (a prefill that continues a
  cache) against the JAX reference scan from h0, within 1e-5 of max;
  h0 = zeros bitwise the scan without one.

The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.kernels import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels import ssm_scan as jax_ssm_scan  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention.contract import (  # noqa: E402
    MAX_OVER_SHARE,
    bf16_contract,
)
from repro_torch.kernels.flash_attention.ops import BLOCK_K  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain  # noqa: E402

BF16 = jnp.bfloat16


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _to_jax(a: np.ndarray, dtype):
    x = jnp.asarray(a, jnp.float32)
    return x.astype(BF16) if dtype == "bfloat16" else x


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _bf16_close(got, want, rel=1e-5, extra=0.0):
    """Each element within 1 bf16 ulp of ``want``'s plus ``rel`` of
    max|want| (two roundings to bfloat16 of float32 results that are within
    the float32 contract) plus ``extra`` (an elementwise bound of what else
    the two computations may differ by)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), np.finfo(np.float32).tiny))) - 7)
    excess = np.abs(got - want) - (ulp + rel * np.abs(want).max() + extra)
    assert excess.max() <= 0, excess.max()


def _close_to_max(got, want, rel=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    gap = np.abs(got - want).max()
    assert gap <= rel * np.abs(want).max(), (gap, np.abs(want).max())


# ---------------------------------------------------------------------------
# ssm_scan
# ---------------------------------------------------------------------------


def _ssm_inputs(b, s, di, ds, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) - 2.0)).astype(np.float32)  # softplus > 0
    a = -np.exp(rng.standard_normal((di, ds))).astype(np.float32)
    bm = rng.standard_normal((b, s, ds)).astype(np.float32)
    cm = rng.standard_normal((b, s, ds)).astype(np.float32)
    x = rng.standard_normal((b, s, di)).astype(np.float32)
    d = rng.standard_normal(di).astype(np.float32)
    return dt, a, bm, cm, x, d


# (b, s, di, ds): whole chunks, a ragged S, an S below the chunk (32)
SSM_SHAPES = [(2, 64, 32, 8), (1, 37, 16, 16), (2, 20, 16, 8)]


@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSM_SHAPES, ids=str)
def test_ssm_scan_plain_matches_ref(shape, stream):
    dt, a, bm, cm, x, d = _ssm_inputs(*shape, seed=sum(shape))
    streams = [_to_torch(t, stream) for t in (dt, bm, cm, x)]
    y, h = ssm_scan_plain(streams[0], torch.from_numpy(a), streams[1], streams[2], streams[3],
                          torch.from_numpy(d), y_dtype=torch.float32)
    js = [_to_jax(t, stream) for t in (dt, bm, cm, x)]
    yr, hr = ssm_scan_ref(js[0], jnp.asarray(a), js[1], js[2], js[3], jnp.asarray(d))
    _close_to_max(y, yr)
    _close_to_max(h, hr)


@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSM_SHAPES, ids=str)
def test_ssm_scan_matches_pallas_interpret(shape, stream):
    dt, a, bm, cm, x, d = _ssm_inputs(*shape, seed=sum(shape) + 1)
    streams = [_to_torch(t, stream) for t in (dt, bm, cm, x)]
    y, h = ssm_scan(streams[0], torch.from_numpy(a), streams[1], streams[2], streams[3],
                    torch.from_numpy(d))
    js = [_to_jax(t, stream) for t in (dt, bm, cm, x)]
    yk, hk = jax_ssm_scan(js[0], jnp.asarray(a), js[1], js[2], js[3], jnp.asarray(d),
                          chunk=32, interpret=True)
    assert y.dtype == streams[3].dtype and h.dtype == torch.float32
    _close_to_max(h, hk)
    if stream == "bfloat16":  # y is written in x's dtype by both
        _bf16_close(y, yk)
    else:
        _close_to_max(y, yk)


@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSM_SHAPES[:2], ids=str)
def test_ssm_scan_plain_from_h0_matches_ref(shape, stream):
    """The scan from a carried state h0 (a prefill that continues a cache)
    against the JAX reference scan from h0, within 1e-5 of max; h0 = zeros
    gives the bits of the scan without one."""
    dt, a, bm, cm, x, d = _ssm_inputs(*shape, seed=sum(shape) + 2)
    h0 = np.random.default_rng(3).standard_normal((shape[0], shape[2], shape[3]))
    h0 = h0.astype(np.float32)
    streams = [_to_torch(t, stream) for t in (dt, bm, cm, x)]
    args = (streams[0], torch.from_numpy(a), streams[1], streams[2], streams[3],
            torch.from_numpy(d))
    y, h = ssm_scan(*args, y_dtype=torch.float32, h0=torch.from_numpy(h0))
    js = [_to_jax(t, stream) for t in (dt, bm, cm, x)]
    yr, hr = ssm_scan_ref(js[0], jnp.asarray(a), js[1], js[2], js[3], jnp.asarray(d),
                          h0=jnp.asarray(h0))
    _close_to_max(y, yr)
    _close_to_max(h, hr)
    plain = ssm_scan_plain(*args)
    zero = ssm_scan_plain(*args, h0=torch.zeros_like(torch.from_numpy(h0)))
    assert all(torch.equal(p, z) for p, z in zip(plain, zero))


def test_ssm_scan_empty_sequence():
    dt, a, bm, cm, x, d = (torch.from_numpy(t[:, :0] if t.ndim == 3 else t)
                           for t in _ssm_inputs(2, 4, 16, 8, seed=0))
    y, h = ssm_scan(dt, a, bm, cm, x, d)
    assert y.shape == (2, 0, 16) and torch.equal(h, torch.zeros(2, 16, 8))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


def _fa_inputs(b, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _check_fa(got: torch.Tensor, want, dtype, qkv=None, causal=True, window=0):
    """``got`` (the plain version) against a JAX result that keeps P in
    float32; a bf16 ``got`` rounds P, which moves an output by at most 2^-8
    times the attention of |v| (computed from the numpy ``qkv``)."""
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        q, k, v = (_to_torch(t, dtype).to(torch.float32) for t in qkv)
        _bf16_close(got, want, extra=2.0 ** -8 * _np(flash_attention_plain(q, k, v.abs(), causal,
                                                                             window)))
    else:
        _close_to_max(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hkv", [4, 2, 1], ids=["G1", "G2", "G4"])
def test_flash_attention_plain_matches_ref(hkv, causal, window, dtype):
    b, s, h, d = 2, 100, 4, 64  # S is not a multiple of the 64-key tile
    q, k, v = _fa_inputs(b, s, h, hkv, d, seed=hkv + 10 * window + causal)
    got = flash_attention_plain(*(_to_torch(t, dtype) for t in (q, k, v)), causal=causal,
                                window=window)
    want = flash_attention_ref(*(_to_jax(t.transpose(0, 2, 1, 3), dtype) for t in (q, k, v)),
                               causal=causal, window=window)
    _check_fa(got, np.asarray(jnp.asarray(want, jnp.float32)).transpose(0, 2, 1, 3), dtype,
              (q, k, v), causal, window)


@pytest.mark.parametrize("case", [
    # (b, s, h, hkv, d, causal, window, dtype)
    (1, 100, 4, 4, 64, True, 0, "float32"),
    (1, 100, 4, 2, 64, True, 32, "float32"),
    (2, 70, 4, 1, 64, False, 0, "float32"),
    (1, 100, 4, 2, 128, False, 32, "bfloat16"),
    (1, 130, 4, 1, 64, True, 0, "bfloat16"),
    (1, 40, 2, 1, 128, True, 32, "bfloat16"),
], ids=str)
def test_flash_attention_matches_pallas_interpret(case):
    b, s, h, hkv, d, causal, window, dtype = case
    q, k, v = _fa_inputs(b, s, h, hkv, d, seed=s + d)
    got = flash_attention(*(_to_torch(t, dtype) for t in (q, k, v)), causal=causal,
                          window=window)
    want = jax_flash_attention(*(_to_jax(t, dtype) for t in (q, k, v)), causal=causal,
                               window=window, block_q=64, block_k=64, interpret=True)
    _check_fa(got, want, dtype, (q, k, v), causal, window)


@pytest.mark.parametrize("sd", [(100, 64), (130, 128)], ids=["S100-D64", "S130-D128"])
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hkv", [4, 2, 1], ids=["G1", "G2", "G4"])
def test_flash_attention_plain_bf16_matches_chunked_attention(hkv, causal, window, sd):
    """bf16 P: the JAX model's prefill attention with the kernel's key tile
    as its chunk, so both rescale at the same tile boundaries."""
    s, d = sd
    q, k, v = _fa_inputs(2, s, 4, hkv, d, seed=hkv + 10 * window + causal + d)
    qkv = [_to_torch(t, "bfloat16") for t in (q, k, v)]
    got = flash_attention_plain(*qkv, causal=causal, window=window)
    pos = jnp.arange(s)
    want = chunked_attention(*(_to_jax(t, "bfloat16") for t in (q, k, v)), pos, pos,
                             causal=causal, window=window, chunk=BLOCK_K)
    assert got.dtype == torch.bfloat16
    result = bf16_contract(torch.from_numpy(_np(want)).to(torch.bfloat16), got, *qkv, causal,
                           window)
    assert result["ok"], result


def _fa_inputs_st(b, s, t, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32))


# (S, T): one query (a decode step's cross-attention), S < T with T ragged
# against the 64- and 128-key tiles, S > T, and a T below one tile
T_NE_S = [(1, 150), (1, 300), (30, 150), (64, 200), (100, 37), (7, 20)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hkv", [2, 1], ids=["G1", "G2"])
@pytest.mark.parametrize("st", T_NE_S, ids=str)
def test_flash_attention_plain_at_t_ne_s_matches_ref_and_pallas(st, hkv, dtype):
    s, t = st
    q, k, v = _fa_inputs_st(2, s, t, 2, hkv, 64, seed=s + t + hkv)
    got = flash_attention_plain(*(_to_torch(a, dtype) for a in (q, k, v)), causal=False)
    assert got.shape == (2, s, 2, 64)
    ref = flash_attention_ref(*(_to_jax(a.transpose(0, 2, 1, 3), dtype) for a in (q, k, v)),
                              causal=False)
    _check_fa(got, np.asarray(jnp.asarray(ref, jnp.float32)).transpose(0, 2, 1, 3), dtype,
              (q, k, v), causal=False)
    pallas = jax_flash_attention(*(_to_jax(a, dtype) for a in (q, k, v)), causal=False,
                                 block_q=64, block_k=64, interpret=True)
    _check_fa(got, pallas, dtype, (q, k, v), causal=False)


@pytest.mark.parametrize("st", T_NE_S, ids=str)
def test_flash_attention_plain_bf16_at_t_ne_s_matches_chunked_attention(st):
    """bf16 P against the JAX model's cross-attention arithmetic, with the
    kernel's 128-key tile as the chunk, under the bf16 contract."""
    s, t = st
    q, k, v = _fa_inputs_st(2, s, t, 4, 2, 64, seed=3 * s + t)
    qkv = [_to_torch(a, "bfloat16") for a in (q, k, v)]
    got = flash_attention_plain(*qkv, causal=False)
    want = chunked_attention(*(_to_jax(a, "bfloat16") for a in (q, k, v)), jnp.arange(s),
                             jnp.arange(t), causal=False, chunk=BLOCK_K)
    result = bf16_contract(torch.from_numpy(_np(want).copy()).to(torch.bfloat16), got, *qkv, False)
    assert result["ok"], result


@pytest.mark.parametrize("fault", ["float32 P", "one key dropped"])
@pytest.mark.parametrize("shape", [(1, 512, 4, 2, 128), (2, 130, 4, 4, 128), (1, 256, 4, 1, 64)],
                         ids=str)
def test_bf16_contract_rejects_systematic_errors(shape, fault):
    """The bf16 contract's slack and share of elements over 1 ulp leave no
    room for keeping P in float32 or for a window one key short."""
    qkv = [_to_torch(t, "bfloat16") for t in _fa_inputs(*shape, seed=7)]
    window = 64
    want = flash_attention_plain(*qkv, window=window)
    if fault == "float32 P":
        got = flash_attention_plain(*(t.float() for t in qkv), window=window).to(torch.bfloat16)
    else:
        got = flash_attention_plain(*qkv, window=window - 1)
    assert bf16_contract(want, want, *qkv, True, window)["ok"]
    result = bf16_contract(got, want, *qkv, True, window)
    assert not result["ok"] and result["n_over"] > 20 * result["n"] * MAX_OVER_SHARE, result


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    kernels.reset_launch_counts()
    q, k, v = (torch.from_numpy(t) for t in _fa_inputs(1, 8, 2, 1, 64, seed=0))
    flash_attention(q, k, v)
    ssm_scan(*(torch.from_numpy(t) for t in _ssm_inputs(1, 5, 16, 8, seed=0)))
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 0 and counts["ssm_scan"] == 0


def test_tensors_on_other_devices_raise():
    """Only CPU tensors take the plain versions; any other device needs the
    kernel (a meta tensor stands in for a device without one)."""
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q[:, :, :1], q[:, :, :1])
    x = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ssm_scan(x, torch.empty(16, 8), torch.empty(1, 4, 8), torch.empty(1, 4, 8), x,
                 torch.empty(16))
