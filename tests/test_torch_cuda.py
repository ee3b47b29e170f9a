"""The port's CUDA kernels on the card (marked ``gpu``; they skip where no
card is present). This file imports neither jax nor the JAX package, so it
runs on the GPU machine, where jax is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Contracts: quantize/dequantize bitwise equal to their plain versions, and
each one launch for a list of leaves; a chunk of FL rounds replayed as a
CUDA graph bitwise equal to the eager rounds, one launch of each FL kernel
a round; masked_aggregate bitwise equal to
its plain version on every leaf (same ascending client order, one rounding
per product and per sum, IEEE division), one launch for a list of leaves,
and exact on the zero-weight fallback; ssm_scan to
``kernels/ssm_scan/contract.py`` (against the plain version in float64:
float32 y and h within 4x the float32 plain version's gap + 1e-6 of max,
bf16 y within 1 bf16 ulp + 1e-5 of max; the kernel takes exp on the
special-function unit and fuses multiply-adds); flash_attention
within 1e-5 of max|out| in float32 (the CUDA-core kernel), and in bfloat16
(the wgmma kernel, P rounded to bf16 as the plain version does) the bf16
contract of ``kernels/flash_attention/contract.py``: within 1 bf16 ulp of
each element plus that plus ``p_rounding_slack`` (the kernel sums the
scores in another order than the plain version's matmul, so a few P
elements round to the neighbouring bf16 value), with at most 1e-3 of the
elements beyond 1 ulp plus 1e-5 of max; the same at MLA's head dims,
(Dqk, Dv) = (192, 128) in bf16 and the reduced (48, 32) in float32, and at
G = 1 (the MoE family's MHA), at stablelm-12b's (160, 160) in bf16 (64-key
tiles) and at G = 16 and G = 6 (chatglm3-6b's and qwen2-vl-2b's), and
non-causal at T != S at whisper-tiny's D = 64 (S = T = 1,500, S = 448 and
S = 1 over T = 1,500, and small ragged cases) in both dtypes; any other
pair raises. The reduced MoE family (deepseek-moe, moonshot,
deepseek-v2-lite) and the reduced chatglm3, stablelm and qwen2-vl (its
vision batch included) in float32 serve on the card through
flash_attention and match the CPU within 1e-5 of max; so do the reduced
whisper-tiny (flash_attention non-causal in its encoder and
cross-attention) and the reduced jamba (ssm_scan and flash_attention in
one stack; 2^-8 of max after its Mamba scans), each launching exactly its
kernels; whisper's frames drawn on the card are the host's bits. The
staleness merge (snapshot
subtracted in the load loop, the global layer as the base) is
masked_aggregate's kernel bitwise equal to its plain version, one launch an
event; the async and fault steps run on the card with each FL kernel once
an event, give the CPU's integer records and simulated clock exactly and
its accuracy within 1e-6, and resume bit for bit, CUDA-graph chunks
included. masked_aggregate's edge mode (two-level aggregation, lanes
walked in a stable sort by edge id) is bitwise its plain version in both
modes, one launch; rounds with edge groups still capture in chunks; the
host-resident population plane is bitwise the device-resident run on the
card. masked_aggregate's partial and combine modes (a cohort sharded over
ranks) are bitwise their plain versions, one launch each, and together
bitwise the edge mode with rank-block ids; a world-1 sharded run on NCCL
is bitwise the unsharded run, CUDA-graph chunks included, and its trace
holds the two all-reduces a round that ``fl/shard`` reckons; gloo on CUDA
tensors refuses chunks (``CollectiveCaptureError``) and runs round by
round. Training: the forward kernels' optional outputs (flash_attention's
row logsumexp, ssm_scan's chunk start states) against the plain versions';
flash_attention_bwd at every (Dqk, Dv) of ``HEAD_DIMS`` in both dtypes,
causal, windowed and non-causal at T != S, and ssm_scan_bwd at d_state 8
and 16, whole and ragged chunks, S under 128, to their backward contracts
(against the backward in float64), their controls rejected, one launch a
call, two calls bitwise equal, what has no kernel refused; the autograd
Functions launch exactly one forward and one backward; the ten reduced
configs' loss and every gradient on the card within 1e-5 of max of the
CPU's (2^-8 with a Mamba scan), through exactly the expected launches.
Cross-silo FL (``fl/cross_silo.py``): three fp32-wire rounds of the reduced
granite, falcon-mamba and whisper on the card within 1e-5 of max of the CPU
(2^-8 behind a scan), the train steps' launches plus one masked_aggregate
a round, shared leaves bitwise equal across silos; one silo mean on
jamba's reduced silos bitwise the CPU in every wire format, EF residuals
included, with one launch of each kernel it uses; ``permutation`` with a
key on the card is the host's draw. The expert-parallel MoE under a (1, 1)
mesh of ranks: the reduced MoE family and jamba on the card within 1e-5
of max of the CPU (2^-8 behind a scan), the MoE layer included; a world-1
NCCL group's all-reduce of each MoE layer shows in the profiler's trace.
Position masks (M-RoPE's t stream: an image's tokens sharing one position,
ties and jumps, T != S with empty slots at -1): flash_attention and its
backward in both dtypes, causal, windowed and non-causal, against the
plain versions under the same contracts, one launch each, the controls
rejected, and positions ``arange(S)`` bitwise the index mask. ssm_scan from
a carried start state h0 to its contract against the float64 scan from h0,
the dropped-start-state control rejected, h0 = zeros bitwise no h0, S = 0
keeping h0.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.data import make_federated_classification
from repro_torch.fl import FLConfig, run_federated
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.contract import bf16_contract
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
from repro_torch.kernels import build
from repro_torch.core.aggregation import staleness_weighted_merge
from repro_torch.kernels.masked_aggregate import (
    masked_aggregate,
    masked_aggregate_combine,
    masked_aggregate_combine_plain,
    masked_aggregate_leaves,
    masked_aggregate_leaves_plain,
    masked_aggregate_partial,
    masked_aggregate_partial_plain,
    masked_aggregate_plain,
)
from repro_torch.kernels.quantize import (
    dequantize,
    dequantize_leaves,
    dequantize_leaves_plain,
    dequantize_plain,
    quantize,
    quantize_leaves,
    quantize_leaves_plain,
    quantize_plain,
)
from repro_torch.kernels.ssm_scan import contract as ssm_contract
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.launch.serve import serve

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _x(rows, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
    u = torch.from_numpy(rng.random((rows, n), dtype=np.float32))
    return x, u


@pytest.mark.parametrize("n", [6, 256, 512, 513, 143616])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_pair_bitwise_vs_plain(cuda, n, bits):
    x, u = _x(4, n, seed=n)
    for noise in (u, None):
        q, s = quantize(x.to(cuda), None if noise is None else noise.to(cuda), bits=bits)
        qp, sp = quantize_plain(x, noise, bits=bits)
        assert torch.equal(q.cpu(), qp) and torch.equal(s.cpu(), sp)
        assert torch.equal(dequantize(q, s).cpu(), dequantize_plain(qp, sp))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_leaves_bitwise_in_one_launch(cuda, bits):
    """har-mlp's 8 leaves at K = 30 clients (a 6-element bias to a 561 x 256
    matrix), stochastic and nearest, with a NaN in one leaf."""
    rng = np.random.default_rng(bits)
    shapes = [(256,), (561, 256), (256,), (256, 256), (256,), (256, 256), (6,), (256, 6)]
    xs = [torch.from_numpy(rng.standard_normal((30, int(np.prod(s)))).astype(np.float32) * 0.01)
          for s in shapes]
    xs[3][1, 7] = float("nan")
    us = [torch.from_numpy(rng.random(x.shape, dtype=np.float32)) for x in xs]
    for noises in (us, None):
        kernels.reset_launch_counts()
        got = quantize_leaves([x.to(cuda) for x in xs],
                              None if noises is None else [u.to(cuda) for u in noises], bits=bits)
        assert kernels.launch_counts()["quantize"] == 1
        for (q, s), (qp, sp) in zip(got, quantize_leaves_plain(xs, noises, bits=bits)):
            q, s = q.cpu(), s.cpu()
            assert torch.equal(q, qp) and torch.equal(torch.isnan(s), torch.isnan(sp))
            assert torch.equal(s.nan_to_num(), sp.nan_to_num())


def test_quantize_leaves_past_one_table(cuda):
    """70 leaves raise (the kernel's table takes 64) and launch nothing; 64
    go in one launch, bitwise."""
    xs = [torch.randn((3, 9 + i), device=cuda) for i in range(70)]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="at most 64 leaves"):
        quantize_leaves(xs)
    assert kernels.launch_counts()["quantize"] == 0
    got = quantize_leaves(xs[:64])
    assert kernels.launch_counts()["quantize"] == 1
    for (q, s), x in zip(got, xs):
        qp, sp = quantize_plain(x.cpu())
        assert torch.equal(q.cpu(), qp) and torch.equal(s.cpu(), sp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_masked_aggregate_vs_plain(cuda, dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((30, 65539)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(((rng.random(30) < 0.5) * rng.integers(20, 400, 30)).astype(np.float32))
    fb = torch.from_numpy(rng.standard_normal(65539).astype(np.float32)).to(dtype)
    got = masked_aggregate(x.to(cuda), w.to(cuda), fb.to(cuda)).cpu()
    assert torch.equal(got, masked_aggregate_plain(x, w, fb))
    zero = masked_aggregate(x.to(cuda), torch.zeros_like(w).to(cuda), fb.to(cuda)).cpu()
    assert torch.equal(zero, fb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_masked_aggregate_leaves_bitwise_in_one_launch(cuda, dtype):
    """har-mlp's leaves (a 6-element bias to a 561 x 256 matrix) under a
    masked-partial weight matrix, R = 4 with an all-zero row."""
    rng = np.random.default_rng(3)
    shapes = [(256,), (561, 256), (256,), (256, 256), (6,), (256, 6)]
    xs = [torch.from_numpy(rng.standard_normal((30,) + s).astype(np.float32)).to(dtype)
          for s in shapes]
    fbs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype) for s in shapes]
    w = ((rng.random((4, 30)) < 0.5) * rng.integers(20, 400, (4, 30))).astype(np.float32)
    w[2] = 0.0
    w = torch.from_numpy(w)
    rows = [0, 1, 2, 2, 3, 1]
    kernels.reset_launch_counts()
    got = masked_aggregate_leaves([x.to(cuda) for x in xs], w.to(cuda), rows,
                                  [fb.to(cuda) for fb in fbs])
    assert kernels.launch_counts()["masked_aggregate"] == 1
    want = masked_aggregate_leaves_plain(xs, w, rows, fbs)
    for i, (g, p) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == p.shape
        assert torch.equal(g.cpu(), p), i
        if rows[i] == 2:
            assert torch.equal(g.cpu(), fbs[i])


@pytest.mark.parametrize("cfg", [dict(codec="int8"),
                                 dict(strategy="fedavg", personalization="none", fraction=1.0)],
                         ids=["acsp-fl+dld+int8", "fedavg"])
def test_aggregation_launches_once_a_round(cuda, cfg):
    ds = make_federated_classification(n_clients=8, n_classes=4, n_features=20,
                                       samples_per_client_range=(60, 90), seed=1)
    kernels.reset_launch_counts()
    run_federated(ds, FLConfig(rounds=3, epochs=1, **cfg), device=cuda)
    assert kernels.launch_counts()["masked_aggregate"] == 3


def test_int8_round_runs_through_the_kernels(cuda):
    ds = make_federated_classification(n_clients=8, n_classes=4, n_features=20,
                                       samples_per_client_range=(60, 90), seed=1)
    kernels.reset_launch_counts()
    h = run_federated(ds, FLConfig(codec="int8", rounds=2, epochs=1), device=cuda)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("quantize", "dequantize", "masked_aggregate")), counts
    assert counts["quantize"] == counts["dequantize"] == 2, counts  # one launch a round
    assert np.isfinite(h.accuracy_mean).all()


def _same(a, b) -> bool:
    """Bitwise equal, a NaN matching a NaN (a NaN scale decodes to NaNs)."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


@pytest.mark.parametrize("bits", [4, 8])
def test_dequantize_leaves_bitwise_in_one_launch(cuda, bits):
    """har-mlp's 8 leaves at K = 30, codes of a quantize run (int4's in
    [-7, 7]), a NaN scale in one leaf: one launch, bitwise the per-leaf
    plain version."""
    rng = np.random.default_rng(10 + bits)
    shapes = [(256,), (561, 256), (256,), (256, 256), (256,), (256, 256), (6,), (256, 6)]
    xs = [torch.from_numpy(rng.standard_normal((30, int(np.prod(s)))).astype(np.float32) * 0.01)
          for s in shapes]
    xs[3][1, 7] = float("nan")
    codes = quantize_leaves_plain(xs, bits=bits)
    kernels.reset_launch_counts()
    got = dequantize_leaves([(q.to(cuda), s.to(cuda)) for q, s in codes])
    assert kernels.launch_counts()["dequantize"] == 1
    for g, p in zip(got, dequantize_leaves_plain(codes)):
        assert g.dtype == torch.float32 and _same(g.cpu(), p)
    assert torch.isnan(got[3][1, :512]).all()


@pytest.mark.parametrize("n", [1, 6, 513, 2049])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_dequantize_odd_rows_and_unaligned_codes(cuda, n, offset):
    """Rows of 1, 6, 513 and 2049 elements (ragged quant blocks, rows that
    start unaligned), codes read from an address 0, 1 or 3 bytes past an
    aligned one, block sizes 512 and 1024 (a quant block longer than the
    threads' stride)."""
    rng = np.random.default_rng(n + offset)
    x = torch.from_numpy(rng.standard_normal((7, n)).astype(np.float32))
    for block_p in (512, 1024):
        q, s = quantize_plain(x, block_p=block_p)
        raw = torch.zeros(offset + q.numel(), dtype=torch.int8, device=cuda)
        qd = raw[offset:].view(q.shape)
        qd.copy_(q.to(cuda))
        assert qd.data_ptr() % 4 == offset % 4 and qd.is_contiguous()
        got = dequantize(qd, s.to(cuda), block_p=block_p)
        assert torch.equal(got.cpu(), dequantize_plain(q, s, block_p=block_p))


def test_dequantize_leaves_past_one_table(cuda):
    codes = [quantize(torch.randn((3, 9 + i), device=cuda)) for i in range(65)]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="at most 64 leaves"):
        dequantize_leaves(codes)
    assert kernels.launch_counts()["dequantize"] == 0
    got = dequantize_leaves(codes[:64])
    assert kernels.launch_counts()["dequantize"] == 1
    for g, (q, s) in zip(got, codes):
        assert torch.equal(g.cpu(), dequantize_plain(q.cpu(), s.cpu()))


@pytest.mark.parametrize("cfg", [dict(codec="int8"),
                                 dict(codec="int4", cohort_size=5, eval_every=2),
                                 dict(strategy="oort", personalization="ft", fraction=0.5)],
                         ids=["acsp-fl+dld+int8", "int4+cohort5+eval2", "oort+ft"])
def test_captured_chunks_equal_eager_rounds(cuda, cfg):
    """scan_chunk 2, 3 (a 2-round tail) and 5: CUDA-graph replays give the
    eager per-round history bit for bit, with one launch of each FL kernel
    a round."""
    ds = make_federated_classification(n_clients=8, n_classes=4, n_features=20,
                                       samples_per_client_range=(60, 90), seed=1)
    runs = {}
    for chunk in (1, 2, 3, 5):
        kernels.reset_launch_counts()
        runs[chunk] = run_federated(ds, FLConfig(rounds=5, epochs=1, scan_chunk=chunk, **cfg),
                                    device=cuda)
        counts = kernels.launch_counts()
        assert counts["masked_aggregate"] == 5, (chunk, counts)
        if "codec" in cfg:
            assert counts["quantize"] == counts["dequantize"] == 5, (chunk, counts)
    for chunk, h in runs.items():
        for field in h._fields:
            if field != "wall_time":
                np.testing.assert_array_equal(np.asarray(getattr(h, field)),
                                              np.asarray(getattr(runs[1], field)),
                                              err_msg=f"chunk={chunk} field={field}")
    assert np.isfinite(runs[1].accuracy_mean).all()


def _close_to_max(got, want, rel=1e-5):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= rel * float(want.abs().max())


@pytest.mark.parametrize("a_kind", ["s4d", "random"])
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(2, 64, 128, 16), (1, 37, 200, 8), (2, 300, 64, 16),
                                   (1, 100, 100, 16), (2, 70, 30, 8)], ids=str)
def test_ssm_scan_vs_plain(cuda, shape, stream, a_kind):
    """The contract at whole and ragged chunks, di not a multiple of the
    block's 64 channels nor of a 16-byte vector (the scalar copies), with
    the S4D-real A and a random A (no structure across states or
    channels)."""
    b, s, di, ds = shape
    gen = torch.Generator(device=cuda).manual_seed(s)
    dt = torch.nn.functional.softplus(torch.randn((b, s, di), generator=gen, device=cuda) - 2)
    if a_kind == "s4d":
        a = -torch.arange(1, ds + 1, dtype=torch.float32, device=cuda).expand(di, ds).contiguous()
    else:
        a = -torch.exp(torch.randn((di, ds), generator=gen, device=cuda))
    bm, cm = (torch.randn((b, s, ds), generator=gen, device=cuda) for _ in range(2))
    x = torch.randn((b, s, di), generator=gen, device=cuda)
    d = torch.randn((di,), generator=gen, device=cuda)
    ins = [t.to(stream) for t in (dt, bm, cm, x)]
    args = (ins[0], a, ins[1], ins[2], ins[3], d)
    plain32, ref64 = ssm_contract.references(*args)
    for y_dtype in (torch.float32, torch.bfloat16):
        kernels.reset_launch_counts()
        y, h = ssm_scan(*args, y_dtype=y_dtype)
        assert kernels.launch_counts()["ssm_scan"] == 1
        assert y.dtype == y_dtype and y.shape == x.shape and h.shape == (b, di, ds)
        result = ssm_contract.check(y, h, plain32, ref64)
        assert result["ok"], result
    for name, (yc, hc) in ssm_contract.controls(*args).items():
        if name.startswith("h reset") and s <= ssm_contract.CONTROL_CHUNK:
            continue  # one chunk: the reset control is the plain version itself
        assert not ssm_contract.check(yc, hc, plain32, ref64)["ok"], name


def test_ssm_scan_empty_sequence(cuda):
    a = -torch.ones((64, 16), device=cuda)
    x = torch.zeros((2, 0, 64), device=cuda)
    y, h = ssm_scan(x, a, x[..., :16], x[..., :16], x, torch.ones(64, device=cuda))
    assert y.shape == (2, 0, 64) and torch.equal(h.cpu(), torch.zeros(2, 64, 16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", [
    # (b, s, h, hkv, d, causal, window)
    (2, 128, 4, 4, 64, True, 0),
    (1, 200, 8, 2, 128, True, 0),
    (1, 200, 8, 2, 128, True, 48),
    (2, 70, 4, 1, 64, False, 0),
    (1, 130, 4, 2, 64, False, 32),
], ids=str)
def test_flash_attention_vs_plain(cuda, case, dtype):
    b, s, h, hkv, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=cuda).to(dtype) for _ in range(2))
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype
    if dtype == torch.float32:
        _close_to_max(got, want)
    else:
        result = bf16_contract(got, want, q, k, v, causal, window)
        assert result["ok"], result


@pytest.mark.parametrize("case", [
    # (b, s, h, hkv, d, causal, window): G = 4 and a ragged S, D = 64, a window
    (1, 2000, 8, 2, 128, True, 0),
    (2, 384, 8, 2, 64, True, 0),
    (1, 640, 8, 2, 128, True, 200),
    (1, 300, 4, 1, 64, False, 0),
    (2, 130, 4, 4, 128, False, 64),
], ids=str)
def test_flash_attention_wgmma_vs_plain(cuda, case):
    b, s, h, hkv, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(s + d + window)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert kernels.launch_counts()["flash_attention"] == 1 and got.dtype == torch.bfloat16
    result = bf16_contract(got, flash_attention_plain(q, k, v, causal=causal, window=window),
                           q, k, v, causal, window)
    assert result["ok"], result


def test_flash_attention_bf16_reaches_only_the_wgmma_kernel(cuda):
    """The CUDA-core library has no bf16 entry and the wgmma one no float32
    entry; a bf16 call at D = 128 runs, float16 raises."""
    assert not hasattr(build.load("flash_attention"), "repro_flash_attention_bf16")
    assert not hasattr(build.load("flash_attention_wgmma"), "repro_flash_attention_f32")
    q = torch.randn((1, 64, 2, 128), device=cuda).to(torch.bfloat16)
    assert flash_attention(q, q[:, :, :1], q[:, :, :1]).dtype == torch.bfloat16
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), q[:, :, :1].half(), q[:, :, :1].half())


def _positions(kind: str, n: int, seed: int) -> np.ndarray:
    """int32 (n,) position vectors: ``image`` (a Qwen2-VL image first: a
    quarter of the tokens at t = 0, then text from t = 8), ``ties`` (a
    non-decreasing walk with steps 0, 1 or 2), ``arange``."""
    if kind == "arange":
        return np.arange(n, dtype=np.int32)
    if kind == "image":
        nv = n // 4
        return np.concatenate([np.zeros(nv), 8 + np.arange(n - nv)]).astype(np.int32)
    return np.cumsum(np.random.default_rng(seed).integers(0, 3, n)).astype(np.int32)


_POS_CASES = [
    # (b, s, h, hkv, dq, dv, window, positions): causal self-attention
    (2, 300, 8, 2, 128, 128, 0, "image"),
    (1, 2000, 12, 2, 128, 128, 0, "image"),
    (1, 333, 8, 2, 128, 128, 40, "ties"),
    (2, 130, 4, 4, 64, 64, 0, "ties"),
    (1, 200, 4, 4, 192, 128, 0, "image"),
    (1, 200, 6, 1, 160, 160, 32, "ties"),
]


@pytest.mark.parametrize("case,dtype", [(c, dt) for c in _POS_CASES
                                         for dt in (torch.float32, torch.bfloat16)
                                         if (c[4], c[5]) in HEAD_DIMS[dt]], ids=str)
def test_flash_attention_positions_vs_plain(cuda, case, dtype):
    """The position mask (q_pos = k_pos, M-RoPE's t stream: an image's
    tokens share one position, or a walk with ties and jumps), forward and
    backward, against the plain versions: float32 within 1e-5 of max, bf16
    to the bf16 contract, the backward to its contract with its controls
    rejected; one launch each; and q_pos = k_pos = arange(S) gives the
    index path's bits."""
    from repro_torch.kernels.flash_attention import contract as fa_contract
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ops import _attention

    b, s, h, hkv, dq, dv, window, kind = case
    pos = torch.from_numpy(_positions(kind, s, s)).to(cuda)
    q, k, v, dout = _attention_inputs(cuda, (b, s, s, h, hkv, dq, dv), dtype)
    mask = dict(q_pos=pos, k_pos=pos)
    kernels.reset_launch_counts()
    out, lse = _attention(q, k, v, True, window, True, pos, pos)
    assert kernels.launch_counts()["flash_attention"] == 1
    want, lse_plain = flash_attention_plain(q, k, v, True, window, return_lse=True, **mask)
    if dtype == torch.float32:
        _close_to_max(out, want)
    else:
        result = bf16_contract(out, want, q, k, v, True, window, **mask)
        assert result["ok"], result
    assert float((lse - lse_plain).abs().max()) <= 1e-5 * max(1.0, float(lse_plain.abs().max()))
    got = flash_attention_bwd(q, k, v, out, lse, dout, True, window, **mask)
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    ref = fa_contract.bwd_references(q, k, v, out, lse, dout, True, window, **mask)
    result = fa_contract.bwd_check(got, ref)
    assert result["ok"], result
    for name, bad in fa_contract.bwd_controls(q, k, v, out, lse, dout, True, window,
                                              **mask).items():
        assert not fa_contract.bwd_check(bad, ref)["ok"], name
    # the index mask's bits where the positions are the indices
    ar = torch.arange(s, dtype=torch.int32, device=cuda)
    out_i, lse_i = _attention(q, k, v, True, window, True)
    out_a, lse_a = _attention(q, k, v, True, window, True, ar, ar)
    assert torch.equal(out_i, out_a) and torch.equal(lse_i, lse_a)
    grads_i = flash_attention_bwd(q, k, v, out_i, lse_i, dout, True, window)
    grads_a = flash_attention_bwd(q, k, v, out_i, lse_i, dout, True, window, q_pos=ar, k_pos=ar)
    assert all(torch.equal(x, y) for x, y in zip(grads_i, grads_a))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", [(2, 100, 700, 6, 6, 64, 64), (1, 64, 300, 4, 2, 128, 128)],
                         ids=str)
def test_flash_attention_positions_t_ne_s_vs_plain(cuda, case, dtype):
    """q_pos (S,) over k_pos (T,) with T != S, causal and non-causal: keys
    with a negative position (an empty cache slot's -1) are never seen; each
    query's position is some key's, so every row sees a key."""
    from repro_torch.kernels.flash_attention import contract as fa_contract
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ops import _attention

    rng = np.random.default_rng(case[2])
    k_np = _positions("ties", case[2], case[2])
    k_np[rng.random(case[2]) < 0.1] = -1
    q_np = np.sort(rng.choice(k_np[k_np >= 0], case[1]))
    q_pos, k_pos = (torch.from_numpy(x.astype(np.int32)).to(cuda) for x in (q_np, k_np))
    q, k, v, dout = _attention_inputs(cuda, case, dtype)
    for causal in (True, False):
        mask = dict(q_pos=q_pos, k_pos=k_pos)
        out, lse = _attention(q, k, v, causal, 0, True, q_pos, k_pos)
        want = flash_attention_plain(q, k, v, causal, **mask)
        if dtype == torch.float32:
            _close_to_max(out, want)
        else:
            result = bf16_contract(out, want, q, k, v, causal, **mask)
            assert result["ok"], result
        got = flash_attention_bwd(q, k, v, out, lse, dout, causal, **mask)
        result = fa_contract.bwd_check(got, fa_contract.bwd_references(q, k, v, out, lse, dout,
                                                                       causal, **mask))
        assert result["ok"], (causal, result)


def test_flash_attention_positions_refuse_bad_vectors(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="together"):
        flash_attention(q, q, q, q_pos=pos)
    with pytest.raises(ValueError, match="int32"):
        flash_attention(q, q, q, q_pos=pos.long(), k_pos=pos.long())
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, q, q, q_pos=pos[:5], k_pos=pos)


@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(2, 64, 128, 16), (1, 37, 200, 8), (2, 300, 64, 16),
                                   (2, 1, 96, 16)], ids=str)
def test_ssm_scan_from_a_start_state_vs_plain(cuda, shape, stream):
    """The scan from a carried state h0 to ``contract.py`` (against the
    float64 scan from h0), the start-state-dropped control rejected, the
    chunk start states beginning with h0; h0 = zeros gives the bits of the
    scan without one; one launch a call."""
    b, s, di, ds = shape
    gen = torch.Generator(device=cuda).manual_seed(s + di)
    dt = torch.nn.functional.softplus(torch.randn((b, s, di), generator=gen, device=cuda) - 2)
    a = -torch.exp(torch.randn((di, ds), generator=gen, device=cuda))
    bm, cm = (torch.randn((b, s, ds), generator=gen, device=cuda) for _ in range(2))
    x = torch.randn((b, s, di), generator=gen, device=cuda)
    d = torch.randn((di,), generator=gen, device=cuda)
    h0 = torch.randn((b, di, ds), generator=gen, device=cuda)
    ins = [t.to(stream) for t in (dt, bm, cm, x)]
    args = (ins[0], a, ins[1], ins[2], ins[3], d)
    plain32, ref64 = ssm_contract.references(*args, h0=h0)
    for y_dtype in (torch.float32, torch.bfloat16):
        kernels.reset_launch_counts()
        y, h = ssm_scan(*args, y_dtype=y_dtype, h0=h0)
        assert kernels.launch_counts()["ssm_scan"] == 1
        result = ssm_contract.check(y, h, plain32, ref64)
        assert result["ok"], result
    _, _, hs = ssm_scan(*args, chunk_states=True, h0=h0)
    assert torch.equal(hs[0], h0)
    bad = ssm_contract.controls(*args, h0=h0)["start state dropped"]
    assert not ssm_contract.check(*bad, plain32, ref64)["ok"]
    y0, h_0 = ssm_scan(*args)
    yz, hz = ssm_scan(*args, h0=torch.zeros_like(h0))
    assert torch.equal(y0, yz) and torch.equal(h_0, hz)


def test_ssm_scan_empty_sequence_keeps_its_start_state(cuda):
    a = -torch.ones((64, 16), device=cuda)
    x = torch.zeros((2, 0, 64), device=cuda)
    h0 = torch.randn((2, 64, 16), device=cuda)
    _, h = ssm_scan(x, a, x[..., :16], x[..., :16], x, torch.ones(64, device=cuda), h0=h0)
    assert torch.equal(h, h0)


def test_flash_attention_rejects_other_head_dims(cuda):
    """Head dim 160 has a kernel in bf16 only (stablelm-12b's; the reduced
    float32 configs cap the head dim at 64)."""
    q = torch.zeros((1, 8, 2, 160), device=cuda)
    with pytest.raises(NotImplementedError, match="takes \\(Dqk, Dv\\)"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("case", [
    # (b, s, h, hkv, dq, dv, causal, window, dtype): MLA's (192, 128) in bf16
    # (deepseek-v2-lite), the reduced (48, 32) in float32, and D = 128 at
    # G = 1 (deepseek-moe's MHA) in bf16
    (2, 300, 4, 4, 192, 128, True, 0, torch.bfloat16),
    (1, 2000, 2, 2, 192, 128, True, 0, torch.bfloat16),
    (1, 640, 4, 4, 192, 128, True, 200, torch.bfloat16),
    (1, 130, 2, 2, 192, 128, False, 0, torch.bfloat16),
    (2, 200, 4, 4, 48, 32, True, 0, torch.float32),
    (1, 130, 4, 2, 48, 32, False, 32, torch.float32),
    (2, 384, 4, 4, 128, 128, True, 0, torch.bfloat16),
], ids=str)
def test_flash_attention_mla_dims_and_g1_vs_plain(cuda, case):
    b, s, h, hkv, dq, dv, causal, window, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(s + dq + window)
    q = torch.randn((b, s, h, dq), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, s, hkv, dq), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, s, hkv, dv), generator=gen, device=cuda).to(dtype)
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert kernels.launch_counts()["flash_attention"] == 1
    assert got.shape == (b, s, h, dv) and got.dtype == dtype
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        _close_to_max(got, want)
    else:
        result = bf16_contract(got, want, q, k, v, causal, window)
        assert result["ok"], result


@pytest.mark.parametrize("case", [
    # (b, s, h, hkv, d, causal, window): stablelm-12b's (160, 160) at G = 4,
    # causal, windowed, a ragged S and non-causal (64-key tiles); D = 128 at
    # chatglm3-6b's G = 16 and qwen2-vl-2b's G = 6, the first group sizes
    # over 4 and the first that is not a power of two
    (2, 384, 8, 2, 160, True, 0),
    (1, 640, 4, 1, 160, True, 200),
    (1, 2000, 4, 1, 160, True, 0),
    (2, 130, 4, 1, 160, False, 0),
    (1, 1000, 32, 2, 128, True, 0),
    (2, 300, 16, 1, 128, True, 100),
    (1, 1000, 12, 2, 128, True, 0),
    (2, 333, 6, 1, 128, False, 0),
], ids=str)
def test_flash_attention_160_and_wide_groups_vs_plain(cuda, case):
    b, s, h, hkv, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(s + d + h + window)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert kernels.launch_counts()["flash_attention"] == 1
    assert got.shape == (b, s, h, d) and got.dtype == torch.bfloat16
    result = bf16_contract(got, flash_attention_plain(q, k, v, causal=causal, window=window),
                           q, k, v, causal, window)
    assert result["ok"], result


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", [
    # (b, s, t, h, hkv): whisper-tiny's encoder (S = T = 1,500: a ragged
    # last 128-key tile of 92 keys), its prefill's cross-attention (448
    # decoder queries over 1,500 frames) and a decode step's (one query: a
    # 64-row TMA box over a rows dimension of 1), then small T != S cases
    # with T ragged and below one tile, G = 2
    (4, 1500, 1500, 6, 6),
    (4, 448, 1500, 6, 6),
    (4, 1, 1500, 6, 6),
    (2, 30, 200, 4, 2),
    (1, 100, 37, 4, 2),
    (3, 1, 20, 2, 1),
], ids=str)
def test_flash_attention_non_causal_t_ne_s_vs_plain(cuda, case, dtype):
    b, s, t, h, hkv = case
    gen = torch.Generator(device=cuda).manual_seed(s + t + h)
    q = torch.randn((b, s, h, 64), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, t, hkv, 64), generator=gen, device=cuda).to(dtype) for _ in range(2))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=False)
    assert kernels.launch_counts()["flash_attention"] == 1
    assert got.shape == (b, s, h, 64) and got.dtype == dtype
    want = flash_attention_plain(q, k, v, causal=False)
    if dtype == torch.float32:
        _close_to_max(got, want)
    else:
        result = bf16_contract(got, want, q, k, v, False)
        assert result["ok"], result


@pytest.mark.parametrize("dims,dtype", [((96, 96), torch.bfloat16), ((48, 32), torch.bfloat16),
                                        ((192, 128), torch.float32), ((128, 64), torch.bfloat16)],
                         ids=str)
def test_flash_attention_rejects_dims_without_a_kernel(cuda, dims, dtype):
    q = torch.zeros((1, 8, 2, dims[0]), device=cuda, dtype=dtype)
    v = torch.zeros((1, 8, 2, dims[1]), device=cuda, dtype=dtype)
    with pytest.raises(NotImplementedError, match="takes \\(Dqk, Dv\\)"):
        flash_attention(q, q, v)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b"])
def test_reduced_moe_family_on_cuda_matches_cpu(cuda, arch):
    """The reduced float32 MoE family served on the card through
    flash_attention's float32 kernel (MLA at (48, 32)), each prefill one
    launch a layer; its prefill and decode logits within 1e-5 of max of
    the same model on the CPU."""
    import copy
    import dataclasses

    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    stats = serve(cfg, requests=3, batch=2, prompt_len=32, max_new=4, device=cuda)
    assert stats["n_requests"] == 3 and stats["logits_finite"]
    cpu_model = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    dev_model = copy.deepcopy(cpu_model).to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    prefill, decode = transformer.make_prefill_step(cfg), transformer.make_decode_step(cfg)
    kernels.reset_launch_counts()
    (want, cpu_cache), (got, dev_cache) = (prefill(m, {"tokens": toks})
                                           for m in (cpu_model, dev_model))
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    _close_to_max(got.cpu(), want)
    for _ in range(2):
        tok = torch.argmax(want, dim=-1)[:, None]
        want, cpu_cache = decode(cpu_model, cpu_cache, tok)
        got, dev_cache = decode(dev_model, dev_cache, tok)
        _close_to_max(got.cpu(), want)


_EP_ARCHS = ["deepseek-moe-16b", "moonshot-v1-16b-a3b", "deepseek-v2-lite-16b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", _EP_ARCHS)
def test_moe_apply_ep_on_cuda_matches_cpu_under_a_1x1_mesh(cuda, arch):
    """Under a (1, 1) mesh of ranks (one world-1 group: gloo for the CPU's
    tensors, NCCL for the card's) the reduced float32 models take
    ``moe_apply_ep`` on both devices: the MoE layer and the prefill and
    two decode steps on the card within 1e-5 of max of the CPU's (2^-8
    behind jamba's scans), one expert-parallel call a MoE layer a step."""
    import copy
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch import context as ctx
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import layers, transformer

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rel = 2.0 ** -8 if cfg.ssm else 1e-5
    cpu_model = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    dev_model = copy.deepcopy(cpu_model).to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    p = layers.init_moe(torch.Generator().manual_seed(2), cfg)
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator().manual_seed(3))
    calls = []
    routes = layers.moe_ep_routes
    layers.moe_ep_routes = lambda *a: calls.append(1) or routes(*a)
    mesh = make_rank_mesh((1, 1), device=cuda, backend="cpu:gloo,cuda:nccl")
    try:
        with ctx.mesh_context(mesh):
            want, _ = layers.moe_apply(p, x, cfg)
            got, _ = layers.moe_apply({k: v.to(cuda) if torch.is_tensor(v) else
                                       {kk: vv.to(cuda) for kk, vv in v.items()}
                                       for k, v in p.items()}, x.to(cuda), cfg)
            _close_to_max(got.cpu(), want, rel=1e-5)
            prefill, decode = transformer.make_prefill_step(cfg), transformer.make_decode_step(cfg)
            calls.clear()
            (want, cpu_cache), (got, dev_cache) = (prefill(m, {"tokens": toks})
                                                   for m in (cpu_model, dev_model))
            _close_to_max(got.cpu(), want, rel=rel)
            for _ in range(2):
                tok = torch.argmax(want, dim=-1)[:, None]
                want, cpu_cache = decode(cpu_model, cpu_cache, tok)
                got, dev_cache = decode(dev_model, dev_cache, tok)
                _close_to_max(got.cpu(), want, rel=rel)
    finally:
        layers.moe_ep_routes = routes
        mesh.close()
    assert len(calls) == 2 * 3 * sum(s.moe for s in transformer.layer_specs(cfg))
    assert not dist.is_initialized()


def test_moe_apply_ep_all_reduces_on_a_one_rank_nccl_group(cuda, tmp_path):
    """A world-1 NCCL mesh: a prefill's trace holds one all-reduce a MoE
    layer, of the float32 (B S, D) partial (``launch/collectives`` reads
    it), and the logits equal the run without a mesh but for the float32
    sum over k (within 1e-5 of max)."""
    import dataclasses

    from repro_torch.launch import context as ctx
    from repro_torch.launch.collectives import collective_bytes
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), dtype="float32")
    model = transformer.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    b, s = 2, 16
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    prefill = transformer.make_prefill_step(cfg)
    want, _ = prefill(model, {"tokens": toks})
    mesh = make_rank_mesh((1, 1), device=cuda)
    try:
        with ctx.mesh_context(mesh):
            prefill(model, {"tokens": toks})  # the communicator's first use
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA],
                                        record_shapes=True) as prof:
                got, _ = prefill(model, {"tokens": toks})
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(tmp_path / "ep.json"))
    finally:
        mesh.close()
    assert mesh.backend == "nccl"
    n_moe = sum(sp.moe for sp in transformer.layer_specs(cfg))
    stats = collective_bytes(str(tmp_path / "ep.json"))
    assert stats["count"] == n_moe and stats["total"] == n_moe * b * s * cfg.d_model * 4, stats
    _close_to_max(got.cpu(), want.cpu(), rel=1e-5)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "stablelm-12b", "qwen2-vl-2b"])
def test_reduced_dense_zoo_on_cuda_matches_cpu(cuda, arch):
    """The reduced float32 chatglm3 (half RoPE), stablelm and qwen2-vl
    (M-RoPE, the vision stub; served in waves) on the card through
    flash_attention, each prefill one launch a layer; prefill and decode
    logits within 1e-5 of max of the same model on the CPU, on the same
    batch (qwen2-vl's vision embeddings and positions included)."""
    import copy
    import dataclasses

    from repro_torch import random as prng
    from repro_torch.models import transformer
    from repro_torch.models.api import make_concrete_batch

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    kernels.reset_launch_counts()
    stats = serve(cfg, requests=3, batch=2, prompt_len=32, max_new=4, device=cuda)
    assert stats["n_requests"] == 3 and stats["logits_finite"]
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers * stats["prefill_calls"]
    cpu_model = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    dev_model = copy.deepcopy(cpu_model).to(cuda)
    batch = make_concrete_batch(cfg, "prefill", 2, 64, prng.PRNGKey(1))
    prefill, decode = transformer.make_prefill_step(cfg), transformer.make_decode_step(cfg)
    kernels.reset_launch_counts()
    (want, cpu_cache), (got, dev_cache) = (prefill(m, batch) for m in (cpu_model, dev_model))
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    assert dev_cache["pos"] == cpu_cache["pos"] == 64
    _close_to_max(got.cpu(), want)
    for _ in range(2):
        tok = torch.argmax(want, dim=-1)[:, None]
        want, cpu_cache = decode(cpu_model, cpu_cache, tok)
        got, dev_cache = decode(dev_model, dev_cache, tok)
        _close_to_max(got.cpu(), want)


@pytest.mark.parametrize("arch", ["whisper-tiny", "jamba-v0.1-52b"])
def test_reduced_whisper_and_jamba_on_cuda_match_cpu(cuda, arch):
    """The reduced float32 whisper (served in waves; flash_attention
    non-causal in its encoder and cross-attention, a decode step's at S =
    1) and jamba (ssm_scan and flash_attention in one stack) on the card:
    exactly the expected launches, and prefill and decode logits within
    1e-5 of max (2^-8 after jamba's Mamba scans) of the same model on the
    CPU, on the same batch."""
    import copy
    import dataclasses

    from repro_torch import random as prng
    from repro_torch.models.api import get_model, make_concrete_batch

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rel = 2.0 ** -8 if cfg.ssm else 1e-5
    kernels.reset_launch_counts()
    stats = serve(cfg, requests=3, batch=2, prompt_len=32, max_new=4, device=cuda)
    assert stats["n_requests"] == 3 and stats["logits_finite"]
    counts = kernels.launch_counts()
    n_pre, n_dec = stats["prefill_calls"], len(stats["decode_ms"])
    if cfg.encoder_decoder:
        assert counts["flash_attention"] == ((cfg.n_encoder_layers + 2 * cfg.n_layers) * n_pre
                                             + cfg.n_layers * n_dec) and counts["ssm_scan"] == 0
    else:
        assert counts["ssm_scan"] == 7 * n_pre and counts["flash_attention"] == n_pre
    bundle = get_model(cfg)
    cpu_model = bundle.init(torch.Generator().manual_seed(0))
    dev_model = copy.deepcopy(cpu_model).to(cuda)
    batch = make_concrete_batch(cfg, "prefill", 2, 64, prng.PRNGKey(1))
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
    (want, cpu_cache), (got, dev_cache) = (prefill(m, batch) for m in (cpu_model, dev_model))
    _close_to_max(got.cpu(), want, rel)
    for _ in range(2):
        tok = torch.argmax(want, dim=-1)[:, None]
        want, cpu_cache = decode(cpu_model, cpu_cache, tok)
        got, dev_cache = decode(dev_model, dev_cache, tok)
        _close_to_max(got.cpu(), want, rel)


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_whisper_frames_drawn_on_cuda_are_the_host_draw(cuda, size):
    from repro_torch import random as prng
    from repro_torch.models.api import make_concrete_batch

    cfg = get_config("whisper-tiny")
    cfg, (b, s) = (cfg.reduced(), (4, 64)) if size == "reduced" else (cfg, (2, 2048))
    host = make_concrete_batch(cfg, "prefill", b, s, prng.PRNGKey(9))
    card = make_concrete_batch(cfg, "prefill", b, s, prng.PRNGKey(9, device=cuda))
    assert list(card) == list(host) == ["frames", "tokens"]
    assert card["frames"].device.type == "cuda" and card["frames"].dtype == torch.bfloat16
    for name, want in host.items():
        got = card[name].cpu()
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype == torch.bfloat16 else want), name


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_vision_batch_drawn_on_cuda_is_the_host_draw(cuda, size):
    """qwen2-vl's serving waves draw their batch on the card: the threefry
    words, the uniform and the erfinv arithmetic give the host's bits (the
    vision embeddings' bf16 included); the positions stay on the host."""
    from repro_torch import random as prng
    from repro_torch.models.api import make_concrete_batch

    cfg = get_config("qwen2-vl-2b")
    cfg, (b, s) = (cfg.reduced(), (4, 64)) if size == "reduced" else (cfg, (2, 2048))
    host = make_concrete_batch(cfg, "prefill", b, s, prng.PRNGKey(9))
    card = make_concrete_batch(cfg, "prefill", b, s, prng.PRNGKey(9, device=cuda))
    assert list(card) == list(host) and card["positions"].device.type == "cpu"
    bits = lambda t: t.cpu().view(torch.int16) if t.dtype == torch.bfloat16 else t.cpu()  # noqa: E731
    for name, want in host.items():
        assert card[name].dtype == want.dtype and torch.equal(bits(card[name]), bits(want)), name


@pytest.mark.parametrize("arch,kernel", [("falcon-mamba-7b", "ssm_scan"),
                                         ("granite-3-8b", "flash_attention")])
def test_reduced_serving_runs_through_its_kernel(cuda, arch, kernel):
    cfg = get_config(arch).reduced()
    kernels.reset_launch_counts()
    stats = serve(cfg, requests=3, batch=2, prompt_len=32, max_new=4, device=cuda)
    assert kernels.launch_counts()[kernel] == cfg.n_layers * stats["prefill_calls"]
    assert stats["n_requests"] == 3 and stats["timer"] == "cuda-events"


_HAR = [(256,), (561, 256), (256,), (256, 256), (256,), (256, 256), (6,), (256, 6)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("landing", ["some", "none"])
def test_staleness_merge_bitwise_in_one_launch(cuda, dtype, landing):
    """har-mlp's 8 leaves at M = 30 slots, layer 2 shared by nobody (its
    leaves come back as the base): one launch, bitwise the plain version,
    and the fused snapshot bitwise the deltas passed."""
    rng = np.random.default_rng(20)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)  # noqa: E731
    snaps = [f(30, *sh) for sh in _HAR]
    xs = [s_ + 0.01 * f(30, *sh) for s_, sh in zip(snaps, _HAR)]
    bases = [f(*sh) for sh in _HAR]
    w = ((rng.random((4, 30)) < 0.5) * rng.integers(20, 400, (4, 30)) * rng.random(30))
    w[2] = 0.0
    if landing == "none":
        w[:] = 0.0
    w = torch.from_numpy(w.astype(np.float32))
    rows = [j for j in range(4) for _ in range(2)]
    dev = lambda ts: [t.to(cuda) for t in ts]  # noqa: E731
    kernels.reset_launch_counts()
    got = masked_aggregate_leaves(dev(xs), w.to(cuda), rows, snapshots=dev(snaps),
                                  bases=dev(bases))
    assert kernels.launch_counts()["masked_aggregate"] == 1
    want = masked_aggregate_leaves_plain(xs, w, rows, snapshots=snaps, bases=bases)
    deltas = masked_aggregate_leaves(dev([x - s_ for x, s_ in zip(xs, snaps)]), w.to(cuda), rows,
                                     bases=dev(bases))
    for i, (g, p, d) in enumerate(zip(got, want, deltas)):
        assert g.dtype == dtype and torch.equal(g.cpu(), p), i
        if dtype == torch.float32:
            assert torch.equal(g, d), i
        if rows[i] == 2 or landing == "none":
            assert torch.equal(g.cpu(), bases[i]), i


def test_staleness_weighted_merge_on_cuda_is_one_launch(cuda):
    rng = np.random.default_rng(21)
    layers = [{"w": torch.from_numpy(rng.standard_normal((5, 7, 3)).astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))}
              for _ in range(3)]
    g = [{"w": torch.zeros(7, 3), "b": torch.ones(3)} for _ in range(3)]
    w = torch.from_numpy(rng.random(5).astype(np.float32))
    share = torch.from_numpy(rng.random((5, 3)) < 0.7)
    to = lambda tree: [{k: v.to(cuda) for k, v in layer.items()} for layer in tree]  # noqa: E731
    kernels.reset_launch_counts()
    got = staleness_weighted_merge(to(layers), to(g), w.to(cuda), share.to(cuda),
                                   snapshots=to(layers))
    assert kernels.launch_counts()["masked_aggregate"] == 1
    want = staleness_weighted_merge(layers, g, w, share, snapshots=layers)
    for a, b in zip(got, want):
        for k in a:
            assert torch.equal(a[k].cpu(), b[k])


_SMALL = dict(n_clients=8, n_classes=4, n_features=20, samples_per_client_range=(60, 90),
              dirichlet_alpha=50.0, client_shift=0.05, class_sep=5.0, seed=1)
_EXACT = ("selected", "pms", "tx_params", "tx_wire_bytes", "round_time", "sim_clock",
          "staleness_mean", "in_flight", "rejected_updates")


@pytest.mark.parametrize("cfg", [
    dict(codec="int8", scheduler="async", buffer_k=2, max_concurrency=4),
    dict(strategy="oort", personalization="ft", fraction=0.5, scheduler="async", buffer_k=4,
         heterogeneity=0.5),
    dict(dropout_rate=0.3, deadline_s=10.0, corrupt_rate=0.3, codec="int8"),
    dict(scheduler="async", buffer_k=2, max_concurrency=4, dropout_rate=0.4, deadline_s=5.0,
         corrupt_rate=0.3),
], ids=["async-int8-M4", "async-oort-ft", "sync-faults-int8", "async-faults"])
def test_async_and_fault_runs_on_cuda_match_cpu(cuda, cfg):
    ds = make_federated_classification(**_SMALL)
    kernels.reset_launch_counts()
    h = run_federated(ds, FLConfig(rounds=5, epochs=1, **cfg), device=cuda)
    counts = kernels.launch_counts()
    n = len(h.accuracy_mean)
    assert counts["masked_aggregate"] == n, counts
    if "codec" in cfg:
        assert counts["quantize"] == counts["dequantize"] == n, counts
    ref = run_federated(ds, FLConfig(rounds=5, epochs=1, **cfg), device="cpu")
    for field in _EXACT:
        np.testing.assert_array_equal(getattr(h, field), getattr(ref, field), err_msg=field)
    assert np.abs(h.accuracy_per_client - ref.accuracy_per_client).max() <= 1e-6


@pytest.mark.parametrize("cfg", [dict(scan_chunk=1), dict(scan_chunk=2), dict(scan_chunk=3),
                                 dict(codec="int8", scheduler="async", buffer_k=2,
                                      max_concurrency=4)],
                         ids=["chunk1", "chunk2", "chunk3", "async-int8"])
def test_resume_on_cuda_bitwise(cuda, tmp_path, cfg):
    """Stopped at 2, resumed to 5: the uninterrupted history bit for bit
    (at chunk 2 and 3 the resumed run captures its graphs after loading)."""
    ds = make_federated_classification(**_SMALL)
    kw = dict(codec="int8", **cfg) if "codec" not in cfg else cfg
    full = run_federated(ds, FLConfig(rounds=5, epochs=1, **kw), device=cuda)
    d = str(tmp_path / "ckpt")
    run_federated(ds, FLConfig(rounds=2, epochs=1, **kw), device=cuda, checkpoint_every=2,
                  checkpoint_dir=d)
    res = run_federated(ds, FLConfig(rounds=5, epochs=1, **kw), device=cuda, resume_from=d)
    for field in full._fields:
        if field != "wall_time" and getattr(full, field) is not None:
            np.testing.assert_array_equal(getattr(res, field), getattr(full, field),
                                          err_msg=field)


@pytest.mark.parametrize("cfg", [dict(scan_chunk=1), dict(scan_chunk=2), dict(scan_chunk=3),
                                 dict(scheduler="async", buffer_k=2, max_concurrency=4)],
                         ids=["chunk1", "chunk2", "chunk3", "async"])
def test_recorded_run_on_cuda_equals_unrecorded(cuda, tmp_path, cfg):
    """A recorded int8 run on the card (CUDA-graph chunks at scan_chunk > 1,
    trace and profile on) gives the unrecorded history bit for bit, the
    same kernel launches, one metrics row a round, a valid trace, and a
    profile with the card's memory watermark (and a capture a chunk
    length)."""
    import json

    from repro_torch.obs import RunRecorder, validate_trace_file

    ds = make_federated_classification(**_SMALL)
    fl = FLConfig(rounds=5, epochs=1, codec="int8", **cfg)
    kernels.reset_launch_counts()
    bare = run_federated(ds, fl, device=cuda)
    bare_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    rec = RunRecorder(str(tmp_path), trace=True, profile=True, echo=False)
    h = run_federated(ds, fl, device=cuda, recorder=rec)
    assert kernels.launch_counts() == bare_counts
    for field in h._fields:
        if field != "wall_time" and getattr(h, field) is not None:
            np.testing.assert_array_equal(getattr(h, field), getattr(bare, field), err_msg=field)
    rows = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 5
    assert validate_trace_file(str(tmp_path / "trace.json"), ds.n_clients) == []
    prof = json.loads((tmp_path / "profile.json").read_text())
    assert prof["peak_live_bytes"] > 0 and prof["device"].startswith("cuda")
    chunk = cfg.get("scan_chunk", 1)
    assert prof["graph_captures"] == (len({min(chunk, 5 - t0) for t0 in range(0, 5, chunk)})
                                      if chunk > 1 else 0)
    env = json.loads((tmp_path / "manifest.json").read_text())["environment"]
    assert env["backend"] == "cuda" and env["gpu"]


@pytest.mark.parametrize("mode", ["none", "ft", "dld"])
def test_classify_lanes_bitwise_on_cuda(cuda, mode):
    """Per-lane bit identity on the card: lane i of a batch of B clients is
    bitwise ``forward_unbatched(client_i, x_i)`` for B = 1, 5, 30 and a batch
    that mixes the modes; each lane within 1e-5 of max|logit| of the plain
    (1, F) x (F, H) forward of the client's composed model on the card, with
    the same prediction; the card's logits within 1e-5 of max|logit| of
    the same artifact on the CPU, with equal predictions."""
    from repro_torch.models.mlp import mlp_apply
    from repro_torch.serve import PersonalizedEngine, fit_servable, servable_from_state
    from repro_torch.weights import servable_from_numpy

    ds = make_federated_classification(**_SMALL)
    codec = "int8" if mode == "dld" else "float32"
    art, state = fit_servable(ds, FLConfig(personalization=mode, rounds=2, epochs=1,
                                           codec=codec), device=cuda)
    engine = PersonalizedEngine(art)
    rng = np.random.default_rng(0)
    for batch in (1, 5, 30):
        ids = rng.integers(0, ds.n_clients, size=batch)
        x = ds.x_test[ids, rng.integers(0, ds.x_test.shape[1], size=batch)].astype(np.float32)
        out = engine.forward(ids, x)
        for k in range(batch):
            assert torch.equal(out[k], engine.forward_unbatched(int(ids[k]), x[k]))
            # the plain product sums in another order: 5.9e-7 to 1.04e-6
            # of max at full width on an H100 (chip_smoke.py [classify])
            plain = mlp_apply(engine.client_model(int(ids[k])),
                              torch.as_tensor(x[k:k + 1], device=cuda))[0]
            assert float((out[k] - plain).abs().max()) <= 1e-5 * float(plain.abs().max())
            assert int(out[k].argmax()) == int(plain.argmax())
    ids = np.arange(ds.n_clients)
    x = ds.x_test[ids, 0].astype(np.float32)
    on_cpu = PersonalizedEngine(servable_from_numpy(art, "cpu")).forward(ids, x)
    got = engine.forward(ids, x).cpu()
    assert float((got - on_cpu).abs().max()) <= 1e-5 * float(on_cpu.abs().max())
    assert torch.equal(got.argmax(1), on_cpu.argmax(1))
    assert servable_from_state(state, mode, data=ds).share_mask.device.type == "cuda"


def _edge_ids(rng, k: int, n_edges: int) -> torch.Tensor:
    """Edge ids of K clients drawn unsorted from 3K, cut in E contiguous
    groups (the aggregators' partition)."""
    pop = 3 * k
    cids = rng.permutation(pop)[:k]
    return torch.from_numpy(np.minimum(cids // -(-pop // n_edges), n_edges - 1).astype(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n_edges", [2, 3, 8])
def test_masked_aggregate_edge_mode_bitwise_in_one_launch(cuda, dtype, n_edges):
    """Eq. 1 (masked-partial rows, one all-zero) and the merge (snapshots,
    bases) in edge mode: unsorted lanes, edge 1 weightless; one launch,
    bitwise the plain version on every leaf."""
    rng = np.random.default_rng(n_edges)
    k, shapes = 37, [(5,), (7, 5), (300,), (3, 300), (1,)]
    xs = [torch.from_numpy(rng.standard_normal((k,) + s).astype(np.float32)).to(dtype)
          for s in shapes]
    snaps = [x + 0.01 for x in xs]
    others = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
              for s in shapes]
    ids = _edge_ids(rng, k, n_edges)
    w = torch.from_numpy(rng.integers(60, 90, k).astype(np.float32)) * (ids != 1).float()
    table = torch.stack([w, w * (torch.rand(k) < 0.5).float(), torch.zeros(k)])
    rows = [0, 1, 2, 1, 0]
    for kw in (dict(fallbacks=others), dict(snapshots=snaps, bases=others)):
        want = masked_aggregate_leaves_plain(xs, table, rows, edge_ids=ids, n_edges=n_edges, **kw)
        dev_kw = {key: [t.to(cuda) for t in v] for key, v in kw.items()}
        kernels.reset_launch_counts()
        got = masked_aggregate_leaves([x.to(cuda) for x in xs], table.to(cuda), rows,
                                      edge_ids=ids.to(cuda), n_edges=n_edges, **dev_kw)
        assert kernels.launch_counts()["masked_aggregate"] == 1
        for g, p in zip(got, want):
            assert torch.equal(g.cpu(), p)


@pytest.mark.parametrize("cfg", [dict(codec="int8", edge_groups=3),
                                 dict(strategy="oort", personalization="ft", fraction=0.5,
                                      cohort_size=5, edge_groups=2)],
                         ids=["int8-E3", "oort-ft-cohort5-E2"])
def test_edge_rounds_capture_in_chunks(cuda, cfg):
    """Edge ids come from the cohort's ids on the device inside the round:
    chunks of rounds still capture, bitwise the eager rounds, one launch of
    masked_aggregate a round; the CPU's records exactly."""
    ds = make_federated_classification(**_SMALL)
    runs = {}
    for chunk in (1, 2, 5):
        kernels.reset_launch_counts()
        runs[chunk] = run_federated(ds, FLConfig(rounds=5, epochs=1, scan_chunk=chunk, **cfg),
                                    device=cuda)
        assert kernels.launch_counts()["masked_aggregate"] == 5
    ref = run_federated(ds, FLConfig(rounds=5, epochs=1, **cfg), device="cpu")
    for chunk, h in runs.items():
        for field in h._fields:
            if field != "wall_time":
                np.testing.assert_array_equal(np.asarray(getattr(h, field)),
                                              np.asarray(getattr(runs[1], field)),
                                              err_msg=f"chunk={chunk} field={field}")
    for field in _EXACT + ("tx_edge_bytes",):
        np.testing.assert_array_equal(getattr(runs[1], field), getattr(ref, field), err_msg=field)


@pytest.mark.parametrize("cfg", [dict(codec="int8"),
                                 dict(codec="int8", cohort_size=3, edge_groups=3),
                                 dict(codec="int8", scheduler="async", buffer_k=2,
                                      max_concurrency=4, edge_groups=2),
                                 dict(scheduler="async", buffer_k=2, max_concurrency=4,
                                      dropout_rate=0.4, deadline_s=5.0)],
                         ids=["sync-int8", "sync-cohort3-E3", "async-int8-E2", "async-faults"])
def test_host_plane_on_cuda_bitwise_device_resident(cuda, cfg):
    """The host-resident population plane on the card (pinned staging,
    non-blocking copies): bitwise the device-resident run, one launch of
    each FL kernel a round or event, and the CPU's records exactly."""
    ds = make_federated_classification(**_SMALL)
    h_dev = run_federated(ds, FLConfig(rounds=4, epochs=1, host_population=-1, **cfg),
                          device=cuda)
    kernels.reset_launch_counts()
    h = run_federated(ds, FLConfig(rounds=4, epochs=1, host_population=1, **cfg), device=cuda)
    counts = kernels.launch_counts()
    assert counts["masked_aggregate"] == len(h.accuracy_mean), counts
    for field in h._fields:
        if field != "wall_time":
            np.testing.assert_array_equal(np.asarray(getattr(h, field)),
                                          np.asarray(getattr(h_dev, field)), err_msg=field)
    ref = run_federated(ds, FLConfig(rounds=4, epochs=1, host_population=1, **cfg), device="cpu")
    for field in _EXACT:
        np.testing.assert_array_equal(getattr(h, field), getattr(ref, field), err_msg=field)
    assert np.abs(h.accuracy_per_client - ref.accuracy_per_client).max() <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("world", [1, 2, 3])
def test_masked_aggregate_partial_and_combine_bitwise(cuda, dtype, world):
    """Each rank's partial launch and the combine launch bitwise their plain
    versions (Eq. 1 with a fallback row, the merge with snapshots and
    bases, and edge partials inside a rank), one launch each; Eq. 1 and the
    merge together bitwise the edge mode with rank-block ids."""
    rng = np.random.default_rng(world)
    k, shapes = 30, [(5,), (7, 5), (300,), (3, 300), (1,)]
    xs = [torch.from_numpy(rng.standard_normal((k,) + s).astype(np.float32)).to(dtype)
          for s in shapes]
    snaps = [x + 0.01 for x in xs]
    others = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
              for s in shapes]
    w = torch.from_numpy(rng.integers(60, 90, k).astype(np.float32))
    table = torch.stack([w, w * (torch.rand(k) < 0.5).float(), torch.zeros(k)])
    rows = [0, 1, 2, 1, 0]
    blk = k // world
    rank_ids = (torch.arange(k) // blk).to(torch.int32)
    inner = (torch.arange(k) % 3 == 0).to(torch.int32)  # two edges inside each rank
    for kw, edges in ((dict(fallbacks=others), False), (dict(snapshots=snaps, bases=others), False),
                      (dict(fallbacks=others), True)):
        snap = kw.get("snapshots")
        bufs_plain, bufs = [], []
        for r in range(world):
            lanes = slice(r * blk, (r + 1) * blk)
            part = dict(rows=rows, edge_ids=inner[lanes] if edges else None,
                        n_edges=2 if edges else 0, slot=r, n_slots=world,
                        snapshots=None if snap is None else [s[lanes] for s in snap])
            bufs_plain.append(masked_aggregate_partial_plain(
                [x[lanes] for x in xs], table[:, lanes].contiguous(), **part))
            part_dev = dict(part, edge_ids=None if part["edge_ids"] is None
                            else part["edge_ids"].to(cuda),
                            snapshots=None if snap is None
                            else [s.to(cuda) for s in part["snapshots"]])
            kernels.reset_launch_counts()
            bufs.append(masked_aggregate_partial([x[lanes].to(cuda) for x in xs],
                                                 table[:, lanes].contiguous().to(cuda), **part_dev))
            assert kernels.launch_counts()["masked_aggregate_partial"] == 1
            assert torch.equal(bufs[-1].cpu(), bufs_plain[-1])
        total_plain, total = bufs_plain[0], bufs[0]
        for a, b in zip(bufs_plain[1:], bufs[1:]):  # the all-reduce, as a rank-order sum
            total_plain, total = total_plain + a, total + b
        ends = {key: v for key, v in kw.items() if key != "snapshots"}
        want = masked_aggregate_combine_plain(total_plain, shapes, rows, dtype=dtype, **ends)
        kernels.reset_launch_counts()
        got = masked_aggregate_combine(total, shapes, rows, dtype=dtype,
                                       **{key: [t.to(cuda) for t in v] for key, v in ends.items()})
        assert kernels.launch_counts()["masked_aggregate_combine"] == 1
        for g, p in zip(got, want):
            assert g.dtype == dtype and torch.equal(g.cpu(), p)
        if not edges:
            dev_kw = {key: [t.to(cuda) for t in v] for key, v in kw.items()}
            edge = masked_aggregate_leaves([x.to(cuda) for x in xs], table.to(cuda), rows,
                                           edge_ids=rank_ids.to(cuda), n_edges=world, **dev_kw)
            for g, e in zip(got, edge):
                assert torch.equal(g, e)


def _history_fields_equal(h, ref, what):
    for field in h._fields:
        if field != "wall_time" and getattr(ref, field) is not None:
            np.testing.assert_array_equal(np.asarray(getattr(h, field)),
                                          np.asarray(getattr(ref, field)),
                                          err_msg=f"{what}: {field}")


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_world1_nccl_sharded_bitwise_unsharded(cuda, chunk):
    """cohort_devices=1 on the card opens a world-1 NCCL group: bitwise the
    unsharded run, CUDA-graph chunks (the all-reduces captured) included;
    one partial and one combine launch a round, no flat launch."""
    import torch.distributed as dist

    ds = make_federated_classification(**_SMALL)
    cfg = dict(rounds=5, epochs=1, codec="int8", scan_chunk=chunk)
    ref = run_federated(ds, FLConfig(**cfg), device=cuda)
    kernels.reset_launch_counts()
    h = run_federated(ds, FLConfig(cohort_devices=1, **cfg), device=cuda)
    counts = kernels.launch_counts()
    assert counts["masked_aggregate_partial"] == counts["masked_aggregate_combine"] == 5, counts
    assert counts["masked_aggregate"] == 0 and counts["quantize"] == 5, counts
    _history_fields_equal(h, ref, f"chunk {chunk}")
    assert not dist.is_initialized()


def test_nccl_round_trace_holds_the_reckoned_collectives(cuda, tmp_path):
    """The NCCL events torch.profiler records for a sharded round: two
    all-reduces of the bytes ``shard_collective_bytes`` reckons."""
    from repro_torch.fl import api
    from repro_torch.fl.sched import _setup_run, initial_state
    from repro_torch.fl.shard import shard_collective_bytes
    from repro_torch.launch.collectives import collective_bytes
    from repro_torch.models.mlp import mlp_accuracy, mlp_loss

    ds = make_federated_classification(**_SMALL)
    cfg = FLConfig(rounds=2, epochs=1, codec="int8", cohort_devices=1)
    su = _setup_run(ds, cfg, cuda, None, mlp_loss, mlp_accuracy, None, None, None)
    state = initial_state(su, ds.n_clients)
    step = api.build_round_step(su.env, su.pipeline, cfg.execution)
    try:
        state, _ = step(state, 0)  # the communicator's first use
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA],
                                    record_shapes=True) as prof:
            step(state, 1)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(tmp_path / "nccl.json"))
    finally:
        step.mesh.close()
    assert step.mesh.backend == "nccl"
    stats = collective_bytes(str(tmp_path / "nccl.json"))
    want = shard_collective_bytes(su.g0, su.n_layers, 1, ds.n_clients, True, True)
    assert stats["count"] == 2 and stats["all-reduce"] == stats["total"] == want, stats


def test_gloo_on_cuda_refuses_chunks_and_runs_per_round(cuda, tmp_path):
    import torch.distributed as dist

    from repro_torch.fl.api import CollectiveCaptureError

    ds = make_federated_classification(**_SMALL)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(CollectiveCaptureError, match="scan_chunk=1"):
            run_federated(ds, FLConfig(rounds=4, epochs=1, cohort_devices=1, scan_chunk=2),
                          device=cuda)
        h = run_federated(ds, FLConfig(rounds=4, epochs=1, cohort_devices=1), device=cuda)
    finally:
        dist.destroy_process_group()
    _history_fields_equal(h, run_federated(ds, FLConfig(rounds=4, epochs=1), device=cuda), "gloo")


# ---------------------------------------------------------------------------
# training: the backward kernels (flash_attention_bwd, ssm_scan_bwd)
# ---------------------------------------------------------------------------


def _attention_inputs(cuda, case, dtype):
    b, s, t, h, hkv, dq, dv = case[:7]
    gen = torch.Generator(device=cuda).manual_seed(s + 7 * t + dq)
    q = torch.randn((b, s, h, dq), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, t, hkv, dq), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, t, hkv, dv), generator=gen, device=cuda).to(dtype)
    dout = torch.randn((b, s, h, dv), generator=gen, device=cuda).to(dtype)
    return q, k, v, dout


_BWD_CASES = [
    # (b, s, t, h, hkv, dq, dv, causal, window, dtype): every (Dqk, Dv) of
    # HEAD_DIMS in each dtype, causal with and without a window, non-causal
    # at T != S (whisper's cross-attention) and T = S, G = 1, 4, 6 and 16;
    # bf16 runs the wgmma kernel, float32 the CUDA-core one
    (2, 130, 130, 4, 1, 64, 64, True, 0, torch.float32),
    (1, 200, 200, 8, 2, 128, 128, True, 48, torch.float32),
    (1, 70, 150, 4, 4, 48, 32, True, 0, torch.float32),
    (2, 45, 150, 6, 6, 64, 64, False, 0, torch.float32),
    (1, 256, 256, 8, 2, 64, 64, True, 0, torch.bfloat16),
    (2, 300, 300, 8, 2, 128, 128, True, 0, torch.bfloat16),
    (1, 640, 640, 4, 1, 128, 128, True, 200, torch.bfloat16),
    (1, 300, 300, 4, 4, 192, 128, True, 0, torch.bfloat16),
    (1, 200, 200, 6, 1, 160, 160, True, 64, torch.bfloat16),
    (2, 100, 700, 6, 6, 64, 64, False, 0, torch.bfloat16),
    (1, 1, 300, 6, 6, 64, 64, False, 0, torch.bfloat16),
    (1, 129, 129, 4, 2, 160, 160, False, 0, torch.bfloat16),
    (1, 200, 200, 16, 1, 128, 128, True, 0, torch.bfloat16),     # G = 16 (chatglm3)
    (1, 256, 1500, 6, 6, 64, 64, False, 0, torch.bfloat16),      # a 92-key last key block
    (1, 400, 400, 4, 4, 192, 128, True, 96, torch.bfloat16),     # a window at MLA's dims
    (1, 333, 333, 8, 2, 160, 160, True, 0, torch.bfloat16),      # S not a multiple of the q tile
]


@pytest.mark.parametrize("case", _BWD_CASES, ids=str)
def test_flash_attention_bwd_vs_plain(cuda, case):
    """The forward kernel's lse against the plain version's; dQ, dK, dV of
    the backward kernel of the dtype to ``contract.bwd_check`` (against the
    backward in float64 on the same o and lse, with the bf16 kernel's
    rounding points in bf16), every control rejected (three in bf16, two in
    float32), one launch, and two calls bitwise equal (no atomics)."""
    from repro_torch.kernels.flash_attention import contract as fa_contract
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ops import _attention

    causal, window, dtype = case[7:]
    q, k, v, dout = _attention_inputs(cuda, case, dtype)
    out, lse = _attention(q, k, v, causal, window, with_lse=True)
    _, lse_plain = flash_attention_plain(q, k, v, causal, window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert float((lse - lse_plain).abs().max()) <= 1e-5 * max(1.0, float(lse_plain.abs().max()))
    kernels.reset_launch_counts()
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal, window)
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    assert [g.dtype for g in got] == [dtype] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal, window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = fa_contract.bwd_references(q, k, v, out, lse, dout, causal, window)
    result = fa_contract.bwd_check(got, ref)
    assert result["ok"], result
    controls = fa_contract.bwd_controls(q, k, v, out, lse, dout, causal, window)
    assert len(controls) == (3 if dtype == torch.bfloat16 else 2)
    for name, bad in controls.items():
        assert not fa_contract.bwd_check(bad, ref)["ok"], name


def test_flash_attention_autograd_launches_forward_and_backward(cuda):
    """Where q, k, v need gradients, ``flash_attention`` goes through
    ``FlashAttentionFn``: one forward launch with lse, one backward launch,
    the gradients ``flash_attention_bwd``'s; without gradients, serving
    launches the forward alone and keeps nothing."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ops import _attention

    q, k, v, dout = _attention_inputs(cuda, (1, 128, 128, 4, 2, 128, 128), torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kernels.reset_launch_counts()
    out = flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    want_out, lse = _attention(q, k, v, True, 0, with_lse=True)
    assert torch.equal(out.detach(), want_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, flash_attention_bwd(q, k, v, want_out,
                                                                             lse, dout)))
    with torch.no_grad():
        assert torch.equal(flash_attention(*leaves), want_out)


def test_flash_attention_bwd_refuses_what_it_has_no_kernel_for(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q = torch.zeros((1, 8, 2, 96), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(NotImplementedError, match="takes \\(Dqk, Dv\\)"):
        flash_attention_bwd(q, q, q, q, lse, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_bwd(q, q, q, q, lse, q)
    q = q.float()
    with pytest.raises(ValueError, match="lse float32"):
        flash_attention_bwd(q, q, q, q, lse[..., :4], q)


def _misaligned(t):
    """``t``'s values in a contiguous view whose data pointer is one element
    past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(2, 256, 128, 16), (1, 300, 200, 8), (2, 100, 64, 16),
                                   (1, 129, 70, 8), (2, 520, 96, 16),
                                   # S at the 8-step stages' and the chunks' edges
                                   (1, 1, 64, 16), (2, 7, 64, 8), (1, 8, 64, 16),
                                   (1, 9, 64, 16), (2, 121, 64, 16), (2, 129, 100, 16),
                                   # di off the 16-byte vector (bf16), odd di, no gh,
                                   # misaligned pointers (the scalar copies)
                                   (1, 136, 36, 16), (1, 140, 33, 16, "no gh"),
                                   (2, 200, 64, 16, "misaligned"),
                                   (1, 130, 72, 8, "misaligned", "no gh")], ids=str)
def test_ssm_scan_bwd_vs_plain(cuda, shape, stream):
    """The forward kernel's chunk start states against the plain version's
    (the forward's float32 contract), then the backward kernel's six
    gradients to ``contract.bwd_check`` (against ``ssm_scan_backward_plain``
    in float64 on the kernel's chunk states), with a final-state cotangent
    (or none), whole and ragged chunks, S under 128 and at the 8-step
    stages' edges, di off the block's 64 channels and off the 16-byte
    vector, d_state 8 and 16, inputs at misaligned pointers; both controls
    rejected; one launch; two calls bitwise equal (no atomics)."""
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd, ssm_scan_plain

    b, s, di, ds, *opts = shape
    gen = torch.Generator(device=cuda).manual_seed(s + di)
    randn = lambda *sh: torch.randn(sh, generator=gen, device=cuda)  # noqa: E731
    dt = torch.nn.functional.softplus(randn(b, s, di) - 2)
    a = -torch.exp(randn(di, ds))
    ins = [t.to(stream) for t in (dt, randn(b, s, ds), randn(b, s, ds), randn(b, s, di))]
    args = (ins[0], a, ins[1], ins[2], ins[3], randn(di))
    y, h, hs = ssm_scan(*args, y_dtype=torch.float32, chunk_states=True)
    _, h32, hs32 = ssm_scan_plain(*args, y_dtype=torch.float32, chunk_states=True)
    _, h64, hs64 = ssm_scan_plain(*args, y_dtype=torch.float64, acc_dtype=torch.float64,
                                  chunk_states=True)
    assert hs.shape == (-(-s // 128), b, di, ds) and not hs[0].any()
    gap, allowed = ssm_contract._f32_rule(hs, hs32, hs64)
    assert gap <= allowed, (gap, allowed)
    gy, gh = randn(b, s, di), (None if "no gh" in opts else randn(b, di, ds))
    if "misaligned" in opts:
        args = tuple(_misaligned(t) if t.dtype == stream else t for t in args)
        gy = _misaligned(gy)
    kernels.reset_launch_counts()
    got = ssm_scan_bwd(*args, hs, gy, gh)
    assert kernels.launch_counts()["ssm_scan_bwd"] == 1
    assert [g.dtype for g in got] == [stream, torch.float32, stream, stream, stream, torch.float32]
    again = ssm_scan_bwd(*args, hs, gy, gh)
    assert all(torch.equal(x, z) for x, z in zip(got, again))
    plain32, ref64 = ssm_contract.bwd_references(*args, hs, gy, gh)
    result = ssm_contract.bwd_check(got, plain32, ref64)
    assert result["ok"], result
    if s > 128:
        for name, bad in ssm_contract.bwd_controls(*args, hs, gy).items():
            bad_ref = ssm_contract.bwd_references(*args, hs, gy)
            assert not ssm_contract.bwd_check(bad, *bad_ref)["ok"], name


def test_selective_scan_on_cuda_launches_both_kernels(cuda):
    """``models.ssm_vjp.selective_scan`` on the card: one ssm_scan launch
    (with the chunk states) and one ssm_scan_bwd launch; the gradients come
    back in the bf16 streams' dtype, and equal ``ssm_scan_bwd``'s."""
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd
    from repro_torch.models.ssm_vjp import selective_scan

    b, s, di, ds = 2, 300, 128, 16
    gen = torch.Generator(device=cuda).manual_seed(3)
    randn = lambda *sh: torch.randn(sh, generator=gen, device=cuda)  # noqa: E731
    streams = [t.to(torch.bfloat16) for t in (torch.nn.functional.softplus(randn(b, s, di) - 2),
                                              randn(b, s, ds), randn(b, s, ds), randn(b, s, di))]
    a, d = -torch.exp(randn(di, ds)), randn(di)
    leaves = [t.clone().requires_grad_() for t in (streams[0], a, streams[1], streams[2],
                                                   streams[3], d)]
    gy = randn(b, s, di).to(torch.bfloat16)
    kernels.reset_launch_counts()
    y, _ = selective_scan(*leaves, y_dtype=torch.bfloat16)
    grads = torch.autograd.grad(y, leaves, gy)
    counts = kernels.launch_counts()
    assert counts["ssm_scan"] == 1 and counts["ssm_scan_bwd"] == 1
    assert [g.dtype for g in grads] == [t.dtype for t in leaves]
    args = [t.detach() for t in leaves]
    _, _, hs = ssm_scan(*args, y_dtype=torch.bfloat16, chunk_states=True)
    want = ssm_scan_bwd(*args, hs, gy.float())
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_ssm_scan_bwd_refuses_other_state_sizes(cuda):
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd

    x = torch.zeros((1, 4, 64), device=cuda)
    a = -torch.ones((64, 4), device=cuda)
    hs = torch.zeros((1, 1, 64, 4), device=cuda)
    with pytest.raises(NotImplementedError, match="d_state"):
        ssm_scan_bwd(x, a, x[..., :4], x[..., :4], x, x[0, 0], hs, x)


def test_backward_launches_the_kernels_refuse_raise(cuda, monkeypatch):
    """A launch that a kernel library refuses (a shape let through the
    wrapper's checks that no instantiation takes: the C entry returns
    cudaErrorInvalidValue) raises instead of returning unwritten
    gradients."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    monkeypatch.setitem(fa_ops.HEAD_DIMS, torch.bfloat16,
                        fa_ops.HEAD_DIMS[torch.bfloat16] + ((96, 96),))
    q = torch.zeros((1, 8, 2, 96), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed: cudaError 1"):
        flash_attention_bwd(q, q, q, q, lse, q)
    monkeypatch.setattr(ssm_ops, "_STATE_SIZES", (4, 8, 16))
    x = torch.zeros((1, 4, 64), device=cuda)
    a = -torch.ones((64, 4), device=cuda)
    hs = torch.zeros((1, 1, 64, 4), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed: cudaError 1"):
        ssm_ops.ssm_scan_bwd(x, a, x[..., :4], x[..., :4], x, x[0, 0], hs, x)


_TRAIN_ARCHS = ["falcon-mamba-7b", "granite-3-8b", "chatglm3-6b", "stablelm-12b", "qwen2-vl-2b",
                "deepseek-moe-16b", "moonshot-v1-16b-a3b", "deepseek-v2-lite-16b",
                "jamba-v0.1-52b", "whisper-tiny"]


def train_launches(cfg) -> dict:
    """What one loss-and-gradient of ``cfg`` launches: with remat (the
    decoder LMs) an attention layer's flash_attention forward twice (the
    forward and its recompute) and its backward once, a Mamba layer's
    ssm_scan likewise; whisper (no remat) flash_attention once an encoder
    layer and twice a decoder layer, and as many backward launches."""
    from repro_torch.models import transformer

    counts = dict.fromkeys(kernels.KERNELS, 0)
    if cfg.encoder_decoder:
        n = cfg.n_encoder_layers + 2 * cfg.n_layers
        counts.update(flash_attention=n, flash_attention_bwd=n)
        return counts
    specs = transformer.layer_specs(cfg)
    n_attn = sum(sp.kind == "attn" for sp in specs)
    n_mamba = len(specs) - n_attn
    counts.update(flash_attention=2 * n_attn, flash_attention_bwd=n_attn,
                  ssm_scan=2 * n_mamba, ssm_scan_bwd=n_mamba)
    return counts


@pytest.mark.parametrize("arch", _TRAIN_ARCHS)
def test_reduced_loss_and_grads_on_cuda_match_cpu(cuda, arch):
    """The reduced float32 model's loss and every parameter's gradient on
    the card (through the forward and backward kernels, exactly
    ``train_launches``) against the same on the CPU (plain versions): within
    1e-5 of each leaf's max, 2^-8 where a Mamba scan is in the stack (a
    scan input's bf16 rounding may flip)."""
    import copy
    import dataclasses

    from repro_torch import random as prng
    from repro_torch.models.api import get_model, make_concrete_batch, param_tree

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rel = 2.0 ** -8 if cfg.ssm else 1e-5
    bundle = get_model(cfg)
    cpu_model = bundle.init(torch.Generator().manual_seed(0))
    dev_model = copy.deepcopy(cpu_model).to(cuda)
    batch = make_concrete_batch(cfg, "train", 2, 64, prng.PRNGKey(1))
    out = []
    for model in (cpu_model, dev_model):
        tree = param_tree(model)
        for p in tree.values():
            p.requires_grad_(True)
        kernels.reset_launch_counts()
        loss = bundle.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(tree.values()), allow_unused=True)
        out.append((loss, grads, kernels.launch_counts()))
    (want_loss, want, _), (got_loss, got, counts) = out
    assert counts == train_launches(cfg), counts
    assert abs(float(got_loss) - float(want_loss)) <= rel * abs(float(want_loss))
    for name, g, w in zip(param_tree(cpu_model), got, want):
        if w is None:
            assert g is None, name
            continue
        _close_to_max(g.cpu(), w, rel)


# ---------------------------------------------------------------------------
# cross-silo FL of LMs (fl/cross_silo.py)
# ---------------------------------------------------------------------------

_SILO_WEIGHTS = [1.0, 2.0, 1.0]


def _reduced_silos(arch, device, n_silos=3):
    import dataclasses

    from repro_torch.fl import cross_silo
    from repro_torch.models.api import get_model

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0)).to(device)
    return cfg, bundle, cross_silo.silo_params_from_model(model, n_silos)


def _silo_batches(cfg, rounds, device, n_silos=3):
    from repro_torch import random as prng
    from repro_torch.models.api import make_concrete_batch

    key, out = prng.PRNGKey(1), []
    for _ in range(rounds):
        key, sub = prng.split(key)
        batch = make_concrete_batch(cfg, "train", 2 * n_silos, 32, sub)
        out.append({k: v.reshape(n_silos, 2, *v.shape[1:]).to(device) for k, v in batch.items()})
    return out


@pytest.mark.parametrize("arch", ["granite-3-8b", "falcon-mamba-7b", "whisper-tiny"])
def test_cross_silo_rounds_on_cuda_match_cpu(cuda, arch):
    """Three fp32-wire rounds of the reduced float32 model, 3 silos, plain
    AdamW at lr 3e-4, on the card (its train steps' kernels and
    masked_aggregate) against the same rounds on the CPU: losses within
    1e-5 (2^-8 behind a Mamba scan) relative; parameters as
    ``tests/_torch_train.py`` holds three AdamW steps: at most 1e-4 of the
    elements beyond 1e-6 (AdamW's first steps take ``lr * g / (|g| +
    eps)``, so an element whose gradient cancels to near zero moves by a
    fraction of lr on a rounding-level difference), each within one lr;
    behind a scan, where a bf16 input flip moves whole gradients by 2^-8
    of max and a step's sign with them, within two lr over the three
    rounds (measured 1.11 lr, 218 of 3.3 M elements beyond 1e-6 on
    falcon-mamba, where one lr did not hold); exactly the train steps'
    launches plus one masked_aggregate launch a round; shared leaves
    bitwise equal across silos on the card."""
    from repro_torch.fl import cross_silo
    from repro_torch.optim import adamw

    rel = 2.0 ** -8 if get_config(arch).ssm else 1e-5
    lr, runs = 3e-4, []
    for dev in (torch.device("cpu"), cuda):
        cfg, bundle, silo = _reduced_silos(arch, dev)
        opt = adamw(lr)
        state = cross_silo.init_silo_opt(opt, silo)
        step = cross_silo.make_fl_round_step(cfg, bundle, opt, shared_periods=1, agg="fp32")
        w = torch.tensor(_SILO_WEIGHTS, device=dev)
        kernels.reset_launch_counts()
        losses = []
        for batch in _silo_batches(cfg, 3, dev):
            silo, state, loss = step(silo, state, batch, w)
            losses.append(loss)
        runs.append((silo, torch.stack(losses).cpu(), kernels.launch_counts()))
    (want, want_loss, _), (got, got_loss, counts) = runs
    expected = {k: 3 * 3 * n for k, n in train_launches(cfg).items()}
    expected["masked_aggregate"] += 3
    assert counts == expected, counts
    assert float(((got_loss - want_loss) / want_loss).abs().max()) <= rel, (got_loss, want_loss)
    n_over = n_total = 0
    worst = 0.0
    for name, p in got.params.items():
        d = (p.cpu().double() - want.params[name].double()).abs()
        worst = max(worst, float(d.max()))
        n_over += int((d > 1e-6).sum())
        n_total += d.numel()
    print(f"{arch}: {n_over} of {n_total} beyond 1e-6, worst {worst:.3g} ({worst / lr:.3g} lr)")
    limit = 2 * lr if cfg.ssm else lr
    assert worst <= limit and n_over <= 1e-4 * n_total, (n_over, n_total, worst)
    for group in cross_silo.shared_groups(cfg, got.params, 1):
        for name in group:
            assert all(torch.equal(got.params[name][s], got.params[name][0]) for s in (1, 2))


@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8", "int4", "int8+ef"])
def test_cross_silo_mean_on_cuda_bitwise_cpu_and_launches(cuda, wire):
    """One silo mean of the same reduced jamba silos (every silo its own
    values; one period of 8 layers shared: 90 JAX leaves) on the card
    bitwise the CPU's plain versions, parameters and EF residuals;
    launches: fp32 one masked_aggregate launch for every 64 leaves, the int
    wires and EF one quantize, one dequantize and one masked_aggregate
    launch a wire call of up to 64 leaves, bf16 none."""
    from repro_torch import random as prng
    from repro_torch.fl import cross_silo

    outs = []
    for dev in (torch.device("cpu"), cuda):
        cfg, _, silo = _reduced_silos("jamba-v0.1-52b", dev)
        gen = torch.Generator().manual_seed(4)
        for p in silo.params.values():
            p.add_(torch.randn(p.shape, generator=gen).to(dev) * 0.05)
        w = torch.tensor(_SILO_WEIGHTS, device=dev)
        kernels.reset_launch_counts()
        res = None
        if wire == "int8+ef":
            silo, res = cross_silo.partial_aggregate_silo_params_ef(
                silo, cross_silo.init_ef_residual(silo), w, 1, rng=prng.PRNGKey(2, device=dev),
                stochastic=True)
        else:
            cross_silo.partial_aggregate_silo_params(silo, w, 1, wire)
        outs.append((silo.params, res, kernels.launch_counts()))
    (want, want_res, _), (got, got_res, counts) = outs
    for name, p in got.items():
        assert torch.equal(p.cpu(), want[name]), name
        if got_res is not None:
            assert torch.equal(got_res[name].cpu(), want_res[name]), name
    groups = cross_silo.shared_groups(cfg, got, 1)
    calls = len(cross_silo.wire_chunks(groups, [sum(got[n][0].numel() for n in g) for g in groups],
                                       3))
    assert len(groups) > 64 and calls == 2
    n = {"fp32": (0, -(-sum(map(len, groups)) // 64)), "bf16": (0, 0)}.get(wire, (calls, calls))
    assert (counts["quantize"], counts["dequantize"], counts["masked_aggregate"]) == (
        n[0], n[0], n[1]), counts


def test_permutation_with_a_card_key_is_the_host_draw(cuda):
    from repro_torch import random as prng

    for n in (1, 7, 256, 8192):
        host = prng.permutation(prng.fold_in(prng.PRNGKey(777), 3), n)
        card = prng.permutation(prng.fold_in(prng.PRNGKey(777, device=cuda), 3), n)
        assert card.device.type == "cuda" and torch.equal(card.cpu(), host)
