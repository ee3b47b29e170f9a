"""The quantize and dequantize tables (``quantize_leaves`` and
``dequantize_leaves``: a round's leaves in one launch each on the card) and
the codec path that feeds them, on the CPU.

- ``quantize_leaves_plain`` (and the wrapper on CPU tensors) over har-mlp's
  8 leaf shapes, int8 and int4, stochastic and nearest, with a NaN in one
  leaf, is bitwise ``quantize_plain`` leaf by leaf;
- ``_roundtrip_trees``/``ef_steps`` over a round's per-layer trees are
  bitwise the per-leaf path (``codec.roundtrip`` of each leaf with key
  ``fold_in(rng_j, i)``, ``ef_step`` per layer) for every codec;
- ``dequantize_leaves_plain`` (and the wrapper on CPU tensors) over the
  same leaves' codes, a NaN scale included, is bitwise ``dequantize_plain``
  leaf by leaf; ``Codec.decode_leaves`` is ``decode`` leaf by leaf for
  every codec;
- a bare ``QuantizeCodec`` sends all leaves of all layers of a round
  through one ``quantize_leaves`` and one ``dequantize_leaves`` call (one
  launch each on the card; more than 64 leaves raise); chains and top-k
  keep the per-leaf path.

On the card the kernel is held to ``quantize_leaves_plain`` bitwise by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; the four goldens of
``tests/test_torch_fl.py`` pin the end to end.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch import random as prng
from repro_torch.comm import codec as tcodec
from repro_torch.data import make_federated_classification
from repro_torch.fl import FLConfig, run_federated
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

HAR_MLP = (561, 256, 256, 256, 6)
# one har-mlp round's leaves in tree order (each layer's 'b' then 'w')
LEAVES = [s for i, o in zip(HAR_MLP[:-1], HAR_MLP[1:]) for s in ((o,), (i, o))]
K = 3  # client rows a leaf


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in
    several worker processes, and torch's default of a thread per core in
    each of them oversubscribes the cores, which slows many small ops far
    more than it speeds a few."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def same(a, b) -> bool:
    """Bitwise equal, a NaN matching a NaN (the codes' NaN scales)."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _leaves(seed, nan_leaf=None):
    rng = np.random.default_rng(seed)
    xs, us = [], []
    for i, s in enumerate(LEAVES):
        x = (rng.standard_normal((K, int(np.prod(s)))) * 0.01).astype(np.float32)
        if i == nan_leaf:
            x[1, 7] = np.nan
        xs.append(torch.from_numpy(x))
        us.append(torch.from_numpy(rng.random(x.shape, dtype=np.float32)))
    return xs, us


@pytest.mark.parametrize("stochastic", [True, False], ids=["stochastic", "nearest"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_leaves_plain_is_quantize_plain_leaf_by_leaf(bits, stochastic):
    xs, us = _leaves(seed=bits, nan_leaf=3)
    noises = us if stochastic else None
    per_leaf = [quantize_plain(x, u if stochastic else None, bits=bits) for x, u in zip(xs, us)]
    for got in (quantize_leaves_plain(xs, noises, bits=bits),
                quantize_leaves(xs, noises, bits=bits)):
        assert len(got) == len(LEAVES)
        for (q, s), (qp, sp) in zip(got, per_leaf):
            assert q.dtype == torch.int8 and torch.equal(q, qp) and same(s, sp)
    # the NaN block: scale NaN, codes 0
    q3, s3 = per_leaf[3]
    assert torch.isnan(s3[1, 0]) and not q3[1, :512].any()


def test_quantize_is_the_one_leaf_case():
    xs, us = _leaves(seed=1)
    for x, u in zip(xs, us):
        (q, s), = quantize_leaves([x], [u])
        q1, s1 = quantize(x, u)
        assert torch.equal(q, q1) and torch.equal(s, s1)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_quantize_leaves_takes_one_noise_per_leaf(device):
    xs = [torch.zeros((2, 8), device=device)] * 2
    with pytest.raises(ValueError, match="one noise"):
        quantize_leaves(xs, [None])


def test_cpu_tensors_count_no_launch():
    kernels.reset_launch_counts()
    xs, us = _leaves(seed=2)
    quantize_leaves(xs, us)
    assert kernels.launch_counts()["quantize"] == 0


def _round_trees(seed):
    """A round's per-layer trees, K lanes each, and per-layer (K, 2) keys."""
    rng = np.random.default_rng(seed)
    trees = [{"b": torch.from_numpy(rng.standard_normal((K, o)).astype(np.float32) * 0.01),
              "w": torch.from_numpy(rng.standard_normal((K, i, o)).astype(np.float32) * 0.01)}
             for i, o in zip(HAR_MLP[:-1], HAR_MLP[1:])]
    keys = [prng.split(prng.fold_in(prng.PRNGKey(seed), j), K) for j in range(len(trees))]
    return trees, keys


@pytest.mark.parametrize("spec", ["int8", "int4", "float32", "topk", "topk+int8"])
def test_roundtrip_trees_is_the_per_leaf_path(spec):
    codec = tcodec.make_codec(spec, topk_fraction=0.3)
    trees, keys = _round_trees(seed=4)
    got = tcodec._roundtrip_trees(codec, trees, keys)
    for tree, key, out in zip(trees, keys, got):
        for i, name in enumerate(sorted(tree)):
            want = codec.roundtrip(tree[name], prng.fold_in(key, i))
            assert out[name].dtype == want.dtype and torch.equal(out[name], want), (spec, name)
        single = tcodec.roundtrip_tree(codec, tree, key)
        assert all(torch.equal(single[n], out[n]) for n in tree)


@pytest.mark.parametrize("spec", ["int8", "int4", "topk+int8"])
def test_ef_steps_is_ef_step_per_layer(spec):
    codec = tcodec.make_codec(spec, topk_fraction=0.3)
    deltas, keys = _round_trees(seed=5)
    residuals, _ = _round_trees(seed=6)
    got = tcodec.ef_steps(codec, deltas, residuals, keys)
    for (dec, res), delta, residual, key in zip(got, deltas, residuals, keys):
        want_dec, want_res = tcodec.ef_step(codec, delta, residual, key)
        for n in delta:
            assert torch.equal(dec[n], want_dec[n]) and torch.equal(res[n], want_res[n])


def _count_quantize_calls(monkeypatch):
    calls = []

    def counting(xs, *args, **kw):
        calls.append(len(xs))
        return quantize_leaves(xs, *args, **kw)

    monkeypatch.setattr(tcodec, "quantize_leaves", counting)
    return calls


@pytest.mark.parametrize("spec,n_calls", [("int8", 1), ("int4", 1), ("topk+int8", 8)])
def test_a_round_quantizes_in_one_call(monkeypatch, spec, n_calls):
    calls = _count_quantize_calls(monkeypatch)
    trees, keys = _round_trees(seed=7)
    tcodec.ef_steps(tcodec.make_codec(spec, topk_fraction=0.3), trees, trees, keys)
    assert len(calls) == n_calls and sum(calls) == len(LEAVES)


def test_more_leaves_than_a_launch_takes(monkeypatch):
    """70 leaves: one codec call, which raises, as the kernel's table takes
    64; 64 leaves still go through, leaf by leaf equal to quantize_plain."""
    calls = _count_quantize_calls(monkeypatch)
    xs = [torch.full((2, 9), float(i)) for i in range(70)]
    keys = [prng.split(prng.PRNGKey(i), 2) for i in range(len(xs))]
    with pytest.raises(ValueError, match="at most 64 leaves"):
        tcodec.QuantizeCodec(stochastic=False)._roundtrip_leaves(xs, keys)
    assert calls == [70]
    for (q, s), x in zip(quantize_leaves(xs[:64]), xs):
        qp, sp = quantize_plain(x)
        assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_quantize_leaves_rejects_more_leaves_than_one_launch_takes(device):
    """The table's 64 leaves is a limit on every device, checked before any
    dispatch, so a round is always one launch on the card."""
    xs = [torch.zeros((2, 8), device=device)] * 65
    with pytest.raises(ValueError, match="at most 64 leaves"):
        quantize_leaves(xs)
    with pytest.raises(ValueError, match="at most 64 leaves"):
        tcodec.QuantizeCodec(stochastic=False).encode_leaves(xs, [None] * len(xs))


def test_federated_int8_round_quantizes_once_a_round(monkeypatch):
    calls = _count_quantize_calls(monkeypatch)
    ds = make_federated_classification(n_clients=6, n_classes=3, n_features=12,
                                       samples_per_client_range=(30, 40), seed=3)
    run_federated(ds, FLConfig(codec="int8", rounds=3, epochs=1), device="cpu")
    assert calls == [len(LEAVES)] * 3  # the mlp's 4 layers, 'b' and 'w' each, every round


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_leaves_plain_is_dequantize_plain_leaf_by_leaf(bits):
    xs, us = _leaves(seed=10 + bits, nan_leaf=3)
    codes = quantize_leaves_plain(xs, us, bits=bits)
    per_leaf = [dequantize_plain(q, s) for q, s in codes]
    for got in (dequantize_leaves_plain(codes), dequantize_leaves(codes)):
        assert len(got) == len(LEAVES)
        for d, dp in zip(got, per_leaf):
            assert d.dtype == torch.float32 and same(d, dp)
    assert torch.isnan(per_leaf[3][1, :512]).all()  # the NaN block decodes to NaNs


def test_dequantize_is_the_one_leaf_case():
    xs, us = _leaves(seed=3)
    for q, s in quantize_leaves_plain(xs, us):
        (d,) = dequantize_leaves([(q, s)])
        assert torch.equal(d, dequantize(q, s))


@pytest.mark.parametrize("spec", ["int8", "int4", "float32", "topk", "topk+int8"])
def test_decode_leaves_is_decode_per_leaf(spec):
    codec = tcodec.make_codec(spec, topk_fraction=0.3)
    xs, _ = _leaves(seed=20)
    keys = [prng.split(prng.fold_in(prng.PRNGKey(20), i), K) for i in range(len(xs))]
    wires = codec.encode_leaves(xs, keys)
    for got, (payload, carrier) in zip(codec.decode_leaves(wires), wires):
        assert torch.equal(got, codec.decode(payload, carrier))


def _count_dequantize_calls(monkeypatch):
    calls = []

    def counting(codes, *args, **kw):
        calls.append(len(codes))
        return dequantize_leaves(codes, *args, **kw)

    monkeypatch.setattr(tcodec, "dequantize_leaves", counting)
    return calls


@pytest.mark.parametrize("spec,n_calls", [("int8", 1), ("int4", 1), ("topk+int8", 8)])
def test_a_round_dequantizes_in_one_call(monkeypatch, spec, n_calls):
    calls = _count_dequantize_calls(monkeypatch)
    trees, keys = _round_trees(seed=8)
    tcodec.ef_steps(tcodec.make_codec(spec, topk_fraction=0.3), trees, trees, keys)
    assert len(calls) == n_calls and sum(calls) == len(LEAVES)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_dequantize_leaves_rejects_more_leaves_than_one_launch_takes(device):
    """As for quantize: 64 leaves a launch on every device, checked before
    any dispatch, so a round decodes in one launch on the card."""
    codes = [(torch.zeros((2, 8), dtype=torch.int8, device=device),
              torch.ones((2, 1), device=device))] * 65
    with pytest.raises(ValueError, match="at most 64 leaves"):
        dequantize_leaves(codes)
    with pytest.raises(ValueError, match="at most 64 leaves"):
        tcodec.QuantizeCodec().decode_leaves([(s, q) for q, s in codes])
    if device == "cpu":
        assert len(dequantize_leaves(codes[:64])) == 64


def test_federated_int8_round_dequantizes_once_a_round(monkeypatch):
    calls = _count_dequantize_calls(monkeypatch)
    ds = make_federated_classification(n_clients=6, n_classes=3, n_features=12,
                                       samples_per_client_range=(30, 40), seed=3)
    run_federated(ds, FLConfig(codec="int8", rounds=3, epochs=1), device="cpu")
    assert calls == [len(LEAVES)] * 3
