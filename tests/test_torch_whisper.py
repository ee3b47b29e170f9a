"""The port's encoder-decoder, whisper-tiny (``models/whisper.py``),
against the JAX package's, on the same weights and inputs.

Reduced config: 2 encoder and 2 decoder layers, d_model 256, 4 heads over
2 kv heads of 64 dims, 64 frames, at most 64 decoder tokens; float32 and
bfloat16, the JAX weights carried over by
``weights.whisper_params_from_numpy``.

- Every leaf bitwise, the JAX tree's names kept; ``init_whisper`` gives
  JAX's shapes and dtypes, ``init_whisper_cache`` its cache.
- ``encode`` (bidirectional self-attention through flash_attention,
  non-causal at T = S), the prefill (the cross-attention non-causal from S
  decoder queries over T frames, T != S), its logits and caches, and 4
  greedy decode steps (the cross-attention one query over T frames):
  within 1e-5 of max in float32 and 2^-5 in bf16 (the contracts of
  ``tests/test_torch_lm.py``).
- ``make_concrete_batch``'s frames (bf16, B x 1,500 x 384 at full width)
  and tokens (capped to ``max_decoder_seq``) are bitwise JAX's from one
  seed, in both threefry streams.
- ``greedy_decode`` in both packages, and the serving waves
  (``launch/serve.serve``) against the JAX launcher's ``main()``, token for
  token on the reduced float32 config, but where the reference's top-2
  logit margin is a near tie within the logits contract.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro.models.api import make_concrete_batch as jax_make_concrete_batch  # noqa: E402
from repro.serve import greedy_decode as jax_greedy_decode  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import whisper as W  # noqa: E402
from repro_torch.models.api import get_model, make_concrete_batch  # noqa: E402
from repro_torch.serve import greedy_decode  # noqa: E402
from repro_torch.weights import whisper_params_from_numpy  # noqa: E402
from test_torch_dense_zoo import _Waves, _bits, _close, _t  # noqa: E402

ARCH = "whisper-tiny"
F32_REL = 1e-5
BF16_REL = 2.0 ** -5
REL = {"float32": F32_REL, "bfloat16": BF16_REL}


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def whisper(request):
    """(cfg, JAX config, JAX params, the port's model on the CPU, jitted
    JAX steps)."""
    jcfg, cfg = _cfgs(request.param)
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    model = whisper_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    return (cfg, jcfg, params, model, jax.jit(bundle.make_prefill_step()),
            jax.jit(bundle.make_decode_step()))


def _flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/list tree or of a module's
    parameters, in a stable order."""
    if isinstance(tree, torch.nn.Module):
        return sorted((name, p) for name, p in tree.named_parameters())
    if isinstance(tree, dict):
        return sorted(kv for k, v in tree.items() for kv in _flat(v, f"{prefix}{k}."))
    if isinstance(tree, (list, tuple)):
        return sorted(kv for i, v in enumerate(tree) for kv in _flat(v, f"{prefix}{i}."))
    return [(prefix[:-1], tree)]


def _batch(cfg, b=2, s=12, seed=0):
    """A prefill batch as numpy: bf16 frames (B, encoder_seq, D) and tokens."""
    rng = np.random.default_rng(seed)
    frames = np.asarray(jnp.asarray(rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)),
                                    jnp.float32).astype(jnp.bfloat16))
    return {"frames": frames,
            "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _close_caches(tcache, jcache, rel, what):
    assert len(tcache["layers"]) == len(jcache["layers"])
    for i, (tc, jc) in enumerate(zip(tcache["layers"], jcache["layers"])):
        assert set(tc) == set(jc) == {"k", "v", "kv_pos"}
        for name in jc:
            _close(tc[name], jc[name], rel, f"{what} layer {i} {name}")
    assert tcache["pos"] == int(jcache["pos"])
    _close(tcache["enc_out"], jcache["enc_out"], rel, f"{what} enc_out")


def test_whisper_params_from_numpy_carries_every_weight(whisper):
    cfg, _, params, model, _, _ = whisper
    want = _flat(jax.device_get(params))
    got = _flat(model)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, value), (_, jvalue) in zip(got, want):
        assert str(value.dtype).removeprefix("torch.") == np.asarray(jvalue).dtype.name, name
        np.testing.assert_array_equal(_bits(value), _bits(jvalue), err_msg=name)
    assert len(model.encoder) == cfg.n_encoder_layers and len(model.decoder) == cfg.n_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_whisper_and_its_cache_have_the_jax_shapes(dtype):
    jcfg, cfg = _cfgs(dtype)
    want = _flat(jax.device_get(jax_get_model(jcfg).init(jax.random.PRNGKey(1))))
    got = _flat(get_model(cfg).init(torch.Generator().manual_seed(1)))
    assert [(n, tuple(v.shape), str(v.dtype).removeprefix("torch.")) for n, v in got] == [
        (n, np.asarray(v).shape, np.asarray(v).dtype.name) for n, v in want]
    jc = JW.init_whisper_cache(jcfg, 2, 16)
    tc = get_model(cfg).init_cache(2, 16)
    assert tc["pos"] == int(jc["pos"]) == 0 and tc["enc_out"].shape == jc["enc_out"].shape
    for tl, jl in zip(tc["layers"], jc["layers"], strict=True):
        for name in jl:
            assert tuple(tl[name].shape) == jl[name].shape and bool((tl[name] == 0).all()) == \
                bool((np.asarray(jl[name]) == 0).all()), name


def test_encode_matches_jax(whisper):
    cfg, jcfg, params, model, _, _ = whisper
    frames = _batch(cfg)["frames"]
    want = jax.jit(lambda p, f: JW.encode(p, jcfg, f))(params, jnp.asarray(frames))
    got = W.encode(model, cfg, _t(frames))
    assert got.dtype == getattr(torch, cfg.dtype)
    _close(got, want, REL[cfg.dtype], "encode")


def test_prefill_and_decode_match_jax(whisper):
    """Prefill (the encoder, then the decoder cross-attending its output)
    and 4 greedy decode steps: logits and caches, ``enc_out`` included."""
    cfg, _, params, model, jprefill, jdecode = whisper
    rel = REL[cfg.dtype]
    bundle = get_model(cfg)
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
    batch = _batch(cfg)
    jlogits, jcache = jprefill(params, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, cache = prefill(model, {k: _t(v) for k, v in batch.items()})
    _close(logits, jlogits, rel, "prefill logits")
    _close_caches(cache, jcache, rel, "prefill")
    assert cache["pos"] == 12
    tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    for step in range(4):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        logits, cache = decode(model, cache, torch.from_numpy(tok))
        _close(logits, jlogits, rel, f"decode {step} logits")
        _close_caches(cache, jcache, rel, f"decode {step}")
        tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("partitionable", [True, False], ids=["partitionable", "legacy"])
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_make_concrete_batch_is_bitwise_jax(size, partitionable):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    b, s = (3, 100) if size == "reduced" else (2, 2048)
    if size == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    with jax.threefry_partitionable(partitionable), prng.threefry_partitionable(partitionable):
        want = jax_make_concrete_batch(jcfg, "prefill", b, s, jax.random.PRNGKey(5))
        got = make_concrete_batch(cfg, "prefill", b, s, prng.PRNGKey(5))
    assert list(got) == list(want) == ["frames", "tokens"]
    assert got["frames"].shape == (b, cfg.encoder_seq, cfg.d_model)
    assert got["frames"].dtype == torch.bfloat16
    assert got["tokens"].shape == (b, min(s, cfg.max_decoder_seq))
    for name in want:
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]), err_msg=name)


def test_greedy_decode_matches_jax():
    """``greedy_decode`` over the same batch in both packages (reduced
    float32): the same tokens and counts, but where a reference top-2
    margin is a near tie within the logits contract."""
    jcfg, cfg = _cfgs()
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    model = whisper_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    batch = _batch(cfg, b=3, s=16, seed=4)
    waves_j, waves_t = _Waves(jax_greedy_decode), _Waves(greedy_decode)
    jseqs, jn = waves_j(jax.jit(bundle.make_prefill_step()), jax.jit(bundle.make_decode_step()),
                        params, {k: jnp.asarray(v) for k, v in batch.items()}, 6, eos_id=1)
    tb = get_model(cfg)
    tseqs, tn = waves_t(tb.make_prefill_step(), tb.make_decode_step(), model,
                        {k: _t(v) for k, v in batch.items()}, 6, eos_id=1)
    for i, (tl, jl) in enumerate(zip(waves_t.logits, waves_j.logits)):
        _close(tl, jl, F32_REL, f"call {i} logits")
        lanes = np.nonzero(tl.argmax(-1) != jl.argmax(-1))[0]
        if lanes.size:  # a near tie of the reference: the runs part here
            top2 = np.sort(jl[lanes], axis=-1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0]).max() < F32_REL * np.abs(jl).max(), (i, lanes)
            return
    assert tseqs == jseqs
    np.testing.assert_array_equal(tn, jn)


def test_serving_waves_match_the_jax_launcher(monkeypatch):
    """The JAX launcher's ``main`` (its wave path: whisper's prefill holds
    frames beside its tokens) and the port's ``serve`` on the reduced
    float32 whisper, the JAX launcher's weights carried to the port; 3
    requests on 2 lanes: a wave of 2, then a wave of 1, each drawn from its
    own key (frames and tokens bitwise)."""
    requests, batch, prompt_len, max_new, seed = 3, 2, 24, 4, 0
    jcfg, cfg = _cfgs()
    monkeypatch.setattr(jax_serve, "get_config",
                        lambda arch: dataclasses.replace(jax_get_config(arch), dtype="float32"))
    jwaves = _Waves(jax_serve.greedy_decode)
    monkeypatch.setattr(jax_serve, "greedy_decode", jwaves)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--requests", str(requests),
                                      "--batch", str(batch), "--prompt-len", str(prompt_len),
                                      "--max-new", str(max_new), "--seed", str(seed)])
    jax_serve.main()

    params = jax_get_model(jcfg).init(jax.random.PRNGKey(seed))
    model = whisper_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    bundle = get_model(cfg)
    monkeypatch.setattr(port_serve, "get_model",
                        lambda c: dataclasses.replace(bundle, init=lambda gen: model))
    twaves = _Waves(port_serve.greedy_decode)
    monkeypatch.setattr(port_serve, "greedy_decode", twaves)
    stats = port_serve.serve(cfg, requests=requests, batch=batch, prompt_len=prompt_len,
                             max_new=max_new, seed=seed, device="cpu")

    assert stats["prefill_calls"] == len(twaves.batches) == len(jwaves.batches) == 2
    assert [len(w["tokens"]) for w in twaves.batches] == [2, 1]
    for tb, jb in zip(twaves.batches, jwaves.batches):
        assert list(tb) == list(jb) == ["frames", "tokens"]
        for name in jb:
            np.testing.assert_array_equal(tb[name], jb[name], err_msg=name)
    assert len(twaves.logits) == len(jwaves.logits)
    for i, (tl, jl) in enumerate(zip(twaves.logits, jwaves.logits)):
        _close(tl, jl, F32_REL, f"call {i} logits")
        lanes = np.nonzero(tl.argmax(-1) != jl.argmax(-1))[0]
        if lanes.size:  # a near tie of the reference may flip; the runs part here
            top2 = np.sort(jl[lanes], axis=-1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0]).max() < F32_REL * np.abs(jl).max(), (i, lanes)
            return
    assert stats["outputs"] == twaves.seqs == jwaves.seqs
    assert stats["tokens"] == sum(len(o) for o in jwaves.seqs) == sum(stats["lens"])
