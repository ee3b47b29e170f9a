"""The port's dense GQA zoo beyond granite — chatglm3-6b (half RoPE),
stablelm-12b (head dim 160) and qwen2-vl-2b (M-RoPE and the vision stub) —
against the JAX package's, on the same weights and inputs.

- ``apply_rope``: half RoPE and M-RoPE within 1e-6 of max|out| in float32.
  M-RoPE is held on distinct (t, h, w) streams: with equal streams its
  frequencies are full RoPE's, so ``make_concrete_batch``'s stand-in
  positions (``arange`` in all three) cannot tell the two apart.
- ``gqa_attention`` prefill and two decode steps under both variants, and
  the three reduced LMs on JAX weights carried over: prefill and 4 decode
  steps, logits and caches within 1e-5 of max in float32 and 2^-5 in bf16
  (the contracts of ``tests/test_torch_lm.py``); qwen2-vl with its
  ``vision_proj`` and (B, S, 3) positions whose h and w streams are not
  the t stream, with the t stream ``arange(S)`` and with a real image's
  (its tokens all at t = 0, the text after from t = grid), which the
  attention kernels mask by position as JAX does. granite-3-8b with tied
  embeddings (no head: the logits are ``x @ embed.T``) the same way.
- qwen2-vl's ``make_concrete_batch`` is bitwise JAX's from one seed, in
  both threefry streams, reduced and at full width (the bf16 vision
  embeddings round the same float32 normals).
- qwen2-vl's serving waves (``launch/serve.serve``, through
  ``greedy_decode``) give the JAX launcher's wave path token for token on
  the reduced float32 config: the same batches bit for bit, and the same
  greedy tokens but where the reference's top-2 logit margin is below 1e-5
  of max|logits| (a near tie the logits contract allows to flip).
- ``flash_attention_plain`` at (160, 160), G = 4 (64-key tiles), and at
  D = 128 with G = 6 and G = 16: within 1e-5 of max of the Pallas kernel
  in interpret mode in float32, and ``chunked_attention``'s bf16 result
  (with the same key tiles as chunks) under the bf16 contract.
- A prefill whose M-RoPE t stream holds a negative position raises
  ``ValueError`` (its query would see no key).
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import flash_attention as jax_flash_attention  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro.models.api import make_concrete_batch as jax_make_concrete_batch  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention.contract import bf16_contract  # noqa: E402
from repro_torch.kernels.flash_attention.ops import key_tile  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.api import get_model, make_concrete_batch  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

ARCHS = ["chatglm3-6b", "stablelm-12b", "qwen2-vl-2b"]
ROPE_REL = 1e-6
F32_REL = 1e-5
BF16_REL = 2.0 ** -5


def _cfgs(arch, dtype="float32", **change):
    """(the JAX config, the port's config): the reduced arch in ``dtype``."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype, **change)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **change)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _t(a) -> torch.Tensor:
    """A numpy/jax array as a torch tensor with the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tree(tree):
    return {k: _tree(v) for k, v in tree.items()} if isinstance(tree, dict) else _t(tree)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _bits(x) -> np.ndarray:
    """The raw bits of a bf16 tensor or array, or the values of another."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _close(got, want, rel=F32_REL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    gap, scale = np.abs(got - want).max(), np.abs(want).max()
    assert gap <= rel * scale, (what, gap, scale)


def _randn(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mrope_positions(b, s, seed, nv=0, grid=4, image_t=False):
    """(B, S, 3) int32 M-RoPE streams: t = arange(S); the first ``nv``
    tokens an image on a ``grid``-wide raster (h = row, w = column), the
    text after it h = w = t plus a per-lane offset, so no two streams are
    equal. ``image_t``: the t stream of a real Qwen2-VL prompt instead, the
    image's tokens all at t = 0 and the text after from t = ``grid``."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.arange(s), (b, s))
    h = t + rng.integers(1, 50, (b, 1))
    w = t + rng.integers(51, 99, (b, 1))
    idx = np.arange(nv)
    h[:, :nv], w[:, :nv] = idx // grid, idx % grid + 3
    if image_t:
        t = np.broadcast_to(np.concatenate([np.zeros(nv, int), grid + np.arange(s - nv)]), (b, s))
    return np.stack([t, h, w], axis=-1).astype(np.int32)


# ---------------------------------------------------------------------------
# RoPE and attention layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["half", "mrope"])
def test_apply_rope_variants_match_jax(variant):
    arch = "chatglm3-6b" if variant == "half" else "qwen2-vl-2b"
    jcfg, cfg = _cfgs(arch)
    x = _randn((2, 12, 4, cfg.head_dim_), 3)
    if variant == "half":
        pos = (np.arange(12)[None] + np.array([[0], [7]])).astype(np.int32)
    else:
        pos = _mrope_positions(2, 12, seed=4, nv=8)
    got = L.apply_rope(_t(x), _t(pos), cfg)
    _close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg), ROPE_REL, variant)
    if variant == "half":  # the second half of each head passes through
        np.testing.assert_array_equal(got[..., cfg.head_dim_ // 2:].numpy(),
                                      x[..., cfg.head_dim_ // 2:])
    else:  # distinct streams: not full RoPE on the t stream
        full = L.apply_rope(_t(x), _t(pos[..., 0]), dataclasses.replace(cfg, rope_variant="full"))
        assert float((got - full).abs().max()) > 1e-2


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen2-vl-2b"])
def test_gqa_prefill_and_decode_under_both_variants(arch, window):
    (jcfg, cfg), s = _cfgs(arch), 16
    p = JL.init_gqa(jax.random.PRNGKey(0), jcfg)
    pt = _tree(p)
    x = _randn((2, s, cfg.d_model), 5)
    mrope = cfg.rope_variant == "mrope"
    pos = _mrope_positions(2, s, seed=6, nv=8) if mrope else np.arange(s, dtype=np.int32)
    out, cache = jax.jit(lambda p, x, pos: JL.gqa_attention(p, x, pos, jcfg, window=window,
                                                            mode="prefill"))(
        p, jnp.asarray(x), jnp.asarray(pos))
    tout, tcache = L.gqa_attention(pt, _t(x), _t(pos), cfg, window=window, mode="prefill")
    _close(tout, out, what="prefill out")
    for name in ("k", "v", "kv_pos"):
        _close(tcache[name], cache[name], what=f"prefill cache {name}")
    jdecode = jax.jit(lambda p, x, pos, c: JL.gqa_attention(p, x, pos, jcfg, cache=c,
                                                            window=window, mode="decode"))
    for step in range(2):
        x1 = _randn((2, 1, cfg.d_model), 7 + step)
        at = s + step
        jpos = np.full((2, 1, 3), at, np.int32) if mrope else np.int32(at)
        out, cache = jdecode(p, jnp.asarray(x1), jnp.asarray(jpos), cache)
        tout, tcache = L.gqa_attention(pt, _t(x1), at, cfg, cache=tcache, window=window,
                                       mode="decode")
        _close(tout, out, what=f"decode {step} out")
        for name in ("k", "v", "kv_pos"):
            _close(tcache[name], cache[name], what=f"decode {step} cache {name}")


# ---------------------------------------------------------------------------
# the three reduced LMs on carried JAX weights
# ---------------------------------------------------------------------------


def _jax_layers(cfg, tree):
    """A JAX parameter or cache tree's per-layer dicts in execution order."""
    n_pro, p, n_periods = T.layer_plan(cfg)

    def take(node, i=None):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node) if i is None else np.asarray(node)[i]

    return ([take(blk) for blk in tree["prologue"]]
            + [take(tree["stack"][j], i) for i in range(n_periods) for j in range(p)])


def _close_caches(cfg, tcache, jcache, rel, what):
    layers = _jax_layers(cfg, jcache)
    assert len(tcache["layers"]) == len(layers)
    for i, (tc, jc) in enumerate(zip(tcache["layers"], layers)):
        assert set(tc) == set(jc)
        for name in jc:
            _close(tc[name], jc[name], rel, f"{what} layer {i} {name}")
    assert tcache["pos"] == int(jcache["pos"])


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def lm(request):
    """(cfg, JAX params, the port's model on the CPU, jitted JAX steps)."""
    arch, dtype = request.param
    jcfg, cfg = _cfgs(arch, dtype)
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    return cfg, params, model, jax.jit(bundle.make_prefill_step()), jax.jit(bundle.make_decode_step())


def _lm_batch(cfg, b=2, s=24, image_t=False):
    """A prefill batch as numpy: tokens, and under the vision stub bf16
    vision embeddings and M-RoPE positions with distinct h and w streams
    (``image_t``: a real image's t stream)."""
    rng = np.random.default_rng(11)
    if cfg.frontend != "vision_stub":
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    nv = cfg.n_vision_tokens
    ve = np.asarray(jnp.asarray(_randn((b, nv, cfg.d_model), 12)).astype(jnp.bfloat16))
    return {"vision_embeds": ve,
            "tokens": rng.integers(0, cfg.vocab_size, (b, s - nv)).astype(np.int32),
            "positions": _mrope_positions(b, s, seed=13, nv=nv, image_t=image_t)}


def test_lm_params_from_numpy_carries_vision_proj(lm):
    cfg, params, model, _, _ = lm
    if cfg.frontend == "vision_stub":
        assert model.vision_proj.dtype == getattr(torch, cfg.dtype)
        np.testing.assert_array_equal(_bits(model.vision_proj), _bits(params["vision_proj"]))
    else:
        assert not hasattr(model, "vision_proj") and "vision_proj" not in params
    for i, (blk, jblk) in enumerate(zip(model.blocks, _jax_layers(cfg, params), strict=True)):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(_bits(blk["mixer"][name]), _bits(jblk["mixer"][name]),
                                          err_msg=f"layer {i} {name}")


def test_prefill_and_decode_logits_and_caches(lm):
    cfg, params, model, jprefill, jdecode = lm
    for image_t in (False, True) if cfg.frontend == "vision_stub" else (False,):
        _prefill_and_decode(cfg, params, model, jprefill, jdecode, _lm_batch(cfg, image_t=image_t))


def _prefill_and_decode(cfg, params, model, jprefill, jdecode, batch):
    """The port's prefill and 4 decode steps against the jitted JAX steps:
    logits and caches within the dtype's contract."""
    rel = F32_REL if cfg.dtype == "float32" else BF16_REL
    bundle = get_model(cfg)
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
    jlogits, jcache = jprefill(params, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, cache = prefill(model, {k: _t(v) for k, v in batch.items()})
    _close(logits, jlogits, rel, "prefill logits")
    _close_caches(cfg, cache, jcache, rel, "prefill")
    assert cache["pos"] == 24
    tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    for step in range(4):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        logits, cache = decode(model, cache, torch.from_numpy(tok))
        _close(logits, jlogits, rel, f"decode {step} logits")
        _close_caches(cfg, cache, jcache, rel, f"decode {step}")
        tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)


def test_negative_t_position_raises():
    """Any non-negative t stream runs (shifted, or an image's ties); a
    negative t position in lane 0's stream (the one the mask reads) raises
    ``ValueError`` before any launch: its query would see no key, where
    JAX's -1e30 fill averages V over the masked keys."""
    _, cfg = _cfgs("qwen2-vl-2b")
    model = T.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: _t(v) for k, v in _lm_batch(cfg).items()}
    prefill = T.make_prefill_step(cfg)
    prefill(model, batch)  # t = arange(S)
    shifted = dict(batch, positions=batch["positions"].clone())
    shifted["positions"][:, :, 0] += 3
    prefill(model, shifted)
    prefill(model, {k: _t(v) for k, v in _lm_batch(cfg, image_t=True).items()})
    negative = dict(batch, positions=batch["positions"].clone())
    negative["positions"][0, 5, 0] = -1
    with pytest.raises(ValueError, match="negative t position"):
        prefill(model, negative)
    lane1 = dict(batch, positions=batch["positions"].clone())
    lane1["positions"][1, 5, 0] = -1  # lane 1's t stream is not the mask's
    prefill(model, lane1)
    with pytest.raises(ValueError, match="positions"):
        prefill(model, {k: v for k, v in batch.items() if k != "positions"})


def test_tied_granite_prefill_and_decode_match_jax():
    """granite-3-8b with tied embeddings: JAX's tree has no ``head`` and
    neither has the port's model; prefill and 4 decode steps within 1e-5 of
    max of JAX's (``x @ embed.T``)."""
    jcfg, cfg = _cfgs("granite-3-8b", tie_embeddings=True)
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    assert "head" not in params
    model = lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    assert model.head is None and "head" not in dict(model.named_parameters())
    _prefill_and_decode(cfg, params, model, jax.jit(bundle.make_prefill_step()),
                        jax.jit(bundle.make_decode_step()), _lm_batch(cfg))


# ---------------------------------------------------------------------------
# the vision batch and the serving waves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partitionable", [True, False], ids=["partitionable", "legacy"])
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_make_concrete_batch_is_bitwise_jax(size, partitionable):
    jcfg, cfg = jax_get_config("qwen2-vl-2b"), get_config("qwen2-vl-2b")
    b, s = (4, 64) if size == "reduced" else (2, 2048)
    if size == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    with jax.threefry_partitionable(partitionable), prng.threefry_partitionable(partitionable):
        want = jax_make_concrete_batch(jcfg, "prefill", b, s, jax.random.PRNGKey(5))
        got = make_concrete_batch(cfg, "prefill", b, s, prng.PRNGKey(5))
    assert list(got) == list(want) == ["vision_embeds", "tokens", "positions"]
    nv = cfg.n_vision_tokens
    assert got["vision_embeds"].shape == (b, nv, cfg.d_model)
    assert got["vision_embeds"].dtype == torch.bfloat16
    assert got["tokens"].shape == (b, s - nv) and got["positions"].shape == (b, s, 3)
    for name in want:
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]), err_msg=name)


class _Recorded:
    """A step function that keeps each call's (B, V) logits as numpy."""

    def __init__(self, fn, into):
        self.fn, self.logits = fn, into

    def __call__(self, *args):
        logits, cache = self.fn(*args)
        self.logits.append(np.asarray(logits.numpy() if isinstance(logits, torch.Tensor)
                                      else logits, np.float32))
        return logits, cache


class _Waves:
    """Wraps a package's ``greedy_decode``: keeps each wave's batch (numpy),
    tokens, and the logits of its prefill and decode calls in order."""

    def __init__(self, fn):
        self.fn, self.batches, self.seqs, self.logits = fn, [], [], []

    def __call__(self, prefill, decode, params, batch, max_new, **kw):
        self.batches.append({k: _bits(v) for k, v in batch.items()})
        seqs, n = self.fn(_Recorded(prefill, self.logits), _Recorded(decode, self.logits), params,
                          batch, max_new, **kw)
        self.seqs.extend(seqs)
        return seqs, n


def test_serving_waves_match_the_jax_launcher(monkeypatch):
    """The JAX launcher's ``main`` (its wave path: qwen2-vl's prefill holds
    more than tokens) and the port's ``serve`` on the reduced float32
    qwen2-vl, the JAX launcher's weights carried to the port; 3 requests on
    2 lanes: a wave of 2, then a wave of 1."""
    requests, batch, prompt_len, max_new, seed = 3, 2, 24, 4, 0
    jcfg, cfg = _cfgs("qwen2-vl-2b")
    monkeypatch.setattr(jax_serve, "get_config",
                        lambda arch: dataclasses.replace(jax_get_config(arch), dtype="float32"))
    jwaves = _Waves(jax_serve.greedy_decode)
    monkeypatch.setattr(jax_serve, "greedy_decode", jwaves)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-vl-2b", "--requests", str(requests),
                                      "--batch", str(batch), "--prompt-len", str(prompt_len),
                                      "--max-new", str(max_new), "--seed", str(seed)])
    jax_serve.main()

    params = jax_get_model(jcfg).init(jax.random.PRNGKey(seed))
    model = lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")
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
        assert list(tb) == list(jb)
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


# ---------------------------------------------------------------------------
# flash_attention_plain at the new shapes
# ---------------------------------------------------------------------------


SHAPES = [(160, 4), (128, 6), (128, 16)]  # (D, G): stablelm-12b, qwen2-vl-2b, chatglm3-6b


def _fa_inputs(s, d, g, seed, hkv=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, s, g * hkv, d)).astype(np.float32),
            rng.standard_normal((1, s, hkv, d)).astype(np.float32),
            rng.standard_normal((1, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_attention_plain_f32_matches_pallas_interpret(shape, window):
    d, g = shape
    q, k, v = _fa_inputs(100, d, g, seed=d + g + window)
    got = flash_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)), causal=True,
                                window=window)
    want = jax_flash_attention(*(jnp.asarray(t) for t in (q, k, v)), causal=True, window=window,
                               block_q=64, block_k=64, interpret=True)
    _close(got, want, F32_REL, "out")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_attention_plain_bf16_matches_chunked_attention(shape, causal):
    """The JAX model's prefill attention with the kernel's key tile (64 keys
    at D = 160, 128 at D = 128) as its chunk; S = 150 spans several tiles."""
    d, g = shape
    s, window = 150, 0 if causal else 40
    q, k, v = _fa_inputs(s, d, g, seed=d + g + causal, hkv=2)
    qkv = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]
    got = flash_attention_plain(*qkv, causal=causal, window=window)
    assert got.shape == (1, s, 2 * g, d) and got.dtype == torch.bfloat16
    pos = jnp.arange(s)
    want = chunked_attention(*(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)), pos, pos,
                             causal=causal, window=window, chunk=key_tile(torch.bfloat16, d, d))
    want = torch.from_numpy(np.asarray(jnp.asarray(want, jnp.float32))).to(torch.bfloat16)
    result = bf16_contract(want, got, *qkv, causal, window)
    assert result["ok"], result
