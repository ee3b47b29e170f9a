"""The port's model-zoo layers and decoder LMs (falcon-mamba-7b,
granite-3-8b) against the JAX package's, on the same weights and inputs.

Reduced configs (2 layers, d_model 256). The gate runs them in float32
(``dataclasses.replace(cfg.reduced(), dtype="float32")``): every layer
function, the prefill and decode logits and the caches are within 1e-5 of
the reference's max magnitude (measured: logits about 2e-6 of max). The
scan inputs are rounded to bfloat16 by both packages even here (the JAX
block's ``_scan_dt``).

What passes through a Mamba scan is the exception. Its inputs are float32
values rounded to bfloat16, and an input whose float32 value lies within
~1e-7 of a rounding boundary rounds the other way in one package, which
moves that input by one bf16 ulp (2^-8 of it). The scan's state, the
block's output and everything after it (falcon-mamba's logits and caches)
are therefore held to 2^-8 of their max magnitude (measured: block output
7.7e-5 and state 9.9e-5 of max on a unit-normal input, where about one
input in 20,000 flips; falcon-mamba logits 1.6e-6 of max).

The configs' own bfloat16 runs are held to 2^-5 of max|logits| (4 bf16 ulps
of the largest logit; measured: 1 ulp, 0.0078 at |logit| ~ 1). Every
matmul output is rounded to bfloat16 in both, but not at the same places:
XLA on the CPU keeps float32 across fused elementwise bfloat16 ops, and
JAX's ``chunked_attention`` rounds P to bfloat16 before P.V where the
port's flash_attention (like the Pallas kernel) keeps it in float32.

The decode KV write reproduces a reference fault: after a full prefill
(T = S) the JAX decode writes slot ``min(pos, T-1)``, so ``kv_pos`` reads
``[0 .. S-2, S]`` after one step (ROADMAP.md queue 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

ARCHS = ["falcon-mamba-7b", "granite-3-8b"]
F32_REL = 1e-5
BF16_REL = 2.0 ** -5
SCAN_REL = 2.0 ** -8  # after a Mamba scan: one bf16 rounding flip of a scan input


def _cfgs(arch, dtype="float32"):
    """(the JAX config, the port's config): the reduced arch in ``dtype``."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _t(a) -> torch.Tensor:
    """A numpy/jax array as a torch tensor with the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, rel=F32_REL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    gap, scale = np.abs(got - want).max(), np.abs(want).max()
    assert gap <= rel * scale, (what, gap, scale)


def _randn(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_silu(dtype):
    x, g = _randn((2, 5, 64), 0), _randn((64,), 1)
    jx, jg = jnp.asarray(x).astype(dtype), jnp.asarray(g).astype(dtype)
    rel = F32_REL if dtype == "float32" else BF16_REL
    _close(L.rms_norm(_t(jx), _t(jg)), JL.rms_norm(jx, jg), rel, "rms_norm")
    _close(L.silu(_t(jx)), JL.silu(jx), rel, "silu")


def test_softplus_is_jax_softplus():
    x = np.concatenate([_randn((100,), 2) * 30, [0.0, 20.5, 80.0, -80.0, np.nan]]).astype(np.float32)
    got, want = L.softplus(torch.from_numpy(x)).numpy(), np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def test_apply_rope():
    jcfg, cfg = _cfgs("granite-3-8b")
    x = _randn((2, 7, 4, 64), 3)
    pos = (np.arange(7)[None] + np.array([[0], [11]])).astype(np.int32)
    _close(L.apply_rope(_t(x), _t(pos), cfg), JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg))
    half, jhalf = (dataclasses.replace(c, rope_variant="half") for c in (cfg, jcfg))
    _close(L.apply_rope(_t(x), _t(pos), half),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jhalf), what="half RoPE")


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_prefill_and_decode(window):
    (jcfg, cfg), s = _cfgs("granite-3-8b"), 16
    p = JL.init_gqa(jax.random.PRNGKey(0), jcfg)
    pt = _tree(p)
    x = _randn((2, s, cfg.d_model), 4)
    jprefill = jax.jit(lambda p, x, pos: JL.gqa_attention(p, x, pos, jcfg, window=window,
                                                          mode="prefill"))
    jdecode = jax.jit(lambda p, x, pos, c: JL.gqa_attention(p, x, pos, jcfg, cache=c,
                                                            window=window, mode="decode"))
    out, cache = jprefill(p, jnp.asarray(x), jnp.arange(s, dtype=jnp.int32))
    tout, tcache = L.gqa_attention(pt, _t(x), torch.arange(s, dtype=torch.int32), cfg,
                                   window=window, mode="prefill")
    _close(tout, out, what="prefill out")
    for name in ("k", "v", "kv_pos"):
        _close(tcache[name], cache[name], what=f"prefill cache {name}")
    for step in range(2):
        x1 = _randn((2, 1, cfg.d_model), 5 + step)
        pos = s + step
        out, cache = jdecode(p, jnp.asarray(x1), jnp.asarray(pos, jnp.int32), cache)
        tout, tcache = L.gqa_attention(pt, _t(x1), pos, cfg, cache=tcache, window=window,
                                       mode="decode")
        _close(tout, out, what=f"decode {step} out")
        for name in ("k", "v", "kv_pos"):
            _close(tcache[name], cache[name], what=f"decode {step} cache {name}")


def test_swiglu():
    jcfg, cfg = _cfgs("granite-3-8b")
    p = JL.init_swiglu(jax.random.PRNGKey(1), jcfg)
    x = _randn((2, 6, cfg.d_model), 6)
    _close(L.swiglu(_tree(p), _t(x)), JL.swiglu(p, jnp.asarray(x)))


@pytest.mark.parametrize("with_state", [False, True], ids=["prefill", "decode"])
def test_causal_conv(with_state):
    x, w, b = _randn((2, 9, 32), 7), _randn((4, 32), 8), _randn((32,), 9)
    state = _randn((2, 3, 32), 10) if with_state else None
    y, st = JL._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            None if state is None else jnp.asarray(state))
    ty, tst = L._causal_conv(_t(x), _t(w), _t(b), None if state is None else _t(state))
    _close(ty, y, what="y")
    _close(tst, st, what="state")


def test_mamba_prefill_and_decode():
    (jcfg, cfg), s = _cfgs("falcon-mamba-7b"), 16
    p = JL.init_mamba(jax.random.PRNGKey(2), jcfg)
    pt = _tree(p)
    x = _randn((2, s, cfg.d_model), 11)
    jprefill = jax.jit(lambda p, x: JL.mamba_block(p, x, jcfg, mode="prefill"))
    jdecode = jax.jit(lambda p, x, c: JL.mamba_block(p, x, jcfg, cache=c, mode="decode"))
    out, cache = jprefill(p, jnp.asarray(x))
    tout, tcache = L.mamba_block(pt, _t(x), cfg, mode="prefill")
    _close(tout, out, SCAN_REL, what="prefill out")
    _close(tcache["conv"], cache["conv"], what="prefill conv")
    _close(tcache["ssm"], cache["ssm"], SCAN_REL, what="prefill ssm")
    for step in range(2):
        x1 = _randn((2, 1, cfg.d_model), 12 + step)
        out, cache = jdecode(p, jnp.asarray(x1), cache)
        tout, tcache = L.mamba_block(pt, _t(x1), cfg, cache=tcache, mode="decode")
        _close(tout, out, SCAN_REL, what=f"decode {step} out")
        _close(tcache["conv"], cache["conv"], what=f"decode {step} conv")
        _close(tcache["ssm"], cache["ssm"], SCAN_REL, what=f"decode {step} ssm")


# ---------------------------------------------------------------------------
# the decoder LMs
# ---------------------------------------------------------------------------


def _jax_layers(cfg, tree):
    """A JAX parameter or cache tree's per-layer dicts in execution order:
    the prologue, then period entry j at index i of the stack
    (``transformer.layer_plan``), leaves as numpy arrays."""
    n_pro, p, n_periods = T.layer_plan(cfg)
    assert len(tree["prologue"]) == n_pro and len(tree["stack"]) == (p if n_periods else 0)

    def take(node, i=None):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node) if i is None else np.asarray(node)[i]

    layers = [take(blk) for blk in tree["prologue"]]
    return layers + [take(tree["stack"][j], i) for i in range(n_periods) for j in range(p)]


def _jax_layer_caches(cfg, cache):
    """The JAX cache's per-layer dicts in execution order."""
    return _jax_layers(cfg, cache)


def _close_caches(cfg, tcache, jcache, rel, what):
    layers = _jax_layer_caches(cfg, jcache)
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


def _assert_same_weights(blk, jblk, what):
    """Every leaf of the port's block (nested ``ParamTree``s) bitwise the
    JAX block's, dtype included, and no leaf missing on either side."""
    assert sorted(blk.keys()) == sorted(jblk), (what, blk.keys(), list(jblk))
    for name, value in blk.items():
        if isinstance(jblk[name], dict):
            _assert_same_weights(value, jblk[name], f"{what}.{name}")
            continue
        want = np.asarray(jblk[name])
        assert str(value.dtype).removeprefix("torch.") == want.dtype.name, (what, name)
        np.testing.assert_array_equal(_np(value), _np(want), err_msg=f"{what}.{name}")


def test_lm_params_from_numpy_carries_every_weight(lm):
    cfg, params, model, _, _ = lm
    assert len(model.blocks) == cfg.n_layers
    assert model.embed.dtype == getattr(torch, cfg.dtype)
    np.testing.assert_array_equal(_np(model.head), _np(params["head"]))
    for i, (blk, jblk) in enumerate(zip(model.blocks, _jax_layers(cfg, params), strict=True)):
        _assert_same_weights(blk, jblk, f"layer {i}")


def test_prefill_and_decode_logits_and_caches(lm):
    cfg, params, model, jprefill, jdecode = lm
    rel = F32_REL if cfg.dtype == "float32" else BF16_REL
    if cfg.ssm:
        rel = max(rel, SCAN_REL)
    bundle = get_model(cfg)
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(toks)})
    logits, cache = prefill(model, {"tokens": torch.from_numpy(toks)})
    _close(logits, jlogits, rel, "prefill logits")
    _close_caches(cfg, cache, jcache, rel, "prefill")
    tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    for step in range(3):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        logits, cache = decode(model, cache, torch.from_numpy(tok))
        _close(logits, jlogits, rel, f"decode {step} logits")
        _close_caches(cfg, cache, jcache, rel, f"decode {step}")
        tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)


def test_kv_write_slot_clamp_is_reproduced():
    """Reference fault kept on purpose: one decode after a full prefill of
    S tokens writes slot S-1, so kv_pos is [0 .. S-2, S] in both."""
    (jcfg, cfg), s = _cfgs("granite-3-8b"), 16
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    tok = np.ones((2, 1), np.int32)
    _, jcache = jax.jit(bundle.make_prefill_step())(params, {"tokens": jnp.asarray(toks)})
    _, jcache = jax.jit(bundle.make_decode_step())(params, jcache, jnp.asarray(tok))
    _, cache = T.make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(toks)})
    _, cache = T.make_decode_step(cfg)(model, cache, torch.from_numpy(tok))
    want = np.concatenate([np.arange(s - 1), [s]]).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jcache["stack"][0]["kv_pos"])[0], want)
    for layer in cache["layers"]:
        np.testing.assert_array_equal(layer["kv_pos"].numpy(), want)
