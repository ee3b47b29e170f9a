"""The port's MLA attention (deepseek-v2-lite-16b) and flash_attention at
MLA's head dims against the JAX package's, on the same weights and inputs.

- ``apply_rope(..., rope_dim=)``: the first ``rope_dim`` dims rotated, the
  rest passed through, within 1e-5 of max of JAX's.
- ``mla_attention`` on the reduced config (nd 32 + rd 16 = 48 q/k dims,
  vd 32), float32 and bfloat16: prefill (through ``flash_attention``) and
  two cached decode steps, the naive re-expansion and the absorbed form
  (``REPRO_MLA_DECODE``), window 0 and a ring window of 8 (``slot = pos %
  T``): outputs and the compressed caches within ``test_torch_lm.py``'s
  ``F32_REL`` / ``BF16_REL`` of max.
- Absorbed against naive on the port
  (``tests/test_layers_extra.py::test_mla_absorbed_decode_matches_naive``:
  3e-2 in bf16; float32: 1e-5 of max, the two differ only in how the
  products associate), and the ring's eviction.
- ``flash_attention_plain`` with a q/k head dim other than v's, at the
  reduced (48, 32) and deepseek-v2-lite's (192, 128): against JAX's
  ``chunked_attention``, which takes Dv != Dq directly and is what JAX's
  ``mla_attention`` runs (float32: 1e-5 of max; bf16: the contract of
  ``kernels/flash_attention/contract.py`` at the kernel's 128-key chunks),
  and against the Pallas kernel in interpret mode, which takes one head dim:
  v zero-padded to Dqk and the output cut back to Dv, which is exact (zero
  v columns add nothing to the others). The Pallas kernel keeps P in
  float32, so a bf16 result is held as ``test_torch_lm_kernels.py`` holds
  it (1 bf16 ulp + 1e-5 of max + 2^-8 of the attention of |v|).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import flash_attention as jax_flash_attention  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention.contract import bf16_contract  # noqa: E402
from repro_torch.kernels.flash_attention.ops import BLOCK_K  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from test_torch_lm import BF16_REL, F32_REL, _close, _randn, _t, _tree  # noqa: E402
from test_torch_lm_kernels import _check_fa, _to_jax, _to_torch  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def test_reduced_mla_dims():
    _, cfg = _cfgs()
    assert (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank) == (32, 16, 32, 32)
    full = get_config(ARCH)
    assert (full.qk_nope_dim + full.qk_rope_dim, full.v_head_dim) == (192, 128)


@pytest.mark.parametrize("rope_dim", [16, 8, None])
def test_apply_rope_on_the_first_dims(rope_dim):
    jcfg, cfg = _cfgs()
    x = _randn((2, 5, 3, 16), 1)
    pos = (np.arange(5)[None] + np.array([[0], [7]])).astype(np.int32)
    got = L.apply_rope(_t(x), _t(pos), cfg, rope_dim=rope_dim)
    _close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg, rope_dim=rope_dim))
    if rope_dim == 8:
        assert torch.equal(got[..., 8:], _t(x)[..., 8:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("decode", ["naive", "absorbed"])
@pytest.mark.parametrize("window", [0, 8])
def test_mla_prefill_and_decode(window, decode, dtype, monkeypatch):
    monkeypatch.setenv("REPRO_MLA_DECODE", decode)
    (jcfg, cfg), s = _cfgs(dtype), 16
    rel = F32_REL if dtype == "float32" else BF16_REL
    p = JL.init_mla(jax.random.PRNGKey(0), jcfg)
    pt = _tree(p)
    x = jnp.asarray(_randn((2, s, cfg.d_model), 4)).astype(dtype)
    jprefill = jax.jit(lambda p, x, pos: JL.mla_attention(p, x, pos, jcfg, window=window,
                                                          mode="prefill"))
    jdecode = jax.jit(lambda p, x, pos, c: JL.mla_attention(p, x, pos, jcfg, cache=c,
                                                            window=window, mode="decode"))
    out, cache = jprefill(p, x, jnp.arange(s, dtype=jnp.int32))
    tout, tcache = L.mla_attention(pt, _t(x), torch.arange(s, dtype=torch.int32), cfg,
                                   window=window, mode="prefill")
    _close(tout, out, rel, "prefill out")
    assert set(tcache) == set(cache) == {"c_kv", "k_rope", "kv_pos"}
    for name in cache:
        _close(tcache[name], cache[name], rel, f"prefill cache {name}")
    for step in range(2):
        x1 = jnp.asarray(_randn((2, 1, cfg.d_model), 5 + step)).astype(dtype)
        pos = s + step
        out, cache = jdecode(p, x1, jnp.asarray(pos, jnp.int32), cache)
        tout, tcache = L.mla_attention(pt, _t(x1), pos, cfg, cache=tcache, window=window,
                                       mode="decode")
        _close(tout, out, rel, f"decode {step} out")
        for name in cache:
            _close(tcache[name], cache[name], rel, f"decode {step} cache {name}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_absorbed_decode_matches_naive(dtype, monkeypatch):
    """``tests/test_layers_extra.py::test_mla_absorbed_decode_matches_naive``
    on the port."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    p = L.init_mla(gen, cfg)
    dt = getattr(torch, dtype)
    x_ctx = torch.randn((2, 16, cfg.d_model), generator=gen).to(dt)
    _, cache = L.mla_attention(p, x_ctx, torch.arange(16, dtype=torch.int32), cfg, mode="prefill")
    x_new = torch.randn((2, 1, cfg.d_model), generator=gen).to(dt)
    outs = {}
    for mode in ("naive", "absorbed"):
        monkeypatch.setenv("REPRO_MLA_DECODE", mode)
        c = {k: v.clone() for k, v in cache.items()}
        outs[mode], _ = L.mla_attention(p, x_new, 16, cfg, cache=c, mode="decode")
    if dtype == "bfloat16":
        np.testing.assert_allclose(outs["naive"].float().numpy(), outs["absorbed"].float().numpy(),
                                   atol=3e-2, rtol=3e-2)
    else:
        _close(outs["absorbed"], outs["naive"], F32_REL, "absorbed vs naive")


def test_mla_ring_window_evicts_the_oldest():
    """Decoding from scratch into a ring of w = 4 slots keeps the last 4
    positions, in both packages."""
    jcfg, cfg = _cfgs()
    p = JL.init_mla(jax.random.PRNGKey(0), jcfg)
    pt = _tree(p)
    w = 4
    jcache = JL.init_mla_cache(jcfg, 1, 64, window=w)
    tcache = L.init_mla_cache(cfg, 1, 64, window=w)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}
    x = _randn((1, 10, cfg.d_model), 1)
    for t in range(10):
        out, jcache = JL.mla_attention(p, jnp.asarray(x[:, t:t + 1]), jnp.asarray(t), jcfg,
                                       cache=jcache, window=w, mode="decode")
        tout, tcache = L.mla_attention(pt, _t(x[:, t:t + 1]), t, cfg, cache=tcache, window=w,
                                       mode="decode")
        _close(tout, out, F32_REL, f"step {t}")
    assert sorted(tcache["kv_pos"].tolist()) == [6, 7, 8, 9]
    for name in jcache:
        _close(tcache[name], jcache[name], F32_REL, name)


# ---------------------------------------------------------------------------
# flash_attention at MLA's head dims (Dqk != Dv)
# ---------------------------------------------------------------------------


def _mla_inputs(b, s, h, dq, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dq)).astype(np.float32),
            rng.standard_normal((b, s, h, dq)).astype(np.float32),
            rng.standard_normal((b, s, h, dv)).astype(np.float32))


MLA_DIMS = [(48, 32), (192, 128)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("dims", MLA_DIMS, ids=str)
def test_flash_attention_plain_matches_chunked_attention(dims, window, dtype):
    dq, dv = dims
    s = 130  # past one 128-key tile
    q, k, v = _mla_inputs(2, s, 2, dq, dv, seed=dq + window)
    qkv = [_to_torch(t, dtype) for t in (q, k, v)]
    got = flash_attention(*qkv, causal=True, window=window)  # CPU: the plain version
    assert got.shape == (2, s, 2, dv) and got.dtype == qkv[0].dtype
    pos = jnp.arange(s)
    want = chunked_attention(*(_to_jax(t, dtype) for t in (q, k, v)), pos, pos, causal=True,
                             window=window, chunk=BLOCK_K)
    if dtype == "float32":
        _close(got, want, F32_REL, "out")
    else:
        want_t = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))).to(torch.bfloat16)
        result = bf16_contract(want_t, got, *qkv, True, window)
        assert result["ok"], result


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", MLA_DIMS, ids=str)
def test_flash_attention_plain_matches_pallas_with_v_padded(dims, dtype):
    dq, dv = dims
    q, k, v = _mla_inputs(1, 70, 2, dq, dv, seed=dq)
    got = flash_attention_plain(*(_to_torch(t, dtype) for t in (q, k, v)), causal=True)
    v_pad = np.concatenate([v, np.zeros(v.shape[:3] + (dq - dv,), np.float32)], axis=-1)
    want = jax_flash_attention(*(_to_jax(t, dtype) for t in (q, k, v_pad)), causal=True,
                               block_q=64, block_k=64, interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.all(want[..., dv:] == 0)
    _check_fa(got, want[..., :dv], dtype, (q, k, v), True, 0)
