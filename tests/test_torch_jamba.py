"""The port's hybrid stack, jamba-v0.1-52b (Mamba-1 and GQA layers, each
followed by a dense SwiGLU or an MoE with no shared experts), against the
JAX package's, on the same weights and inputs.

Reduced config: one full period of 8 layers (attention at index 4, MoE on
the odd layers), d_model 256, d_state 8, 4 experts top-2, no shared
experts; float32 and bfloat16, the JAX weights carried over by
``weights.lm_params_from_numpy`` (the JAX tree: no prologue, one stack
entry per position of the period, each with a leading axis of 1 period).

- Every leaf bitwise, the Mamba blocks' ``norm2`` with ``moe`` or ``ffn``
  included; falcon-mamba (``d_ff = 0``) keeps Mamba blocks without an FFN.
- The MoE layer at jamba's config (no ``shared`` subtree): routed ids and
  kept masks exactly, y and aux within 1e-5 / 2^-5 of max.
- Prefill and 4 greedy decode steps (JAX's tokens fed to both): logits and
  every layer's cache, the Mamba ``{conv, ssm}`` caches beside the
  attention layer's ``{k, v, kv_pos}``, within 2^-8 of max in float32
  (after a Mamba scan: one bf16 rounding flip of a scan input moves a
  value by 2^-8 of it; ``tests/test_torch_lm.py``) and 2^-5 in bf16;
  every MoE call's routed ids equal on these seeds (in bf16 a near-tie may
  flip: ``BF16_ROUTE_FLIPS`` records the flips these seeds give, none).
- The continuous-batching decode loop (``DecodeProgram`` under
  ``ContinuousBatcher``) gives the JAX loop's tokens on the reduced
  float32 config.
- A prefill that continues a carried cache (jamba and falcon-mamba, float32)
  against JAX's ``forward(..., cache=, mode="prefill")``: the Mamba layers'
  conv and scan from the carried state, jamba's attention restarting its
  cache as JAX's does; logits and caches within 2^-8 of max; falcon-mamba's
  two chunks give the whole prefill's last logits and caches.
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
from repro.models.api import make_concrete_batch as jax_make_concrete_batch  # noqa: E402
from repro.serve import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serve import DecodeProgram as JaxDecodeProgram  # noqa: E402
from repro.serve import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.serve import ContinuousBatcher, DecodeProgram, ServeRequest  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402
from test_torch_lm import (  # noqa: E402
    BF16_REL,
    F32_REL,
    SCAN_REL,
    _assert_same_weights,
    _close,
    _close_caches,
    _jax_layers,
    _randn,
    _t,
    _tree,
)
from test_torch_moe import _flipped, _jax_route, _routes  # noqa: E402

ARCH = "jamba-v0.1-52b"
DTYPES = ["float32", "bfloat16"]
REL = {"float32": SCAN_REL, "bfloat16": BF16_REL}
# (step, token) of every bf16 route that differs from JAX's on these seeds
# (prompt tokens from default_rng(0), weights from PRNGKey(0)): none
BF16_ROUTE_FLIPS: set = set()
KINDS = ["mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"]


def _cfgs(dtype="float32", arch=ARCH):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


@pytest.fixture(scope="module", params=DTYPES)
def jamba(request):
    """(cfg, JAX bundle, JAX params, the port's model on the CPU)."""
    jcfg, cfg = _cfgs(request.param)
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    return cfg, bundle, params, lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")


def test_layer_plan_is_one_period_of_mamba_attention_and_moe():
    _, cfg = _cfgs()
    specs = T.layer_specs(cfg)
    assert [s.kind for s in specs] == KINDS
    assert [s.moe for s in specs] == [i % 2 == 1 for i in range(8)]
    assert T.layer_plan(cfg) == (0, 8, 1) and cfg.n_shared_experts == 0
    full = get_config(ARCH)
    assert T.layer_plan(full) == (0, 8, 4)
    assert [s.kind for s in T.layer_specs(full)] == KINDS * 4


def test_lm_params_from_numpy_carries_the_hybrid_stack(jamba):
    """Every leaf bitwise, dtype included: a Mamba block's ``norm2`` with
    ``moe`` (odd layers) or ``ffn``, the attention block's, and no
    ``shared`` experts."""
    cfg, _, params, model = jamba
    assert len(params["prologue"]) == 0 and len(params["stack"]) == 8
    for i, (blk, jblk) in enumerate(zip(model.blocks, _jax_layers(cfg, params), strict=True)):
        _assert_same_weights(blk, jblk, f"layer {i}")
        assert "norm2" in blk and ("moe" in blk) == (i % 2 == 1) and ("ffn" in blk) != ("moe" in blk)
        if "moe" in blk:
            assert "shared" not in blk["moe"] and blk["moe"]["router"].dtype == torch.float32
    assert set(model.blocks[4]["mixer"].keys()) == {"wq", "wk", "wv", "wo"}
    assert "A_log" in model.blocks[3]["mixer"]


@pytest.mark.parametrize("arch", [ARCH, "falcon-mamba-7b"])
def test_init_params_gives_mamba_blocks_an_ffn_only_where_jax_does(arch):
    """jamba's Mamba blocks get ``norm2`` and an MoE or a dense SwiGLU, as
    JAX's ``init_block`` gives them; falcon-mamba (``d_ff = 0``, no MoE)
    keeps its Mamba blocks without an FFN, in both packages."""
    jcfg, cfg = _cfgs(arch=arch)
    want = _jax_layers(cfg, jax.device_get(jax_get_model(jcfg).init(jax.random.PRNGKey(1))))
    model = T.init_params(torch.Generator().manual_seed(1), cfg)
    for i, (blk, jblk) in enumerate(zip(model.blocks, want, strict=True)):
        assert sorted(blk.keys()) == sorted(jblk), (i, blk.keys(), list(jblk))
        for name in ("moe", "ffn"):
            if name in blk:
                for leaf, value in blk[name].items():
                    assert tuple(value.shape) == jblk[name][leaf].shape, (i, name, leaf)
                    assert str(value.dtype).removeprefix("torch.") == jblk[name][leaf].dtype.name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16), (4, 1)], ids=str)
def test_moe_without_shared_experts_matches_jax(shape, dtype):
    jcfg, cfg = _cfgs(dtype)
    p = JL.init_moe(jax.random.PRNGKey(sum(shape)), jcfg)
    assert "shared" not in p
    jx = jnp.asarray(_randn(shape + (cfg.d_model,), sum(shape))).astype(dtype)
    jy, jaux = jax.jit(lambda p, x: JL.moe_apply_local(p, x, jcfg))(p, jx)
    jidx, _, jkeep = jax.jit(lambda p, x: _jax_route(p, x, jcfg))(p, jx)
    pt = _tree(p)
    y, aux = L.moe_apply_local(pt, _t(jx), cfg)
    _, idx, _, _, keep, _ = L.moe_route(pt, _t(jx).reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    rel = F32_REL if dtype == "float32" else BF16_REL
    _close(y, jy, rel, "y")
    _close(aux, jaux, rel, "aux")


def test_prefill_and_decode_match_jax(jamba, monkeypatch):
    """Prefill and 4 greedy decode steps: logits and every layer's cache
    (Mamba and attention side by side) within ``REL``, every MoE call's
    routes equal."""
    cfg, bundle, params, model = jamba
    rel = REL[cfg.dtype]
    jrec, trec = _routes(monkeypatch)
    jprefill, jdecode = jax.jit(bundle.make_prefill_step()), jax.jit(bundle.make_decode_step())
    prefill, decode = T.make_prefill_step(cfg), T.make_decode_step(cfg)
    b, s = 2, 16
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(toks)})
    logits, cache = prefill(model, {"tokens": torch.from_numpy(toks)})
    jax.effects_barrier()
    n_moe = cfg.n_layers // 2
    assert len(jrec) == len(trec) == n_moe
    flips = set()
    for _ in range(n_moe):  # each MoE layer's call, in order
        _flipped("prefill", [jrec.pop(0)], [trec.pop(0)], flips)
    assert [sorted(c) for c in cache["layers"]] == [
        ["k", "kv_pos", "v"] if k == "attn" else ["conv", "ssm"] for k in KINDS]
    _close(logits, jlogits, rel, "prefill logits")
    _close_caches(cfg, cache, jcache, rel, "prefill")
    tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    for step in range(4):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        logits, cache = decode(model, cache, torch.from_numpy(tok))
        jax.effects_barrier()
        assert len(jrec) == len(trec) == n_moe
        for _ in range(n_moe):
            _flipped(step, [jrec.pop(0)], [trec.pop(0)], flips)
        _close(logits, jlogits, rel, f"decode {step} logits")
        _close_caches(cfg, cache, jcache, rel, f"decode {step}")
        tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    assert flips == (BF16_ROUTE_FLIPS if cfg.dtype == "bfloat16" else set())


def test_decode_step_updates_both_cache_kinds():
    """A decode step writes the attention layer's cache in place (slot
    ``min(pos, T - 1)``, JAX's clamp) and carries every Mamba layer's
    state forward: new ``conv`` and ``ssm`` values, the attention cache the
    same tensors."""
    _, cfg = _cfgs()
    model = T.init_params(torch.Generator().manual_seed(2), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    logits, cache = T.make_prefill_step(cfg)(model, {"tokens": toks})
    before = [{k: v.clone() for k, v in c.items()} for c in cache["layers"]]
    attn = cache["layers"][4]
    k_ptr = attn["k"].data_ptr()
    _, cache = T.make_decode_step(cfg)(model, cache, logits.argmax(-1)[:, None])
    assert cache["pos"] == 13 and cache["layers"][4] is attn and attn["k"].data_ptr() == k_ptr
    np.testing.assert_array_equal(attn["kv_pos"].numpy(), list(range(11)) + [12])
    for i, (old, new) in enumerate(zip(before, cache["layers"])):
        for name, value in old.items():
            if name == "kv_pos":
                continue
            assert not torch.equal(value, new[name]), (i, name)


def test_decode_program_matches_jax():
    """``DecodeProgram`` under ``ContinuousBatcher`` on the reduced float32
    jamba: 5 requests on 2 lanes (backfills re-prefill the joined batch),
    the same tokens per request, ``tokens_out`` and ``prefill_calls`` as
    JAX's loop, but where a reference top-2 margin is a near tie within
    the logits contract (the runs then part at that call)."""
    jcfg, cfg = _cfgs()
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    requests, batch, prompt_len, max_new = 5, 2, 16, 5
    prompts = np.asarray(jax_make_concrete_batch(jcfg, "prefill", requests, prompt_len,
                                                 jax.random.PRNGKey(1))["tokens"])
    jlog, tlog = [], []

    def recorded(fn, into):
        def call(*args):
            out = fn(*args)
            into.append(np.asarray(out[0].numpy() if isinstance(out[0], torch.Tensor) else out[0]))
            return out
        return call

    jprog = JaxDecodeProgram(recorded(jax.jit(bundle.make_prefill_step()), jlog),
                             recorded(jax.jit(bundle.make_decode_step()), jlog), params, batch,
                             prompt_len, eos_id=cfg.eos_token_id, rng=jax.random.PRNGKey(2))
    jres = JaxBatcher(jprog, batch).run(
        [JaxRequest(rid=i, client_id=i, inputs=prompts[i], steps=max_new) for i in range(requests)])
    tb = get_model(cfg)
    tprog = DecodeProgram(recorded(tb.make_prefill_step(), tlog), recorded(tb.make_decode_step(), tlog),
                          model, batch, prompt_len, eos_id=cfg.eos_token_id, rng=prng.PRNGKey(2))
    tres = ContinuousBatcher(tprog, batch).run(
        [ServeRequest(rid=i, client_id=i, inputs=prompts[i], steps=max_new) for i in range(requests)])
    assert tprog.prefill_calls >= 3
    for i, (jl, tl) in enumerate(zip(jlog, tlog)):
        _close(tl, jl, SCAN_REL, f"call {i} logits")
        lanes = np.nonzero(jl.argmax(-1) != tl.argmax(-1))[0]
        if lanes.size:  # a near tie of the reference: the runs part here
            top2 = np.sort(jl[lanes], axis=-1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0]).max() < SCAN_REL * np.abs(jl).max(), (i, lanes)
            return
    by_rid = lambda rs: {r.rid: (list(r.output), r.steps) for r in rs}  # noqa: E731
    assert by_rid(tres) == by_rid(jres)
    assert (tprog.tokens_out, tprog.prefill_calls) == (jprog.tokens_out, jprog.prefill_calls)


@pytest.mark.parametrize("arch", [ARCH, "falcon-mamba-7b"])
def test_prefill_from_a_carried_cache_matches_jax(arch):
    """A prefill that continues a cache (``forward(..., cache=,
    mode="prefill")``, float32): each Mamba layer's conv and scan start from
    the carried state (the scan kernel's start state ``h0``), each attention
    layer restarts its cache, as JAX's layers do; the second chunk's logits
    and every layer's cache within 2^-8 of max of JAX's. For falcon-mamba
    (no attention) the two chunks give the whole prefill's last logits and
    final caches."""
    from repro.models import transformer as JT

    jcfg, cfg = _cfgs("float32", arch)
    params = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    jfwd = jax.jit(lambda p, t, c: JT.forward(p, jcfg, t, cache=c, mode="prefill")[:2])
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    first, second = toks[:, :10], toks[:, 10:]
    _, jcache = jfwd(params, jnp.asarray(first), None)
    jlogits, jcache = jfwd(params, jnp.asarray(second), jcache)
    _, cache, _ = T.forward(model, cfg, torch.from_numpy(first), mode="prefill")
    logits, cache, _ = T.forward(model, cfg, torch.from_numpy(second), cache=cache,
                                 mode="prefill")
    _close(logits, jlogits, SCAN_REL, "second prefill logits")
    _close_caches(cfg, cache, jcache, SCAN_REL, "second prefill")
    assert cache["pos"] == second.shape[1]
    if arch == "falcon-mamba-7b":
        whole, wcache, _ = T.forward(model, cfg, torch.from_numpy(toks), mode="prefill")
        _close(logits[:, -1], whole[:, -1], SCAN_REL, "chunked vs whole logits")
        for got, want in zip(cache["layers"], wcache["layers"]):
            for name in ("conv", "ssm"):
                _close(got[name], want[name], SCAN_REL, f"chunked vs whole {name}")
