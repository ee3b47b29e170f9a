"""The port's MoE layer and the MoE family (deepseek-moe-16b,
moonshot-v1-16b-a3b, deepseek-v2-lite-16b) against the JAX package's, on
the same weights and inputs.

Reduced configs (2 layers: a dense first layer and one MoE layer, 4
experts top-2, 1 shared expert), float32 and bfloat16, weights carried
over by ``weights.lm_params_from_numpy``.

- ``moe_apply_local`` on the same inputs: the routed expert ids and the
  kept mask exactly (the port's stable descending sort keeps
  ``jax.lax.top_k``'s tie order, and its stable sort by expert gives the
  queue positions of JAX's one-hot cumsum); y and aux within
  ``test_torch_lm.py``'s ``F32_REL`` / ``BF16_REL`` of max.
- The JAX package's two MoE tests repeated on the port
  (``tests/test_layers_extra.py``): capacity and gates, the zero-capacity
  drop.
- End to end, prefill and 4 greedy decode steps (JAX's tokens fed to
  both): logits and caches within those tolerances, every MoE call's
  routed ids equal. In bfloat16 a route can differ where two experts'
  probabilities lie within bf16 rounding of each other: the two packages
  round the MoE input to bf16 at different places (XLA keeps float32
  across fused elementwise ops), 5e-3 to 1.1e-2 of max apart, which flips
  or reorders such a near-tie. ``BF16_ROUTE_FLIPS`` records the flips
  these seeds give (ROADMAP.md queue 3): each must be a near-tie of the
  experts involved (within ``NEAR_TIE`` of each other), and a lane whose
  logit token (the last prompt token at prefill, the step's token at
  decode) flipped is left out of that step's logit comparison; every
  other lane and step holds. In these 2-layer configs the MoE layer is the
  last, so a flip moves no cache.
- The two reference behaviours kept for parity (ROADMAP.md queue 3): the
  capacity is counted over the whole call, so a batch-4 decode step has
  one slot per expert and drops a second token routed to an expert; and a
  request's prefill logits depend on which requests share its prefill.
"""

import dataclasses
import math

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
from repro_torch.weights import lm_params_from_numpy  # noqa: E402
from test_torch_lm import (  # noqa: E402
    BF16_REL,
    F32_REL,
    _assert_same_weights,
    _close,
    _close_caches,
    _jax_layers,
    _np,
    _randn,
    _t,
    _tree,
)

MOE_ARCHS = ["deepseek-moe-16b", "moonshot-v1-16b-a3b", "deepseek-v2-lite-16b"]
DTYPES = ["float32", "bfloat16"]
# (step, token) of every bf16 route that differs from JAX's on these seeds
# (prompt tokens from default_rng(0), weights from PRNGKey(0); "prefill" or
# the decode step; the token's row in the call's flattened batch). Each is a
# near-tie: deepseek-moe and moonshot (the same reduced config) at prefill
# token 9 (experts 0 and 3: 0.2565988 / 0.2564450 in JAX) and 19 (2 and 3
# reordered: 0.2619166 / 0.2625617), decode step 2 lane 0 (0 and 1:
# 0.2242174 / 0.2252678); deepseek-v2-lite decode step 3 lane 1 (1 and 3:
# 0.2469472 / 0.2470589). ROADMAP.md queue 3.
BF16_ROUTE_FLIPS = {
    "deepseek-moe-16b": {("prefill", 9), ("prefill", 19), (2, 0)},
    "moonshot-v1-16b-a3b": {("prefill", 9), ("prefill", 19), (2, 0)},
    "deepseek-v2-lite-16b": {(3, 1)},
}
# a flip is a near-tie: the experts involved within this relative gap of
# probability (the measured flips lie 4.5e-4 to 4.7e-3 apart)
NEAR_TIE = 2.0 ** -6


def _cfgs(arch, dtype="float32", **change):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype, **change)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **change)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _jax_route(p, x, cfg):
    """JAX's routed ids, probabilities and kept mask: the lines of
    ``moe_apply_local`` that compute them."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    probs = jax.nn.softmax(x.reshape(n, d).astype(jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = max(1, int(math.ceil(n * k * cfg.capacity_factor / e)))
    fidx = idx.reshape(-1)
    onehot = jax.nn.one_hot(fidx, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0), fidx[:, None], axis=1)[:, 0] - 1
    return idx, probs, pos < cap


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("change", [{}, dict(n_experts=16, top_k=4), dict(capacity_factor=0.5)],
                         ids=["reduced", "E16-k4", "cf0.5"])
@pytest.mark.parametrize("shape", [(2, 32), (4, 1), (3, 50)], ids=str)
def test_moe_apply_local_matches_jax(shape, change, dtype):
    jcfg, cfg = _cfgs("deepseek-moe-16b", dtype, **change)
    p = JL.init_moe(jax.random.PRNGKey(sum(shape)), jcfg)
    jx = jnp.asarray(_randn(shape + (cfg.d_model,), sum(shape))).astype(dtype)
    jy, jaux = jax.jit(lambda p, x: JL.moe_apply_local(p, x, jcfg))(p, jx)
    jidx, _, jkeep = jax.jit(lambda p, x: _jax_route(p, x, jcfg))(p, jx)
    pt = _tree(p)
    assert pt["router"].dtype == torch.float32 and pt["wg"].dtype == getattr(torch, dtype)
    y, aux = L.moe_apply_local(pt, _t(jx), cfg)
    _, idx, _, _, keep, cap = L.moe_route(pt, _t(jx).reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert cap == max(1, math.ceil(shape[0] * shape[1] * cfg.top_k * cfg.capacity_factor
                                   / cfg.n_experts))
    rel = F32_REL if dtype == "float32" else BF16_REL
    _close(y, jy, rel, "y")
    _close(aux, jaux, F32_REL, "aux")


def test_moe_capacity_and_gates():
    """``tests/test_layers_extra.py::test_moe_capacity_and_gates`` on the
    port: shape kept, the aux loss near 1 (E times near-uniform routing)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    y, aux = L.moe_apply_local(p, x.to(torch.bfloat16), cfg)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert bool(torch.isfinite(aux)) and float(aux) > 0.5
    assert float(aux) < float(cfg.n_experts)
    gate, _, _, _, _, _ = L.moe_route(p, x.reshape(-1, cfg.d_model).to(torch.bfloat16), cfg)
    torch.testing.assert_close(gate.sum(-1), torch.ones(64), rtol=0, atol=1e-6)


def test_moe_zero_capacity_factor_drops_everything():
    """``tests/test_layers_extra.py::test_moe_zero_capacity_factor_drops_everything``
    on the port, and against JAX: one slot per expert, every later route to
    it dropped (zero contribution), the same kept mask and output."""
    jcfg, cfg = _cfgs("deepseek-moe-16b", "bfloat16", capacity_factor=1e-9, n_shared_experts=0)
    p = JL.init_moe(jax.random.PRNGKey(0), jcfg)
    jx = (jax.random.normal(jax.random.PRNGKey(1), (1, 8, cfg.d_model))).astype(jnp.bfloat16)
    jy, _ = JL.moe_apply_local(p, jx, jcfg)
    _, _, jkeep = _jax_route(p, jx, jcfg)
    pt = _tree(p)
    y, _ = L.moe_apply_local(pt, _t(jx), cfg)
    _, idx, _, pos, keep, cap = L.moe_route(pt, _t(jx).reshape(-1, cfg.d_model), cfg)
    assert cap == 1 and bool(torch.isfinite(y.float()).all())
    assert int(keep.sum()) == len(set(idx.reshape(-1).tolist())) < keep.numel()
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert bool((pos[keep] == 0).all())
    _close(y, jy, BF16_REL, "y")


def test_top_k_keeps_the_lower_expert_first_on_ties():
    """Equal probabilities (a zero router): ``jax.lax.top_k`` returns the
    lowest indices in order, and so does the port."""
    jcfg, cfg = _cfgs("deepseek-moe-16b", n_experts=8, top_k=3)
    p = JL.init_moe(jax.random.PRNGKey(0), jcfg)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    jx = jnp.asarray(_randn((1, 5, cfg.d_model), 2))
    jidx, _, _ = _jax_route(p, jx, jcfg)
    _, idx, _, _, _, _ = L.moe_route(_tree(p), _t(jx).reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(np.asarray(jidx), np.tile([0, 1, 2], (5, 1)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("seed", range(4))
def test_queue_positions_are_the_one_hot_cumsum(seed):
    """``moe_route``'s positions, from a stable sort by expert, equal JAX's
    formula (an (N*k, E) one-hot cumsum) on routings with many repeats."""
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), n_experts=6, top_k=3)
    router = torch.from_numpy(rng.standard_normal((cfg.d_model, 6)).astype(np.float32)) * 3
    x = torch.from_numpy(rng.standard_normal((37, cfg.d_model)).astype(np.float32))
    _, idx, _, pos, _, _ = L.moe_route({"router": router}, x, cfg)
    fidx = idx.reshape(-1).numpy()
    onehot = np.eye(6, dtype=np.int64)[fidx]
    want = np.take_along_axis(np.cumsum(onehot, axis=0), fidx[:, None], axis=1)[:, 0] - 1
    np.testing.assert_array_equal(pos.numpy(), want)


def test_moe_init_keeps_the_router_in_float32():
    cfg = get_config("deepseek-moe-16b").reduced()
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    dff = cfg.d_ff_expert
    assert p["router"].dtype == torch.float32 and p["router"].shape == (cfg.d_model, 4)
    assert p["wg"].shape == (4, cfg.d_model, dff) and p["wd"].shape == (4, dff, cfg.d_model)
    assert p["wg"].dtype == torch.bfloat16
    assert {k: v.shape for k, v in p["shared"].items()} == {
        "wg": (cfg.d_model, dff), "wu": (cfg.d_model, dff), "wd": (dff, cfg.d_model)}


# ---------------------------------------------------------------------------
# the MoE family end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(a, d) for a in MOE_ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def moe_lm(request):
    """(cfg, JAX bundle, JAX params, the port's model on the CPU)."""
    arch, dtype = request.param
    jcfg, cfg = _cfgs(arch, dtype)
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    return cfg, bundle, params, lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")


def test_lm_params_from_numpy_carries_the_moe_family(moe_lm):
    """Every leaf bitwise, nested ``moe.shared`` and the float32 router
    included, through the JAX tree's prologue (the dense first layer) and
    stack (the MoE layers)."""
    cfg, _, params, model = moe_lm
    specs = T.layer_specs(cfg)
    assert [s.moe for s in specs] == [False, True] and T.layer_plan(cfg) == (1, 1, 1)
    for i, (blk, jblk) in enumerate(zip(model.blocks, _jax_layers(cfg, params), strict=True)):
        _assert_same_weights(blk, jblk, f"layer {i}")
    moe = model.blocks[1]["moe"]
    assert moe["router"].dtype == torch.float32 and "shared" in moe and "ffn" in model.blocks[0]
    assert moe["shared"]["wg"].shape == (cfg.d_model, cfg.d_ff_expert * cfg.n_shared_experts)


def _routes(monkeypatch):
    """Record every MoE call's routed ids (and JAX's probabilities) in both
    packages: a ``jax.debug.callback`` inside the jitted steps, a wrapper of
    the port's ``moe_route``."""
    jrec, trec = [], []
    jax_local = JL.moe_apply_local

    def jax_wrapped(p, x, cfg):
        idx, probs, _ = _jax_route(p, x, cfg)
        jax.debug.callback(lambda i, pr: jrec.append((np.asarray(i), np.asarray(pr))), idx, probs)
        return jax_local(p, x, cfg)

    port_route = L.moe_route

    def port_wrapped(p, xf, cfg):
        out = port_route(p, xf, cfg)
        trec.append(out[1].numpy())
        return out

    monkeypatch.setattr(JL, "moe_apply_local", jax_wrapped)
    monkeypatch.setattr(L, "moe_route", port_wrapped)
    return jrec, trec


def _flipped(step, jrec, trec, flips) -> set:
    """The tokens of the last MoE call whose routed ids differ between the
    packages, each checked to be a near-tie, added to ``flips``."""
    (jidx, jprobs), tidx = jrec[-1], trec[-1]
    rows = np.flatnonzero((jidx != tidx).any(-1))
    for r in rows:
        cols = jidx[r] != tidx[r]
        p = jprobs[r, np.union1d(jidx[r][cols], tidx[r][cols])]
        assert p.max() - p.min() <= NEAR_TIE * p.max(), (step, r, jidx[r], tidx[r], jprobs[r])
        flips.add((step, int(r)))
    return set(rows.tolist())


def test_moe_family_prefill_and_decode_match_jax(moe_lm, monkeypatch):
    cfg, bundle, params, model = moe_lm
    rel = F32_REL if cfg.dtype == "float32" else BF16_REL
    jrec, trec = _routes(monkeypatch)
    jprefill, jdecode = jax.jit(bundle.make_prefill_step()), jax.jit(bundle.make_decode_step())
    prefill, decode = T.make_prefill_step(cfg), T.make_decode_step(cfg)
    b, s = 2, 16
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(toks)})
    logits, cache = prefill(model, {"tokens": torch.from_numpy(toks)})
    jax.effects_barrier()
    assert len(jrec) == len(trec) == 1
    flips = set()
    rows = _flipped("prefill", jrec, trec, flips)
    lanes = [i for i in range(b) if (i + 1) * s - 1 not in rows]  # whose logit token held
    _close(logits[lanes], np.asarray(jlogits)[lanes], rel, "prefill logits")
    _close_caches(cfg, cache, jcache, rel, "prefill")
    tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    for step in range(4):
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(tok))
        logits, cache = decode(model, cache, torch.from_numpy(tok))
        jax.effects_barrier()
        assert len(jrec) == len(trec) == step + 2
        rows = _flipped(step, jrec, trec, flips)
        lanes = [i for i in range(b) if i not in rows]
        _close(logits[lanes], np.asarray(jlogits)[lanes], rel, f"decode {step} logits")
        _close_caches(cfg, cache, jcache, rel, f"decode {step}")
        tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    assert flips == (BF16_ROUTE_FLIPS[cfg.name] if cfg.dtype == "bfloat16" else set())


def test_moe_family_aux_loss_matches_jax(moe_lm):
    """``forward`` returns the sum of the MoE layers' aux losses (JAX's
    ``aux_total``), no longer a constant 0. In bfloat16 the router sees the
    MoE input as each package rounded it (see above), so the aux loss is
    held to ``BF16_REL``."""
    from repro.models import transformer as JT

    cfg, bundle, params, model = moe_lm
    jcfg = bundle.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    _, _, jaux = jax.jit(lambda p, t: JT.forward(p, jcfg, t, mode="prefill", remat=False))(
        params, jnp.asarray(toks))
    _, _, aux = T.forward(model, cfg, torch.from_numpy(toks), mode="prefill")
    assert float(aux) > 0.5
    _close(aux, jaux, F32_REL if cfg.dtype == "float32" else BF16_REL, "aux")


@pytest.mark.parametrize("n_layers,moe_every", [(4, 2), (5, 2), (3, 1)])
def test_lm_params_from_numpy_follows_the_layer_plan(n_layers, moe_every):
    """A period of 2 (MoE every other layer) and a ragged tail folded into
    the prologue: layer ``len(prologue) + i * p + j`` is stack entry j at
    index i, and the carried model's prefill matches JAX's."""
    jcfg, cfg = _cfgs("deepseek-moe-16b", n_layers=n_layers, moe_every=moe_every)
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(3))
    n_pro, p, n_periods = T.layer_plan(cfg)
    assert (len(params["prologue"]), len(params["stack"])) == (n_pro, p if n_periods else 0)
    model = lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    assert [("moe" in b) for b in model.blocks] == [cfg.is_moe_layer(i) for i in range(n_layers)]
    for i, (blk, jblk) in enumerate(zip(model.blocks, _jax_layers(cfg, params), strict=True)):
        _assert_same_weights(blk, jblk, f"layer {i}")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jlogits, _ = jax.jit(bundle.make_prefill_step())(params, {"tokens": jnp.asarray(toks)})
    logits, _ = T.make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(toks)})
    _close(logits, jlogits, F32_REL, "prefill logits")


def test_lm_params_from_numpy_rejects_another_layout():
    jcfg, cfg = _cfgs("deepseek-moe-16b")
    params = jax.device_get(jax_get_model(jcfg).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="prologue"):
        lm_params_from_numpy(cfg, dict(params, prologue=[]), device="cpu")


# ---------------------------------------------------------------------------
# reference behaviours kept for parity (ROADMAP.md queue 3)
# ---------------------------------------------------------------------------


def _one_expert_router(cfg, expert):
    """A router that sends every token to ``expert`` first (and the next
    experts by index after it)."""
    r = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    r[:, expert] = 1.0
    return r


def test_decode_step_capacity_is_one_slot_per_expert():
    """deepseek-moe-16b at full width: a batch-4 decode step routes N = 4
    tokens, so each expert has ceil(4 * 6 * 1.25 / 64) = 1 slot. Reduced
    (4 experts top-2): ceil(4 * 2 * 1.25 / 4) = 3. When all 4 tokens pick
    the same experts, only the first 3 (full width: the first 1) are kept,
    in both packages."""
    full = get_config("deepseek-moe-16b")
    assert max(1, math.ceil(4 * full.top_k * full.capacity_factor / full.n_experts)) == 1
    jcfg, cfg = _cfgs("deepseek-moe-16b", n_shared_experts=0)
    p = JL.init_moe(jax.random.PRNGKey(0), jcfg)
    x = np.abs(_randn((4, 1, cfg.d_model), 5))  # positive, so the router's column 0 wins
    p = dict(p, router=jnp.asarray(_one_expert_router(cfg, 0)))
    jy, _ = JL.moe_apply_local(p, jnp.asarray(x), jcfg)
    _, _, jkeep = _jax_route(p, jnp.asarray(x), jcfg)
    pt = _tree(p)
    y, _ = L.moe_apply_local(pt, _t(x), cfg)
    _, idx, _, _, keep, cap = L.moe_route(pt, _t(x).reshape(4, -1), cfg)
    assert cap == 3 and bool((idx[:, 0] == 0).all())
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert keep.reshape(4, 2)[:, 0].tolist() == [True, True, True, False]
    _close(y, jy, F32_REL, "y")
    assert float(y[3].abs().max()) < float(y[0].abs().max())  # token 3 lost its first expert


def test_a_requests_prefill_depends_on_its_batch():
    """The capacity is counted over every token of the call, and the
    routes queue in token-major order, so what a request's tokens keep
    depends on the requests ahead of it in the prefill: request A's prefill
    logits differ when B or C goes first, in both packages (which agree on
    each)."""
    jcfg, cfg = _cfgs("deepseek-moe-16b", capacity_factor=0.5)
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    rng = np.random.default_rng(4)
    a, b, c = (rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32) for _ in range(3))
    jprefill, prefill = jax.jit(bundle.make_prefill_step()), T.make_prefill_step(cfg)
    got = {}
    for name, other in (("BA", b), ("CA", c)):
        toks = np.concatenate([other, a])
        jlogits, _ = jprefill(params, {"tokens": jnp.asarray(toks)})
        logits, _ = prefill(model, {"tokens": torch.from_numpy(toks)})
        _close(logits, jlogits, F32_REL, name)
        got[name] = logits[1]
    gap = float((got["BA"] - got["CA"]).abs().max()) / float(got["BA"].abs().max())
    assert gap > 1e-3, gap
