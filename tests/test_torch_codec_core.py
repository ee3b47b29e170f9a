"""The port's codec and core modules against the JAX package's, on the same
numpy-made inputs and keys.

Contracts: ``ef_step``/``roundtrip_tree`` bitwise for float32, int8, int4
(and top-k chains) under the same key, for one client and for a (K, ...)
lane batch against JAX's vmap; selection masks identical for every
strategy on tie-heavy observations; the layer-sharing, decay and
personalization functions exact; the aggregators within 2 ulp of the mean's
magnitude scale (another client-sum order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.comm import codec as jcodec  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import decay as jdecay  # noqa: E402
from repro.core import layersharing as jls  # noqa: E402
from repro.core import personalization as jpers  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.comm import codec as tcodec  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import decay as tdecay  # noqa: E402
from repro_torch.core import layersharing as tls  # noqa: E402
from repro_torch.core import personalization as tpers  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402

CODECS = ["float32", "int8", "int4", "topk", "topk+int8"]


def _np(t):
    return t.detach().cpu().numpy()


def _layer(rng, k=None, fan_in=37, fan_out=11):
    lead = () if k is None else (k,)
    return {
        "w": rng.standard_normal(lead + (fan_in, fan_out)).astype(np.float32) * 0.1,
        "b": rng.standard_normal(lead + (fan_out,)).astype(np.float32) * 0.01,
    }


def _tree_t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _tree_j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("spec", CODECS)
@pytest.mark.parametrize("seed", [0, 5])
def test_ef_step_single_client_bitwise(spec, seed):
    rng = np.random.default_rng(seed)
    delta, res = _layer(rng), _layer(rng)
    dj, rj = jcodec.ef_step(jcodec.make_codec(spec, topk_fraction=0.3), _tree_j(delta),
                            _tree_j(res), jax.random.PRNGKey(seed))
    dt, rt = tcodec.ef_step(tcodec.make_codec(spec, topk_fraction=0.3), _tree_t(delta),
                            _tree_t(res), prng.PRNGKey(seed))
    for k in ("w", "b"):
        np.testing.assert_array_equal(_np(dt[k]), np.asarray(dj[k]))
        np.testing.assert_array_equal(_np(rt[k]), np.asarray(rj[k]))


@pytest.mark.parametrize("spec", CODECS)
def test_ef_step_lane_batch_equals_jax_vmap(spec):
    """All K lanes of a layer in one call, one key per lane — what the
    transmit phase does — equals JAX's vmap over clients."""
    rng = np.random.default_rng(7)
    k = 6
    delta, res = _layer(rng, k), _layer(rng, k)
    codec_j = jcodec.make_codec(spec, topk_fraction=0.3)
    keys_j = jax.random.split(jax.random.PRNGKey(3), k)
    dj, rj = jax.vmap(lambda d, e, key: jcodec.ef_step(codec_j, d, e, key))(
        _tree_j(delta), _tree_j(res), keys_j)
    dt, rt = tcodec.ef_step(tcodec.make_codec(spec, topk_fraction=0.3), _tree_t(delta),
                            _tree_t(res), prng.split(prng.PRNGKey(3), k))
    for name in ("w", "b"):
        np.testing.assert_array_equal(_np(dt[name]), np.asarray(dj[name]))
        np.testing.assert_array_equal(_np(rt[name]), np.asarray(rj[name]))


@pytest.mark.parametrize("spec", CODECS)
def test_roundtrip_tree_and_wire_bytes(spec):
    rng = np.random.default_rng(1)
    tree = [_layer(rng), _layer(rng, fan_in=11, fan_out=3)]
    cj, ct = jcodec.make_codec(spec, topk_fraction=0.3), tcodec.make_codec(spec, topk_fraction=0.3)
    oj = jcodec.roundtrip_tree(cj, [_tree_j(t) for t in tree], jax.random.PRNGKey(9))
    ot = tcodec.roundtrip_tree(ct, [_tree_t(t) for t in tree], prng.PRNGKey(9))
    for lj, lt in zip(oj, ot):
        for name in ("w", "b"):
            np.testing.assert_array_equal(_np(lt[name]), np.asarray(lj[name]))
    assert tcodec.tree_wire_bytes(ct, [_tree_t(t) for t in tree]) == \
        jcodec.tree_wire_bytes(cj, [_tree_j(t) for t in tree])


@pytest.mark.parametrize("n", [1, 2, 7, 256, 1001])
def test_pack_nibbles_round_trip_and_layout(n):
    rng = np.random.default_rng(n)
    q = rng.integers(-7, 8, (3, n)).astype(np.int8)
    packed = tcodec._pack_nibbles(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape == (3, (n + 1) // 2)
    for r in range(3):
        np.testing.assert_array_equal(_np(packed[r]), np.asarray(jcodec._pack_nibbles(jnp.asarray(q[r]))))
    np.testing.assert_array_equal(_np(tcodec._unpack_nibbles(packed, n)), q)


# ---------------------------------------------------------------------------
# selection on tie-heavy observations
# ---------------------------------------------------------------------------

STRATEGIES = ["fedavg", "poc", "oort", "deev", "acsp-fl", "grad-importance", "oort-wire", "oort-fair"]


def _observations(c, seed):
    rng = np.random.default_rng(seed)
    levels = np.asarray([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)
    return dict(
        accuracy=rng.choice(levels, c),                       # many exact ties
        loss=rng.choice(levels * 2.0, c),
        n_samples=rng.choice([60.0, 75.0, 90.0], c).astype(np.float32),
        delay=rng.uniform(0.5, 2.0, c).astype(np.float32),
        wire_bytes=rng.choice([100.0, 400.0], c).astype(np.float32),
        update_norm=rng.choice([0.5, 1.0, 2.0], c).astype(np.float32),
        participation_count=rng.integers(0, 4, c).astype(np.int32),
    )


@pytest.mark.parametrize("name", STRATEGIES)
@pytest.mark.parametrize("c", [8, 30])
def test_selection_masks_identical(name, c):
    for seed in range(3):
        obs = _observations(c, seed)
        oj = jsel.ClientObservations(**{k: jnp.asarray(v) for k, v in obs.items()})
        ot = tsel.ClientObservations(**{k: torch.from_numpy(v) for k, v in obs.items()})
        sj, st = jsel.get_strategy(name, fraction=0.5), tsel.get_strategy(name, fraction=0.5)
        for t in (0, 7, 40):
            mj = np.asarray(sj.select(oj, jnp.asarray(t), jax.random.PRNGKey(seed + t)))
            mt = _np(st.select(ot, t, prng.PRNGKey(seed + t)))
            assert (mj == mt).all(), (name, seed, t, mj, mt)


@pytest.mark.parametrize("k", [3, 8, 12])
def test_cohort_from_mask_stable(k):
    mask = np.asarray([0, 1, 1, 0, 1, 0, 0, 1, 1, 0], bool)
    cj = jsel.cohort_from_mask(jnp.asarray(mask), k)
    ct = tsel.cohort_from_mask(torch.from_numpy(mask), k)
    np.testing.assert_array_equal(_np(ct.idx), np.asarray(cj.idx))
    np.testing.assert_array_equal(_np(ct.valid), np.asarray(cj.valid))


def test_phi_decay_exact():
    for size in (0, 1, 7, 30):
        for t in (0, 1, 5, 100, 1000):
            for decay in (0.0, 0.005, 0.1, 0.5):
                assert int(tdecay.phi_decay(size, t, decay)) == int(jdecay.phi_decay(size, t, decay))


# ---------------------------------------------------------------------------
# layer sharing, personalization, aggregation
# ---------------------------------------------------------------------------


def test_dynamic_layer_definition_and_share_mask():
    acc = np.asarray([0.0, 0.1, 0.25, 0.26, 1 / 3, 0.34, 0.5, 0.51, 0.99, 1.0], np.float32)
    pj = np.array(jls.dynamic_layer_definition(jnp.asarray(acc), 4))
    pt = _np(tls.dynamic_layer_definition(torch.from_numpy(acc), 4))
    np.testing.assert_array_equal(pt, pj)
    assert pt.dtype == np.int32
    np.testing.assert_array_equal(_np(tls.layer_share_mask(4, torch.from_numpy(pj))),
                                  np.asarray(jls.layer_share_mask(4, jnp.asarray(pj))))
    np.testing.assert_array_equal(_np(tls.layer_share_mask(4, torch.tensor(2))),
                                  np.asarray(jls.layer_share_mask(4, 2)))


def _layered(rng, k=None):
    return [_layer(rng, k, 9, 5), _layer(rng, k, 5, 5), _layer(rng, k, 5, 3)]


def test_compose_model_and_personalize_ft_exact():
    rng = np.random.default_rng(4)
    g, loc = _layered(rng), _layered(rng, 6)
    share = rng.random((6, 3)) < 0.5
    cj = jpers.compose_model([_tree_j(t) for t in g], [_tree_j(t) for t in loc], jnp.asarray(share))
    ct = tpers.compose_model([_tree_t(t) for t in g], [_tree_t(t) for t in loc], torch.from_numpy(share))
    for lj, lt in zip(cj, ct):
        for name in ("w", "b"):
            np.testing.assert_array_equal(_np(lt[name]), np.asarray(lj[name]))
    ll = rng.choice([0.5, 1.0], 6).astype(np.float32)
    lg = rng.choice([0.5, 1.0], 6).astype(np.float32)
    fj = jpers.personalize_ft([_tree_j(t) for t in loc], [_tree_j(t) for t in g],
                              jnp.asarray(ll), jnp.asarray(lg))
    ft = tpers.personalize_ft([_tree_t(t) for t in loc], [_tree_t(t) for t in g],
                              torch.from_numpy(ll), torch.from_numpy(lg))
    for lj, lt in zip(fj, ft):
        for name in ("w", "b"):
            np.testing.assert_array_equal(_np(lt[name]), np.asarray(lj[name]))


def _close(got, want, x, w):
    scale = (np.abs(x.reshape(x.shape[0], -1)) * w[:, None]).sum(0) / max(w.sum(), 1e-12)
    tol = 2 * np.spacing(np.maximum(scale, np.finfo(np.float32).tiny).astype(np.float32))
    assert (np.abs(got.reshape(-1) - want.reshape(-1)) <= tol).all()


def test_fedavg_and_masked_partial_aggregate_close():
    rng = np.random.default_rng(8)
    stacked, prev = _layered(rng, 8), _layered(rng)
    sel = np.asarray([1, 0, 1, 1, 0, 1, 1, 0], bool)
    n = rng.integers(60, 90, 8).astype(np.float32)
    share = np.array(jls.layer_share_mask(3, jnp.asarray([3, 1, 2, 3, 1, 1, 2, 3])))
    share[:, 2] = False  # nobody shares the head: it keeps the previous global
    sj = [_tree_j(t) for t in stacked]
    st = [_tree_t(t) for t in stacked]
    fj = jagg.fedavg_aggregate(sj, jnp.asarray(sel), jnp.asarray(n))
    ft = tagg.fedavg_aggregate(st, torch.from_numpy(sel), torch.from_numpy(n))
    w = sel * n
    for j in range(3):
        for name in ("w", "b"):
            _close(_np(ft[j][name]), np.asarray(fj[j][name]), stacked[j][name], w)
    mj = jagg.masked_partial_aggregate(sj, [_tree_j(t) for t in prev], jnp.asarray(sel),
                                       jnp.asarray(n), jnp.asarray(share))
    mt = tagg.masked_partial_aggregate(st, [_tree_t(t) for t in prev], torch.from_numpy(sel),
                                       torch.from_numpy(n), torch.from_numpy(share))
    for j in range(3):
        for name in ("w", "b"):
            _close(_np(mt[j][name]), np.asarray(mj[j][name]), stacked[j][name], w * share[:, j])
    for name in ("w", "b"):
        np.testing.assert_array_equal(_np(mt[2][name]), prev[2][name])


def test_guard_and_transmitted_parameters():
    norm = np.asarray([1.0, np.nan, np.inf, 2.0], np.float32)
    sel = np.asarray([1, 1, 0, 1], bool)
    okj, nj = jagg.finite_update_guard(jnp.asarray(sel), jnp.asarray(norm))
    okt, nt = tagg.finite_update_guard(torch.from_numpy(sel), torch.from_numpy(norm))
    np.testing.assert_array_equal(_np(okt), np.asarray(okj))
    assert int(nt) == int(nj) == 1
    share = np.array(jls.layer_share_mask(3, jnp.asarray([3, 1, 2, 3])))
    sizes = [50, 30, 18]
    tj = jagg.transmitted_parameters(jnp.asarray(sel), jnp.asarray(share), jnp.asarray(sizes))
    tt = tagg.transmitted_parameters(torch.from_numpy(sel), torch.from_numpy(share), sizes)
    assert float(tt) == float(tj)


def test_sharded_or_edge_aggregation_raises():
    """The sharded reduction (``axis_name``) takes the port's cohort mesh:
    a JAX-style axis name string raises, a world-1 mesh computes the flat
    mean bit for bit (tests/test_torch_shard.py holds larger worlds); the
    edge reduction computes, and equals its plain version (tests/
    test_torch_edge.py holds it to JAX's)."""
    from repro_torch.kernels.masked_aggregate import masked_aggregate_plain
    from repro_torch.launch.mesh import make_cohort_mesh

    x = [{"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}]
    sel, n = torch.ones(2, dtype=torch.bool), torch.tensor([3.0, 5.0])
    with pytest.raises(TypeError, match="CohortMesh"):
        tagg.fedavg_aggregate(x, sel, n, axis_name="cohort")
    mesh = make_cohort_mesh(1, device="cpu")
    try:
        got = tagg.fedavg_aggregate(x, sel, n, axis_name=mesh)
    finally:
        mesh.close()
    assert torch.equal(got[0]["w"], tagg.fedavg_aggregate(x, sel, n)[0]["w"])
    ids = torch.tensor([1, 0], dtype=torch.int32)
    got = tagg.fedavg_aggregate(x, sel, n, edge_ids=ids, n_edges=2)
    want = masked_aggregate_plain(x[0]["w"], n, edge_ids=ids, n_edges=2)
    assert torch.equal(got[0]["w"], want)
    torch.testing.assert_close(got[0]["w"], (3.0 * x[0]["w"][0] + 5.0 * x[0]["w"][1]) / 8.0)
