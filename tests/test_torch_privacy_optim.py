"""``core/privacy`` and ``optim`` of the port against the JAX package's on
seeded numpy trees.

Tolerances, with their reasons:

- privacy: a leaf that clipping leaves alone (norm under the radius) is
  bitwise JAX's, and so are the unclipped clients of
  ``clip_client_updates``. Where the scale is below 1 the clipped leaves
  are within 4 float32 ulp: the float32 sum of squares behind the norm is
  reduced in torch's order, not XLA's, so the norm may differ in its last
  bits (norms within rtol 1e-6). Noise goes through ``erfinv``, whose
  float32 XLA and port implementations differ by a few ulp: within 1e-6 of
  the noise scale.
- optim: 20 steps on the same gradients, updates and parameters within
  rtol 1e-5 / atol 1e-7: the float32 reductions (global norm) and ``pow``
  / ``cos`` / ``sqrt`` of the two libraries may differ in the last bit,
  and 20 steps compound it.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.core import privacy as jax_privacy  # noqa: E402
from repro.optim import optim as jax_optim  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.core import privacy  # noqa: E402
from repro_torch.optim import optim  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _tree(rng, lead=(), scale=1.0):
    return [{"w": (rng.standard_normal(lead + (7, 5)) * scale).astype(np.float32),
             "b": (rng.standard_normal(lead + (5,)) * scale).astype(np.float32)},
            {"w": (rng.standard_normal(lead + (5, 3)) * scale).astype(np.float32)}]


def _t(tree):
    return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()} for layer in tree]


def _j(tree):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in tree]


def _leaves_np(tree, jax_tree=False):
    if jax_tree:
        return [np.asarray(x) for x in jax.tree.leaves(tree)]
    return [x.numpy() for x in tree_leaves(tree)]


def _ulp(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("clip", [100.0, 0.5])
def test_clip_update_matches_jax(clip):
    rng = np.random.default_rng(0)
    delta = _tree(rng)
    got, gnorm = privacy.clip_update(_t(delta), clip)
    want, wnorm = jax_privacy.clip_update(_j(delta), clip)
    np.testing.assert_allclose(gnorm.numpy(), np.asarray(wnorm), rtol=1e-6)
    for g, w in zip(_leaves_np(got), _leaves_np(want, True)):
        if float(wnorm) <= clip:
            np.testing.assert_array_equal(g, w)  # scale 1: untouched
        else:
            assert _ulp(g, w) <= 4


def test_clip_client_updates_matches_jax():
    rng = np.random.default_rng(1)
    deltas = _tree(rng, lead=(6,))
    # clients 0-2 inside the ball, 3-5 clipped
    for layer in deltas:
        for v in layer.values():
            v[:3] *= 0.01
    got, gn = privacy.clip_client_updates(_t(deltas), 1.0)
    want, wn = jax_privacy.clip_client_updates(_j(deltas), 1.0)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-6)
    assert (np.asarray(wn)[:3] < 1.0).all() and (np.asarray(wn)[3:] > 1.0).all()
    for g, w in zip(_leaves_np(got), _leaves_np(want, True)):
        np.testing.assert_array_equal(g[:3], w[:3])
        assert _ulp(g[3:], w[3:]) <= 4


def test_add_gaussian_noise_matches_jax():
    rng = np.random.default_rng(2)
    tree, sigma = _tree(rng), 0.3
    for partitionable in (False, True):
        with jax.threefry_partitionable(partitionable), prng.threefry_partitionable(partitionable):
            got = privacy.add_gaussian_noise(_t(tree), prng.PRNGKey(7), sigma)
            want = jax_privacy.add_gaussian_noise(_j(tree), jax.random.PRNGKey(7), sigma)
        for g, w, x in zip(_leaves_np(got), _leaves_np(want, True), _leaves_np(_t(tree))):
            assert np.abs(g - w).max() <= 1e-6 * sigma * max(1.0, np.abs(w - x).max())
            assert np.abs(g - x).max() > 0.1 * sigma  # noise was added


def test_dp_aggregate_deltas_matches_jax():
    rng = np.random.default_rng(3)
    deltas = _tree(rng, lead=(8,))
    sel = np.array([1, 0, 1, 1, 0, 1, 1, 0], bool)
    got = privacy.dp_aggregate_deltas(_t(deltas), torch.from_numpy(sel), 1.0, 1.1,
                                      prng.PRNGKey(3))
    want = jax_privacy.dp_aggregate_deltas(_j(deltas), jnp.asarray(sel), 1.0, 1.1,
                                           jax.random.PRNGKey(3))
    for g, w in zip(_leaves_np(got), _leaves_np(want, True)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_noise_multiplier_for_epsilon_is_copied():
    for args in ((1.0, 1e-5, 100), (8.0, 1e-6, 30, 0.1)):
        assert privacy.noise_multiplier_for_epsilon(*args) == \
            jax_privacy.noise_multiplier_for_epsilon(*args)


_OPTIMIZERS = {
    "sgd": lambda m, lr: m.sgd(lr),
    "sgd-momentum": lambda m, lr: m.sgd(lr, momentum=0.9),
    "sgd-nesterov": lambda m, lr: m.sgd(lr, momentum=0.9, nesterov=True),
    "adamw": lambda m, lr: m.adamw(lr),
    "adamw-decay": lambda m, lr: m.adamw(lr, weight_decay=0.1),
    "clip+adamw": lambda m, lr: m.chain(m.clip_by_global_norm(1.0), m.adamw(lr)),
    "clip+sgd-momentum": lambda m, lr: m.chain(m.clip_by_global_norm(0.5),
                                               m.sgd(lr, momentum=0.9)),
    "adamw-cosine": lambda m, lr: m.adamw(m.cosine_schedule(1e-2, 5, 20), weight_decay=0.05),
}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_optimizer_matches_jax_over_20_steps(name):
    rng = np.random.default_rng(4)
    params = _tree(rng)
    grads = [_tree(rng, scale=0.5) for _ in range(20)]
    topt, jopt = _OPTIMIZERS[name](optim, 1e-2), _OPTIMIZERS[name](jax_optim, 1e-2)
    tp, jp = _t(params), _j(params)
    ts, js = topt.init(tp), jopt.init(jp)
    for g in grads:
        tu, ts = topt.update(_t(g), ts, tp)
        ju, js = jopt.update(_j(g), js, jp)
        tp, jp = optim.apply_updates(tp, tu), jax_optim.apply_updates(jp, ju)
        for a, b in zip(_leaves_np(tu), _leaves_np(ju, True)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    for a, b, p0 in zip(_leaves_np(tp), _leaves_np(jp, True), _leaves_np(_t(params))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        assert not np.array_equal(a, p0)  # the parameters moved


def test_global_norm_and_cosine_schedule_match_jax():
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    np.testing.assert_allclose(optim.global_norm(_t(tree)).numpy(),
                               np.asarray(jax_optim.global_norm(_j(tree))), rtol=1e-6)
    t_sched = optim.cosine_schedule(3e-4, 10, 100)
    j_sched = jax_optim.cosine_schedule(3e-4, 10, 100)
    for step in (0, 3, 10, 11, 50, 99, 100, 150):
        got = t_sched(torch.tensor(step, dtype=torch.int32)).numpy()
        want = np.asarray(j_sched(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
