"""The port's async scheduler (FedBuff-style buffered aggregation over
dispatch slots) against the JAX package's, the async cases of
``tests/test_sched.py``.

Both packages get the same numpy-made data and the JAX init (carried over
with ``params_from_numpy``) and draw from jax's legacy threefry stream, as
``tests/test_torch_fl.py`` compares them.

Contracts:

- ``selected``, ``pms``, ``tx_params``, ``tx_wire_bytes``, ``round_time``,
  ``sim_clock``, ``staleness_mean``, ``in_flight`` and
  ``rejected_updates`` exactly equal; every client's accuracy within 1e-6
  an event (6e-8 with ``eval_every > 1``: the JAX package evaluates inside
  a ``lax.cond``);
- ``EventQueue`` pops the JAX queue's slots on every randomized sequence;
  ``ClientClock.durations`` bitwise the JAX clock's, subset rows bitwise
  the full rows; ``CommModel.client_times`` and ``round_time`` bitwise;
- ``staleness_weight`` bitwise for ``constant`` and ``hinge`` and for
  ``polynomial`` at its default exponent 0.5, within 1 float32 ulp at
  other exponents, on staleness 0..64 (XLA's ``pow`` is not torch's);
- ``staleness_weighted_merge`` (plain version) within 2 float32 ulp of
  the value's magnitude of the JAX merge (the client sum runs in another
  order), its fused-snapshot form bitwise the form with the deltas passed;
- the port's own async run with ``buffer_k = C`` and constant staleness
  matches its sync run within 1e-5 (``tests/test_sched.py``'s criterion).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.core.aggregation import staleness_weighted_merge as jax_merge  # noqa: E402
from repro.data import make_federated_classification as jax_make_data  # noqa: E402
from repro.fl import FLConfig as JaxFLConfig  # noqa: E402
from repro.fl import run_federated as jax_run_federated  # noqa: E402
from repro.fl.phases import staleness_weight as jax_staleness_weight  # noqa: E402
from repro.fl.sched import ClientClock as JaxClientClock  # noqa: E402
from repro.fl.sched import EventQueue as JaxEventQueue  # noqa: E402
from repro.models.mlp import init_mlp as jax_init_mlp  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.core.aggregation import staleness_weighted_merge  # noqa: E402
from repro_torch.core.metrics import CommModel  # noqa: E402
from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.fl import FLConfig, pipeline_from_config, run_federated  # noqa: E402
from repro_torch.fl.cohort import tree_scatter  # noqa: E402
from repro_torch.fl.phases import STALENESS_FNS, staleness_weight  # noqa: E402
from repro_torch.fl.sched import ClientClock, EventQueue  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

# tests/test_sched.py's small_ds fixture
FIXTURE = dict(n_clients=8, n_classes=4, n_features=20, samples_per_client_range=(60, 90),
               dirichlet_alpha=50.0, client_shift=0.05, class_sep=5.0, seed=1)
STRAGGLER = np.r_[np.ones(6), 30.0, 30.0]

# async configurations held to the JAX package: (FLConfig kwargs, client delay)
CASES = {
    "fedavg+none+float32-straggler": (
        dict(strategy="fedavg", personalization="none", fraction=1.0, rounds=6,
             scheduler="async", buffer_k=4), STRAGGLER),
    "acsp-fl+dld+int8-M4": (
        dict(codec="int8", rounds=5, scheduler="async", buffer_k=2, max_concurrency=4), None),
    "oort+ft+float32": (
        dict(strategy="oort", personalization="ft", fraction=0.5, rounds=5, scheduler="async",
             buffer_k=4, heterogeneity=0.5), None),
    "eval_every=2-hinge": (
        dict(rounds=6, scheduler="async", buffer_k=3, eval_every=2, heterogeneity=0.5,
             staleness_fn="hinge"), None),
}
EXACT = ("selected", "pms", "tx_params", "tx_wire_bytes", "round_time", "sim_clock",
         "staleness_mean", "in_flight", "rejected_updates")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors (the suite runs in
    several worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_ds():
    return jax_make_data(**FIXTURE)


@pytest.fixture(scope="module")
def port_ds():
    return make_federated_classification(**FIXTURE)


def _jax_init(ds, seed=0):
    r_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.device_get(jax_init_mlp(r_init, ds.n_features, ds.n_classes))


def _runs(jax_ds, port_ds, kw, delay=None):
    """The same config through both packages (legacy stream, JAX init)."""
    with jax.threefry_partitionable(False):
        hj = jax_run_federated(jax_ds, JaxFLConfig(epochs=1, **kw), client_delay=delay)
        g0 = _jax_init(jax_ds, kw.get("seed", 0))
    with prng.threefry_partitionable(False):
        ht = run_federated(port_ds, FLConfig(epochs=1, **kw), device="cpu", client_delay=delay,
                           init_fn=lambda key: params_from_numpy(g0, key.device))
    return hj, ht


def assert_same_run(ht, hj, acc_tol=1e-6):
    for field in EXACT:
        np.testing.assert_array_equal(getattr(ht, field), np.asarray(getattr(hj, field)),
                                      err_msg=field)
    gap = np.abs(ht.accuracy_per_client - np.asarray(hj.accuracy_per_client)).max()
    assert gap <= acc_tol, gap


@pytest.mark.parametrize("name", sorted(CASES))
def test_async_history_matches_jax(jax_ds, port_ds, name):
    kw, delay = CASES[name]
    hj, ht = _runs(jax_ds, port_ds, kw, delay)
    assert_same_run(ht, hj, acc_tol=6e-8 if kw.get("eval_every", 1) > 1 else 1e-6)
    assert np.isfinite(ht.accuracy_mean).all()
    assert (np.diff(ht.sim_clock) >= 0).all()
    if name.startswith("fedavg"):
        assert (ht.staleness_mean > 0).any()  # the straggler lands stale
    if "M4" in name:
        assert ht.in_flight.max() <= 4 and (ht.selected.sum(axis=1) <= 2).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_queue_matches_jax(seed):
    """Randomized pushes (re-arming live slots, equal finish times) and
    pops: the same slots in the same order, the same finish lane."""
    rng = np.random.default_rng(seed)
    m = 12
    ours, ref = EventQueue(m), JaxEventQueue(m)
    live = np.zeros(m, bool)
    for _ in range(400):
        if live.sum() and rng.random() < 0.4:
            k = int(rng.integers(1, live.sum() + 1))
            a, b = ours.pop_k(k), ref.pop_k(k)
            np.testing.assert_array_equal(a, b)
            live[a] = False
        else:
            slot = int(rng.integers(m))
            finish = float(rng.integers(0, 20)) / 4.0  # ties are common
            client = int(rng.integers(100))
            ours.push(slot, finish, client)
            ref.push(slot, finish, client)
            live[slot] = True
        np.testing.assert_array_equal(ours.finish, ref.finish)


@pytest.mark.parametrize("fn", sorted(STALENESS_FNS))
def test_staleness_weight_matches_jax(fn):
    s = np.arange(0, 65, dtype=np.int32)
    for exponent, threshold in ((0.5, 4.0), (0.3, 0.0), (1.0, 2.0), (1.5, 8.0)):
        want = np.asarray(jax_staleness_weight(fn, jnp.asarray(s), exponent, threshold))
        got = staleness_weight(fn, torch.from_numpy(s), exponent, threshold).numpy()
        assert got.dtype == np.float32 and want.dtype == np.float32
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        exact = fn != "polynomial" or exponent in (0.5, 1.0)
        assert ulps.max() <= (0 if exact else 1), (fn, exponent, ulps.max())
        assert got[0] == 1.0
    with pytest.raises(KeyError, match="staleness_fn"):
        staleness_weight("exponential", torch.zeros(3))


def _merge_inputs(seed=0, m=6):
    rng = np.random.default_rng(seed)
    shapes = [((20, 16), (16,)), ((16, 4), (4,))]
    snaps = [{"w": rng.standard_normal((m,) + w).astype(np.float32),
              "b": rng.standard_normal((m,) + b).astype(np.float32)} for w, b in shapes]
    clients = [{k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
                for k, v in layer.items()} for layer in snaps]
    g = [{"w": rng.standard_normal(w).astype(np.float32),
          "b": rng.standard_normal(b).astype(np.float32)} for w, b in shapes]
    land = rng.random(m) < 0.6
    land[0] = True
    weights = (land * rng.integers(40, 90, m) * rng.random(m)).astype(np.float32)
    share = np.ones((m, 2), bool)
    share[:, 1] = False  # layer 1 shared by nobody: keeps g
    share[1, 1] = True
    share[1, 0] = False
    return snaps, clients, g, weights, share


def _t(tree):
    return params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_staleness_merge_matches_jax(seed):
    snaps, clients, g, weights, share = _merge_inputs(seed)
    deltas = [{k: clients[j][k] - snaps[j][k] for k in snaps[j]} for j in range(2)]
    want = jax.device_get(jax_merge(deltas, g, jnp.asarray(weights), jnp.asarray(share)))
    w_t, share_t = torch.from_numpy(weights), torch.from_numpy(share)
    got = staleness_weighted_merge(_t(deltas), _t(g), w_t, share_t)
    fused = staleness_weighted_merge(_t(clients), _t(g), w_t, share_t, snapshots=_t(snaps))
    for j in range(2):
        for k in ("w", "b"):
            a, b, f = got[j][k].numpy(), np.asarray(want[j][k]), fused[j][k].numpy()
            np.testing.assert_array_equal(f, a)  # the fused subtraction is the unfused one
            tol = 2 * np.spacing(np.maximum(np.abs(b), np.float32(1e-30)))
            assert (np.abs(a - b) <= tol).all(), (j, k, np.abs(a - b).max())
    if not weights[1]:  # nobody landed a shared copy of layer 1: g + 0 exactly
        np.testing.assert_array_equal(got[1]["w"].numpy(), g[1]["w"])


def test_staleness_merge_without_landings_keeps_g():
    snaps, clients, g, weights, share = _merge_inputs(2)
    out = staleness_weighted_merge(_t(clients), _t(g), torch.zeros(len(weights)),
                                   torch.from_numpy(share), snapshots=_t(snaps))
    for j in range(2):
        for k in ("w", "b"):
            np.testing.assert_array_equal(out[j][k].numpy(), g[j][k])


def test_staleness_aggregator_under_the_sync_barrier_matches_jax():
    """With no dispatch snapshots (the sync barrier) the deltas are taken
    against the broadcast global at staleness 0: within 2 ulp of the JAX
    aggregator's merge, and bitwise the port's merge against explicit
    stacked copies of the global."""
    from types import SimpleNamespace

    from repro.fl.phases import RoundContext as JaxRoundContext
    from repro.fl.phases import StalenessAggregator as JaxStalenessAggregator
    from repro_torch.fl.phases import RoundContext, StalenessAggregator

    _, clients, g, weights, share = _merge_inputs(3)
    select = weights > 0
    n_samples = np.random.default_rng(3).integers(40, 90, len(weights)).astype(np.int32)
    want = JaxStalenessAggregator().aggregate(
        JaxRoundContext(global_params=g, agg_src=clients, select=jnp.asarray(select),
                        share=jnp.asarray(share)),
        SimpleNamespace(n_samples=jnp.asarray(n_samples))).new_global
    env = SimpleNamespace(n_samples=torch.from_numpy(n_samples))
    ctx = RoundContext(global_params=_t(g), agg_src=_t(clients), select=torch.from_numpy(select),
                       share=torch.from_numpy(share))
    got = StalenessAggregator().aggregate(ctx, env)
    stacked = [{k: np.broadcast_to(v, clients[j][k].shape).copy() for k, v in g[j].items()}
               for j in range(2)]
    snap = StalenessAggregator().aggregate(ctx._replace(dispatch_params=_t(stacked)), env)
    np.testing.assert_array_equal(got.merge_weight.numpy(), 1.0)
    for j in range(2):
        for k in ("w", "b"):
            a, b = got.new_global[j][k].numpy(), np.asarray(want[j][k])
            np.testing.assert_array_equal(a, snap.new_global[j][k].numpy())
            tol = 2 * np.spacing(np.maximum(np.abs(b), np.float32(1e-30)))
            assert (np.abs(a - b) <= tol).all(), (j, k, np.abs(a - b).max())


def test_tree_scatter_drop_ignores_sentinel_lanes():
    """Lanes at the sentinel index C write nothing, whatever they hold and
    however often a client id repeats among them."""
    base = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([4, 2, 4, 0])
    upd = torch.tensor([[9.0] * 3, [7.0] * 3, [8.0] * 3, [5.0] * 3])
    got = tree_scatter([{"w": base}], idx, [{"w": upd}], mode="drop")[0]["w"]
    want = base.clone()
    want[2], want[0] = 7.0, 5.0
    assert torch.equal(got, want) and torch.equal(base, torch.arange(12.0).reshape(4, 3))
    with pytest.raises(ValueError, match="mode"):
        tree_scatter([{"w": base}], idx, [{"w": upd}], mode="clip")


def test_client_clock_matches_jax(jax_ds, port_ds):
    cfg = FLConfig(heterogeneity=0.7, codec="int8")
    g0 = _jax_init(jax_ds)
    pipe = pipeline_from_config(cfg)
    from repro.fl import api as jax_api
    from repro.core.metrics import CommModel as JaxCommModel

    ours = ClientClock.build(params_from_numpy(g0, "cpu"), pipe.transmit.codec, port_ds, cfg,
                             CommModel())
    ref = JaxClientClock.build(g0, jax_api.pipeline_from_config(JaxFLConfig(
        heterogeneity=0.7, codec="int8")).transmit.codec, jax_ds, cfg, JaxCommModel())
    pms = np.asarray([4, 1, 2, 3, 4, 4, 2, 1])
    np.testing.assert_array_equal(ours.durations(pms), ref.durations(pms))
    for a, b in zip(ours.component_times(pms), ref.component_times(pms)):
        np.testing.assert_array_equal(a, b)
    cids = np.asarray([6, 1, 3])
    np.testing.assert_array_equal(ours.durations(pms[cids], cids=cids), ours.durations(pms)[cids])
    np.testing.assert_array_equal(ours.round_flops(pms[cids], cids=cids),
                                  ref.round_flops(pms[cids], cids=cids))


def test_comm_model_client_and_round_times_match_jax():
    """``client_times`` (float64) and ``round_time`` (float32 in the JAX
    package without x64) bitwise, with and without the delay lane."""
    from repro.core.metrics import CommModel as JaxCommModel

    rng = np.random.default_rng(4)
    tx, flops, rx = rng.random(40) * 1e6, rng.random(40) * 1e9, rng.random(40) * 4e6
    delay, sel = rng.lognormal(0.0, 0.5, 40), rng.random(40) < 0.5
    ours, ref = CommModel(), JaxCommModel()
    for kw in (dict(), dict(delay=delay)):
        np.testing.assert_array_equal(ours.client_times(tx, flops, rx, **kw),
                                      np.asarray(ref.client_times(tx, flops, rx, **kw)))
        got, want = ours.round_time(tx, flops, sel, rx, **kw), ref.round_time(tx, flops, sel, rx,
                                                                              **kw)
        assert got.dtype == np.float32 and got == np.asarray(want)


def test_async_full_buffer_matches_sync(port_ds):
    """``buffer_k = C`` with constant weights and uniform clocks is the sync
    barrier (``tests/test_sched.py``'s acceptance criterion)."""
    kw = dict(strategy="fedavg", personalization="none", fraction=1.0, rounds=5, epochs=1)
    sync = run_federated(port_ds, FLConfig(**kw), device="cpu")
    asy = run_federated(port_ds, FLConfig(scheduler="async", buffer_k=port_ds.n_clients,
                                          staleness_fn="constant", **kw), device="cpu")
    np.testing.assert_allclose(asy.accuracy_per_client, sync.accuracy_per_client, atol=1e-5)
    np.testing.assert_array_equal(asy.selected, sync.selected)
    np.testing.assert_array_equal(asy.tx_params, sync.tx_params)
    np.testing.assert_array_equal(asy.staleness_mean, 0.0)


def test_async_deterministic(port_ds):
    cfg = FLConfig(rounds=4, epochs=1, scheduler="async", buffer_k=4)
    a = run_federated(port_ds, cfg, device="cpu", client_delay=STRAGGLER)
    b = run_federated(port_ds, cfg, device="cpu", client_delay=STRAGGLER)
    for field in a._fields:
        if field != "wall_time" and getattr(a, field) is not None:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    assert a.wall_time.shape == (4,)


def test_async_rejects_sync_built_pipeline(port_ds):
    with pytest.raises(ValueError, match="StalenessAggregator"):
        run_federated(port_ds, FLConfig(rounds=2, scheduler="async"), device="cpu",
                      pipeline=pipeline_from_config(FLConfig()))


def test_async_pipeline_takes_the_scheduler_staleness_settings():
    cfg = FLConfig(scheduler="async", staleness_fn="hinge")
    agg = pipeline_from_config(dataclasses.replace(
        cfg, scheduler=dataclasses.replace(cfg.scheduler, staleness_exponent=2.0))).aggregator
    assert (agg.staleness_fn, agg.exponent, agg.threshold) == ("hinge", 2.0, 4.0)
