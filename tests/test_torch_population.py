"""The port's host-resident population plane (``repro_torch.fl.population``)
and lazy population (``ShardedFederatedData``).

Contracts:

- ``PopulationStore``: ``scatter(idx, gather(idx))`` is the identity for
  any index multiset (duplicates and empties included), ``gather`` returns
  copies (or fills given buffers), memmap-backed trees round-trip through
  their ``.npy`` files;
- ``make_sharded_population``: the meta lanes, ``shard`` and
  ``materialize`` bitwise the JAX package's;
- the host plane is bitwise the device-resident port (every ``FLHistory``
  field but ``wall_time``), sync and async, K = C and K < C, with faults;
- against the JAX package in the legacy threefry stream (the committed
  goldens' stream): the four goldens through ``host_population=1`` give the
  committed selections, accuracy within 1e-6 of the committed hex, and
  ``selected``, ``pms``, ``tx_*``, ``round_time`` exactly JAX's; the async
  host plane matches JAX's ``run_host_async`` (exact fields, accuracy
  within 1e-6);
- ``eval_chunk`` windows against the whole-C evaluation: selections and
  depths equal, accuracy within rtol 1e-6 / atol 1e-7 (JAX's 1-ulp
  allowance; measured 0 on the CPU here);
- a host-plane resume, RAM- and memmap-backed, is bitwise the
  uninterrupted run;
- routing: at the threshold and for a lazy population the schedulers run
  the host plane.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

from repro.data import make_federated_classification as jax_make_data  # noqa: E402
from repro.data.synthetic import make_sharded_population as jax_sharded  # noqa: E402
from repro.fl import FLConfig as JaxFLConfig  # noqa: E402
from repro.fl.population import run_host_async as jax_run_host_async  # noqa: E402
from repro.fl.population import run_host_sync as jax_run_host_sync  # noqa: E402
from repro.models.mlp import init_mlp as jax_init_mlp  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import base as config_base  # noqa: E402
from repro_torch.data import (  # noqa: E402
    ShardedFederatedData,
    make_federated_classification,
    make_sharded_population,
)
from repro_torch.fl import FLConfig, pipeline_from_config, population, run_federated  # noqa: E402
from repro_torch.fl.population import PopulationStore, run_host_async, run_host_sync  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # optional dev dependency (tests/test_property.py)
    HAVE_HYPOTHESIS = False

FIXTURE = dict(
    n_clients=8, n_classes=4, n_features=20,
    samples_per_client_range=(60, 90), dirichlet_alpha=50.0,
    client_shift=0.05, class_sep=5.0, seed=1,
)
# tests/test_fl_api.py::_GOLDEN (configs, committed accuracy hex, selections)
GOLDEN = {
    "acsp-fl+dld+float32": (dict(), "9022033f6842293f97df533f117e613f428a6e3f",
                            ["11111111", "11110100", "10001100", "01000101", "00111100"]),
    "fedavg+none+float32": (dict(strategy="fedavg", personalization="none", fraction=1.0),
                            "9022033ff082713f38cb733f38cb733f38cb733f", ["11111111"] * 5),
    "oort+ft+float32": (dict(strategy="oort", personalization="ft", fraction=0.5),
                        "dab4073f08bf6c3f38cb6d3f38cb753fd264773f",
                        ["11111111", "10010110", "10010101", "01010101", "10010101"]),
    "acsp-fl+dld+int8": (dict(codec="int8"), "9022033f6842293f97df533f117e613f428a6e3f",
                         ["11111111", "11110100", "10001100", "01000101", "00111100"]),
}
JAX_EXACT = ("selected", "pms", "tx_params", "tx_wire_bytes", "tx_bytes_cum", "round_time",
             "sim_clock", "staleness_mean", "in_flight", "rejected_updates")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def small_ds():
    return make_federated_classification(**FIXTURE)


def _differs(h, ref) -> list[str]:
    """The FLHistory fields where ``h`` differs from ``ref`` (bitwise; the
    measured wall_time aside)."""
    return [f for f in ref._fields if f != "wall_time"
            and not np.array_equal(np.asarray(getattr(h, f)), np.asarray(getattr(ref, f)))]


def _jax_g0():
    r_init, _ = jax.random.split(jax.random.PRNGKey(0))
    return jax.device_get(jax_init_mlp(r_init, FIXTURE["n_features"], FIXTURE["n_classes"]))


# ---------------------------------------------------------------------------
# PopulationStore
# ---------------------------------------------------------------------------


def _demo_store(c=32, backing_dir=None, seed=0):
    rng = np.random.default_rng(seed)
    store = PopulationStore(c, backing_dir=backing_dir)
    store.add_lane("accuracy", rng.random(c).astype(np.float32))
    store.add_lane("pms", rng.integers(1, 4, c).astype(np.int32))
    template = [{"w": np.zeros((5, 3), np.float32), "b": np.zeros((3,), np.float32)},
                {"w": np.zeros((3, 2), np.float32), "b": np.zeros((2,), np.float32)}]
    store.add_tree("local", template, init="zeros")
    for leaf in tree_leaves(store.trees["local"]):
        leaf[...] = rng.normal(size=leaf.shape).astype(np.float32)
    return store


def _snapshot(store):
    return ({k: v.copy() for k, v in store.lanes.items()},
            {k: tree_map(np.array, t) for k, t in store.trees.items()})


def _assert_store_equal(store, lanes, trees):
    for k, v in lanes.items():
        np.testing.assert_array_equal(store.lanes[k], v)
    for k, t in trees.items():
        for got, want in zip(tree_leaves(store.trees[k]), tree_leaves(t)):
            np.testing.assert_array_equal(got, want)


def _roundtrip(store, idx):
    lanes, trees = _snapshot(store)
    names = [*store.lanes, *store.trees]
    store.scatter(idx, store.gather(idx, names))
    _assert_store_equal(store, lanes, trees)


def test_scatter_gather_is_identity_seeded():
    store = _demo_store()
    rng = np.random.default_rng(7)
    for _ in range(25):
        n = int(rng.integers(0, store.n_clients + 1))
        _roundtrip(store, rng.integers(0, store.n_clients, n))  # duplicates welcome


if HAVE_HYPOTHESIS:

    @settings(max_examples=25, deadline=None)
    @given(idx=st.lists(st.integers(min_value=0, max_value=15), max_size=40),
           seed=st.integers(min_value=0, max_value=5))
    def test_scatter_gather_is_identity_hypothesis(idx, seed):
        store = _demo_store(c=16, seed=seed)
        _roundtrip(store, np.asarray(idx, np.int64))


def test_gather_returns_mutation_safe_copies_or_fills_buffers():
    store = _demo_store()
    lanes, trees = _snapshot(store)
    got = store.gather(np.arange(4), ["accuracy", "local"])
    got["accuracy"][:] = -1.0
    for leaf in tree_leaves(got["local"]):
        leaf[:] = -1.0
    _assert_store_equal(store, lanes, trees)
    idx = np.asarray([5, 1, 5])
    out = {"pms": np.empty((3,), np.int32),
           "local": tree_map(lambda leaf: np.empty((3,) + leaf.shape[1:], leaf.dtype),
                             store.trees["local"])}
    filled = store.gather(idx, ["pms", "local"], out=out)
    assert filled["pms"] is out["pms"]
    np.testing.assert_array_equal(out["pms"], store.lanes["pms"][idx])
    for got_leaf, leaf in zip(tree_leaves(out["local"]), tree_leaves(store.trees["local"])):
        np.testing.assert_array_equal(got_leaf, leaf[idx])


def test_lane_leading_dim_validated():
    store = PopulationStore(8)
    with pytest.raises(ValueError, match="leading dim"):
        store.add_lane("accuracy", np.zeros((4,)))
    with pytest.raises(KeyError):
        store.gather(np.arange(2), ["missing"])
    with pytest.raises(KeyError):
        store.scatter(np.arange(2), {"missing": np.zeros(2)})


def test_build_allocates_only_needed_trees():
    g0 = [{"w": torch.ones((4, 2)), "b": torch.ones((2,))}]
    lanes = {"accuracy": np.zeros((6,), np.float32)}
    assert PopulationStore.build(6, lanes).trees == {}
    s = PopulationStore.build(6, lanes, g0=g0, stateful=True, lossy=True)
    assert set(s.trees) == {"local", "residual"}
    np.testing.assert_array_equal(s.trees["local"][0]["w"][3], np.ones((4, 2)))
    assert not s.trees["residual"][0]["w"].any()
    assert s.nbytes() == 6 * 4 + 2 * 6 * 10 * 4


def test_memmap_backing_roundtrip(tmp_path):
    backing = str(tmp_path / "pop")
    store = _demo_store(backing_dir=backing)
    assert all(isinstance(leaf, np.memmap) for leaf in tree_leaves(store.trees["local"]))
    idx = np.asarray([3, 0, 9])
    rows = store.gather(idx, ["local"])["local"]
    bumped = tree_map(lambda r: r + 1.0, rows)
    store.scatter(idx, {"local": bumped})
    store.flush()
    # leaf 0 in tree order is layer 0's "b": the .npy files reload cold
    disk = np.load(os.path.join(backing, "local_0.npy"), mmap_mode="r")
    np.testing.assert_array_equal(disk[idx], bumped[0]["b"])
    _roundtrip(store, idx)


# ---------------------------------------------------------------------------
# the lazy population against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(n_clients=12, n_classes=3, n_features=8,
                                     samples_per_client_range=(10, 16), seed=3),
                                dict(n_clients=40, n_classes=5, n_features=20,
                                     samples_per_client_range=(24, 32), dirichlet_alpha=50.0,
                                     seed=0)])
def test_sharded_population_bitwise_jax(kw):
    pj, pt = jax_sharded(**kw), make_sharded_population(**kw)
    assert isinstance(pt, ShardedFederatedData) and not hasattr(pt, "x_train")
    for field in ("means", "counts", "props", "tr_counts", "te_counts", "n_samples"):
        a, b = np.asarray(getattr(pj, field)), np.asarray(getattr(pt, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (pj.n_tr, pj.n_te, pj.n_clients, pj.n_features) == (pt.n_tr, pt.n_te, pt.n_clients,
                                                               pt.n_features)
    idx = np.asarray([7, 2, 2, 11, 0])  # duplicates regenerate identically
    full_t = pt.materialize()
    for a, b, full in zip(pj.shard(idx), pt.shard(idx),
                          (full_t.x_train, full_t.y_train, full_t.m_train,
                           full_t.x_test, full_t.y_test, full_t.m_test)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        np.testing.assert_array_equal(b, full[idx])
    full_j = pj.materialize()
    for field in ("x_train", "y_train", "m_train", "x_test", "y_test", "m_test"):
        np.testing.assert_array_equal(getattr(full_t, field), getattr(full_j, field))


# ---------------------------------------------------------------------------
# the host plane against the device-resident port, and against JAX
# ---------------------------------------------------------------------------

HOST_EQ_DEVICE = {
    "sync-K=C-int8-dld": dict(codec="int8"),
    "sync-K<C-oort-ft-int8": dict(strategy="oort", personalization="ft", fraction=0.5,
                                  codec="int8", cohort_size=3),
    "sync-faults": dict(dropout_rate=0.2, corrupt_rate=0.2, deadline_s=1.0),
    "async-M=C-int8": dict(scheduler="async", buffer_k=4, codec="int8", heterogeneity=0.5),
    "async-M<C-ft-int8": dict(scheduler="async", buffer_k=2, max_concurrency=4, codec="int8",
                              personalization="ft", strategy="oort", fraction=0.5,
                              heterogeneity=0.8),
    "async-faults": dict(scheduler="async", buffer_k=2, max_concurrency=4, dropout_rate=0.3,
                         deadline_s=5.0, max_retries=1),
}


@pytest.mark.parametrize("name", sorted(HOST_EQ_DEVICE))
def test_host_plane_bitwise_device_resident(small_ds, name):
    kw = dict(rounds=4, epochs=1, **HOST_EQ_DEVICE[name])
    h_dev = run_federated(small_ds, FLConfig(host_population=-1, **kw), device="cpu")
    h_host = run_federated(small_ds, FLConfig(host_population=1, **kw), device="cpu")
    assert not _differs(h_host, h_dev), _differs(h_host, h_dev)
    assert h_host.wall_time.shape == h_dev.wall_time.shape


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_host_population_goldens_match_jax(small_ds, name):
    cfg, acc_hex, want_bits = GOLDEN[name]
    kw = dict(rounds=5, epochs=1, host_population=1, **cfg)
    with jax.threefry_partitionable(False), prng.threefry_partitionable(False):
        g0 = _jax_g0()
        hj = jax_run_host_sync(jax_make_data(**FIXTURE), JaxFLConfig(**kw))
        h = run_federated(small_ds, FLConfig(**kw), device="cpu",
                          init_fn=lambda key: params_from_numpy(g0, key.device))
    assert ["".join("1" if b else "0" for b in row) for row in h.selected] == want_bits
    want_acc = np.frombuffer(bytes.fromhex(acc_hex), np.dtype("<f4"))
    assert np.abs(h.accuracy_mean.astype(np.float32) - want_acc).max() <= 1e-6
    for field in JAX_EXACT:
        np.testing.assert_array_equal(getattr(h, field), np.asarray(getattr(hj, field)),
                                      err_msg=field)
    assert h.tx_edge_bytes is None and hj.tx_edge_bytes is None


def test_async_host_plane_matches_jax(small_ds):
    kw = dict(strategy="oort", personalization="ft", fraction=0.5, codec="int8", rounds=5,
              epochs=1, scheduler="async", buffer_k=3, max_concurrency=4, heterogeneity=0.8,
              host_population=1)
    with jax.threefry_partitionable(False), prng.threefry_partitionable(False):
        g0 = _jax_g0()
        hj = jax_run_host_async(jax_make_data(**FIXTURE), JaxFLConfig(**kw))
        h = run_host_async(small_ds, FLConfig(**kw), "cpu",
                           init_fn=lambda key: params_from_numpy(g0, key.device))
    for field in JAX_EXACT:
        np.testing.assert_array_equal(getattr(h, field), np.asarray(getattr(hj, field)),
                                      err_msg=field)
    assert np.abs(h.accuracy_per_client - np.asarray(hj.accuracy_per_client)).max() <= 1e-6


def test_async_host_rejects_sync_aggregator(small_ds):
    cfg = FLConfig(scheduler="async", rounds=2, epochs=1, host_population=1)
    with pytest.raises(ValueError, match="dispatch snapshots"):
        run_host_async(small_ds, cfg, "cpu", pipeline=pipeline_from_config(FLConfig(rounds=2)))


@pytest.mark.parametrize("eval_chunk", [3, 8])
def test_eval_chunk_streaming_matches_whole_population(small_ds, eval_chunk):
    base = dict(rounds=4, epochs=1, host_population=1, codec="int8")
    h0 = run_federated(small_ds, FLConfig(**base), device="cpu")
    hc = run_federated(small_ds, FLConfig(eval_chunk=eval_chunk, **base), device="cpu")
    np.testing.assert_allclose(hc.accuracy_per_client, h0.accuracy_per_client, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(hc.selected, h0.selected)
    np.testing.assert_array_equal(hc.pms, h0.pms)


def test_memmap_run_matches_ram_run(small_ds, tmp_path):
    cfg = FLConfig(strategy="oort", personalization="ft", fraction=0.5, rounds=3, epochs=1,
                   codec="int8", host_population=1)
    stats: dict = {}
    h_ram = run_host_sync(small_ds, cfg, "cpu", stats=stats)
    h_mm = run_host_sync(small_ds, cfg, "cpu", backing_dir=str(tmp_path / "pop"))
    assert not _differs(h_mm, h_ram)
    names = os.listdir(str(tmp_path / "pop"))
    assert any(n.startswith("local_") for n in names)
    assert any(n.startswith("residual_") for n in names)
    assert set(stats) == {"round_ms", "host_gather_ms", "staged_bytes", "store_bytes"}
    assert {len(stats[k]) for k in ("round_ms", "host_gather_ms", "staged_bytes")} == {3}
    # both trees (8 clients x har-mlp's 20-256-256-256-4 parameters x 4 B) and the 6 lanes
    params = 20 * 256 + 256 + 2 * (256 * 256 + 256) + 256 * 4 + 4
    assert stats["store_bytes"] == 2 * 8 * params * 4 + 8 * (4 * 4 + 1 + 4)


RESUME = {
    "sync-ram": (dict(codec="int8", cohort_size=5), False),
    "sync-memmap": (dict(codec="int8", personalization="ft", strategy="oort", fraction=0.5),
                    True),
    "async-ram": (dict(scheduler="async", buffer_k=2, max_concurrency=4, codec="int8",
                       personalization="ft", heterogeneity=0.8), False),
    "async-memmap": (dict(scheduler="async", buffer_k=3, codec="int8"), True),
}


@pytest.mark.parametrize("name", sorted(RESUME))
def test_host_plane_resume_bitwise(small_ds, tmp_path, name):
    kw, memmap = RESUME[name]
    run = run_host_async if kw.get("scheduler") == "async" else run_host_sync

    def backing(tag):
        return str(tmp_path / tag) if memmap else None

    full = run(small_ds, FLConfig(rounds=5, epochs=1, host_population=1, **kw), "cpu",
               backing_dir=backing("full"))
    ckpt = str(tmp_path / "ckpt")
    run(small_ds, FLConfig(rounds=2, epochs=1, host_population=1, **kw), "cpu",
        backing_dir=backing("part"), checkpoint_every=2, checkpoint_dir=ckpt)
    res = run(small_ds, FLConfig(rounds=5, epochs=1, host_population=1, **kw), "cpu",
              backing_dir=backing("resumed"), resume_from=ckpt)
    assert not _differs(res, full), _differs(res, full)
    if memmap:  # the resumed store's trees are memmap files, restored in place
        assert any(n.startswith("residual_") for n in os.listdir(tmp_path / "resumed"))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.fixture
def host_calls(monkeypatch):
    """Counts the schedulers' calls into the host runners."""
    calls = []
    for name in ("run_host_sync", "run_host_async"):
        real = getattr(population, name)
        monkeypatch.setattr(population, name,
                            lambda *a, _real=real, _name=name, **k: calls.append(_name)
                            or _real(*a, **k))
    return calls


@pytest.mark.parametrize("scheduler", ["sync", "async"])
def test_threshold_routes_to_the_host_plane(small_ds, host_calls, monkeypatch, scheduler):
    monkeypatch.setattr(config_base, "HOST_POPULATION_THRESHOLD", small_ds.n_clients)
    kw = dict(rounds=2, epochs=1, scheduler=scheduler, buffer_k=2)
    run_federated(small_ds, FLConfig(**kw), device="cpu")
    run_federated(small_ds, FLConfig(host_population=-1, **kw), device="cpu")
    assert host_calls == [f"run_host_{scheduler}"]


@pytest.mark.parametrize("scheduler", ["sync", "async"])
def test_lazy_population_routes_to_the_host_plane(host_calls, scheduler):
    pop = make_sharded_population(n_clients=16, n_classes=3, n_features=8,
                                  samples_per_client_range=(10, 14), seed=0)
    h = run_federated(pop, FLConfig(strategy="fedavg", personalization="none", fraction=0.5,
                                    rounds=3, epochs=1, cohort_size=4, scheduler=scheduler,
                                    buffer_k=2, edge_groups=2), device="cpu")
    assert host_calls == [f"run_host_{scheduler}"]
    assert h.accuracy_mean.shape == (3,) and np.isfinite(h.accuracy_mean).all()
    assert h.tx_edge_bytes.shape == (3, 2)
    if scheduler == "sync":
        assert (h.in_flight == 4).all()
