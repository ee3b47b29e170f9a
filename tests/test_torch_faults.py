"""The port's fault injection against the JAX package's, the cases of
``tests/test_faults.py``: compiled fault plans, corruption, and the sync
and async fault trajectories (dropout, deadline, corruption rejected by the
finite guard, retries capped).

Both packages get the same numpy-made data and the JAX init and draw from
jax's legacy threefry stream, as ``tests/test_torch_fl.py`` compares them.

Contracts: ``FaultPlan`` lanes bitwise; ``apply_corruption`` bitwise
(kind 0 leaves a lane bitwise unchanged); the trajectories' ``selected``,
``pms``, ``tx_params``, ``tx_wire_bytes``, ``round_time``, ``sim_clock``,
``staleness_mean``, ``in_flight`` and ``rejected_updates`` exactly equal,
every client's accuracy within 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.configs.base import FaultConfig as JaxFaultConfig  # noqa: E402
from repro.data import make_federated_classification as jax_make_data  # noqa: E402
from repro.fl import FLConfig as JaxFLConfig  # noqa: E402
from repro.fl import run_federated as jax_run_federated  # noqa: E402
from repro.fl.faults import apply_corruption as jax_apply_corruption  # noqa: E402
from repro.fl.faults import compile_fault_plan as jax_compile_fault_plan  # noqa: E402
from repro.models.mlp import init_mlp as jax_init_mlp  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs.base import FaultConfig  # noqa: E402
from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.fl import FLConfig, run_federated  # noqa: E402
from repro_torch.fl.faults import FaultPlan, apply_corruption, compile_fault_plan  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

FIXTURE = dict(n_clients=8, n_classes=4, n_features=20, samples_per_client_range=(60, 90),
               dirichlet_alpha=50.0, client_shift=0.05, class_sep=5.0, seed=1)
ASYNC = dict(scheduler="async", buffer_k=2, max_concurrency=4)

# fault trajectories held to the JAX package (FLConfig kwargs, seed 1; a
# "faults" entry holds FaultConfig kwargs that have no flat form)
CASES = {
    "sync-dropout": dict(rounds=4, strategy="fedavg", personalization="none", fraction=1.0,
                         dropout_rate=0.4),
    "sync-deadline-slow": dict(rounds=4, strategy="fedavg", personalization="none",
                               fraction=1.0, heterogeneity=1.0,
                               faults=dict(deadline_s=0.05, slow_rate=0.3)),
    "sync-corrupt-int8": dict(rounds=4, codec="int8", corrupt_rate=0.5, dropout_rate=0.2),
    "async-corrupt": dict(rounds=4, corrupt_rate=0.5, **ASYNC),
    "async-dropout-deadline": dict(rounds=6, dropout_rate=0.4, deadline_s=5.0, max_retries=2,
                                   **ASYNC),
    "async-retries-capped": dict(rounds=4, dropout_rate=0.5, max_retries=0, **ASYNC),
}
EXACT = ("selected", "pms", "tx_params", "tx_wire_bytes", "round_time", "sim_clock",
         "staleness_mean", "in_flight", "rejected_updates")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_fault_trajectory_matches_jax(jax_ds, port_ds, name):
    kw = dict(epochs=1, seed=1, **CASES[name])
    fk = kw.pop("faults", None)
    jax_faults = {} if fk is None else dict(faults=JaxFaultConfig(**fk))
    port_faults = {} if fk is None else dict(faults=FaultConfig(**fk))
    with jax.threefry_partitionable(False):
        hj = jax_run_federated(jax_ds, JaxFLConfig(**kw, **jax_faults))
        r_init, _ = jax.random.split(jax.random.PRNGKey(1))
        g0 = jax.device_get(jax_init_mlp(r_init, jax_ds.n_features, jax_ds.n_classes))
    with prng.threefry_partitionable(False):
        ht = run_federated(port_ds, FLConfig(**kw, **port_faults), device="cpu",
                           init_fn=lambda key: params_from_numpy(g0, key.device))
    assert len(ht.accuracy_mean) == len(hj.accuracy_mean)
    for field in EXACT:
        np.testing.assert_array_equal(getattr(ht, field), np.asarray(getattr(hj, field)),
                                      err_msg=field)
    assert np.abs(ht.accuracy_per_client - np.asarray(hj.accuracy_per_client)).max() <= 1e-6
    assert np.isfinite(ht.accuracy_per_client).all()
    if "corrupt" in name:
        assert ht.rejected_updates.sum() > 0
    if name.startswith("async"):
        assert ht.in_flight.max() <= 4
    if name == "sync-deadline-slow":
        # the deadline cuts stragglers and caps those rounds (round 1 lost
        # every selected client and ran fault-free)
        cut = ht.selected.sum(axis=1) < 8
        assert cut.sum() == 3 and (ht.round_time[cut] <= 0.05 + 0.01).all()
    if name == "sync-dropout":
        for t in range(4):
            crash = compile_fault_plan(FaultConfig(dropout_rate=0.4), 1, t, 8).crash
            assert not (ht.selected[t] & crash).any()


_PLANS = [dict(dropout_rate=0.4, slow_rate=0.3, corrupt_rate=0.3),
          dict(dropout_rate=0.5, fault_seed=1), dict(corrupt_rate=0.9, slow_factor=7.0),
          dict()]


@pytest.mark.parametrize("i", range(len(_PLANS)))
def test_fault_plan_bitwise_and_prefix_stable(i):
    kw = _PLANS[i]
    for seed, t in ((7, 3), (0, 0), (123, 41)):
        ours = compile_fault_plan(FaultConfig(**kw), seed, t, 32)
        ref = jax_compile_fault_plan(JaxFaultConfig(**kw), seed, t, 32)
        assert isinstance(ours, FaultPlan)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        wide = compile_fault_plan(FaultConfig(**kw), seed, t, 64)
        for a, b in zip(wide, ours):
            np.testing.assert_array_equal(a[:32], b)


def test_apply_corruption_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3, 2)).astype(np.float32)
    kinds = np.asarray([0, 1, 2, 3, 0], np.int32)
    want = np.asarray(jax_apply_corruption({"w": jnp.asarray(x)}, jnp.asarray(kinds),
                                           1e6)["w"])
    got = apply_corruption({"w": torch.from_numpy(x)}, torch.from_numpy(kinds), 1e6)["w"]
    np.testing.assert_array_equal(got.numpy(), want)  # NaNs in the same places
    assert torch.equal(got[0], torch.from_numpy(x[0])) and torch.isnan(got[1]).all()
    assert torch.isposinf(got[2]).all()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_disabled_faults_bit_identical(port_ds, mode):
    kw = dict(rounds=3, epochs=1, seed=1, **(ASYNC if mode == "async" else {}))
    h0 = run_federated(port_ds, FLConfig(**kw), device="cpu")
    h1 = run_federated(port_ds, FLConfig(faults=FaultConfig(), **kw), device="cpu")
    for field in ("accuracy_per_client", "selected", "round_time", "sim_clock"):
        np.testing.assert_array_equal(getattr(h0, field), getattr(h1, field))
    assert (h0.rejected_updates == 0).all()


def test_sync_all_dead_round_falls_back_to_fault_free(port_ds):
    """At dropout 0.99 the plan crashes all 8 clients in rounds 0-2; those
    rounds run fault-free."""
    kw = dict(rounds=3, epochs=1, seed=1, strategy="fedavg", personalization="none",
              fraction=1.0)
    cfg = FLConfig(dropout_rate=0.99, **kw)
    for t in range(3):
        assert compile_fault_plan(cfg.faults, 1, t, 8).crash.all()
    h = run_federated(port_ds, cfg, device="cpu")
    np.testing.assert_array_equal(h.accuracy_per_client,
                                  run_federated(port_ds, FLConfig(**kw),
                                                device="cpu").accuracy_per_client)


@pytest.mark.parametrize("kw,exc", [
    (dict(cohort_size=4, cohort_devices=-1), ValueError),
    (dict(edge_groups=2), ValueError),
])
def test_faults_with_sharding_or_edges_raise(port_ds, kw, exc):
    with pytest.raises(exc, match="FaultConfig"):
        run_federated(port_ds, FLConfig(rounds=2, epochs=1, seed=1, dropout_rate=0.3, **kw),
                      device="cpu")


def test_fault_config_flat_kwargs():
    cfg = FLConfig(dropout_rate=0.25, deadline_s=30.0, corrupt_rate=0.1, max_retries=5)
    assert cfg.faults.enabled and cfg.faults == dataclasses.replace(
        FaultConfig(), dropout_rate=0.25, deadline_s=30.0, corrupt_rate=0.1, max_retries=5)
    assert not FLConfig().faults.enabled
