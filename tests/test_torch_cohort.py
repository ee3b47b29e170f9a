"""K < C cohort rounds and thinned evaluation of the port against the JAX
package's, the cases of ``tests/test_cohort.py``.

Both packages get the same numpy-made data and the JAX init (carried over
with ``params_from_numpy``) and draw from jax's legacy threefry stream, the
stream of the committed goldens, as ``tests/test_torch_fl.py`` compares
them.

Contracts:

- ``selected``, ``pms``, ``tx_params``, ``tx_wire_bytes``, ``round_time``
  and ``in_flight`` exactly equal, every client's accuracy within 1e-6 a
  round (one flipped prediction on these fixtures moves it by >= 1/60);
- thinned evaluation (``eval_every > 1``): every client's accuracy within
  6e-8, float32 resolution (the JAX package evaluates inside a
  ``lax.cond``, which XLA may fuse otherwise than the plain round; the
  port holds its own thinned path bitwise), carried rows exactly their
  evaluation round's row;
- the port's own cohort step computes the dense step's numbers exactly when
  the cohort covers the selection.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.configs.base import ExecutionConfig as JaxExecutionConfig  # noqa: E402
from repro.data import make_federated_classification as jax_make_data  # noqa: E402
from repro.fl import FLConfig as JaxFLConfig  # noqa: E402
from repro.fl import api as jax_api  # noqa: E402
from repro.fl import run_federated as jax_run_federated  # noqa: E402
from repro.models.mlp import init_mlp as jax_init_mlp  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs.base import ExecutionConfig  # noqa: E402
from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.fl import FLConfig, api, run_federated  # noqa: E402
from repro_torch.weights import params_from_numpy, state_from_numpy  # noqa: E402

# tests/test_cohort.py's small_ds fixture
FIXTURE = dict(n_clients=16, n_classes=4, n_features=20, samples_per_client_range=(40, 60),
               dirichlet_alpha=50.0, client_shift=0.05, class_sep=5.0, seed=3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in
    several worker processes, and torch's default of a thread per core in
    each of them oversubscribes the cores, which slows many small ops far
    more than it speeds a few."""
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


def _runs(jax_ds, port_ds, **kw):
    """The same config through both packages' ``run_federated`` (legacy
    stream, the JAX init in both)."""
    with jax.threefry_partitionable(False):
        hj = jax_run_federated(jax_ds, JaxFLConfig(**kw))
        r_init, _ = jax.random.split(jax.random.PRNGKey(0))
        g0 = jax.device_get(jax_init_mlp(r_init, jax_ds.n_features, jax_ds.n_classes))
    with prng.threefry_partitionable(False):
        ht = run_federated(port_ds, FLConfig(**kw), device="cpu",
                           init_fn=lambda key: params_from_numpy(g0, key.device))
    return hj, ht


def _assert_same_run(ht, hj, acc_tol=1e-6):
    for field in ("selected", "pms", "tx_params", "tx_wire_bytes", "round_time", "in_flight",
                  "rejected_updates"):
        np.testing.assert_array_equal(getattr(ht, field), np.asarray(getattr(hj, field)),
                                      err_msg=field)
    gap = np.abs(ht.accuracy_per_client - np.asarray(hj.accuracy_per_client)).max()
    assert gap <= acc_tol, gap


def _jax_state(ds, g0, select, stateful):
    c = ds.n_clients
    loc0 = jax.tree.map(lambda l: jnp.broadcast_to(l, (c,) + l.shape), g0) if stateful else None
    return jax_api.RoundState(
        global_params=g0, local_params=loc0, accuracy=jnp.zeros((c,)), select=select,
        pms=jnp.full((c,), len(g0), jnp.int32), rng=jax.random.PRNGKey(7),
        participation=jnp.zeros((c,), jnp.int32), loss=jnp.zeros((c,)),
        update_norm=jnp.zeros((c,)),
    )


@pytest.mark.parametrize("personalization", ["ft", "none"])
def test_cohort_step_matches_dense_when_selection_fits(jax_ds, port_ds, personalization):
    """From the same state with 4 of 16 clients selected: the port's cohort
    step (K = 4) is its dense step exactly, and the JAX cohort step's
    records to the contract, round after round."""
    c = port_ds.n_clients
    kw = dict(strategy="fedavg", personalization=personalization, fraction=0.25, rounds=3,
              epochs=1)
    with jax.threefry_partitionable(False):
        jpipe = jax_api.pipeline_from_config(JaxFLConfig(**kw))
        jstep = jax.jit(jax_api.build_round_step(jax_api.build_env(jax_ds, 0), jpipe,
                                                 JaxExecutionConfig(cohort_size=4)))
        g0 = jax_init_mlp(jax.random.PRNGKey(0), jax_ds.n_features, jax_ds.n_classes)
        js = _jax_state(jax_ds, g0, jnp.asarray([True] * 4 + [False] * (c - 4)),
                        jpipe.personalizer.stateful)
        start = jax.device_get(js)
        jouts = []
        for t in range(3):
            js, jout = jstep(js, jnp.asarray(t))
            jouts.append(jax.device_get(jout))
    cfg = FLConfig(**kw)
    env, pipe = api.build_env(port_ds, 0, "cpu"), api.pipeline_from_config(cfg)
    dense = api.build_round_step(env, pipe)
    cohort = api.build_round_step(env, pipe, ExecutionConfig(cohort_size=4))
    sd, sc = state_from_numpy(start, "cpu"), state_from_numpy(start, "cpu")
    with prng.threefry_partitionable(False):
        for t in range(3):
            sd, od = dense(sd, t)
            sc, oc = cohort(sc, t)
            for key in ("selected", "acc", "wire_per_client"):
                np.testing.assert_array_equal(od[key].numpy(), oc[key].numpy(), err_msg=key)
            for key in ("selected", "wire_per_client", "tx_params", "pms"):
                np.testing.assert_array_equal(oc[key].numpy(), np.asarray(jouts[t][key]),
                                              err_msg=key)
            assert np.abs(oc["acc"].numpy() - np.asarray(jouts[t]["acc"])).max() <= 1e-6


def test_cohort_run_end_to_end_stateless(jax_ds, port_ds):
    """cohort_size bounds the trained lanes; the history records the lane
    count; steady-state cohorts hold 4 clients."""
    hj, ht = _runs(jax_ds, port_ds, strategy="fedavg", personalization="none", fraction=0.25,
                   rounds=4, epochs=1, cohort_size=4)
    _assert_same_run(ht, hj)
    assert np.isfinite(ht.accuracy_mean).all()
    np.testing.assert_array_equal(ht.in_flight, 4)
    assert (ht.selected[1:].sum(axis=1) == 4).all()


def test_cohort_run_with_lossy_codec_and_dld(jax_ds, port_ds):
    """A cohort of 8 of 16 with int8 error feedback (the EF residuals
    scatter back by client id) and DLD partial sharing."""
    hj, ht = _runs(jax_ds, port_ds, strategy="acsp-fl", personalization="dld", rounds=5,
                   epochs=1, codec="int8", cohort_size=8)
    _assert_same_run(ht, hj)
    assert ht.accuracy_mean[-1] > ht.accuracy_mean[0]
    assert (ht.selected.sum(axis=1) <= 8).all()


@pytest.mark.parametrize("kw", [
    dict(strategy="oort", personalization="ft", fraction=0.5, cohort_size=5),
    dict(strategy="acsp-fl", personalization="dld", cohort_size=6),
    dict(strategy="oort", personalization="pms", fraction=0.75, codec="int4", cohort_size=10),
], ids=["oort+ft+k5", "acsp-fl+dld+k6", "oort+pms+int4+k10"])
def test_cohort_runs_match_jax(jax_ds, port_ds, kw):
    """Stateful FT (the local slab gathered and scattered), partial sharing
    and an int4 uplink at K < C, with more clients selected than lanes."""
    hj, ht = _runs(jax_ds, port_ds, rounds=4, epochs=1, **kw)
    _assert_same_run(ht, hj)
    np.testing.assert_array_equal(ht.in_flight, kw["cohort_size"])
    assert (ht.selected.sum(axis=1) <= kw["cohort_size"]).all()


def test_eval_every_carries_last_known_accuracy(jax_ds, port_ds):
    kw = dict(strategy="fedavg", personalization="none", fraction=0.5, rounds=6, epochs=1)
    hj, thinned = _runs(jax_ds, port_ds, eval_every=2, **kw)
    _assert_same_run(thinned, hj, acc_tol=6e-8)
    with prng.threefry_partitionable(False):
        every = run_federated(port_ds, FLConfig(**kw), device="cpu")
        thinned_own = run_federated(port_ds, FLConfig(eval_every=2, **kw), device="cpu")
    acc = thinned_own.accuracy_per_client
    # skipped rounds repeat the previous row; evaluation rounds match the
    # every-round run exactly (selection is rng-driven, not accuracy-driven)
    for t in range(6):
        want = every.accuracy_per_client[t] if t % 2 == 0 else acc[t - 1]
        np.testing.assert_array_equal(acc[t], want)


@pytest.mark.parametrize("kw", [
    dict(strategy="acsp-fl", personalization="dld", codec="int8", eval_every=3),
    dict(strategy="oort", personalization="ft", fraction=0.5, eval_every=2, cohort_size=6),
], ids=["acsp-fl+dld+int8+eval3", "oort+ft+eval2+k6"])
def test_thinned_eval_runs_match_jax(jax_ds, port_ds, kw):
    """Selection reads the carried accuracy and loss on skipped rounds."""
    hj, ht = _runs(jax_ds, port_ds, rounds=5, epochs=1, **kw)
    _assert_same_run(ht, hj, acc_tol=6e-8)
    acc = ht.accuracy_per_client
    for t in range(5):
        if t % kw["eval_every"]:
            np.testing.assert_array_equal(acc[t], acc[t - 1])
