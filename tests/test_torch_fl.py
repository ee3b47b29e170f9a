"""The ported slice as a whole: the synchronous ACSP-FL round of the port
against the JAX package's, on the golden configurations of
``tests/test_fl_api.py``.

The committed golden trajectories were drawn from jax's legacy threefry
stream (``jax_threefry_partitionable=False``); under the installed jax's
default (partitionable) stream the JAX package no longer reproduces them.
Both packages are compared in the legacy stream on all four configurations
(and must also give the committed bitstrings there), and in the default
stream on the two that draw random numbers every round (int8 noise, Oort
exploration).

Contracts (both packages start from the JAX init, carried over with
``params_from_numpy``):

- ``selected`` and ``pms`` identical, ``tx_params``, ``tx_wire_bytes`` and
  the simulated ``round_time`` exactly equal;
- ``accuracy_mean`` within 1e-6 a round (one flipped prediction on the
  fixture moves it by >= 5.7e-3);
- one round from the same ``RoundState``: global and local parameters and
  EF residuals within rtol 1e-5 / atol 1e-6 (the aggregation's client sum
  and the CPU GEMMs run in another order than XLA's; under int8 a code may
  flip, see ``_assert_round_close``), the round's records exactly equal
  (accuracy within 1e-6).

The port's own init (threefry ``normal``, within 4 ulp of jax's) also
reproduces the committed golden selection bitstrings.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.data import make_federated_classification as jax_make_data  # noqa: E402
from repro.fl import FLConfig as JaxFLConfig  # noqa: E402
from repro.fl import api as jax_api  # noqa: E402
from repro.fl import run_federated as jax_run_federated  # noqa: E402
from repro.fl.sched import _setup_run as jax_setup_run  # noqa: E402
from repro.models.mlp import init_mlp as jax_init_mlp  # noqa: E402
from repro.models.mlp import mlp_apply as jax_mlp_apply  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.data import make_federated_classification, make_har_dataset  # noqa: E402
from repro_torch.fl import FLConfig, api, run_federated  # noqa: E402
from repro_torch.models.mlp import mlp_apply  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.weights import params_from_numpy, state_from_numpy  # noqa: E402

FIXTURE = dict(
    n_clients=8, n_classes=4, n_features=20,
    samples_per_client_range=(60, 90), dirichlet_alpha=50.0,
    client_shift=0.05, class_sep=5.0, seed=1,
)

# tests/test_fl_api.py::_GOLDEN (configs and committed selection bitstrings)
GOLDEN = {
    "acsp-fl+dld+float32": (dict(), ["11111111", "11110100", "10001100", "01000101", "00111100"]),
    "fedavg+none+float32": (dict(strategy="fedavg", personalization="none", fraction=1.0),
                            ["11111111"] * 5),
    "oort+ft+float32": (dict(strategy="oort", personalization="ft", fraction=0.5),
                        ["11111111", "10010110", "10010101", "01010101", "10010101"]),
    "acsp-fl+dld+int8": (dict(codec="int8"),
                         ["11111111", "11110100", "10001100", "01000101", "00111100"]),
}


@pytest.fixture(scope="module")
def jax_ds():
    return jax_make_data(**FIXTURE)


@pytest.fixture(scope="module")
def port_ds():
    return make_federated_classification(**FIXTURE)


def _jax_init(ds, seed=0):
    r_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.device_get(jax_init_mlp(r_init, ds.n_features, ds.n_classes))


# (config, threefry stream) pairs compared end to end
CASES = [(name, False) for name in sorted(GOLDEN)] + [
    ("acsp-fl+dld+int8", True), ("oort+ft+float32", True)]


@pytest.fixture(scope="module")
def jax_runs(jax_ds):
    runs = {}
    for name, partitionable in CASES:
        with jax.threefry_partitionable(partitionable):
            cfg = JaxFLConfig(rounds=5, epochs=1, **GOLDEN[name][0])
            runs[name, partitionable] = (jax_run_federated(jax_ds, cfg), _jax_init(jax_ds))
    return runs


def _bits(selected):
    return ["".join("1" if b else "0" for b in row) for row in np.asarray(selected)]


def test_datasets_bitwise_equal(jax_ds, port_ds):
    for field in ("x_train", "y_train", "m_train", "x_test", "y_test", "m_test", "n_samples"):
        a, b = np.asarray(getattr(jax_ds, field)), np.asarray(getattr(port_ds, field))
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all(), field
    from repro.data import make_har_dataset as jax_har

    a, b = jax_har("uci-har", seed=3, scale=0.1), make_har_dataset("uci-har", seed=3, scale=0.1)
    assert (np.asarray(a.x_train) == np.asarray(b.x_train)).all()
    assert (np.asarray(a.y_test) == np.asarray(b.y_test)).all()


@pytest.mark.parametrize("name,partitionable", CASES,
                         ids=[f"{n}-{'partitionable' if p else 'legacy'}" for n, p in CASES])
def test_run_federated_matches_jax(jax_runs, port_ds, name, partitionable):
    cfg, want_bits = GOLDEN[name]
    hj, g0 = jax_runs[name, partitionable]
    with prng.threefry_partitionable(partitionable):
        ht = run_federated(port_ds, FLConfig(rounds=5, epochs=1, **cfg), device="cpu",
                           init_fn=lambda key: params_from_numpy(g0, key.device))
    assert _bits(ht.selected) == _bits(hj.selected)
    if not partitionable:
        assert _bits(hj.selected) == want_bits
    np.testing.assert_array_equal(ht.pms, np.asarray(hj.pms))
    np.testing.assert_array_equal(ht.tx_params, np.asarray(hj.tx_params))
    np.testing.assert_array_equal(ht.tx_wire_bytes, np.asarray(hj.tx_wire_bytes))
    np.testing.assert_array_equal(ht.tx_bytes_cum, np.asarray(hj.tx_bytes_cum))
    np.testing.assert_array_equal(ht.round_time, np.asarray(hj.round_time))
    np.testing.assert_array_equal(ht.rejected_updates, np.asarray(hj.rejected_updates))
    assert np.abs(ht.accuracy_mean - np.asarray(hj.accuracy_mean)).max() <= 1e-6


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_port_init_reproduces_golden_selection(port_ds, name):
    cfg, want_bits = GOLDEN[name]
    with prng.threefry_partitionable(False):
        h = run_federated(port_ds, FLConfig(rounds=5, epochs=1, **cfg), device="cpu")
    assert _bits(h.selected) == want_bits
    assert h.accuracy_mean[-1] > h.accuracy_mean[0]


def _assert_round_close(got, want, lossy, what):
    """rtol 1e-5 / atol 1e-6. Under int8 the last-bit differences of local
    training can move a value across a quantization code boundary; such a
    flipped code moves the decoded update and the residual by one step of
    its block (max|x|/127 of deltas of at most ~0.1 here, so <= 1e-3), and
    it may touch at most 0.1% of a field's elements."""
    off = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
    if not lossy:
        assert not off.any(), (what, np.abs(got - want).max())
        return
    assert off.mean() <= 1e-3 and np.abs(got - want).max() <= 1e-3, (what, off.mean())


@pytest.mark.parametrize("name", ["acsp-fl+dld+int8", "oort+ft+float32", "fedavg+none+float32"])
def test_one_round_step_from_the_same_state(jax_ds, port_ds, name):
    """Round 2 of a run, from the JAX state after round 1, through both
    ``build_round_step``s."""
    cfg_kw, _ = GOLDEN[name]
    jcfg = JaxFLConfig(rounds=3, epochs=1, **cfg_kw)
    su = jax_setup_run(jax_ds, jcfg, None, jax_api.mlp_loss, jax_api.mlp_accuracy, None, None, None)
    state = jax_api.RoundState(
        global_params=su.g0, local_params=su.loc0,
        accuracy=jnp.zeros((jax_ds.n_clients,)),
        select=jnp.ones((jax_ds.n_clients,), bool),
        pms=jnp.full((jax_ds.n_clients,), su.pms0, jnp.int32),
        rng=su.r_loop, residual=su.residual0,
        participation=jnp.zeros((jax_ds.n_clients,), jnp.int32),
        loss=jnp.zeros((jax_ds.n_clients,), jnp.float32),
        update_norm=jnp.zeros((jax_ds.n_clients,), jnp.float32),
    )
    jstep = jax.jit(jax_api.build_round_step(su.env, su.pipeline, jcfg.execution))
    state, _ = jstep(state, jnp.asarray(0))
    start = jax.device_get(state)
    jnew, jout = jax.device_get(jstep(state, jnp.asarray(1)))

    tcfg = FLConfig(rounds=3, epochs=1, **cfg_kw)
    tstep = api.build_round_step(api.build_env(port_ds, tcfg.seed, "cpu"),
                                 api.pipeline_from_config(tcfg), tcfg.execution)
    tnew, tout = tstep(state_from_numpy(start, "cpu"), 1)

    for field in ("global_params", "local_params", "residual"):
        jl = jax.tree.leaves(getattr(jnew, field))
        tl = tree_leaves(getattr(tnew, field))
        assert len(jl) == len(tl), field
        for a, b in zip(jl, tl):
            _assert_round_close(b.numpy(), np.asarray(a), lossy=name.endswith("int8"), what=field)
    assert np.abs(tout["acc"].numpy() - np.asarray(jout["acc"])).max() <= 1e-6
    for key in ("selected", "tx_params", "pms", "wire_per_client", "rejected"):
        np.testing.assert_array_equal(tout[key].numpy(), np.asarray(jout[key]), err_msg=key)
    np.testing.assert_array_equal(tnew.select.numpy(), np.asarray(jnew.select))
    np.testing.assert_array_equal(tnew.pms.numpy(), np.asarray(jnew.pms))
    np.testing.assert_array_equal(tnew.rng.numpy(), np.asarray(jnew.rng).astype(np.int64))
    np.testing.assert_allclose(tnew.update_norm.numpy(), np.asarray(jnew.update_norm), rtol=1e-5)


def test_params_from_numpy_logits_match(jax_ds):
    g0 = _jax_init(jax_ds)
    x = np.asarray(jax_ds.x_test[0])
    want = np.asarray(jax_mlp_apply(g0, jnp.asarray(x)))
    got = mlp_apply(params_from_numpy(g0, "cpu"), torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    # stacked per-lane weights give each lane's own logits
    stacked = [{k: np.stack([v, v * 0.5]) for k, v in layer.items()} for layer in g0]
    two = mlp_apply(params_from_numpy(stacked, "cpu"), torch.from_numpy(np.stack([x, x])))
    assert np.abs(two[0].numpy() - want).max() <= 1e-5
