"""Fused chunks of rounds (``ExecutionConfig.scan_chunk``,
``repro_torch.fl.api.build_chunk_step``) on the CPU, the cases of
``tests/test_loop_fused.py``.

Contracts:

- every chunk size, tail chunks included, gives the per-round loop's
  ``FLHistory`` bit for bit (every field but the measured ``wall_time``),
  also with thinned evaluation (the port selects the carried values on the
  device instead of branching, so there is no ``lax.cond`` carve-out);
- through every chunk size the port, from the JAX init in jax's legacy
  threefry stream, gives the committed golden selections and the committed
  golden accuracy within 1e-6 a round (``tests/test_torch_fl.py``'s
  contract);
- a round step reads nothing back to the host and copies nothing from it
  (what a CUDA-graph capture refuses), checked here by the aten ops it
  dispatches;
- the chunk step updates its state in place and returns the rounds'
  records stacked; progress prints at chunk boundaries.

On the card ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
CUDA-graph replays to the eager rounds bitwise.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")  # the JAX init and goldens these tests compare with

from repro.models.mlp import init_mlp as jax_init_mlp  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs.base import ExecutionConfig  # noqa: E402
from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.fl import FLConfig, api, run_federated  # noqa: E402
from repro_torch.fl.sched import _progress_rows, _setup_run, initial_state  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

from test_fl_api import _GOLDEN  # noqa: E402  the 4 committed golden trajectories

FIXTURE = dict(n_clients=8, n_classes=4, n_features=20, samples_per_client_range=(60, 90),
               dirichlet_alpha=50.0, client_shift=0.05, class_sep=5.0, seed=1)


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
def small_ds():
    return make_federated_classification(**FIXTURE)


@pytest.fixture(scope="module")
def jax_g0():
    with jax.threefry_partitionable(False):
        r_init, _ = jax.random.split(jax.random.PRNGKey(0))
        return jax.device_get(jax_init_mlp(r_init, FIXTURE["n_features"], FIXTURE["n_classes"]))


def _run(ds, g0=None, **kw):
    init_fn = None if g0 is None else (lambda key: params_from_numpy(g0, key.device))
    with prng.threefry_partitionable(False):
        return run_federated(ds, FLConfig(epochs=1, **kw), device="cpu", init_fn=init_fn)


def _assert_same_history(h, ref, what):
    for field in ref._fields:
        if field != "wall_time":
            np.testing.assert_array_equal(np.asarray(getattr(h, field)),
                                          np.asarray(getattr(ref, field)),
                                          err_msg=f"{what} field={field}")


def test_build_chunk_step_rejects_bad_length(small_ds):
    cfg = FLConfig(rounds=2, epochs=1)
    rs = api.build_round_step(api.build_env(small_ds, 0, "cpu"), api.pipeline_from_config(cfg),
                              cfg.execution)
    with pytest.raises(ValueError, match="chunk length"):
        api.build_chunk_step(rs, 0)


@pytest.mark.parametrize("chunk", [1, 2, 7])
@pytest.mark.parametrize("name", sorted(_GOLDEN))
def test_goldens_bit_identical_through_fused_scan(small_ds, jax_g0, name, chunk):
    """Chunk sizes 1, 2 (a tail) and 7 (more than the run, capped): the
    committed golden selections, accuracy within 1e-6 of the committed
    golden, and chunk 1's history bit for bit."""
    gold = _GOLDEN[name]
    h = _run(small_ds, jax_g0, rounds=5, scan_chunk=chunk, **gold["cfg"])
    want_acc = np.frombuffer(bytes.fromhex(gold["acc_hex"]), np.dtype("<f4"))
    assert np.abs(h.accuracy_mean - want_acc).max() <= 1e-6
    got_sel = ["".join("1" if b else "0" for b in row) for row in h.selected]
    assert got_sel == gold["selected"]
    if chunk != 1:
        _assert_same_history(h, _run(small_ds, jax_g0, rounds=5, **gold["cfg"]), f"chunk={chunk}")


def test_full_history_identical_across_chunk_sizes(small_ds):
    """Every FLHistory field is identical between per-round and fused
    execution, including the rounds % scan_chunk != 0 tail (5 = 3 + 2)."""
    ref = _run(small_ds, rounds=5, codec="int8")
    for chunk in (3, 5, 0):  # tail chunk, exact fit, whole-run fuse
        _assert_same_history(_run(small_ds, rounds=5, codec="int8", scan_chunk=chunk), ref,
                             f"chunk={chunk}")


def test_eval_thinning_under_scan(small_ds):
    """eval_every > 1 composes with fused chunks, bit for bit at every
    chunk size (per-round dispatch included)."""
    kw = dict(strategy="fedavg", personalization="none", fraction=1.0, rounds=6, eval_every=3)
    ref = _run(small_ds, **kw)
    for chunk in (4, 2):  # 6 = 4 + 2, a chunk across evaluations; boundaries between them
        _assert_same_history(_run(small_ds, scan_chunk=chunk, **kw), ref, f"chunk={chunk}")
    acc = ref.accuracy_per_client
    np.testing.assert_array_equal(acc[1], acc[0])  # t = 1, 2 carry t = 0's evaluation
    np.testing.assert_array_equal(acc[2], acc[0])
    assert not np.array_equal(acc[3], acc[2])      # t = 3 evaluates again


def test_ft_personalization_through_fused_scan(small_ds):
    """Stateful FT: the (C, P) local slab carried in the chunk step's
    buffers survives chunking."""
    kw = dict(strategy="oort", personalization="ft", fraction=0.5, rounds=5)
    _assert_same_history(_run(small_ds, scan_chunk=2, **kw), _run(small_ds, **kw), "ft")


def test_cohort_composes_with_fused_scan(small_ds):
    """cohort_size < C gathered execution is unchanged by chunking."""
    kw = dict(strategy="oort", personalization="none", fraction=0.5, rounds=4, cohort_size=4)
    _assert_same_history(_run(small_ds, scan_chunk=3, **kw), _run(small_ds, **kw), "4 = 3 + 1")


def _start(ds, **kw):
    cfg = FLConfig(epochs=1, **kw)
    su = _setup_run(ds, cfg, torch.device("cpu"), None, api.mlp_loss, api.mlp_accuracy, None,
                    None, None)
    return initial_state(su, ds.n_clients), api.build_round_step(su.env, su.pipeline,
                                                                 cfg.execution)


def test_chunk_step_updates_its_state_in_place(small_ds):
    """The chunk step adopts the state's tensors as its buffers and writes
    each chunk's final state into them (the counterpart of donation): the
    state passed in is the state returned, and it holds the new state, the
    one two plain round steps reach from the same start."""
    state, round_step = _start(small_ds, rounds=4)
    w_before = state.local_params[0]["w"].clone()
    step = api.build_chunk_step(round_step, 2)
    new, outs = step(state, torch.arange(2, dtype=torch.int32))
    assert all(a is b for a, b in zip(tree_leaves(list(new)), tree_leaves(list(state))))
    assert not torch.equal(state.local_params[0]["w"], w_before)
    assert outs["acc"].shape == (2, small_ds.n_clients) and outs["rejected"].shape == (2,)
    ref, _ = _start(small_ds, rounds=4)  # the same start, in tensors of its own
    for t in range(2):
        ref, out = round_step(ref, t)
        assert torch.equal(out["acc"], outs["acc"][t])
    for a, b in zip(tree_leaves(list(ref)), tree_leaves(list(new))):
        assert torch.equal(a, b)
    # a state that is not the buffers is copied into them
    copy = api._state_like(ref, [leaf.clone() for leaf in tree_leaves(list(ref))])
    again, _ = step(copy, torch.arange(2, 4, dtype=torch.int32))
    assert again.accuracy is new.accuracy
    with pytest.raises(ValueError, match="round indices"):
        step(again, torch.arange(3, dtype=torch.int32))


def test_stacked_outs_fetch_one_buffer():
    outs = [{"acc": torch.full((3,), float(t)), "selected": torch.tensor([True, False, t == 1]),
             "rejected": torch.tensor(t, dtype=torch.int32),
             "pms": torch.arange(3, dtype=torch.int32) + t} for t in range(2)]
    stacked = api.StackedOuts(outs)
    host = stacked.numpy()
    assert all(v.untyped_storage().data_ptr() == stacked.packed.untyped_storage().data_ptr()
               for v in stacked.values())
    np.testing.assert_array_equal(host["acc"], [[0.0] * 3, [1.0] * 3])
    np.testing.assert_array_equal(host["selected"], [[True, False, False], [True, False, True]])
    assert host["selected"].dtype == np.bool_ and host["pms"].dtype == np.int32
    np.testing.assert_array_equal(host["rejected"], [0, 1])
    np.testing.assert_array_equal(host["pms"], [[0, 1, 2], [1, 2, 3]])


class _NoHostTraffic(TorchDispatchMode):
    """Fails on the aten ops that move data between host and device inside a
    round: a tensor made from host data (``torch.tensor``, a Python number
    set into a tensor) and a read of a device value (``.item()``,
    ``nonzero``)."""

    BANNED = {torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED:
            raise AssertionError(f"the round step calls {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("partitionable", [True, False], ids=["partitionable", "legacy"])
@pytest.mark.parametrize("kw", [
    dict(codec="int8"), dict(codec="int4", cohort_size=5, eval_every=2), dict(codec="topk+int8"),
    dict(strategy="oort", personalization="ft", fraction=0.5),
    dict(strategy="fedavg", personalization="none", fraction=0.5), dict(strategy="oort-fair"),
    dict(strategy="poc"), dict(personalization="pms"),
    dict(codec="int8", edge_groups=3),
    dict(strategy="oort", personalization="ft", fraction=0.5, cohort_size=5, edge_groups=2),
], ids=["int8", "int4+k5+eval2", "topk+int8", "oort+ft", "fedavg-half", "oort-fair", "poc", "pms",
        "int8+E3", "oort+ft+k5+E2"])
def test_round_step_makes_no_host_traffic(small_ds, kw, partitionable):
    """What a CUDA-graph capture refuses, caught on the CPU: the round step
    with the round index as a device tensor, as a captured chunk runs it."""
    with prng.threefry_partitionable(partitionable):
        state, round_step = _start(small_ds, rounds=3, **kw)
        ts = torch.arange(3, dtype=torch.int32)
        with _NoHostTraffic():
            for t in range(3):
                state, _ = round_step(state, ts[t])


def test_progress_prints_at_chunk_boundaries(small_ds, capsys):
    run_federated(small_ds, FLConfig(strategy="fedavg", personalization="none", fraction=1.0,
                                     rounds=5, epochs=1, scan_chunk=2), device="cpu",
                  progress=True)
    lines = [line for line in capsys.readouterr().out.splitlines() if "round" in line]
    # t = 0, each chunk's last round (1, 3), and the final round (4)
    assert [int(line.split()[1]) for line in lines] == [0, 1, 3, 4]


def test_progress_legacy_cadence_at_chunk_one(small_ds, capsys):
    run_federated(small_ds, FLConfig(strategy="fedavg", personalization="none", fraction=1.0,
                                     rounds=12, epochs=1), device="cpu", progress=True)
    lines = [line for line in capsys.readouterr().out.splitlines() if "round" in line]
    assert [int(line.split()[1]) for line in lines] == [0, 10, 11]  # every 10th + the last


def test_progress_rows_match_the_reference():
    from repro.fl.sched import _progress_rows as jax_progress_rows

    for rounds in (1, 5, 12, 23):
        for chunk in (1, 2, 3, 5, 7, rounds):
            for t0 in range(0, rounds, chunk):
                n = min(chunk, rounds - t0)
                assert _progress_rows(t0, n, chunk, rounds) == jax_progress_rows(t0, n, chunk,
                                                                                 rounds)


def test_scan_chunk_resolution():
    assert ExecutionConfig().resolved_chunk(100) == 1
    assert ExecutionConfig(scan_chunk=7).resolved_chunk(100) == 7
    assert ExecutionConfig(scan_chunk=7).resolved_chunk(5) == 5   # capped
    assert ExecutionConfig(scan_chunk=0).resolved_chunk(100) == 100  # whole run
