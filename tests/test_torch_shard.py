"""Sharded cohort rounds of the port (``repro_torch.fl.shard``) over
``torch.distributed`` on the CPU (gloo).

The JAX package's own sharded tests fail under the installed jax (ROADMAP.md
queue 3), so the port is held to three contracts of its own:

- world 1, in process: the sharded run is bitwise the port's unsharded run
  (every ``FLHistory`` field but ``wall_time``), on the four committed
  goldens and a K < C cohort, at ``scan_chunk`` 1 and 3;
- worlds 2 and 4, one gloo process a rank (spawned with a ``FileStore``
  under ``tmp_path``): the committed goldens to the JAX package's D > 1
  contract (``accuracy_mean`` within 1 ulp, the selections exact), chunked
  = per-round, K < C within 1 ulp of the unsharded run, every rank's
  histories and final state bitwise equal, and the aggregation bitwise the
  port's edge mode with ``edge_ids = lane // (K/D)`` and ``n_edges = D`` —
  on seeded lanes for the three aggregators and on a real round 0;
- the partial and combine modes' plain versions against the JAX package's
  ``_weighted_mean`` with ``axis_name`` (run under ``jax.vmap`` with a named
  axis, whose ``psum`` sums the D shards) within 2 float32 ulp.

The spawned ranks import this module (without jax) and run ``_rank_main``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import random as prng
from repro_torch.configs.base import ExecutionConfig
from repro_torch.core.aggregation import (
    fedavg_aggregate,
    masked_partial_aggregate,
    staleness_weighted_merge,
)
from repro_torch.data import make_federated_classification
from repro_torch.fl import FLConfig, api, phases, pipeline_from_config, run_federated
from repro_torch.fl.sched import _setup_run, initial_state
from repro_torch.fl.shard import build_sharded_round_step, shard_collective_bytes
from repro_torch.kernels.masked_aggregate import (
    masked_aggregate_combine,
    masked_aggregate_combine_plain,
    masked_aggregate_leaves,
    masked_aggregate_partial,
    masked_aggregate_partial_plain,
    partial_layout,
)
from repro_torch.launch.collectives import collective_breakdown_str, collective_bytes
from repro_torch.launch.mesh import make_cohort_mesh
from repro_torch.models.mlp import mlp_accuracy, mlp_loss
from repro_torch.obs import RunRecorder
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]

FIXTURE = dict(n_clients=8, n_classes=4, n_features=20, samples_per_client_range=(60, 90),
               dirichlet_alpha=50.0, client_shift=0.05, class_sep=5.0, seed=1)

# tests/test_fl_api.py::_GOLDEN: configs, committed accuracy_mean (hex of
# little-endian float32) and selection bitstrings (jax's legacy stream)
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
KC = dict(strategy="poc", fraction=0.5, rounds=4, epochs=1, cohort_size=4, codec="int8")
CHUNKED = dict(rounds=6, epochs=1, codec="int8")
STATE_RUN = dict(rounds=3, epochs=1, codec="int8")  # acsp-fl + dld: stateful, lossy
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 600


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors (the suite runs in
    several worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def small_ds():
    return make_federated_classification(**FIXTURE)


def _bits(selected):
    return ["".join("1" if b else "0" for b in row) for row in np.asarray(selected)]


def _ulp(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def _history_diff(h, ref) -> list:
    return [f for f in ref._fields if f != "wall_time" and getattr(ref, f) is not None
            and not np.array_equal(np.asarray(getattr(h, f)), np.asarray(getattr(ref, f)))]


def _no_group():
    return not dist.is_initialized()


# ---------------------------------------------------------------------------
# config plumbing and the JAX package's errors
# ---------------------------------------------------------------------------


def test_cohort_devices_flat_kwarg_and_validation():
    cfg = FLConfig(cohort_devices=2)
    assert cfg.cohort_devices == 2 and cfg.execution.cohort_devices == 2
    assert FLConfig().cohort_devices == 0
    with pytest.raises(ValueError, match="cohort_devices"):
        ExecutionConfig(cohort_devices=-2)
    with pytest.raises(ValueError, match="host_population=1 does not compose"):
        ExecutionConfig(host_population=1, cohort_devices=1)
    assert not ExecutionConfig(cohort_devices=1).resolved_host_population(10**7)


class _StubMesh:
    def __init__(self, **shape):
        self.shape, self.rank, self.world = shape, 0, max(shape.values())


def test_cohort_lanes_must_divide_mesh(small_ds):
    cfg = FLConfig(rounds=1)
    env = api.build_env(small_ds, cfg.seed, "cpu")
    pipe = pipeline_from_config(cfg)
    # 8 lanes over a 3-way cohort axis: rejected before any compute
    with pytest.raises(ValueError, match="must divide"):
        build_sharded_round_step(env, pipe, cfg.execution, mesh=_StubMesh(cohort=3))
    # a mesh without the cohort axis is rejected too
    with pytest.raises(ValueError, match="cohort"):
        build_sharded_round_step(env, pipe, cfg.execution, mesh=_StubMesh(data=2))
    # a K < C cohort must divide as well
    with pytest.raises(ValueError, match="must divide"):
        build_sharded_round_step(env, pipe, ExecutionConfig(cohort_size=6),
                                 mesh=_StubMesh(cohort=4))


def test_custom_aggregator_without_axis_name_rejected(small_ds):
    class Opaque(phases.Aggregator):
        def aggregate(self, ctx, env):
            return ctx

    cfg = FLConfig(rounds=1, cohort_devices=1)
    env = api.build_env(small_ds, cfg.seed, "cpu")
    pipe = dataclasses.replace(pipeline_from_config(cfg), aggregator=Opaque())
    with pytest.raises(TypeError, match="axis_name"):
        build_sharded_round_step(env, pipe, cfg.execution)
    assert _no_group()  # the world-1 group it opened was closed again


def test_faults_with_sharding_raise(small_ds):
    with pytest.raises(ValueError, match="FaultConfig"):
        run_federated(small_ds, FLConfig(rounds=2, epochs=1, dropout_rate=0.3, cohort_devices=1),
                      device="cpu")
    env = api.build_env(small_ds, 0, "cpu")
    cfg = FLConfig(dropout_rate=0.3, cohort_devices=1)
    with pytest.raises(ValueError, match="FaultConfig"):
        api.build_round_step(env, pipeline_from_config(cfg), cfg.execution, cfg.faults)
    assert _no_group()


def test_world_above_one_without_a_group_names_torchrun(small_ds):
    with pytest.raises(ValueError, match="torchrun"):
        run_federated(small_ds, FLConfig(rounds=1, epochs=1, cohort_devices=2), device="cpu")
    with pytest.raises(ValueError, match="need >= 1"):
        make_cohort_mesh(-3, device="cpu")
    assert _no_group()


def test_sharded_step_exposes_mesh(small_ds):
    cfg = FLConfig(rounds=1, cohort_devices=1)
    env = api.build_env(small_ds, cfg.seed, "cpu")
    step = api.build_round_step(env, pipeline_from_config(cfg), cfg.execution)
    try:
        assert step.mesh.shape == {"cohort": 1} and step.mesh.axis_names == ("cohort",)
        assert step.mesh.backend == "gloo" and step.mesh.rank == 0 and step.mesh.size == 1
        assert step.lanes_per_device == small_ds.n_clients
        assert dist.is_initialized() and dist.get_world_size() == 1
        with pytest.raises(ValueError, match="3 devices requested"):
            make_cohort_mesh(3, device="cpu")  # a group of 1 is there now
    finally:
        step.mesh.close()
    assert _no_group()


def test_manifest_records_cohort_mesh(small_ds, tmp_path):
    run_federated(small_ds, FLConfig(rounds=2, epochs=1, cohort_devices=1), device="cpu",
                  recorder=RunRecorder(out_dir=str(tmp_path / "run"), echo=False))
    m = json.load(open(tmp_path / "run" / "manifest.json"))
    assert m["mesh"] == {"axis_names": ["cohort"], "shape": [1], "devices": 1}
    # unsharded runs record no mesh
    run_federated(small_ds, FLConfig(rounds=2, epochs=1), device="cpu",
                  recorder=RunRecorder(out_dir=str(tmp_path / "run2"), echo=False))
    assert json.load(open(tmp_path / "run2" / "manifest.json"))["mesh"] is None
    assert _no_group()


def test_async_ignores_cohort_devices(small_ds):
    """The JAX package's async scheduler has no sharded step and runs
    unsharded whatever ``cohort_devices`` says; so does the port's."""
    kw = dict(rounds=4, epochs=1, codec="int8", scheduler="async", buffer_k=2, max_concurrency=4)
    ref = run_federated(small_ds, FLConfig(**kw), device="cpu")
    h = run_federated(small_ds, FLConfig(cohort_devices=1, **kw), device="cpu")
    assert not _history_diff(h, ref)
    assert _no_group()


# ---------------------------------------------------------------------------
# world 1, in process: bitwise the unsharded runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_world1_goldens_bitwise_unsharded(small_ds, name, chunk):
    cfg, acc_hex, bits = GOLDEN[name]
    with prng.threefry_partitionable(False):
        ref = run_federated(small_ds, FLConfig(rounds=5, epochs=1, **cfg), device="cpu")
        h = run_federated(small_ds, FLConfig(rounds=5, epochs=1, cohort_devices=1,
                                             scan_chunk=chunk, **cfg), device="cpu")
    assert not _history_diff(h, ref)
    assert h.accuracy_mean.astype(np.float32).tobytes().hex() == acc_hex
    assert _bits(h.selected) == bits
    assert _no_group()


@pytest.mark.parametrize("chunk", [1, 3])
def test_world1_cohort_k_lt_c_bitwise_unsharded(small_ds, chunk):
    ref = run_federated(small_ds, FLConfig(**KC), device="cpu")
    h = run_federated(small_ds, FLConfig(cohort_devices=1, scan_chunk=chunk, **KC), device="cpu")
    assert not _history_diff(h, ref)
    assert (h.in_flight == 4).all() and (h.selected.sum(axis=1) <= 4).all()


def test_world1_round_step_makes_no_host_traffic(small_ds):
    """What a CUDA-graph capture refuses (a tensor from host data, a read of
    a device value), caught on the CPU in the sharded step too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoHostTraffic(TorchDispatchMode):
        BANNED = {torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default,
                  torch.ops.aten.nonzero.default}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in self.BANNED:
                raise AssertionError(f"the round step calls {func}")
            return func(*args, **(kwargs or {}))

    cfg = FLConfig(epochs=1, codec="int8", cohort_size=4, cohort_devices=1)
    su = _setup_run(small_ds, cfg, torch.device("cpu"), None, mlp_loss, mlp_accuracy, None,
                    None, None)
    state = initial_state(su, small_ds.n_clients)
    step = api.build_round_step(su.env, su.pipeline, cfg.execution)
    try:
        ts = torch.arange(2, dtype=torch.int32)
        with NoHostTraffic():
            for t in range(2):
                state, out = step(state, ts[t])
        assert out["rejected"].dtype == torch.int32 and int(out["rejected"]) == 0
    finally:
        step.mesh.close()


# ---------------------------------------------------------------------------
# worlds 2 and 4: one gloo process a rank
# ---------------------------------------------------------------------------


def _agg_inputs(k: int):
    """Seeded lanes for the three aggregators: 3 layers of 8 leaves' worth
    of shapes, weights with an unselected lane, a layer nobody shares
    (its fallback), snapshots and staleness weights for the merge."""
    rng = np.random.default_rng(11)
    shapes = [[(5,), (6, 5)], [(3,), (5, 3)], [(2,), (3, 2)]]
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = [[f32(k, *s) for s in layer] for layer in shapes]
    snaps = [[f32(k, *s) for s in layer] for layer in shapes]
    prev = [[f32(*s) for s in layer] for layer in shapes]
    sel = rng.random(k) < 0.8
    sel[0] = True
    n = rng.integers(60, 90, k).astype(np.float32)
    share = rng.random((k, 3)) < 0.7
    share[:, 2] = False
    stale_w = (rng.random(k) * sel).astype(np.float32)
    return x, snaps, prev, sel, n, share, stale_w


def _layers(arrs, lanes=slice(None)):
    return [{f"l{i}": torch.from_numpy(np.ascontiguousarray(a[lanes])) for i, a in enumerate(layer)}
            for layer in arrs]


def _run_aggregators(k: int, lanes: slice, mesh=None, edge_ids=None, n_edges: int = 0) -> dict:
    """The three aggregators on lanes ``lanes`` of ``_agg_inputs(k)``: with a
    mesh over the ranks, or on all lanes with edge ids."""
    x, snaps, prev, sel, n, share, stale_w = _agg_inputs(k)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[lanes]))  # noqa: E731
    g = _layers(prev)
    kw = dict(axis_name=mesh, edge_ids=edge_ids, n_edges=n_edges)
    out = {
        "fedavg": fedavg_aggregate(_layers(x, lanes), t(sel), t(n), **kw),
        "masked": masked_partial_aggregate(_layers(x, lanes), g, t(sel), t(n), t(share), **kw),
        "merge": staleness_weighted_merge(_layers(x, lanes), g, t(stale_w), t(share),
                                          snapshots=_layers(snaps, lanes), **kw),
    }
    return {f"agg/{name}/{i}": leaf.numpy() for name, tree in out.items()
            for i, leaf in enumerate(tree_leaves(tree))}


@dataclasses.dataclass(frozen=True)
class _RecordingAggregator(phases.MaskedPartialAggregator):
    """The masked-partial aggregator, keeping its first call's inputs and
    output (this rank's lanes)."""

    log: list = dataclasses.field(default_factory=list, compare=False)

    def aggregate(self, ctx, env):
        out = super().aggregate(ctx, env)
        if not self.log:
            self.log.append(dict(agg_src=tree_leaves(ctx.agg_src), select=ctx.select,
                                 n=env.n_samples, share=ctx.share,
                                 new_global=tree_leaves(out.new_global)))
        return out


def _put_history(out: dict, prefix: str, h) -> None:
    for f in h._fields:
        v = getattr(h, f)
        if v is not None and f != "wall_time":
            out[f"{prefix}/{f}"] = np.asarray(v)


def _rank_body(rank: int, world: int, out_dir: str) -> dict:
    ds = make_federated_classification(**FIXTURE)
    out: dict = {}
    with prng.threefry_partitionable(False):
        for name, (cfg, _, _) in GOLDEN.items():
            _put_history(out, f"golden/{name}", run_federated(
                ds, FLConfig(rounds=5, epochs=1, cohort_devices=world, **cfg), device="cpu"))
    for chunk in (1, 3):
        _put_history(out, f"chunk{chunk}", run_federated(
            ds, FLConfig(cohort_devices=world, scan_chunk=chunk, **CHUNKED), device="cpu"))
    _put_history(out, "kc", run_federated(ds, FLConfig(cohort_devices=world, **KC), device="cpu"))

    mesh = make_cohort_mesh(world, device="cpu")
    k = 8
    out.update(_run_aggregators(k, slice(rank * k // world, (rank + 1) * k // world), mesh))

    # round 0 of the masked-partial pipeline, its aggregator's inputs kept
    cfg = FLConfig(rounds=1, epochs=1, cohort_devices=world)
    pipe = dataclasses.replace(pipeline_from_config(cfg), aggregator=_RecordingAggregator())
    run_federated(ds, cfg, device="cpu", pipeline=pipe)
    rec = pipe.aggregator.log[0]
    for key in ("select", "n", "share"):
        out[f"round0/{key}"] = rec[key].numpy()
    for i, leaf in enumerate(rec["agg_src"]):
        out[f"round0/agg_src/{i}"] = leaf.numpy()
    for i, leaf in enumerate(rec["new_global"]):
        out[f"round0/new_global/{i}"] = leaf.numpy()

    # the final state after 3 rounds, then one more round under the profiler
    cfg = FLConfig(cohort_devices=world, **STATE_RUN)
    su = _setup_run(ds, cfg, torch.device("cpu"), None, mlp_loss, mlp_accuracy, None, None, None)
    state = initial_state(su, ds.n_clients)
    step = api.build_round_step(su.env, su.pipeline, cfg.execution)
    for t in range(STATE_RUN["rounds"]):
        state, _ = step(state, t)
    for i, leaf in enumerate(tree_leaves(list(state))):
        out[f"state/{i}"] = leaf.numpy()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        step(state, STATE_RUN["rounds"])
    prof.export_chrome_trace(os.path.join(out_dir, f"trace{rank}.json"))
    return out


def _rank_main(rank: str, world: str, store_dir: str, out_dir: str) -> None:
    """One spawned rank: join the gloo group, run ``_rank_body``, save."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(store_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **_rank_body(rank, world, out_dir))
    finally:
        dist.destroy_process_group()


_RANK_SCRIPT = (
    "import sys; sys.path[:0] = [{src!r}, {tests!r}]; import test_torch_shard as m; "
    "m._rank_main(*sys.argv[1:])"
)


def _spawn_world(world: int, base: pathlib.Path) -> list:
    """Run ``_rank_main`` in ``world`` processes; returns each rank's saved
    arrays and the directory with their traces."""
    store, out = base / f"store{world}", base / f"out{world}"
    store.mkdir(parents=True)
    out.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    script = _RANK_SCRIPT.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(world), str(store),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log[-4000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)], out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("shard")
    return {world: _spawn_world(world, base) for world in WORLDS}


@pytest.fixture(scope="module")
def unsharded(small_ds):
    """The port's unsharded runs of the spawned configurations."""
    with prng.threefry_partitionable(False):
        gold = {name: run_federated(small_ds, FLConfig(rounds=5, epochs=1, **cfg), device="cpu")
                for name, (cfg, _, _) in GOLDEN.items()}
    return gold, run_federated(small_ds, FLConfig(**KC), device="cpu")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_worlds_goldens_to_the_jax_contract(worlds, unsharded, name, world):
    """The JAX package's D > 1 contract: the committed accuracy within 1
    ulp of float32, the committed selections exactly (and, observed on this
    fixture as in the JAX package, the unsharded port's accuracy exactly)."""
    ranks, _ = worlds[world]
    _, acc_hex, bits = GOLDEN[name]
    want = np.frombuffer(bytes.fromhex(acc_hex), np.dtype("<f4"))
    got = ranks[0][f"golden/{name}/accuracy_mean"].astype(np.float32)
    assert _ulp(got, want) <= 1
    assert _bits(ranks[0][f"golden/{name}/selected"]) == bits
    np.testing.assert_array_equal(ranks[0][f"golden/{name}/accuracy_mean"],
                                  unsharded[0][name].accuracy_mean)


@pytest.mark.parametrize("world", WORLDS)
def test_worlds_chunked_equal_per_round(worlds, world):
    ranks, _ = worlds[world]
    keys = [k for k in ranks[0] if k.startswith("chunk1/")]
    assert keys
    for key in keys:
        np.testing.assert_array_equal(ranks[0][key], ranks[0][key.replace("chunk1/", "chunk3/")],
                                      err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_worlds_cohort_k_lt_c_against_unsharded(worlds, unsharded, world):
    ranks, _ = worlds[world]
    ref = unsharded[1]
    assert _ulp(ranks[0]["kc/accuracy_mean"], ref.accuracy_mean) <= 1
    for field in ("selected", "pms", "tx_params", "tx_wire_bytes", "round_time", "in_flight"):
        np.testing.assert_array_equal(ranks[0][f"kc/{field}"], getattr(ref, field), err_msg=field)
    if world == 2:  # the JAX package's D = 2 observation: exact
        np.testing.assert_array_equal(ranks[0]["kc/accuracy_mean"], ref.accuracy_mean)


@pytest.mark.parametrize("world", WORLDS)
def test_worlds_every_rank_bitwise_equal(worlds, world):
    """Histories, aggregations and the final state (global and local
    models, residuals, selection, rng) are the same bits on every rank."""
    ranks, _ = worlds[world]
    assert any(k.startswith("state/") for k in ranks[0])
    for r in range(1, world):
        assert sorted(ranks[r]) == sorted(ranks[0])
        for key in ranks[0]:
            if key.startswith("round0/"):  # each rank's own lanes
                continue
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"rank {r} {key}")
    for key in ranks[0]:
        if key.startswith("state/") and ranks[0][key].dtype.kind == "f":
            assert np.isfinite(ranks[0][key]).all(), key


@pytest.mark.parametrize("world", WORLDS)
def test_worlds_aggregators_bitwise_edge_mode(worlds, world):
    """fedavg, masked-partial (with a fallback layer) and the staleness
    merge over D ranks equal the one-process edge mode with rank-block
    ids, bit for bit."""
    ranks, _ = worlds[world]
    k = 8
    ids = (torch.arange(k) // (k // world)).to(torch.int32)
    want = _run_aggregators(k, slice(None), edge_ids=ids, n_edges=world)
    flat = _run_aggregators(k, slice(None))
    assert want.keys() == {key for key in ranks[0] if key.startswith("agg/")}
    for key, value in want.items():
        np.testing.assert_array_equal(ranks[0][key], value, err_msg=key)
        # the reassociated sum stays near the flat one
        np.testing.assert_allclose(value, flat[key], rtol=1e-5, atol=1e-6, err_msg=key)


@dataclasses.dataclass(frozen=True)
class _RankBlockAggregator(phases.MaskedPartialAggregator):
    """Masked-partial aggregation through the edge mode with the lanes'
    rank blocks as edges: the one-process reference of a D-rank run."""

    ranks: int = 1

    def _edges(self, ctx, env):
        k = ctx.select.shape[0]
        return (torch.arange(k) // (k // self.ranks)).to(torch.int32), self.ranks


@pytest.mark.parametrize("world", WORLDS)
def test_worlds_trajectory_bitwise_rank_block_edge_mode(worlds, small_ds, world):
    """A whole sharded run (int8, 6 rounds) is the unsharded run whose
    aggregation goes through the edge mode with rank-block ids, bit for bit:
    every lane computes the same numbers, and the rank partials are the
    edges' partials."""
    ranks, _ = worlds[world]
    cfg = FLConfig(**CHUNKED)
    pipe = dataclasses.replace(pipeline_from_config(cfg),
                               aggregator=_RankBlockAggregator(ranks=world))
    ref = run_federated(small_ds, cfg, device="cpu", pipeline=pipe)
    for f in ref._fields:
        if f != "wall_time" and getattr(ref, f) is not None:
            np.testing.assert_array_equal(ranks[0][f"chunk1/{f}"], np.asarray(getattr(ref, f)),
                                          err_msg=f)


@pytest.mark.parametrize("world", WORLDS)
def test_worlds_round0_aggregation_bitwise_edge_mode(worlds, world):
    """Round 0 of acsp-fl + dld: the new global model every rank combined
    equals masked-partial aggregation of all ranks' lanes in one process
    through the edge mode with rank-block ids."""
    ranks, _ = worlds[world]
    n_leaves = sum(1 for key in ranks[0] if key.startswith("round0/agg_src/"))
    cat = lambda key: torch.from_numpy(np.concatenate([r[key] for r in ranks]))  # noqa: E731
    xs = [cat(f"round0/agg_src/{i}") for i in range(n_leaves)]
    sel, n, share = cat("round0/select"), cat("round0/n"), cat("round0/share")
    k = sel.shape[0]
    assert k == FIXTURE["n_clients"] and share.shape == (k, n_leaves // 2)
    base = sel.to(torch.float32) * n
    weights = base[None, :] * share.T.to(torch.float32)
    rows = [i // 2 for i in range(n_leaves)]
    ids = (torch.arange(k) // (k // world)).to(torch.int32)
    # round 0 shares every layer, so no fallback is taken
    got = masked_aggregate_leaves(xs, weights, rows, edge_ids=ids, n_edges=world)
    for i, g in enumerate(got):
        for r in ranks:
            np.testing.assert_array_equal(r[f"round0/new_global/{i}"], g.numpy(), err_msg=str(i))


@pytest.mark.parametrize("world", WORLDS)
def test_worlds_collective_bytes_match_the_reckoning(worlds, small_ds, world):
    """A gloo round's trace holds two all-reduces whose bytes are what
    ``shard_collective_bytes`` reckons from the shapes."""
    _, out = worlds[world]
    cfg = FLConfig(**STATE_RUN)
    su = _setup_run(small_ds, cfg, torch.device("cpu"), None, mlp_loss, mlp_accuracy, None,
                    None, None)
    want = shard_collective_bytes(su.g0, su.n_layers, world, small_ds.n_clients // world,
                                  stateful=True, lossy=True)
    for r in range(world):
        stats = collective_bytes(str(out / f"trace{r}.json"))
        assert stats["count"] == 2 and stats["all-reduce"] == stats["total"] == want, stats
    assert "ops=2" in collective_breakdown_str(stats)


# ---------------------------------------------------------------------------
# the partial and combine modes' plain versions
# ---------------------------------------------------------------------------


def _emulated_all_reduce(bufs):
    """The all-reduce of D rank-slotted buffers, as a sum in rank order."""
    total = bufs[0].clone()
    for b in bufs[1:]:
        total = total + b
    return total


def _mode_inputs(k: int, rng_seed: int = 5):
    g = torch.Generator().manual_seed(rng_seed)
    shapes = [(5,), (3, 7), (0,), (4,), (2, 2)]
    xs = [torch.randn((k,) + s, generator=g) for s in shapes]
    snaps = [torch.randn((k,) + s, generator=g) for s in shapes]
    w = torch.rand((3, k), generator=g)
    w[1] = 0.0  # a row that sums to 0: the fallback
    w[2, ::3] = 0.0
    rows = [0, 1, 2, 2, 1]
    fallbacks = [torch.randn(s, generator=g) for s in shapes]
    return shapes, xs, snaps, w, rows, fallbacks


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_partial_then_combine_is_the_edge_mode(world):
    k = 12
    shapes, xs, snaps, w, rows, fallbacks = _mode_inputs(k)
    blk = k // world
    ids = (torch.arange(k) // blk).to(torch.int32)
    for snap, others in ((None, dict(fallbacks=fallbacks)), (snaps, dict(bases=fallbacks))):
        bufs = [masked_aggregate_partial([x[r * blk:(r + 1) * blk] for x in xs],
                                         w[:, r * blk:(r + 1) * blk].contiguous(), rows,
                                         None if snap is None
                                         else [s[r * blk:(r + 1) * blk] for s in snap],
                                         slot=r, n_slots=world) for r in range(world)]
        for r, b in enumerate(bufs):  # every row but the rank's is -0.0
            other = torch.cat([b[:r], b[r + 1:]])
            assert (other == 0).all() and torch.signbit(other).all()
        got = masked_aggregate_combine(_emulated_all_reduce(bufs), shapes, rows, **others)
        want = masked_aggregate_leaves(xs, w, rows, snapshots=snap, edge_ids=ids,
                                       n_edges=world, **others)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
        assert torch.equal(got[1], fallbacks[1]) or snap is not None  # row 1 weighs nothing


def test_partial_layout_and_buffer():
    offsets, totals_at, width = partial_layout([5, 21, 0, 4, 4], 3)
    assert offsets == [0, 8, 32, 32, 36] and totals_at == 40 and width == 44
    shapes, xs, _, w, rows, _ = _mode_inputs(8)
    buf = masked_aggregate_partial_plain(xs, w, rows, slot=1, n_slots=3)
    assert buf.shape == (3, 44) and buf.dtype == torch.float32
    for i, (x, r) in enumerate(zip(xs, rows)):
        n = x[0].numel()
        want = torch.zeros(x.shape[1:]).reshape(-1)
        for c in range(8):
            want = want + w[r, c] * x[c].reshape(-1)
        assert torch.equal(buf[1, offsets[i]:offsets[i] + n], want)
    for r in range(3):
        total = torch.zeros(())
        for c in range(8):
            total = total + w[r, c]
        assert torch.equal(buf[1, totals_at + r], total)
    # the combine of a lone slot is the flat mean
    got = masked_aggregate_combine_plain(buf[1:2], shapes, rows)
    for g_, w_ in zip(got, masked_aggregate_leaves(xs, w, rows)):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_plain_modes_match_jax_weighted_mean_with_axis_name(world):
    """The JAX package's ``_weighted_mean(axis_name=...)``: each shard's
    partial sums, ``psum`` over the axis, the divide and the fallback on
    the global total; run under ``jax.vmap`` over a named axis of D
    shards. Within 2 float32 ulp (the shards' own sums are reduced in
    another order by XLA), measured 0 on these inputs."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.aggregation import _weighted_mean

    k = 16
    rng = np.random.default_rng(9)
    blk = k // world
    for case in ("fallback", "weighted", "edges"):
        x = rng.standard_normal((k, 6, 5)).astype(np.float32)
        wt = (rng.random(k) * 80).astype(np.float32)
        fb = rng.standard_normal((6, 5)).astype(np.float32)
        if case == "fallback":
            wt[:] = 0.0
        edge = (np.arange(k) % 2).astype(np.int32) if case == "edges" else None
        n_edges = 2 if case == "edges" else 0

        def shard(xs, ws, es):
            return _weighted_mean(xs, ws, jnp.asarray(fb), axis_name="cohort",
                                  edge_ids=None if edge is None else es, n_edges=n_edges)

        es = np.zeros((world, blk), np.int32) if edge is None else edge.reshape(world, blk)
        want = np.asarray(jax.vmap(shard, axis_name="cohort")(
            jnp.asarray(x.reshape(world, blk, 6, 5)), jnp.asarray(wt.reshape(world, blk)),
            jnp.asarray(es)))
        for d in range(world):
            np.testing.assert_array_equal(want[d], want[0])  # replicated

        t_edge = None if edge is None else torch.from_numpy(edge)
        bufs = [masked_aggregate_partial_plain(
            [torch.from_numpy(x[d * blk:(d + 1) * blk])],
            torch.from_numpy(wt[None, d * blk:(d + 1) * blk]),
            edge_ids=None if t_edge is None else t_edge[d * blk:(d + 1) * blk],
            n_edges=n_edges, slot=d, n_slots=world) for d in range(world)]
        got = masked_aggregate_combine_plain(_emulated_all_reduce(bufs), [(6, 5)],
                                             fallbacks=[torch.from_numpy(fb)])[0].numpy()
        assert _ulp(got, want[0]) <= 2, case
        if case == "fallback":
            np.testing.assert_array_equal(got, fb)


def test_collective_bytes_reads_gloo_and_nccl_events(tmp_path):
    """gloo's ``gloo:all_reduce`` annotations from a real in-process trace;
    NCCL's ``record_param_comms`` events from their recorded layout (the
    card's traces are read in chip_smoke.py and tests/test_torch_cuda.py)."""
    mesh = make_cohort_mesh(1, device="cpu")
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    record_shapes=True) as prof:
            mesh.all_reduce(torch.full((1, 1000), -0.0))
            mesh.all_reduce(torch.zeros(7, dtype=torch.float64))
        prof.export_chrome_trace(str(tmp_path / "gloo.json"))
    finally:
        mesh.close()
    stats = collective_bytes(str(tmp_path / "gloo.json"))
    assert stats == {"all-reduce": 4000 + 56, "total": 4056, "count": 2}
    nccl = {"traceEvents": [
        {"ph": "X", "name": "record_param_comms", "args": {
            "Collective name": "allreduce", "In msg nelems": 1000, "Out msg nelems": 1000,
            "dtype": "Float", "Group size": 2}},
        {"ph": "X", "name": "nccl:all_reduce", "args": {"Input Dims": [[1000]],
                                                        "Input type": ["float"]}},
        {"ph": "X", "name": "record_param_comms", "args": {
            "Collective name": "_allgather_base", "In msg nelems": 10, "dtype": "BFloat16"}},
        {"ph": "X", "name": "record_param_comms", "args": {"Collective name": "init"}},
    ]}
    assert collective_bytes(nccl) == {"all-reduce": 4000, "all-gather": 20, "total": 4020,
                                      "count": 2}
    assert collective_bytes([]) == {"count": 0}
