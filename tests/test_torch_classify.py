"""The port's personalized serving (``repro_torch.serve``: artifact, engine,
``ClassifyProgram``, batcher recorder, ``ServeRecorder``): the port-only
cases of ``tests/test_serve.py``, and the artifacts held to the JAX
package's.

Port-only: the artifact projections (none / ft / pms / dld onto the (C, L)
share mask); the save/load round trip is bitwise; lane i of a batch of B
clients is bitwise ``forward_unbatched(client_i, x_i)`` for B in {1, 5, 30}
and each mode, for batches that mix the modes, and whatever the batch
around the lane; the batcher serves each request once and orders its
latencies; the serve recorder writes its artifacts and changes no output.

Parity (the small_ds fixture of ``tests/test_fl_api.py``, jax's legacy
threefry stream, the JAX init carried over):

- ``servable_from_state`` on a JAX ``RoundState`` carried across gives the
  JAX package's share mask (hence its FT pick) exactly;
- an artifact the JAX package saved, loaded by the port, gives the JAX
  engine's argmax predictions, and logits within ``LOGIT_TOL`` of the JAX
  engine's (relative to the largest logit: the CPU GEMM libraries sum in
  another order, ROADMAP.md queue 3);
- ``fit_servable`` gives the JAX package's share mask and ``meta``.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch import random as prng
from repro_torch.data import make_federated_classification
from repro_torch.fl import FLConfig
from repro_torch.models.mlp import mlp_apply
from repro_torch.obs import validate_trace
from repro_torch.serve import (
    ClassifyProgram,
    ContinuousBatcher,
    PersonalizedEngine,
    ServeRecorder,
    ServeRequest,
    fit_servable,
    latency_stats,
    load_servable,
    save_servable,
    servable_from_state,
)
from repro_torch.serve.engine import LANES
from repro_torch.weights import params_from_numpy, servable_from_numpy, state_from_numpy

FIXTURE = dict(n_clients=8, n_classes=4, n_features=20, samples_per_client_range=(60, 90),
               dirichlet_alpha=50.0, client_shift=0.05, class_sep=5.0, seed=1)
MODES = ["none", "ft", "pms", "dld"]
# the JAX engine's logits against the port's on the same artifact, relative
# to max|logit|: measured 1.5e-7 to 3.0e-7 over the four modes, 51 to 54 of
# the 64 logits differing in their last bits
LOGIT_TOL = 1e-6


def _cfg(mode):
    return FLConfig(strategy="acsp-fl", personalization=mode, rounds=2, epochs=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ds():
    return make_federated_classification(**FIXTURE)


@pytest.fixture(scope="module")
def artifacts(ds):
    """One short trained artifact (+ final state) per mode, the port's init."""
    return {mode: fit_servable(ds, _cfg(mode), device="cpu") for mode in MODES}


def _composed_by_hand(art, client_id: int):
    """Independent per-client composition: each layer global-vs-local in
    plain Python off the host share mask (no lanes, no gather, no engine)."""
    if art.local_params is None:
        return art.global_params
    share = art.share_mask.cpu().numpy()[client_id]
    return [art.global_params[j] if share[j]
            else {k: v[client_id] for k, v in art.local_params[j].items()}
            for j in range(art.n_layers)]


def _inputs(ds, ids, row=0):
    return np.stack([ds.x_test[int(c), (row + k) % ds.x_test.shape[1]]
                     for k, c in enumerate(ids)]).astype(np.float32)


# ---------------------------------------------------------------------------
# artifact projection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_servable_projection_shapes(ds, artifacts, mode):
    art, state = artifacts[mode]
    assert art.n_clients == ds.n_clients
    assert art.n_layers == len(state.global_params)
    assert tuple(art.share_mask.shape) == (art.n_clients, art.n_layers)
    assert art.share_mask.dtype == torch.bool
    assert art.meta["mode"] == mode and art.meta["rounds"] == 2


def test_servable_none_has_no_local_state(artifacts):
    art, _ = artifacts["none"]
    assert art.local_params is None
    assert bool(art.share_mask.all()) and art.meta["personalized_clients"] == 0


def test_servable_ft_rows_are_whole_model_picks(artifacts):
    art, _ = artifacts["ft"]
    rows = art.share_mask.numpy()
    assert all(r.all() or not r.any() for r in rows)
    assert art.local_params is not None
    assert art.meta["personalized_clients"] == int((~rows.all(axis=1)).sum())


@pytest.mark.parametrize("mode", ["pms", "dld"])
def test_servable_share_rows_are_prefixes(artifacts, mode):
    art, state = artifacts[mode]
    rows, pms = art.share_mask.numpy(), state.pms.numpy()
    for i, r in enumerate(rows):
        assert r[: pms[i]].all() and not r[pms[i]:].any()


def test_servable_unknown_mode_rejected(artifacts):
    with pytest.raises(ValueError):
        servable_from_state(artifacts["pms"][1], "quantile")


def test_servable_ft_requires_data(artifacts):
    with pytest.raises(ValueError):
        servable_from_state(artifacts["ft"][1], "ft", data=None)


@pytest.mark.parametrize("mode", MODES)
def test_servable_save_load_roundtrip(tmp_path, artifacts, mode):
    art, _ = artifacts[mode]
    save_servable(art, str(tmp_path))
    back = load_servable(str(tmp_path), device="cpu")
    assert back.meta == json.loads(json.dumps(art.meta))
    assert torch.equal(back.share_mask, art.share_mask)
    assert (back.local_params is None) == (art.local_params is None)
    pairs = list(zip(art.global_params, back.global_params))
    if art.local_params is not None:
        pairs += list(zip(art.local_params, back.local_params))
    for a, b in pairs:
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])


# ---------------------------------------------------------------------------
# batched personalized inference — per-lane bit identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 5, 30])
@pytest.mark.parametrize("mode", MODES)
def test_batched_forward_bit_identical_per_lane(ds, artifacts, mode, batch):
    art, _ = artifacts[mode]
    engine = PersonalizedEngine(art)
    ids = np.random.default_rng(MODES.index(mode) * 7 + batch).integers(
        0, ds.n_clients, size=batch)
    x = _inputs(ds, ids)
    out = engine.forward(ids, x)
    assert tuple(out.shape) == (batch, ds.n_classes)
    for k in range(batch):
        assert torch.equal(out[k], engine.forward_unbatched(int(ids[k]), x[k]))
        # the composed model is the hand-composed one, bit for bit
        for got, want in zip(engine.client_model(int(ids[k])),
                             _composed_by_hand(art, int(ids[k]))):
            assert all(torch.equal(got[key], want[key]) for key in want)


@pytest.mark.parametrize("mode", ["ft", "dld"])
def test_mixed_mode_batch_bit_identical(ds, artifacts, mode):
    """A batch whose lanes compose differently: FT clients that kept their
    whole model beside clients that took the global one; DLD clients at
    different share depths — plus repeats of one client."""
    art, _ = artifacts[mode]
    rows = art.share_mask.numpy()
    kinds = {}
    for i, r in enumerate(rows):
        kinds.setdefault(tuple(r), []).append(i)
    assert len(kinds) >= 2, f"{mode}: every client composes alike {rows.tolist()}"
    groups = list(kinds.values())
    ids = np.asarray([groups[0][0], groups[1][0], groups[0][-1], groups[0][0]], np.int64)
    engine = PersonalizedEngine(art)
    x = _inputs(ds, ids, row=1)
    x[3] = x[0]
    out = engine.forward(ids, x)
    for k in range(len(ids)):
        assert torch.equal(out[k], engine.forward_unbatched(int(ids[k]), x[k]))
    assert torch.equal(out[0], out[3])


def test_lane_independent_of_batch_and_position(ds, artifacts):
    """A client's lane gives the same bits alone, at any position of a batch,
    and across a block boundary (B = 40 > LANES)."""
    art, _ = artifacts["dld"]
    engine = PersonalizedEngine(art)
    ids = np.arange(40) % ds.n_clients
    assert len(ids) > LANES
    x = _inputs(ds, ids, row=2)
    out = engine.forward(ids, x)
    rev = engine.forward(ids[::-1].copy(), x[::-1].copy())
    assert torch.equal(out, rev.flip(0))
    for k in range(40):
        assert torch.equal(out[k], engine.forward_unbatched(int(ids[k]), x[k]))


def test_engine_forward_unbatched_matches_plain_forward(ds, artifacts):
    """``forward_unbatched`` against the plain (1, F) x (F, H) forward of the
    hand-composed model: within 1e-5 of max|logit| (oneDNN picks another
    kernel for that shape; the lanes are held to each other bitwise)."""
    art, _ = artifacts["pms"]
    engine = PersonalizedEngine(art)
    for c in range(ds.n_clients):
        x = torch.as_tensor(ds.x_test[c, 2])
        got = engine.forward_unbatched(c, x)
        want = mlp_apply(_composed_by_hand(art, c), x[None])[0]
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        assert int(got.argmax()) == int(want.argmax())


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------


def _classify_requests(ds, n, seed=0):
    ids = np.random.default_rng(seed).integers(0, ds.n_clients, size=n)
    return [ServeRequest(rid=i, client_id=int(c),
                         inputs=np.asarray(ds.x_test[int(c), i % ds.x_test.shape[1]]))
            for i, c in enumerate(ids)]


@pytest.mark.parametrize("batch", [1, 4])
def test_batcher_serves_every_request_once(ds, artifacts, batch):
    engine = PersonalizedEngine(artifacts["pms"][0])
    reqs = _classify_requests(ds, 11)
    results = ContinuousBatcher(ClassifyProgram(engine, batch), batch).run(reqs)
    assert sorted(r.rid for r in results) == list(range(11))
    for res in results:
        ref = engine.forward_unbatched(res.client_id, reqs[res.rid].inputs).numpy()
        np.testing.assert_array_equal(res.output, ref)


def test_batcher_latency_ordering(ds, artifacts):
    engine = PersonalizedEngine(artifacts["none"][0])
    results = ContinuousBatcher(ClassifyProgram(engine, 2), 2).run(_classify_requests(ds, 7))
    for r in results:
        assert 0.0 <= r.enqueue_s <= r.start_s <= r.finish_s
    stats = latency_stats(results)
    assert stats["n_requests"] == 7 and stats["qps"] > 0
    assert stats["latency_p99_ms"] >= stats["latency_p50_ms"] > 0


def test_latency_stats_empty():
    assert latency_stats([]) == {"n_requests": 0, "qps": 0.0}


# ---------------------------------------------------------------------------
# serve records
# ---------------------------------------------------------------------------


def test_serve_recorder_artifacts(tmp_path, ds, artifacts):
    art, _ = artifacts["ft"]
    engine = PersonalizedEngine(art)
    rec = ServeRecorder(str(tmp_path), trace=True)
    rec.open_session(artifact_meta=art.meta, engine="classify", batch_size=3, device="cpu")
    results = ContinuousBatcher(ClassifyProgram(engine, 3), 3, recorder=rec).run(
        _classify_requests(ds, 8))
    rec.close(latency_stats(results))

    manifest = json.load(open(tmp_path / "manifest.json"))
    assert manifest["kind"] == "serve" and manifest["requests_recorded"] == 8
    assert manifest["artifact"]["mode"] == "ft" and manifest["engine"] == "classify"
    assert manifest["summary"]["n_requests"] == 8
    assert manifest["environment"]["backend"] == "cpu"
    rows = [json.loads(line) for line in open(tmp_path / "requests.jsonl")]
    assert sorted(r["rid"] for r in rows) == list(range(8))
    for r in rows:
        assert r["finish_s"] >= r["start_s"] >= r["enqueue_s"] >= 0
        assert r["latency_s"] == pytest.approx(r["finish_s"] - r["enqueue_s"])
    trace = json.load(open(tmp_path / "trace.json"))
    assert validate_trace(trace) == []
    assert sum(e["ph"] == "B" and e["name"] == "request" for e in trace["traceEvents"]) == 8
    with pytest.raises(ValueError, match="already opened"):
        rec.open_session(artifact_meta=art.meta, engine="classify", batch_size=3)


def test_serve_recorder_is_pure_observation(ds, artifacts, tmp_path):
    engine = PersonalizedEngine(artifacts["dld"][0])
    reqs = _classify_requests(ds, 6)
    bare = ContinuousBatcher(ClassifyProgram(engine, 2), 2).run(reqs)
    rec = ServeRecorder(str(tmp_path / "rec"))
    rec.open_session(artifact_meta=artifacts["dld"][0].meta, engine="classify", batch_size=2,
                     device="cpu")
    recorded = ContinuousBatcher(ClassifyProgram(engine, 2), 2, recorder=rec).run(reqs)
    rec.close()
    for a, b in zip(sorted(bare, key=lambda r: r.rid), sorted(recorded, key=lambda r: r.rid)):
        np.testing.assert_array_equal(a.output, b.output)


# ---------------------------------------------------------------------------
# parity with the JAX package (legacy stream)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """Per mode: the JAX package's fit_servable artifact and state (legacy
    stream), and the JAX init it started from."""
    jax = pytest.importorskip("jax")
    from repro.data import make_federated_classification as jax_make_data
    from repro.fl import FLConfig as JaxFLConfig
    from repro.models.mlp import init_mlp as jax_init_mlp
    from repro.serve import fit_servable as jax_fit_servable

    jds = jax_make_data(**FIXTURE)
    out = {}
    with jax.threefry_partitionable(False):
        r_init, _ = jax.random.split(jax.random.PRNGKey(0))
        g0 = jax.device_get(jax_init_mlp(r_init, jds.n_features, jds.n_classes))
        for mode in MODES:
            out[mode] = jax_fit_servable(
                jds, JaxFLConfig(strategy="acsp-fl", personalization=mode, rounds=2, epochs=1))
    return jax, out, g0


@pytest.mark.parametrize("mode", ["ft", "pms", "dld"])
def test_servable_from_jax_state_matches_jax(ds, jax_side, mode):
    jax, arts, _ = jax_side
    jart, jstate = arts[mode]
    state = state_from_numpy(jax.device_get(jstate), "cpu")
    art = servable_from_state(state, mode, data=ds)
    np.testing.assert_array_equal(art.share_mask.numpy(), np.asarray(jart.share_mask))
    assert art.meta["personalized_clients"] == jart.meta["personalized_clients"]


@pytest.mark.parametrize("mode", MODES)
def test_jax_saved_artifact_served_by_port(ds, jax_side, tmp_path, mode):
    jax, arts, _ = jax_side
    from repro.serve import PersonalizedEngine as JaxEngine
    from repro.serve import save_servable as jax_save_servable

    jart, _ = arts[mode]
    jax_save_servable(jart, str(tmp_path))
    art = load_servable(str(tmp_path), device="cpu")
    assert art.meta == json.loads(json.dumps(jart.meta, default=str))
    np.testing.assert_array_equal(art.share_mask.numpy(), np.asarray(jart.share_mask))
    # the same artifact carried in memory gives the same tensors
    mem = servable_from_numpy(jax.device_get(jart), "cpu")
    for a, b in zip(mem.global_params, art.global_params):
        assert all(torch.equal(a[k], b[k]) for k in a)
    ids = np.arange(16) % ds.n_clients
    x = _inputs(ds, ids, row=3)
    want = np.asarray(JaxEngine(jart).forward(ids.astype(np.int32), x))
    got = PersonalizedEngine(art).forward(ids, x).numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


@pytest.mark.parametrize("mode", MODES)
def test_fit_servable_matches_jax(ds, jax_side, mode):
    _, arts, g0 = jax_side
    jart, _ = arts[mode]
    with prng.threefry_partitionable(False):
        art, _ = fit_servable(ds, _cfg(mode), device="cpu",
                              init_fn=lambda key: params_from_numpy(g0, key.device))
    np.testing.assert_array_equal(art.share_mask.numpy(), np.asarray(jart.share_mask))
    assert art.meta == jart.meta
