"""The port's run records (``repro_torch.obs`` and ``run_federated(recorder=)``):
the port-only cases of ``tests/test_obs.py``, and the records held to the
JAX package's.

Port-only: the metrics stream is byte-identical across ``scan_chunk``
sizes and reruns (trace included), matches the ``FLHistory``; a recorded
run's history is bitwise the unrecorded run's (sync, chunked, async,
faults, resumed); the trace schema and the simulated clock are exact; the
manifest, run log, profile and environment snapshot have their fields; the
recorded goldens reproduce the committed hex (jax's legacy stream).

Parity (both packages on the same numpy data, the JAX init carried over,
jax's legacy threefry stream, as ``tests/test_torch_fl.py`` runs them):
``metrics.jsonl`` row for row — ``t``, ``n_selected``, ``tx_params``,
``wire_bytes``, ``round_time_s``, ``sim_clock_s``, ``pms_mean``,
``staleness_mean``, ``in_flight``, ``buffer_k``, ``rejected`` and
``dropped`` exactly; ``acc_mean`` and ``acc_min`` within 1e-6;
``update_norm_mean`` within ``UPDATE_NORM_RTOL`` of JAX's (the norms of
deltas whose parameters the two packages compute in another order,
``tests/test_torch_fl.py``: rtol 1e-5 a parameter); the async trace's
span timestamps exactly.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from repro_torch import random as prng
from repro_torch.data import make_federated_classification
from repro_torch.fl import FLConfig, run_federated
from repro_torch.obs import (
    Profiler,
    RunRecorder,
    TraceBuilder,
    environment_snapshot,
    validate_trace,
    validate_trace_file,
)
from repro_torch.weights import params_from_numpy

# tests/test_fl_api.py's small_ds fixture
FIXTURE = dict(n_clients=8, n_classes=4, n_features=20, samples_per_client_range=(60, 90),
               dirichlet_alpha=50.0, client_shift=0.05, class_sep=5.0, seed=1)
SERVER_LATENCY_S = 0.01  # CommModel default the async event clock pays
ASYNC = dict(scheduler="async", buffer_k=2, heterogeneity=1.0)
# tests/test_fl_api.py::_GOLDEN, the two configurations tests/test_obs.py records
GOLDEN_HEX = {
    "acsp-fl+dld+float32": (dict(), "9022033f6842293f97df533f117e613f428a6e3f"),
    "acsp-fl+dld+int8": (dict(codec="int8"), "9022033f6842293f97df533f117e613f428a6e3f"),
}

# the runs held to the JAX package's records (FLConfig kwargs, epochs=1)
PARITY = {
    "sync-int8-chunk2": dict(codec="int8", rounds=5, scan_chunk=2),
    "async-straggler": dict(rounds=6, **ASYNC),
    "sync-dropout": dict(rounds=4, strategy="fedavg", personalization="none", fraction=1.0,
                         dropout_rate=0.4, seed=1),
    # the host plane with the edge hop accounted (E = 1: the flat
    # trajectory; E = 3 trajectories are held to JAX in test_torch_edge.py)
    "sync-host-edge1": dict(rounds=4, host_population=1, edge_groups=1),
}
EXACT_COLS = ("t", "n_selected", "tx_params", "wire_bytes", "round_time_s", "sim_clock_s",
              "pms_mean", "staleness_mean", "in_flight", "buffer_k", "rejected", "dropped")
ACC_TOL = 1e-6
# update_norm_mean against JAX's, relative: measured 6.4e-6 at most on the
# int8 run and 3.3e-7 on the float32 runs; held to 1e-5, the per-parameter
# rtol of the one-round comparison in tests/test_torch_fl.py
UPDATE_NORM_RTOL = 1e-5


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
def out_root(tmp_path_factory):
    return tmp_path_factory.mktemp("records")


def _record(ds, cfg, out_dir, run_kw=None, **rec_kw):
    rec = RunRecorder(str(out_dir), echo=False, **rec_kw)
    h = run_federated(ds, cfg, device="cpu", recorder=rec, **(run_kw or {}))
    return h, str(out_dir)


def _rows(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _trace(out):
    with open(os.path.join(out, "trace.json")) as f:
        return json.load(f)


def assert_same_history(a, b):
    for field in a._fields:
        if field == "wall_time":  # measured host time
            continue
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=field)


# ---------------------------------------------------------------------------
# stream parity: identical runs -> identical records
# ---------------------------------------------------------------------------


def test_metrics_stream_identical_across_scan_chunks(ds, out_root):
    blobs = {}
    for chunk in (1, 2, 7):
        _, out = _record(ds, FLConfig(rounds=7, epochs=1, scan_chunk=chunk),
                         out_root / f"chunk{chunk}")
        with open(os.path.join(out, "metrics.jsonl"), "rb") as f:
            blobs[chunk] = f.read()
    assert blobs[1] == blobs[2] == blobs[7]
    assert [json.loads(line)["t"] for line in blobs[1].splitlines()] == list(range(7))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_rerun_identical_record_including_trace(ds, out_root, mode):
    kw = dict(scan_chunk=2) if mode == "sync" else ASYNC
    cfg = FLConfig(rounds=5, epochs=1, **kw)
    outs = [_record(ds, cfg, out_root / f"rerun-{mode}-{tag}", trace=True)[1] for tag in "ab"]
    for fname in ("metrics.jsonl", "trace.json"):
        with open(os.path.join(outs[0], fname), "rb") as fa, \
             open(os.path.join(outs[1], fname), "rb") as fb:
            assert fa.read() == fb.read(), fname


def test_sync_metrics_match_history(ds, out_root):
    h, out = _record(ds, FLConfig(rounds=6, epochs=1, scan_chunk=3), out_root / "match")
    rows = _rows(out)
    assert len(rows) == 6
    for t, r in enumerate(rows):
        assert r["acc_mean"] == float(h.accuracy_mean[t])
        assert r["acc_min"] == float(h.accuracy_per_client[t].min())
        assert r["n_selected"] == int(h.selected[t].sum())
        assert r["sim_clock_s"] == float(h.sim_clock[t])  # exact, == np.cumsum
        assert r["round_time_s"] == float(h.round_time[t])
        assert r["wire_bytes"] == float(h.tx_wire_bytes[t])
        assert r["tx_params"] == float(h.tx_params[t])
        assert r["staleness_mean"] == 0.0 and r["buffer_k"] is None
        assert r["in_flight"] == int(h.in_flight[t])
        assert r["rejected"] == int(h.rejected_updates[t])


# ---------------------------------------------------------------------------
# bit-identity: recording must not perturb the trajectory
# ---------------------------------------------------------------------------


RECORDED_CASES = {
    "sync": dict(rounds=6),
    "sync-chunk4": dict(rounds=6, scan_chunk=4),
    "async": dict(rounds=6, **ASYNC),
    "sync-faults": dict(rounds=5, dropout_rate=0.3, corrupt_rate=0.3, seed=1),
    "async-faults": dict(rounds=6, dropout_rate=0.4, deadline_s=5.0, max_retries=2,
                         scheduler="async", buffer_k=2, max_concurrency=4),
}


@pytest.mark.parametrize("name", sorted(RECORDED_CASES))
def test_recorded_history_equals_unrecorded(ds, out_root, name):
    cfg = FLConfig(epochs=1, **RECORDED_CASES[name])
    h_rec, out = _record(ds, cfg, out_root / f"bitwise-{name}", trace=True, profile=True)
    assert_same_history(h_rec, run_federated(ds, cfg, device="cpu"))
    rows = _rows(out)
    assert len(rows) == len(h_rec.accuracy_mean)
    if cfg.faults.enabled:  # the fault columns ride along
        keys = {"dropped"} if name.startswith("sync") else {"retried", "timed_out", "dropped"}
        assert all(keys <= set(r) for r in rows)
        assert validate_trace_file(os.path.join(out, "trace.json"), ds.n_clients) == []


def test_recorded_resume_equals_unrecorded_resume(ds, tmp_path):
    """A recorded run that resumes records the resumed rounds, as the JAX
    package's recorder does: rows from the snapshot's round on, its
    simulated clock restarting at 0; the history is the uninterrupted
    run's."""
    cfg = FLConfig(rounds=5, epochs=1, scan_chunk=2)
    ckpt = str(tmp_path / "ckpt")
    run_federated(ds, FLConfig(rounds=2, epochs=1, scan_chunk=2), device="cpu",
                  checkpoint_every=2, checkpoint_dir=ckpt)
    h, out = _record(ds, cfg, tmp_path / "rec", run_kw=dict(resume_from=ckpt), trace=True)
    assert_same_history(h, run_federated(ds, cfg, device="cpu"))
    rows = _rows(out)
    assert [r["t"] for r in rows] == [2, 3, 4]
    np.testing.assert_array_equal([r["sim_clock_s"] for r in rows],
                                  np.cumsum(h.round_time[2:]))
    assert validate_trace_file(os.path.join(out, "trace.json"), ds.n_clients) == []


@pytest.mark.parametrize("name", sorted(GOLDEN_HEX))
def test_recorded_run_reproduces_golden_hex(ds, out_root, name):
    """Recording a golden configuration reproduces the committed golden
    accuracy hex (jax's legacy stream, the port's own init)."""
    kw, acc_hex = GOLDEN_HEX[name]
    with prng.threefry_partitionable(False):
        h, out = _record(ds, FLConfig(rounds=5, epochs=1, **kw), out_root / f"golden-{name}",
                         trace=True)
    want = np.frombuffer(bytes.fromhex(acc_hex), np.dtype("<f4"))
    np.testing.assert_array_equal(np.asarray(h.accuracy_mean, np.float32), want)
    np.testing.assert_array_equal(np.asarray([r["acc_mean"] for r in _rows(out)], np.float32),
                                  want)


# ---------------------------------------------------------------------------
# trace: schema validity + simulated-clock exactness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_trace_schema_valid(ds, out_root, mode):
    kw = dict(scan_chunk=2) if mode == "sync" else ASYNC
    _, out = _record(ds, FLConfig(rounds=5, epochs=1, **kw), out_root / f"schema-{mode}",
                     trace=True)
    path = os.path.join(out, "trace.json")
    assert validate_trace_file(path, population=ds.n_clients) == []
    events = _trace(out)["traceEvents"]
    assert {"M", "B", "E", "i"} <= {e["ph"] for e in events}
    client_tids = {e["tid"] for e in events if e["pid"] == 1 and e["ph"] in ("B", "E")}
    assert client_tids <= set(range(ds.n_clients))


def test_async_trace_simulated_clock_exact(ds, out_root):
    h, out = _record(ds, FLConfig(rounds=10, epochs=1, **ASYNC), out_root / "async-clock",
                     trace=True)
    events = _trace(out)["traceEvents"]
    aggs = [e for e in events if e["ph"] == "i" and e["name"] == "aggregate"]
    assert len(aggs) == len(h.sim_clock) == 10
    for a in aggs:
        t = a["args"]["t"]
        assert a["args"]["clock_s"] == float(h.sim_clock[t])
        assert max(a["args"]["finish_s"]) + SERVER_LATENCY_S == float(h.sim_clock[t])
        assert a["args"]["n_landed"] == int(h.selected[t].sum())
    ends = {}
    for e in events:
        if e["ph"] == "E" and e["pid"] == 1 and e["name"] == "upload":
            ends.setdefault(e["tid"], []).append(e["ts"] / 1e6)
    for a in aggs:
        for c, f in zip(a["args"]["landed"], a["args"]["finish_s"]):
            assert any(abs(end - f) < 1e-12 for end in ends.get(c, [])), (c, f)


def test_sync_trace_round_spans_cover_sim_clock(ds, out_root):
    h, out = _record(ds, FLConfig(rounds=6, epochs=1, scan_chunk=3), out_root / "sync-spans",
                     trace=True)
    events = _trace(out)["traceEvents"]
    rounds = [e for e in events if e["pid"] == 0 and e["name"] == "round" and e["ph"] == "E"]
    assert len(rounds) == 6
    for t, e in enumerate(rounds):
        assert e["ts"] == pytest.approx(float(h.sim_clock[t]) * 1e6, rel=1e-12)
    chunks = [e for e in events if e["pid"] == 0 and e["name"] == "chunk" and e["ph"] == "B"]
    assert [c["args"]["t0"] for c in chunks] == [0, 3]


def test_validate_trace_catches_malformed():
    assert validate_trace("not a dict") != []
    assert validate_trace({"traceEvents": "nope"}) != []
    tb = TraceBuilder()
    tb.client_lane(3)
    tb.begin("work", 1, 3, 1.0)
    assert any("unclosed" in e for e in validate_trace(tb.to_obj()))
    tb.end("work", 1, 3, 2.0)
    assert validate_trace(tb.to_obj()) == []
    assert validate_trace(tb.to_obj(), population=3) != []  # lane 3 out of range
    obj = tb.to_obj()
    obj["traceEvents"].append({"ph": "Z", "name": "x", "pid": 0, "tid": 0, "ts": 0})
    assert any("bad ph" in e for e in validate_trace(obj))
    back = tb.to_obj()
    back["traceEvents"].append({"ph": "i", "name": "late", "pid": 0, "tid": 0, "ts": 0.5})
    assert any("decreases" in e for e in validate_trace(back))
    wrong = TraceBuilder()
    wrong.begin("a", 0, 0, 0.0)
    wrong.end("b", 0, 0, 1.0)
    assert any("does not match" in e for e in validate_trace(wrong.to_obj()))


def test_validate_trace_file_missing(tmp_path):
    assert len(validate_trace_file(str(tmp_path / "nope.json"))) == 1


# ---------------------------------------------------------------------------
# manifest / run.log / profile / environment
# ---------------------------------------------------------------------------


def test_manifest_fields_and_stable_run_id(ds, out_root):
    cfg = FLConfig(rounds=4, epochs=1)
    h, out_a = _record(ds, cfg, out_root / "man-a")
    _, out_b = _record(ds, cfg, out_root / "man-b")
    man_a = json.load(open(os.path.join(out_a, "manifest.json")))
    man_b = json.load(open(os.path.join(out_b, "manifest.json")))
    assert man_a["run_id"] == man_b["run_id"]  # content hash, timestamp-free
    assert man_a["schema_version"] == 1 and man_a["mode"] == "sync"
    assert man_a["population"] == ds.n_clients and man_a["lanes"] == ds.n_clients
    assert man_a["rounds_recorded"] == 4 and man_a["mesh"] is None
    assert man_a["config"]["train"]["rounds"] == 4
    assert man_a["population_plane"] == {"host_population": False, "edge_groups": 0,
                                         "store_backing": None}
    assert man_a["environment"]["backend"] == "cpu"
    assert man_a["files"] == {"metrics": "metrics.jsonl", "log": "run.log"}
    assert man_a["summary"]["final_accuracy"] == float(h.accuracy_mean[-1])
    assert man_a["summary"]["sim_clock_s"] == float(h.sim_clock[-1])
    _, out_c = _record(ds, FLConfig(rounds=5, epochs=1), out_root / "man-c")
    assert json.load(open(os.path.join(out_c, "manifest.json")))["run_id"] != man_a["run_id"]


@pytest.mark.parametrize("scheduler", ["sync", "async"])
def test_host_plane_manifest_and_staging_columns(ds, tmp_path, scheduler):
    """A host-plane run records the JAX package's population block (memmap
    backing named), the staging columns under the barrier, and the
    unrecorded run's history."""
    from repro_torch.fl.population import run_host_async, run_host_sync

    run = run_host_sync if scheduler == "sync" else run_host_async
    cfg = FLConfig(rounds=3, epochs=1, host_population=1, edge_groups=2, codec="int8",
                   **(ASYNC if scheduler == "async" else {}))
    backing = str(tmp_path / "store")
    h = run(ds, cfg, "cpu", backing_dir=backing,
            recorder=RunRecorder(str(tmp_path / "rec"), echo=False))
    ref = run(ds, cfg, "cpu")
    np.testing.assert_array_equal(h.accuracy_per_client, ref.accuracy_per_client)
    np.testing.assert_array_equal(h.tx_edge_bytes, ref.tx_edge_bytes)
    man = json.load(open(tmp_path / "rec" / "manifest.json"))
    assert man["population_plane"] == {"host_population": True, "edge_groups": 2,
                                       "store_backing": f"memmap:{backing}"}
    rows = _rows(str(tmp_path / "rec"))
    assert len(rows) == 3
    if scheduler == "sync":
        assert all(r["host_gather_ms"] >= 0.0 and r["staged_bytes"] > 0 for r in rows)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_progress_routes_through_run_log(ds, tmp_path, capsys, mode):
    kw = {} if mode == "sync" else ASYNC
    rec = RunRecorder(str(tmp_path / "rec"))  # echo=True: print AND log
    run_federated(ds, FLConfig(rounds=5, epochs=1, **kw), device="cpu", recorder=rec,
                  progress=True)
    printed = capsys.readouterr().out
    logged = open(str(tmp_path / "rec" / "run.log")).read()
    assert logged.strip()
    for line in logged.splitlines():
        assert line.startswith("  round " if mode == "sync" else "  event ")
        assert line in printed


def test_recorder_open_twice_raises(ds, tmp_path):
    cfg = FLConfig(rounds=2, epochs=1)
    rec = RunRecorder(str(tmp_path / "rec"), echo=False)
    run_federated(ds, cfg, device="cpu", recorder=rec)
    with pytest.raises(ValueError, match="already opened"):
        run_federated(ds, cfg, device="cpu", recorder=rec)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_profile_smoke(ds, out_root, mode):
    kw = dict(scan_chunk=2) if mode == "sync" else dict(scheduler="async", buffer_k=2)
    _, out = _record(ds, FLConfig(rounds=4, epochs=1, **kw), out_root / f"profile-{mode}",
                     profile=True)
    prof = json.load(open(os.path.join(out, "profile.json")))
    for phase in ("dispatch", "device_get", "record"):
        assert prof["totals_s"][phase] > 0
    # the CPU has no CUDA graph to capture and no device-memory counter
    assert prof["graph_captures"] == 0 and prof["peak_live_bytes"] is None
    assert "capture" not in prof["totals_s"]
    assert prof["device"] == "cpu"
    assert [c["rounds"] for c in prof["chunks"]] == ([2, 2] if mode == "sync" else [1] * 4)


def test_profiler_nested_phase_counts_for_itself():
    """A phase inside another (a chunk's capture inside its first dispatch)
    counts for itself only; each capture phase counts one capture."""
    prof = Profiler()
    prof.begin_chunk(0, 1)
    with prof.phase("dispatch"):
        with prof.phase("capture"):
            time.sleep(0.05)
    prof.end_chunk()
    summary = prof.summary()
    assert summary["graph_captures"] == 1
    totals = summary["totals_s"]
    assert totals["capture"] >= 0.05 > totals["dispatch"] >= 0
    assert summary["chunks"][0]["capture_s"] == totals["capture"]


def test_torch_trace_capture(ds, tmp_path):
    rec = RunRecorder(str(tmp_path / "rec"), echo=False,
                      torch_trace_dir=str(tmp_path / "torch"))
    run_federated(ds, FLConfig(rounds=2, epochs=1), device="cpu", recorder=rec)
    prof = json.load(open(tmp_path / "rec" / "profile.json"))
    trace = json.load(open(prof["torch_trace"]))
    assert trace["traceEvents"]


def test_environment_snapshot_shape():
    env = environment_snapshot("cpu")
    assert env["backend"] == "cpu" and env["device_count"] == 1 and env["gpu"] is None
    assert env["torch"] == torch.__version__ and env["packages"]["torch"]
    assert env["packages"]["numpy"] and env["python"]


# ---------------------------------------------------------------------------
# parity with the JAX package's records (legacy stream)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parity_records(tmp_path_factory):
    """Each PARITY run recorded (with its trace) by both packages."""
    jax = pytest.importorskip("jax")
    from repro.data import make_federated_classification as jax_make_data
    from repro.fl import FLConfig as JaxFLConfig
    from repro.fl import run_federated as jax_run_federated
    from repro.models.mlp import init_mlp as jax_init_mlp
    from repro.obs import RunRecorder as JaxRunRecorder

    jax_ds = jax_make_data(**FIXTURE)
    port_ds = make_federated_classification(**FIXTURE)
    root = tmp_path_factory.mktemp("parity")
    out = {}
    for name, kw in PARITY.items():
        jdir, tdir = str(root / f"jax-{name}"), str(root / f"port-{name}")
        with jax.threefry_partitionable(False):
            jax_run_federated(jax_ds, JaxFLConfig(epochs=1, **kw),
                              recorder=JaxRunRecorder(jdir, trace=True, echo=False))
            r_init, _ = jax.random.split(jax.random.PRNGKey(kw.get("seed", 0)))
            g0 = jax.device_get(jax_init_mlp(r_init, jax_ds.n_features, jax_ds.n_classes))
        with prng.threefry_partitionable(False):
            run_federated(port_ds, FLConfig(epochs=1, **kw), device="cpu",
                          init_fn=lambda key, g0=g0: params_from_numpy(g0, key.device),
                          recorder=RunRecorder(tdir, trace=True, echo=False))
        out[name] = (jdir, tdir)
    return out


@pytest.mark.parametrize("name", sorted(PARITY))
def test_metrics_match_jax(parity_records, name):
    jdir, tdir = parity_records[name]
    jrows, trows = _rows(jdir), _rows(tdir)
    assert len(trows) == len(jrows) == PARITY[name]["rounds"]
    for jr, tr in zip(jrows, trows):
        assert set(tr) == set(jr)
        for col in EXACT_COLS:
            if col in jr:
                assert tr[col] == jr[col], (jr["t"], col)
        for col in ("acc_mean", "acc_min"):
            assert abs(tr[col] - jr[col]) <= ACC_TOL, (jr["t"], col)
        assert tr["update_norm_mean"] == pytest.approx(jr["update_norm_mean"],
                                                       rel=UPDATE_NORM_RTOL)
        if "merge_discount_mean" in jr:
            assert tr["merge_discount_mean"] == pytest.approx(jr["merge_discount_mean"],
                                                              rel=1e-6)
    if name == "sync-dropout":
        assert any(r["dropped"] for r in trows)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_trace_matches_jax(parity_records, name):
    """The trace's events and their simulated timestamps are the JAX
    package's exactly (span names, lanes, ``ts`` and the float64 seconds
    in ``args``); only the accuracy-free structure is compared."""
    jdir, tdir = parity_records[name]
    jev, tev = _trace(jdir)["traceEvents"], _trace(tdir)["traceEvents"]
    assert validate_trace(_trace(tdir), population=FIXTURE["n_clients"]) == []
    assert len(tev) == len(jev)
    for je, te in zip(jev, tev):
        assert (te["name"], te["ph"], te["pid"], te["tid"]) == \
            (je["name"], je["ph"], je["pid"], je["tid"])
        assert te.get("ts") == je.get("ts")
        assert te.get("args") == je.get("args")


def test_manifest_keeps_jax_field_names(parity_records):
    jdir, tdir = parity_records["sync-int8-chunk2"]
    jman = json.load(open(os.path.join(jdir, "manifest.json")))
    tman = json.load(open(os.path.join(tdir, "manifest.json")))
    assert set(tman) == set(jman)
    assert set(tman["summary"]) == set(jman["summary"])
    assert tman["config"] == jman["config"]
    assert {"backend", "device_count", "devices", "python", "platform", "packages",
            "git_rev"} <= set(tman["environment"])
    assert dataclasses.asdict(FLConfig(epochs=1, **PARITY["sync-int8-chunk2"])) == \
        tman["config"]
