"""Checkpoint/resume of the port: a run stopped at round (or event) 2 and
resumed from its snapshot to 5 gives the uninterrupted run's history bit
for bit, every field but the measured ``wall_time`` — the cases of
``tests/test_checkpoint_resume.py`` that the port covers (both schedulers,
the golden configurations, stateful FT and lossy int8, faults), plus sync
resumes at ``scan_chunk`` 2 and 3 (3: the resumed run's only chunk is 3
rounds where the uninterrupted run has a chunk of 3 and a tail of 2)."""

import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.data import make_federated_classification
from repro_torch.fl import FLConfig, run_federated
from repro_torch.fl.sched import resolve_checkpoint_dir

FIXTURE = dict(n_clients=8, n_classes=4, n_features=20, samples_per_client_range=(60, 90),
               dirichlet_alpha=50.0, client_shift=0.05, class_sep=5.0, seed=1)

# the four committed golden configurations (tests/test_fl_api.py::_GOLDEN)
GOLDEN = {
    "acsp-fl+dld+float32": dict(),
    "fedavg+none+float32": dict(strategy="fedavg", personalization="none", fraction=1.0),
    "oort+ft+float32": dict(strategy="oort", personalization="ft", fraction=0.5),
    "acsp-fl+dld+int8": dict(codec="int8"),
}
ASYNC = dict(scheduler="async", buffer_k=2, max_concurrency=4)

CASES = {f"sync-{name}": kw for name, kw in GOLDEN.items()}
CASES.update({
    "sync-scan_chunk=2": dict(scan_chunk=2),
    "sync-scan_chunk=3": dict(scan_chunk=3),
    "async-oort+ft+float32": dict(GOLDEN["oort+ft+float32"], **ASYNC),
    "async-acsp-fl+dld+int8": dict(GOLDEN["acsp-fl+dld+int8"], **ASYNC),
    "sync-faults": dict(dropout_rate=0.3, deadline_s=10.0, corrupt_rate=0.2),
    "async-faults": dict(dropout_rate=0.4, deadline_s=5.0, corrupt_rate=0.2, **ASYNC),
})


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def small_ds():
    return make_federated_classification(**FIXTURE)


def assert_history_equal(h_full, h_res):
    for field in h_full._fields:
        a, b = getattr(h_full, field), getattr(h_res, field)
        if field == "wall_time" or (a is None and b is None):
            continue
        assert a is not None and b is not None, field
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)
    assert h_res.wall_time.shape == h_full.wall_time.shape


@pytest.mark.parametrize("name", sorted(CASES))
def test_resume_bitwise(small_ds, tmp_path, name):
    kw = CASES[name]
    d = str(tmp_path / "ckpt")
    h_full = run_federated(small_ds, FLConfig(rounds=5, epochs=1, **kw), device="cpu")
    run_federated(small_ds, FLConfig(rounds=2, epochs=1, **kw), device="cpu",
                  checkpoint_every=2, checkpoint_dir=d)
    h_res = run_federated(small_ds, FLConfig(rounds=5, epochs=1, **kw), device="cpu",
                          resume_from=d)
    assert_history_equal(h_full, h_res)


def test_resume_from_doubles_as_write_dir(small_ds, tmp_path):
    d = str(tmp_path / "ckpt")
    run_federated(small_ds, FLConfig(rounds=2, epochs=1), device="cpu", checkpoint_every=2,
                  checkpoint_dir=d)
    run_federated(small_ds, FLConfig(rounds=4, epochs=1), device="cpu", checkpoint_every=2,
                  resume_from=d)
    assert sorted(fn for fn in os.listdir(d) if fn.endswith("_meta.json")) == [
        "round_00002_meta.json", "round_00004_meta.json"]


def test_checkpoint_every_requires_dir(small_ds):
    with pytest.raises(ValueError, match="checkpoint"):
        resolve_checkpoint_dir(2, None, None)
    assert resolve_checkpoint_dir(0, None, None) is None
    assert resolve_checkpoint_dir(2, "/tmp/x", None) == "/tmp/x"
    assert resolve_checkpoint_dir(2, None, "/tmp/y") == "/tmp/y"
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_federated(small_ds, FLConfig(rounds=1, epochs=1), device="cpu", checkpoint_every=1)


def test_pytree_round_trip_keeps_dtypes_and_structure(tmp_path):
    tree = {"layers": [{"w": torch.randn(3, 2), "b": torch.zeros(2, dtype=torch.bfloat16)}],
            "step": torch.tensor([7, 9], dtype=torch.int64), "none": None}
    tree["layers"][0]["b"][1] = 1.5
    save_pytree(tree, str(tmp_path), "t")
    like = {"layers": [{"w": torch.empty(3, 2), "b": torch.empty(2, dtype=torch.bfloat16)}],
            "step": torch.empty(2, dtype=torch.int64), "none": None}
    got = load_pytree(like, str(tmp_path), "t")
    assert got["none"] is None and got["layers"][0]["b"].dtype == torch.bfloat16
    assert torch.equal(got["layers"][0]["w"], tree["layers"][0]["w"])
    assert torch.equal(got["layers"][0]["b"], tree["layers"][0]["b"])
    assert torch.equal(got["step"], tree["step"])
