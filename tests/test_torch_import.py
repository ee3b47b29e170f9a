"""The port stands alone: it imports neither jax nor the JAX package, its
entry points (training's ``launch.train.train`` among them) refuse to run
quietly on the CPU, no ``NotImplementedError`` names a ROADMAP.md item of
the model zoo (tied embeddings serve and train), and the ported items'
options (every FL option, ``cohort_devices`` included) run on the CPU when
asked."""

import dataclasses
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import make_federated_classification
from repro_torch.fl import FLConfig, make_round_step, run_federated
from repro_torch.fl.api import RoundState
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train
from repro_torch.models import transformer
from repro_torch.models.api import get_model
from repro_torch.weights import (
    lm_params_from_numpy,
    params_from_numpy,
    silo_params_from_numpy,
    state_from_numpy,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "cross_silo_llm_torch.py"]

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, {root!r})
import chip_smoke
bad = sorted(n for n in sys.modules if n == "repro" or n.startswith(("repro.", "jax.", "jaxlib")))
print("BAD", bad)
print("LOADED", sorted(n for n in ("repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
                                   "repro_torch.fl.faults", "repro_torch.fl.sched",
                                   "repro_torch.obs.record", "repro_torch.serve.engine")
                       if n in sys.modules))
print("LOADED2", sorted(n for n in ("repro_torch.core.privacy", "repro_torch.fl.shard",
                                    "repro_torch.launch.collectives", "repro_torch.launch.context",
                                    "repro_torch.launch.mesh", "repro_torch.launch.sharding",
                                    "repro_torch.optim.optim")
                        if n in sys.modules))
"""


def test_import_with_jax_blocked_loads_no_reference_module():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert ("LOADED ['repro_torch.checkpoint', 'repro_torch.checkpoint.checkpoint', "
            "'repro_torch.fl.faults', 'repro_torch.fl.sched', 'repro_torch.obs.record', "
            "'repro_torch.serve.engine']") in out.stdout, out.stdout
    assert ("LOADED2 ['repro_torch.core.privacy', 'repro_torch.fl.shard', "
            "'repro_torch.launch.collectives', 'repro_torch.launch.context', "
            "'repro_torch.launch.mesh', 'repro_torch.launch.sharding', "
            "'repro_torch.optim.optim']") in out.stdout, out.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)", src, re.M), path
    assert not re.search(r"^\s*(from repro[. ]|import repro\b(?!_torch))", src, re.M), path


_BLOCKED_CROSS_SILO = """
import importlib.util, sys
sys.modules["jax"] = None
import repro_torch.fl.cross_silo
spec = importlib.util.spec_from_file_location("ex", {example!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("BAD", sorted(n for n in sys.modules if n == "repro" or n.startswith(("repro.", "jax.", "jaxlib"))))
"""


def test_cross_silo_and_its_example_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CROSS_SILO.format(
            example=str(ROOT / "examples" / "cross_silo_llm_torch.py"))],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_cross_silo_dryrun_and_bits_raise():
    """``build_fl_dryrun`` (through ``launch.dryrun.run_one(fl_shared=)``)
    traces the mesh round on (2, 1): two silos, their Eq. 1 mean one
    partial and one combine launch and one all-reduce of the (2, width)
    float32 buffer over the data axis, and the losses' all-gather; the
    quantized round
    takes bits 4 and 8 only, with the JAX package's ValueError."""
    from repro_torch.fl import cross_silo
    from repro_torch.kernels.masked_aggregate import partial_layout
    from repro_torch.launch.dryrun import run_one

    cfg = get_config("granite-3-8b").reduced()
    r = run_one("granite-3-8b", "train_4k", fl_shared=1, mesh=(2, 1), cfg=cfg, batch=4, seq=32,
                verbose=False)
    assert (r["mode"], r["n_silos"], r["local_batch"], r["fl_shared"]) == ("fl_round", 2, 2, 1)
    launches = r["launches"]
    assert launches["masked_aggregate_partial"] == launches["masked_aggregate_combine"] == 1
    shared = [p.numel() for n, p in cross_silo.param_tree(get_model(cfg).init(
        torch.Generator().manual_seed(0))).items() if n == "embed" or n.startswith("blocks.0.")]
    width = partial_layout(shared, 1)[2]
    assert r["collectives"] == {"all-reduce": 4.0 * 2 * width, "all-gather": 4.0}
    assert r["memory"]["peak_bytes"] > r["memory"]["argument_bytes"] > 0
    with pytest.raises(ValueError, match=r"supports bits in \(4, 8\), got 2"):
        cross_silo.make_quantized_fl_round_step(cfg, get_model(cfg), None, 1, bits=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors (the suite runs in
    several worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny_ds():
    return make_federated_classification(
        n_clients=4, n_classes=3, n_features=6, samples_per_client_range=(20, 30), seed=0
    )


_LAYERS = [{"w": np.ones((3, 2), np.float32), "b": np.zeros((2,), np.float32)}]
_ENTRY_POINTS = {
    "run_federated": lambda ds: run_federated(ds, FLConfig(rounds=1)),
    "make_round_step": lambda ds: make_round_step(ds, FLConfig(rounds=1)),
    "params_from_numpy": lambda ds: params_from_numpy(_LAYERS),
    "state_from_numpy": lambda ds: state_from_numpy(
        RoundState(*([_LAYERS] + [None] * (len(RoundState._fields) - 1)))),
    "serve": lambda ds: serve(get_config("granite-3-8b").reduced(), requests=1, batch=1,
                              prompt_len=4, max_new=1),
    "lm_params_from_numpy": lambda ds: lm_params_from_numpy(get_config("granite-3-8b"), {}),
    "train": lambda ds: train(get_config("granite-3-8b").reduced(), steps=1, batch=1, seq=4),
    # the cross-silo round runs where its SiloParams lie; both ways to make
    # them from numpy or a fresh model default to the card
    "silo_params_from_numpy": lambda ds: silo_params_from_numpy(get_config("granite-3-8b"), {}),
    "cross_silo_llm_torch": lambda ds: _cross_silo_example().main(["--small", "--steps", "1"]),
}


def _cross_silo_example():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "cross_silo_llm_torch", ROOT / "examples" / "cross_silo_llm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_without_cuda_raise(tiny_ds, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[entry](tiny_ds)


@pytest.mark.parametrize("entry", ["params_from_numpy", "state_from_numpy"])
def test_weights_on_the_cpu_when_asked(entry):
    if entry == "params_from_numpy":
        got = params_from_numpy(_LAYERS, "cpu")
    else:
        state = RoundState(*([_LAYERS] + [None] * (len(RoundState._fields) - 1)))
        got = state_from_numpy(state, "cpu").global_params
    assert got[0]["w"].device.type == "cpu" and torch.equal(got[0]["w"], torch.ones(3, 2))


# ROADMAP.md queue 1 item 12, ported: cohort sharding runs on the CPU when
# asked (a world-1 gloo group opened and closed by the run)
_ITEM_12 = {
    "cohort_devices": dict(cohort_devices=1),
    "cohort_devices_all": dict(cohort_devices=-1),
    "cohort_devices_chunked": dict(cohort_devices=1, scan_chunk=2, codec="int8"),
}


@pytest.mark.parametrize("name", sorted(_ITEM_12))
def test_sharding_options_run_on_the_cpu(tiny_ds, name):
    import torch.distributed as dist

    kw = _ITEM_12[name]
    h = run_federated(tiny_ds, FLConfig(rounds=3, epochs=1, **kw), device="cpu")
    ref = run_federated(tiny_ds, FLConfig(rounds=3, epochs=1,
                                          **{k: v for k, v in kw.items() if k != "cohort_devices"}),
                        device="cpu")
    np.testing.assert_array_equal(h.accuracy_per_client, ref.accuracy_per_client)
    np.testing.assert_array_equal(h.selected, ref.selected)
    assert not dist.is_initialized()


# ROADMAP.md queue 1 item 10, ported: each option runs on the CPU when asked
_ITEM_10 = {
    "host_population": dict(host_population=1),
    "eval_chunk": dict(host_population=1, eval_chunk=3),
    "edge_groups": dict(edge_groups=2),
}


@pytest.mark.parametrize("scheduler", ["sync", "async"])
@pytest.mark.parametrize("name", sorted(_ITEM_10))
def test_population_options_run_on_the_cpu(tiny_ds, name, scheduler):
    h = run_federated(tiny_ds, FLConfig(rounds=3, epochs=1, scheduler=scheduler, buffer_k=2,
                                        **_ITEM_10[name]), device="cpu")
    assert h.accuracy_per_client.shape == (3, tiny_ds.n_clients)
    assert np.isfinite(h.accuracy_mean).all() and h.wall_time.shape == (3,)
    if name == "edge_groups":
        assert h.tx_edge_bytes.shape == (3, 2) and (h.tx_edge_bytes > 0).any()
    else:
        assert h.tx_edge_bytes is None


# ROADMAP.md queue 1 item 7, ported: each option runs on the CPU when asked
_ITEM_7 = {
    "cohort_size": dict(cohort_size=2),
    "eval_every": dict(eval_every=2),
    "scan_chunk": dict(scan_chunk=2),
    "scan_chunk_whole_run": dict(scan_chunk=0),
}


@pytest.mark.parametrize("name", sorted(_ITEM_7))
def test_cohort_thinning_and_chunk_options_run(tiny_ds, name):
    h = run_federated(tiny_ds, FLConfig(rounds=3, epochs=1, **_ITEM_7[name]), device="cpu")
    assert h.accuracy_per_client.shape == (3, tiny_ds.n_clients)
    assert np.isfinite(h.accuracy_mean).all() and h.wall_time.shape == (3,)
    np.testing.assert_array_equal(h.in_flight, 2 if name == "cohort_size" else tiny_ds.n_clients)


# ROADMAP.md queue 1 item 9's recorder, ported: each scheduler records on the CPU
_RECORDED = {
    "sync": dict(scan_chunk=2),
    "async": dict(scheduler="async", buffer_k=2),
}


@pytest.mark.parametrize("name", sorted(_RECORDED))
def test_recorder_runs_and_writes_its_record(tiny_ds, tmp_path, name):
    """``run_federated(recorder=RunRecorder(...))`` runs, leaves the history
    bitwise the unrecorded run's and writes its record: a manifest, one
    metrics row a round, the run log, a valid trace and a profile."""
    from repro_torch.obs import RunRecorder, validate_trace_file

    cfg = FLConfig(rounds=3, epochs=1, **_RECORDED[name])
    rec = RunRecorder(str(tmp_path), trace=True, profile=True, echo=False)
    h = run_federated(tiny_ds, cfg, device="cpu", recorder=rec, progress=True)
    np.testing.assert_array_equal(h.accuracy_per_client,
                                  run_federated(tiny_ds, cfg, device="cpu").accuracy_per_client)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["mode"] == name and manifest["rounds_recorded"] == 3
    assert sorted(manifest["files"]) == ["log", "metrics", "profile", "trace"]
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["t"] for r in rows] == [0, 1, 2]
    assert [r["sim_clock_s"] for r in rows] == h.sim_clock.tolist()
    assert (tmp_path / "run.log").read_text().strip()
    assert validate_trace_file(str(tmp_path / "trace.json"), tiny_ds.n_clients) == []


# ROADMAP.md queue 1 item 8 and the faults/checkpoint part of item 9,
# ported: each option runs on the CPU when asked
_ITEMS_8_9 = {
    "async": dict(cfg=dict(scheduler="async", buffer_k=2)),
    "faults": dict(cfg=dict(dropout_rate=0.1, corrupt_rate=0.3)),
    "checkpoint": dict(cfg=dict(), run=dict(checkpoint_every=1)),
}


@pytest.mark.parametrize("name", sorted(_ITEMS_8_9))
def test_async_faults_and_checkpoint_run(tiny_ds, tmp_path, name):
    case = _ITEMS_8_9[name]
    run_kw = dict(case.get("run", {}))
    if run_kw:
        run_kw["checkpoint_dir"] = str(tmp_path / "ckpt")
    h = run_federated(tiny_ds, FLConfig(rounds=3, epochs=1, **case["cfg"]), device="cpu",
                      **run_kw)
    assert h.accuracy_per_client.shape == (3, tiny_ds.n_clients)
    assert np.isfinite(h.accuracy_mean).all() and h.wall_time.shape == (3,)
    if name == "async":
        assert (h.selected.sum(axis=1) <= 2).all() and (np.diff(h.sim_clock) >= 0).all()
    if name == "checkpoint":
        assert sorted(p.name for p in (tmp_path / "ckpt").glob("round_*.npz")) == [
            "round_00001.npz", "round_00002.npz", "round_00003.npz"]


def test_lazy_population_routes_to_the_host_plane(monkeypatch):
    """A lazily generated population (no eager ``x_train``) runs on the
    host-resident population plane."""
    from repro_torch.data import make_sharded_population
    from repro_torch.fl import population

    calls = []
    real = population.run_host_sync
    monkeypatch.setattr(population, "run_host_sync",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    lazy = make_sharded_population(n_clients=6, n_classes=3, n_features=6,
                                   samples_per_client_range=(20, 30), seed=0)
    assert not hasattr(lazy, "x_train")
    h = run_federated(lazy, FLConfig(rounds=2, epochs=1), device="cpu")
    assert calls == [1] and h.accuracy_per_client.shape == (2, 6)


_ZOO_ARCHS = ["falcon-mamba-7b", "granite-3-8b", "deepseek-moe-16b", "moonshot-v1-16b-a3b",
              "deepseek-v2-lite-16b", "chatglm3-6b", "stablelm-12b", "qwen2-vl-2b",
              "jamba-v0.1-52b", "whisper-tiny"]


@pytest.mark.parametrize("arch", _ZOO_ARCHS)
def test_ported_archs_are_registered(arch):
    assert get_config(arch).name == arch


def test_every_jax_arch_is_registered_and_an_unknown_one_raises():
    """The port registers a config module for every one of the JAX
    package's (read from its directory, not imported); an unknown name
    raises the JAX registry's KeyError."""
    from repro_torch.configs import _ARCH_MODULES

    jax_modules = {p.stem for p in (ROOT / "src" / "repro" / "configs").glob("*.py")}
    assert {m.rsplit(".", 1)[1] for m in _ARCH_MODULES.values()} == jax_modules - {"__init__",
                                                                                  "base"}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


def test_no_refusal_names_a_model_zoo_item():
    """The model zoo's refusals are gone: no ``NotImplementedError`` in the
    port names ROADMAP.md's item 14 or item 6."""
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        text = path.read_text()
        assert not re.search(r"NotImplementedError\([^)]*item (14|6)\b", text), path
        assert "_TODO" not in text, path


def test_tied_embeddings_build_serve_and_train():
    """A tied config (``tie_embeddings=True``) has no ``head`` leaf; its
    logits are ``x @ embed.T``: a prefill, a decode step and two train
    steps run on the CPU, the embedding moving; a tree with a head is
    refused for it, and a tree without one for an untied config."""
    from repro_torch import optim
    from repro_torch import random as prng
    from repro_torch.models.api import make_concrete_batch, param_tree

    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(), tie_embeddings=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    assert model.head is None and "head" not in param_tree(model)
    batch = make_concrete_batch(cfg, "prefill", 2, 8, prng.PRNGKey(1))
    logits, cache = bundle.make_prefill_step()(model, batch)
    logits, cache = bundle.make_decode_step()(model, cache, logits.argmax(-1)[:, None])
    assert logits.shape == (2, cfg.vocab_padded) and bool(torch.isfinite(logits).all())
    opt = optim.adamw(1e-3)
    step = bundle.make_train_step(opt)
    state = opt.init(param_tree(model))
    embed0 = model.embed.detach().clone()
    train_batch = make_concrete_batch(cfg, "train", 2, 8, prng.PRNGKey(2))
    for _ in range(2):
        model, state, loss = step(model, state, train_batch)
        assert bool(torch.isfinite(loss))
    assert not torch.equal(model.embed.detach(), embed0)
    tree = {"embed": model.embed.detach(), "final_norm": model.final_norm.detach(),
            "blocks": [{k: v for k, v in b.named_parameters()} for b in model.blocks]}
    with pytest.raises(ValueError, match="head"):
        transformer.DecoderLM(cfg, dict(tree, head=tree["embed"].t()))
    with pytest.raises(ValueError, match="head"):
        transformer.DecoderLM(dataclasses.replace(cfg, tie_embeddings=False), tree)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-tiny"])
def test_hybrid_and_encoder_decoder_archs_run(arch):
    """The hybrid stack (Mamba and attention caches side by side, an MoE or
    a dense FFN after every mixer) and the encoder-decoder (frames in the
    prefill batch, ``enc_out`` in the cache), each raising before this
    slice, build and run a prefill and a decode step on the CPU at their
    reduced configs."""
    from repro_torch import random as prng
    from repro_torch.models.api import make_concrete_batch

    cfg = get_config(arch).reduced()
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    batch = make_concrete_batch(cfg, "prefill", 2, 8, prng.PRNGKey(1))
    logits, cache = bundle.make_prefill_step()(model, batch)
    assert cache["pos"] == 8
    logits, cache = bundle.make_decode_step()(model, cache, logits.argmax(-1)[:, None])
    assert logits.shape == (2, cfg.vocab_padded) and bool(torch.isfinite(logits).all())
    assert cache["pos"] == 9
    if cfg.encoder_decoder:
        assert list(batch) == ["frames", "tokens"] and batch["frames"].dtype == torch.bfloat16
        assert cache["enc_out"].shape == (2, cfg.encoder_seq, cfg.d_model)
        assert len(cache["layers"]) == cfg.n_layers
    else:
        kinds = [sorted(c) for c in cache["layers"]]
        assert kinds.count(["k", "kv_pos", "v"]) == 1 and kinds.count(["conv", "ssm"]) == 7
        assert all("ffn" in blk or "moe" in blk for blk in model.blocks)


@pytest.mark.parametrize("change", [dict(moe=True, n_experts=4, top_k=2), dict(attn_type="mla"),
                                    dict(rope_variant="half"),
                                    dict(frontend="vision_stub", n_vision_tokens=4,
                                         rope_variant="mrope", mrope_sections=(8, 12, 12))],
                         ids=str)
def test_moe_and_mla_features_run(change):
    """MoE layers, MLA attention, half RoPE and the vision stub with M-RoPE
    (each raised before its slice was ported) build and run a prefill and a
    decode step on the CPU, on granite's reduced config."""
    from repro_torch import random as prng
    from repro_torch.models.api import make_concrete_batch

    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(), **change)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    batch = make_concrete_batch(cfg, "prefill", 2, 8, prng.PRNGKey(1))
    toks = batch["tokens"]
    logits, cache = bundle.make_prefill_step()(model, batch)
    assert cache["pos"] == 8
    logits, cache = bundle.make_decode_step()(model, cache, logits.argmax(-1)[:, None])
    assert logits.shape == (2, cfg.vocab_padded) and bool(torch.isfinite(logits).all())
    if cfg.frontend == "vision_stub":
        assert set(batch) == {"vision_embeds", "tokens", "positions"} and toks.shape == (2, 4)
        assert model.vision_proj.shape == (cfg.d_model, cfg.d_model)
    if cfg.moe:
        assert all("moe" in blk for blk in model.blocks)
        _, _, aux = transformer.forward(model, cfg, toks)
        assert float(aux) > 0
    elif cfg.attn_type == "mla":
        assert set(cache["layers"][0]) == {"c_kv", "k_rope", "kv_pos"}


def test_expert_parallel_moe_raises(monkeypatch):
    """The expert-parallel MoE is ported (ROADMAP.md queue 1 item 14.8):
    under a (1, 1) mesh of ranks ``moe_apply`` takes ``moe_apply_ep`` and
    gives JAX's ``moe_apply`` under the JAX package's (1, 1) mesh context
    (its ``moe_apply_ep``) within 1e-5 of max, aux too; without a mesh it
    takes ``moe_apply_local``. It trains: the gradients of a loss of y and
    aux with respect to x and the router are JAX's ``jax.grad`` of the same
    loss under its mesh within 1e-5 of max (``tests/test_torch_train_mesh.py``
    trains whole models on larger meshes)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.launch import context as jax_ctx
    from repro.models import layers as JL

    from repro_torch.launch import context as ctx
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("deepseek-moe-16b").reduced(), dtype="float32")
    p = layers.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    taken = []
    ep = layers.moe_apply_ep
    monkeypatch.setattr(layers, "moe_apply_ep", lambda *a: taken.append("ep") or ep(*a))
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    xg = x.clone().requires_grad_(True)
    p["router"].requires_grad_(True)
    mesh = make_rank_mesh((1, 1), device="cpu")
    try:
        with ctx.mesh_context(mesh):
            y, aux = layers.moe_apply(p, xg, cfg)
            gx, grouter = torch.autograd.grad(torch.sum(y * dy) + aux, [xg, p["router"]])
    finally:
        mesh.close()
    y, aux = y.detach(), aux.detach()
    p["router"].requires_grad_(False)
    assert taken == ["ep"]
    layers.moe_apply(p, x, cfg)
    assert taken == ["ep"]
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jp = {k: v.numpy() if isinstance(v, torch.Tensor) else {kk: vv.numpy() for kk, vv in v.items()}
          for k, v in p.items()}
    with jax_ctx.mesh_context(jmesh):
        jy, jaux = jax.jit(lambda p, x: JL.moe_apply(p, x, jcfg))(jp, x.numpy())
    jy = np.asarray(jy)
    assert np.abs(y.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))

    def jloss(p, x):
        jy, jaux = JL.moe_apply(p, x, jcfg)
        return (jy * dy.numpy()).sum() + jaux

    with jax_ctx.mesh_context(jmesh):
        jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x.numpy())
    for got, want in ((gx, jgx), (grouter, jgp["router"])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_serve_record_writes_a_record(tmp_path):
    """``launch/serve.py --record DIR`` on the CPU writes the JAX CLI's serve
    record: a manifest with the session's summary, one ``requests.jsonl``
    row a request, and a valid trace of the request spans."""
    from repro_torch.obs import validate_trace_file

    rec = tmp_path / "rec"
    stats = serve_main(["--arch", "granite-3-8b", "--requests", "3", "--batch", "2",
                        "--prompt-len", "8", "--max-new", "3", "--record", str(rec),
                        "--device", "cpu"])
    assert stats["record"] == str(rec)
    manifest = json.loads((rec / "manifest.json").read_text())
    assert manifest["kind"] == "serve" and manifest["engine"] == "decode"
    assert manifest["artifact"]["arch"] == "granite-3-8b" and manifest["requests_recorded"] == 3
    assert manifest["summary"]["tokens"] == stats["tokens"]
    rows = [json.loads(line) for line in (rec / "requests.jsonl").read_text().splitlines()]
    assert sorted(r["rid"] for r in rows) == [0, 1, 2]
    assert [r["steps"] for r in sorted(rows, key=lambda r: r["rid"])] == stats["lens"]
    assert validate_trace_file(str(rec / "trace.json")) == []


def test_ssm_bwd_ab_runs_chip_smokes_shapes_and_needs_a_card(monkeypatch):
    """``launch/ssm_bwd_ab.py``, the A/B tool of the scan's backward kernel,
    imports on the CPU and refuses to time without a card; its falcon
    shapes are the ones ``chip_smoke.py``'s ``[train_kernels]`` holds to the
    contract (chip_smoke takes them from the tool): B and S of the serving
    run, falcon-mamba-7b's d_inner and d_state, a ragged S, and the reduced
    configs' d_state 8."""
    import importlib.util

    from repro_torch.launch import ssm_bwd_ab

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)  # its dataclasses look it up
    spec.loader.exec_module(cs)
    fm = get_config("falcon-mamba-7b")
    b, s = cs.SERVE_RUN["batch"], cs.SERVE_RUN["prompt_len"]
    shapes = ssm_bwd_ab.shapes()
    assert cs.ssm_bwd_shapes is ssm_bwd_ab.shapes
    assert shapes["falcon"] == (b, s, fm.d_inner, fm.d_state) == (4, 2048, 8192, 16)
    assert shapes["falcon_ragged"] == (b, 1999, fm.d_inner, fm.d_state)
    assert shapes["falcon_ds8"] == (b, s, fm.d_inner, fm.reduced().d_state) == (4, 2048, 8192, 8)
    monkeypatch.setattr(sys, "argv", ["ssm_bwd_ab", "variant.cu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ssm_bwd_ab.main()
