"""The port's tensor parallelism for serving over the ``model`` axis of a
(data, model) mesh of ranks (``launch/tp.py``, ``launch.sharding.model_block``)
against the JAX package's sharded prefill and decode, on the CPU.

The reference: one ``tests/_subproc.run_forced(code, 4)`` call jits JAX's
prefill and decode steps under ``repro.launch.context.mesh_context`` on
meshes (1, 2), (1, 4) and (2, 2) built with Auto axes, the parameters
placed by ``repro.launch.sharding.tree_shardings`` (``param_spec``'s
``model`` entries on every leaf: XLA's tensor parallelism), for the reduced
float32 granite-3-8b, falcon-mamba-7b, jamba-v0.1-52b (Mamba, attention,
MoE), moonshot-v1-16b-a3b (shared experts, a dense first layer),
chatglm3-6b (Hkv = 2 < 4 ranks) and deepseek-v2-lite-16b (MLA): a prefill
of a batch of 4 and two decode steps. Weights (``init_params`` from a
seed, in the JAX package's tree) and tokens (numpy, from a seed) are made
here and carried to both packages; the port's ranks take them through
``lm_params_from_numpy(..., mesh=)``.

The port: one gloo world of 4 ((1, 4), then (2, 2)) and one of 2 ((1, 2)),
one process a rank spawned over a ``FileStore`` while JAX runs; (1, 1) runs
in this process. Asserted, rank by rank:

- the gathered logits of the prefill and both decode steps within 1e-5 of
  max of JAX's sharded run (2^-8 behind a Mamba scan), every rank's bitwise
  equal;
- the rank's cache within the same tolerance of its rows, kv heads and
  d_inner block of JAX's (MLA's compressed cache whole);
- ``init_params`` under the mesh: the model ranks' blocks, put back where
  ``model_block`` says they lie, are bitwise the unsharded init (Mamba's
  ``in_proj`` block is the x and then the z columns of a d_inner block);
- a rank's held parameter bytes are JAX's ``param_spec`` blocks over
  ``model`` but for the leaves ``model_block`` keeps whole (the norms, the
  router, MLA's ``wdkv``/``wkr``, a kv head shared by ranks), whose excess
  is counted exactly;
- ``serve`` on (1, 4) and (1, 2) gives every rank the tokens of the run
  without a mesh;
- granite-3-8b with tied embeddings on (1, 2) (the head a row product over
  the rank's d columns of ``embed``): prefill and two decode steps within
  1e-5 of max of the port's own unsharded tied model, every rank bitwise
  equal (no JAX compile beside it);
- in process: (1, 1) is bitwise the run without a mesh, and a
  tensor-parallel block outside a ``mesh_context`` raises ``RuntimeError``.

Training under tensor parallelism is ``tests/test_torch_train_mesh.py``'s.

The spawned ranks import this module, which imports no jax at top level.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import context as ctx
from repro_torch.launch import tp
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.launch.serve import serve
from repro_torch.launch.sharding import model_block
from repro_torch.models import transformer as T
from repro_torch.weights import lm_params_from_numpy
from test_torch_expert_parallel import (
    _StubMesh,
    _close,
    _jax_cache_layers,
    _jax_tree,
    _join,
    _key,
    _np,
    _np_tree,
    _spawn_world,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]

ARCHS = ["granite-3-8b", "falcon-mamba-7b", "jamba-v0.1-52b", "moonshot-v1-16b-a3b",
         "chatglm3-6b", "deepseek-v2-lite-16b"]
MESHES = [(1, 2), (1, 4), (2, 2)]  # (1, 1) runs in this process, against no mesh
WORLDS = {4: [(1, 4), (2, 2)], 2: [(1, 2)]}
B, S, DECODE_STEPS = 4, 16, 2
REL = {"falcon-mamba-7b": 2.0 ** -8, "jamba-v0.1-52b": 2.0 ** -8}  # behind a Mamba scan
F32_REL = 1e-5
SPAWN_TIMEOUT_S = 600
SERVE = dict(requests=3, batch=2, prompt_len=12, max_new=4, seed=0)
SERVE_ON = {(1, 4): "granite-3-8b", (1, 2): "falcon-mamba-7b"}
TIED_ON = (1, 2)  # the mesh the tied granite serves on, against itself without one
# leaves model_block keeps whole where JAX's param_spec splits them over model
WHOLE_LEAVES = ("norm1", "norm2", "final_norm", "router", "wdkv", "wkr")


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _rel(arch) -> float:
    return REL.get(arch, F32_REL)


def _flat(tree, path=""):
    """{path: leaf} of nested dicts and lists, paths as the JAX package's
    ``_path_str`` joins them."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}/{k}" if path else str(k)))
    return out


def _leaves(model) -> dict:
    """A port model's leaves by ``model_block`` path, as numpy arrays."""
    return {name.replace(".", "/"): _np(p) for name, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# the port, one rank (spawned)
# ---------------------------------------------------------------------------


def _steps(cfg, model, toks, dec) -> list:
    """Prefill ``toks`` then a decode step a column of ``dec``: each step's
    (gathered logits, this rank's cache)."""
    prefill, decode = T.make_prefill_step(cfg), T.make_decode_step(cfg)
    logits, cache = prefill(model, {"tokens": torch.from_numpy(toks)})
    out = [(_np(logits), _np_tree(cache))]
    for t in range(dec.shape[1]):
        logits, cache = decode(model, cache, torch.from_numpy(dec[:, t:t + 1]))
        out.append((_np(logits), _np_tree(cache)))
    return out


def _tied_cfg():
    return dataclasses.replace(_cfg("granite-3-8b"), tie_embeddings=True)


def _tied_steps(inputs: dict, mesh=None) -> list:
    """The tied granite's steps on its carried weights (under ``mesh``, the
    rank's blocks)."""
    cfg, arrays = _tied_cfg(), inputs["tied"]
    model = lm_params_from_numpy(cfg, arrays["params"], device="cpu", mesh=mesh)
    return _steps(cfg, model, arrays["toks"], arrays["dec"])


def _port_mesh_run(shape, inputs: dict) -> dict:
    """Every arch under one mesh on this rank: the steps on the carried
    weights, the rank's held bytes by JAX path, and ``init_params``'s
    leaves (on (1, 2), also the tied granite's steps)."""
    mesh = make_rank_mesh(shape, device="cpu")
    out = {"coords": (mesh.coords["data"], mesh.coords["model"])}
    try:
        with ctx.mesh_context(mesh):
            for arch in ARCHS:
                cfg, arrays = _cfg(arch), inputs[arch]
                rows = ctx.data_rows(cfg, B) or slice(0, B)
                model = lm_params_from_numpy(cfg, arrays["params"], device="cpu", mesh=mesh)
                out[arch] = {
                    "rows": (rows.start, rows.stop),
                    "steps": _steps(cfg, model, arrays["toks"], arrays["dec"]),
                    "bytes": {p: a.nbytes for p, a in _flat(_jax_tree(cfg, model)).items()},
                    "init": _leaves(T.init_params(torch.Generator().manual_seed(0), cfg)),
                }
                del model
            if tuple(shape) in SERVE_ON:
                out["serve"] = serve(_cfg(SERVE_ON[tuple(shape)]), device="cpu",
                                     **SERVE)["outputs"]
            if tuple(shape) == TIED_ON:
                out["tied"] = _tied_steps(inputs, mesh)
    finally:
        mesh.close()
    return out


def _rank_main(rank: str, world: str, store_dir: str, base: str) -> None:
    """One spawned rank: join the gloo world, run its meshes, save."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(os.path.join(base, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(store_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        out = {_key(shape): _port_mesh_run(shape, inputs) for shape in WORLDS[world]}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(base, f"port_w{world}_r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


_RANK_SCRIPT = (
    "import sys; sys.path[:0] = [{src!r}, {tests!r}]; import test_torch_tensor_parallel as m; "
    "m._rank_main(*sys.argv[1:])"
)


# ---------------------------------------------------------------------------
# the JAX reference, in one subprocess with 4 forced host devices
# ---------------------------------------------------------------------------

_JAX_CODE = """
import dataclasses, math, pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from repro.configs import get_config
from repro.launch import context as ctx
from repro.launch.sharding import tree_shardings
from repro.models.api import get_model

ARCHS, MESHES = {archs!r}, {meshes!r}
with open({base!r} + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
pool = ThreadPoolExecutor(8)


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:math.prod(shape)])


def lowered(mesh, fn, *args):
    with ctx.mesh_context(mesh):
        return pool.submit(jax.jit(fn).lower(*args).compile)


jobs = []
for arch in ARCHS:
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    bundle, a = get_model(cfg), inputs[arch]
    for shape in MESHES:
        mesh = mesh_of(shape)
        params = jax.device_put(a["params"], tree_shardings(a["params"], mesh, ("data",)))
        batch = {{"tokens": jnp.asarray(a["toks"])}}
        jobs.append((arch, shape, bundle, mesh, params, a,
                     lowered(mesh, bundle.make_prefill_step(), params, batch)))

out, pending = {{}}, []
for arch, shape, bundle, mesh, params, a, fut in jobs:
    logits, cache = fut.result()(params, {{"tokens": jnp.asarray(a["toks"])}})
    steps = out.setdefault(arch, {{}})[shape] = [(np.asarray(logits), jax.device_get(cache))]
    pending.append((steps, mesh, params, a["dec"], cache,
                    lowered(mesh, bundle.make_decode_step(), params, cache,
                            jnp.asarray(a["dec"][:, :1]))))
for steps, mesh, params, dec, cache, fut in pending:
    for t in range(dec.shape[1]):
        logits, cache = fut.result()(params, cache, jnp.asarray(dec[:, t:t + 1]))
        steps.append((np.asarray(logits), jax.device_get(cache)))
with open({base!r} + "/jax.pkl", "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _inputs() -> dict:
    """Each reduced float32 arch's weights (``init_params`` from seed 0, in
    the JAX package's tree) and numpy tokens from a seed: the prompts (B,
    S) and the decode tokens (B, 2)."""
    out = {}
    for n, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        rng = np.random.default_rng(200 + n)
        out[arch] = {
            "params": _jax_tree(cfg, T.init_params(torch.Generator().manual_seed(0), cfg)),
            "toks": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "dec": rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32),
        }
    cfg, rng = _tied_cfg(), np.random.default_rng(300)
    out["tied"] = {
        "params": _jax_tree(cfg, T.init_params(torch.Generator().manual_seed(0), cfg)),
        "toks": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "dec": rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32),
    }
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's outputs by arch and mesh, the port's by mesh as a list of
    ranks, the inputs, the unsharded init's leaves by arch, the serving
    runs' tokens without a mesh by arch, the tied granite's steps without a
    mesh)."""
    pytest.importorskip("jax")
    from _subproc import run_forced

    base = tmp_path_factory.mktemp("tp")
    inputs = _inputs()
    with open(base / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    code = _JAX_CODE.format(archs=ARCHS, meshes=MESHES, base=str(base))
    jax_err: list = []

    def jax_ref():
        try:
            run_forced(code, 4, timeout=SPAWN_TIMEOUT_S)
        except BaseException as e:  # noqa: BLE001 - raised again in the test's thread
            jax_err.append(e)

    ref = threading.Thread(target=jax_ref)
    ref.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    script = _RANK_SCRIPT.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"))
    worlds = {w: _spawn_world(w, base, script) for w in WORLDS}
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        unsharded = {arch: _leaves(T.init_params(torch.Generator().manual_seed(0), _cfg(arch)))
                     for arch in ARCHS}
        served = {arch: serve(_cfg(arch), device="cpu", **SERVE)["outputs"]
                  for arch in SERVE_ON.values()}
        tied = _tied_steps(inputs)
    finally:
        torch.set_num_threads(before)
        for w, procs in worlds.items():
            _join(procs, deadline, f"gloo world {w}")
        ref.join(max(deadline - time.monotonic(), 1))
    assert not ref.is_alive(), "the JAX reference did not finish"
    if jax_err:
        raise jax_err[0]
    port = {}
    for w, shapes in WORLDS.items():
        ranks = []
        for r in range(w):
            with open(base / f"port_w{w}_r{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        for shape in shapes:
            port[_key(shape)] = [rk[_key(shape)] for rk in ranks]
    with open(base / "jax.pkl", "rb") as f:
        jax_out = pickle.load(f)
    return jax_out, port, inputs, unsharded, served, tied


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax_rank_by_rank(runs, arch, shape):
    """Prefill and two decode steps at batch 4: each rank's gathered logits
    within 1e-5 of max of JAX's sharded run (2^-8 behind a Mamba scan), and
    every rank's bitwise equal."""
    jax_out, port, _, _, _, _ = runs
    ranks = port[_key(shape)]
    want = jax_out[arch][shape]
    for rk in ranks:
        got = rk[arch]["steps"]
        assert len(got) == len(want) == 1 + DECODE_STEPS
        for t, ((logits, _), (jlogits, _)) in enumerate(zip(got, want)):
            _close(logits, jlogits, _rel(arch), f"{arch} {shape} rank {rk['coords']} step {t}")
            np.testing.assert_array_equal(logits, ranks[0][arch]["steps"][t][0])


@pytest.mark.parametrize("shape", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_caches_hold_the_ranks_heads_and_channels(runs, arch, shape):
    """Each rank's cache after every step within the same tolerance of its
    rows, its kv heads and its d_inner block of JAX's cache (MLA's
    compressed cache whole), and smaller than JAX's by that split."""
    jax_out, port, _, _, _, _ = runs
    cfg = _cfg(arch)
    for rk in port[_key(shape)]:
        model = (shape[1], rk["coords"][1])
        for t, ((_, cache), (_, jcache)) in enumerate(zip(rk[arch]["steps"], jax_out[arch][shape])):
            layers = _jax_cache_layers(cfg, jcache, slice(*rk[arch]["rows"]), model)
            assert len(cache["layers"]) == len(layers) and cache["pos"] == int(jcache["pos"])
            for i, (tc, jc) in enumerate(zip(cache["layers"], layers)):
                assert set(tc) == set(jc), (arch, t, i)
                for name in jc:
                    _close(tc[name], jc[name], _rel(arch),
                           f"{arch} {shape} rank {rk['coords']} step {t} layer {i} {name}")


def _put_back(arch, shape, ranks, path, whole):
    """The blocks the model ranks of data row 0 hold of leaf ``path``,
    written where ``model_block`` puts them in an array of the whole
    leaf's shape (NaN where no rank writes)."""
    cfg = _cfg(arch)
    out = np.full(whole.shape, np.nan, dtype=np.float64)
    for rk in ranks:
        i, j = rk["coords"]
        if i:
            continue
        part = rk[arch]["init"][path]
        block = model_block(path, whole.shape, _StubMesh(1, shape[1], j), cfg)
        if "/moe/" in path and path.rsplit("/", 1)[1] in ("wg", "wu", "wd") and whole.ndim == 3:
            e = whole.shape[0] // shape[1]  # the expert leaves: expert_block's E axis
            block = (0, (slice(j * e, (j + 1) * e),))
        if block is None:
            np.testing.assert_array_equal(part, whole, err_msg=f"{path} whole on rank {j}")
            out[...] = whole
            continue
        dim, slices = block
        at = 0
        for s in slices:
            n = s.stop - s.start
            idx = [slice(None)] * whole.ndim
            idx[dim] = s
            got = np.take(part, range(at, at + n), axis=dim)
            prev = out[tuple(idx)]
            assert np.isnan(prev).all() or np.array_equal(prev, got), f"{path} ranks disagree"
            out[tuple(idx)] = got
            at += n
        assert at == part.shape[dim], (path, part.shape, slices)
    return out


@pytest.mark.parametrize("shape", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_blocks_put_back_are_the_unsharded_init(runs, arch, shape):
    """``init_params`` under the mesh draws as without one and keeps each
    leaf's ``model_block``: the model ranks' blocks, put back in place, are
    bitwise the unsharded init, every element covered; the rank holds a
    block of every leaf the layout table splits."""
    _, port, _, unsharded, _, _ = runs
    ranks = port[_key(shape)]
    assert all(rk[arch]["init"].keys() == unsharded[arch].keys() for rk in ranks)
    for path, whole in unsharded[arch].items():
        back = _put_back(arch, shape, ranks, path, whole)
        np.testing.assert_array_equal(back, whole.astype(np.float64), err_msg=path)
    split = [p for p, w in unsharded[arch].items() if ranks[0][arch]["init"][p].shape != w.shape]
    kept = {p.split("/")[-1] for p in unsharded[arch]} - {p.split("/")[-1] for p in split}
    assert kept <= set(WHOLE_LEAVES), kept


def _jax_model_bytes(path: str, a, shape) -> float:
    """The bytes of leaf ``path`` of JAX's tree a rank holds under
    ``param_spec``'s ``model`` entry (its data entries left out: a served
    model holds no ZeRO blocks)."""
    from repro.launch.sharding import param_spec

    spec = param_spec(path, a.shape, _StubMesh(*shape), ("data",))
    return a.nbytes / (shape[1] if "model" in spec else 1)


def _excess(cfg, path: str, a, shape) -> float:
    """The bytes a rank holds of leaf ``path`` beyond JAX's block where
    ``model_block`` keeps it whole: a whole leaf JAX splits, or the one kv
    head of ``wk``/``wv`` that ranks share where Hkv < n."""
    n = shape[1]
    leaf = path.split("/")[-1]
    from repro.launch.sharding import param_spec

    split_by_jax = "model" in param_spec(path, a.shape, _StubMesh(*shape), ("data",))
    if leaf in WHOLE_LEAVES:
        return a.nbytes * (1 - 1 / n) if split_by_jax else 0.0
    if "/mixer/" in f"/{path}/" and leaf in ("wk", "wv") and cfg.attn_type != "mla" \
            and cfg.n_kv_heads < n:
        return a.nbytes / cfg.n_kv_heads - a.nbytes / n
    return 0.0


@pytest.mark.parametrize("shape", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_held_bytes_are_jaxs_param_spec_blocks(runs, arch, shape):
    """A rank's held bytes, leaf by leaf of JAX's tree, are the bytes of
    JAX's ``param_spec`` block over ``model``, but for the leaves
    ``model_block`` keeps whole, whose excess is counted exactly; every
    rank holds the same."""
    _, port, inputs, _, _, _ = runs
    cfg = _cfg(arch)
    jtree = _flat(inputs[arch]["params"])
    for rk in port[_key(shape)]:
        held = rk[arch]["bytes"]
        assert held.keys() == jtree.keys()
        total_excess = 0.0
        for path, a in jtree.items():
            want = _jax_model_bytes(path, a, shape)
            excess = _excess(cfg, path, a, shape)
            assert held[path] == want + excess, (path, held[path], want, excess)
            total_excess += excess
        assert total_excess > 0  # the norms at least


@pytest.mark.parametrize("shape", sorted(SERVE_ON), ids=_key)
def test_serve_gives_every_rank_the_unsharded_tokens(runs, shape):
    """``serve`` inside the mesh context (continuous batching with a
    backfill, reduced float32): every rank produces the tokens of the run
    without a mesh."""
    _, port, _, _, served, _ = runs
    outs = [rk["serve"] for rk in port[_key(shape)]]
    want = served[SERVE_ON[shape]]
    assert all(o == want for o in outs) and len(want) == SERVE["requests"]


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


def test_tied_granite_on_1x2_matches_the_unsharded_model(runs):
    """Tied embeddings on a model axis of 2: every rank's gathered logits of
    the prefill and two decode steps within 1e-5 of max of the port's tied
    model without a mesh, and bitwise equal across the ranks."""
    _, port, _, _, _, tied = runs
    ranks = port[_key(TIED_ON)]
    for rk in ranks:
        assert len(rk["tied"]) == len(tied) == 1 + DECODE_STEPS
        for t, ((logits, _), (want, _)) in enumerate(zip(rk["tied"], tied)):
            _close(logits, want, F32_REL, f"tied step {t} rank {rk['coords']}")
            np.testing.assert_array_equal(logits, ranks[0]["tied"][t][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_1x1_is_bitwise_the_run_without_a_mesh(arch):
    """A (1, 1) mesh splits nothing and runs no row collective: prefill and
    two decode steps, logits and cache, bitwise the run without a mesh."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32)
    model = T.init_params(torch.Generator().manual_seed(0), cfg)
    want = _steps(cfg, model, toks, dec)
    mesh = make_rank_mesh((1, 1), device="cpu")
    try:
        with ctx.mesh_context(mesh):
            sharded = T.init_params(torch.Generator().manual_seed(0), cfg)
            got = _steps(cfg, sharded, toks, dec)
    finally:
        mesh.close()
    assert not dist.is_initialized()
    for (g, gc), (w, wc) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        for tl, wl in zip(gc["layers"], wc["layers"]):
            for name in wl:
                np.testing.assert_array_equal(tl[name], wl[name])
    assert all(torch.equal(a, b) for a, b in zip(sharded.parameters(), model.parameters()))


@pytest.mark.parametrize("arch", ["granite-3-8b", "falcon-mamba-7b", "deepseek-v2-lite-16b"])
def test_a_tensor_parallel_block_outside_a_mesh_context_raises(arch):
    """Rank 0 of a (1, 2) mesh (stub: no collective is reached): the model
    holds its blocks (the head's half of the padded vocabulary, at most
    the model's kv heads and d_inner channels), and one of its blocks
    called outside a ``mesh_context`` raises ``RuntimeError``."""
    cfg = _cfg(arch)
    model = T.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = _StubMesh(1, 2, 0)
    sharded = lm_params_from_numpy(cfg, _jax_tree(cfg, model), device="cpu", mesh=mesh)
    blk, spec = sharded.blocks[-1], sharded.specs[-1]
    x = torch.randn((2, 4, cfg.d_model), generator=torch.Generator().manual_seed(1))
    assert sharded.head.shape[1] == cfg.vocab_padded // 2
    with ctx.mesh_context(mesh):
        assert ctx.tensor_parallel()
        assert tp.kv_heads(cfg) <= cfg.n_kv_heads and tp.d_inner(cfg) <= cfg.d_inner
    assert not ctx.tensor_parallel()
    with pytest.raises(RuntimeError, match="outside a mesh_context"), torch.no_grad():
        T.apply_block(blk, x, torch.arange(4), cfg, spec, mode="prefill")


def test_model_block_rules():
    """The layout table on a (1, 4) stub: Mamba's ``in_proj`` the x and
    then the z columns of d_inner block j; a kv head shared where Hkv < n;
    wo, wd, x_proj and out_proj by rows; norms, the router and MLA's
    ``wdkv`` whole; nothing split on one model rank."""
    fm, gr, ds = _cfg("falcon-mamba-7b"), _cfg("granite-3-8b"), _cfg("deepseek-v2-lite-16b")
    di, d = fm.d_inner, fm.d_model
    q = di // 4
    for j in range(4):
        m = _StubMesh(1, 4, j)
        assert model_block("blocks/0/mixer/in_proj", (d, 2 * di), m, fm) == (
            1, (slice(j * q, (j + 1) * q), slice(di + j * q, di + (j + 1) * q)))
        assert model_block("blocks/0/mixer/out_proj", (di, d), m, fm) == (
            0, (slice(j * q, (j + 1) * q),))
        assert model_block("blocks/0/mixer/x_proj", (di, 3), m, fm)[0] == 0
        hd = gr.head_dim_  # H 4, Hkv 2: one q head a rank, the kv head of its group
        assert model_block("blocks/0/mixer/wk", (gr.d_model, 2 * hd), m, gr) == (
            1, (slice(j // 2 * hd, (j // 2 + 1) * hd),))
        assert model_block("blocks/0/mixer/wo", (4 * hd, gr.d_model), m, gr) == (
            0, (slice(j * hd, (j + 1) * hd),))
        for path in ("blocks/0/norm1", "final_norm", "blocks/1/moe/router",
                     "blocks/0/mixer/wdkv", "blocks/0/mixer/wkr"):
            assert model_block(path, (d, 8), m, ds) is None, path
    assert model_block("embed", (512, d), _StubMesh(2, 1), fm) is None
