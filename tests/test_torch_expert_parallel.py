"""The port's expert-parallel MoE over a (data, model) mesh of ranks
(``launch/mesh.RankMesh``, ``launch/context.mesh_context``,
``models/layers.moe_apply_ep``) against the JAX package's under the same
meshes, on the CPU.

The reference: one ``tests/_subproc.run_forced(code, 4)`` call computes
every JAX output once, under ``repro.launch.context.mesh_context`` on
meshes (1, 1), (1, 2), (1, 4), (2, 2) and (4, 1) built with Auto axes
(``jax.make_mesh`` under jax 0.9.0 makes Explicit ones, on which
``constrain`` asserts in jamba's Mamba prefill: ROADMAP.md queue 3): the
MoE layer (``moe_apply``, which takes ``moe_apply_ep``) and the whole
model's prefill plus two decode steps, for the reduced float32
deepseek-moe-16b, deepseek-v2-lite-16b (MLA), moonshot-v1-16b-a3b (a dense
first layer, shared experts) and jamba-v0.1-52b (Mamba + attention + MoE),
at a batch of 4, and a prefill plus one decode at a batch of 1 on (2, 2),
where JAX replicates the tokens over the data axis. On (2, 2) also the
cases where ``moe_apply`` takes ``moe_apply_local`` under the mesh, which
counts capacity over the whole global batch: every arch under
``mesh_context(moe_ep=False)``, and deepseek-moe with 5 experts, which a
``model`` axis of 2 does not divide. Each shard's routes and
kept mask are recorded with a ``jax.debug.callback`` inside a shard_map
that repeats the routing lines of JAX's ``moe_apply_ep`` (as
``test_torch_moe._jax_route`` repeats ``moe_apply_local``'s). Weights
(``init_params`` from a seed, in the JAX package's tree) and inputs (numpy,
from a seed) are made here and carried to both packages; the port's ranks
take them through ``lm_params_from_numpy(..., mesh=)``.

The port: one gloo world of 4 (meshes (1, 4), (2, 2), (4, 1) in turn) and
one of 2 ((1, 2)), one process a rank spawned over a ``FileStore`` (as
``tests/test_torch_shard.py`` spawns its worlds), while JAX runs; (1, 1)
runs in this process. Asserted, rank by rank:

- the MoE layer's y (this rank's rows) within 1e-5 of max of JAX's, aux
  JAX's where JAX has one value (one data rank; else data rank 0's, the
  shard JAX returns), routes and kept masks equal;
- the gathered logits of the prefill and both decode steps within 1e-5 of
  max of JAX's (2^-8 behind jamba's Mamba scans), every rank's bitwise
  equal, the rank's cache within the same tolerance of JAX's rows of it;
- every MoE call's routes and kept masks equal to JAX's shard's; on (2, 2)
  the routes dropped differ from the unsharded model's exactly as JAX's do
  (each data shard counts capacity over its own tokens);
- where the MoE takes ``moe_apply_local`` on (2, 2), every rank runs the
  whole batch, its logits and cache within the same tolerance of JAX's and
  no expert-parallel call made;
- under a mesh, ``init_params`` leaves each rank only its experts, and the
  slices of the model ranks, concatenated, are bitwise the unsharded
  init (a served model holds no ZeRO blocks); ``serve`` on (1, 2) gives
  every rank the tokens of the run without a mesh;
- in process: the context comes back after an exception,
  ``seq_parallel=True`` opens it and changes no value, the dispatch falls
  back to ``moe_apply_local`` where ``model`` does not divide the experts,
  ``lm_params_from_numpy(mesh=)`` keeps the rank's slice,
  ``make_production_mesh`` names the world it needs, and the
  expert-parallel MoE's gradients on (1, 1) are ``moe_apply_local``'s.
  Training under the mesh is ``tests/test_torch_train_mesh.py``'s.

The spawned ranks import this module, which imports no jax at top level.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import context as ctx
from repro_torch.launch.mesh import RankMesh, make_production_mesh, make_rank_mesh
from repro_torch.launch.serve import serve
from repro_torch.launch.sharding import model_block
from repro_torch.launch.tp import cut
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.weights import EXPERT_LEAVES, lm_params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]

ARCHS = ["deepseek-moe-16b", "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b"]
MESHES = [(1, 1), (1, 2), (1, 4), (2, 2), (4, 1)]
WORLDS = {4: [(1, 4), (2, 2), (4, 1)], 2: [(1, 2)]}  # (1, 1) runs in this process
B, S, DECODE_STEPS = 4, 16, 2
B1_MESH = (2, 2)  # the batch-1 prefill + decode: tokens replicated over the data axis
REL = {"jamba-v0.1-52b": 2.0 ** -8}  # behind a Mamba scan; 1e-5 elsewhere
F32_REL = 1e-5
SPAWN_TIMEOUT_S = 600
SERVE = dict(requests=3, batch=2, prompt_len=12, max_new=4, seed=0)
# (2, 2) runs where the MoE takes moe_apply_local, so JAX counts capacity
# over the whole global batch: name -> (arch, moe_ep, n_experts or None)
LOCAL_MESH = (2, 2)
LOCAL_CASES = {**{f"{arch} moe_ep=False": (arch, False, None) for arch in ARCHS},
               "deepseek-moe-16b 5 experts": ("deepseek-moe-16b", True, 5)}


def _cfg(arch, n_experts=None):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return cfg if n_experts is None else dataclasses.replace(cfg, n_experts=n_experts)


def _rel(arch) -> float:
    return REL.get(arch, F32_REL)


def _key(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _np(t):
    return t.detach().numpy().copy() if isinstance(t, torch.Tensor) else t


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return _np(tree)


# ---------------------------------------------------------------------------
# the port, one rank (spawned, or in this process for (1, 1))
# ---------------------------------------------------------------------------


def _record_routes(into: list):
    """Record every ``moe_ep_routes`` call's (global expert ids, this rank's
    kept mask); returns the undo."""
    orig = L.moe_ep_routes

    def recorded(idx, keep, first, e_local):
        out = orig(idx, keep, first, e_local)
        into.append((_np(idx), _np(out[1])))
        return out

    L.moe_ep_routes = recorded
    return lambda: setattr(L, "moe_ep_routes", orig)


def _steps(cfg, model, toks, dec, routes) -> list:
    """Prefill ``toks`` then a decode step a column of ``dec``: each step's
    (gathered logits, this rank's cache, its MoE calls' routes)."""
    prefill, decode = T.make_prefill_step(cfg), T.make_decode_step(cfg)
    out = []
    logits, cache = prefill(model, {"tokens": torch.from_numpy(toks)})
    out.append((_np(logits), _np_tree(cache), list(routes)))
    for t in range(dec.shape[1]):
        routes.clear()
        logits, cache = decode(model, cache, torch.from_numpy(dec[:, t:t + 1]))
        out.append((_np(logits), _np_tree(cache), list(routes)))
    routes.clear()
    return out


def _port_mesh_run(shape, inputs: dict) -> dict:
    """Every arch under one mesh on this rank: the MoE layer on the rank's
    rows, the steps at batch 4 (and at batch 1 on ``B1_MESH``), the expert
    slices ``init_params`` keeps."""
    mesh = make_rank_mesh(shape, device="cpu")
    out = {"coords": (mesh.coords["data"], mesh.coords["model"])}
    routes: list = []
    undo = _record_routes(routes)
    try:
        with ctx.mesh_context(mesh):
            for arch in ARCHS:
                cfg, arrays = _cfg(arch), inputs[arch]
                res = out[arch] = {}
                rows = ctx.data_rows(cfg, B) or slice(0, B)
                res["rows"] = (rows.start, rows.stop)
                moe = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                       else torch.from_numpy(v) for k, v in arrays["moe"].items()}
                y, aux = L.moe_apply(moe, torch.from_numpy(arrays["x"][rows]), cfg)
                res["moe"] = (_np(y), float(aux), list(routes))
                routes.clear()
                model = lm_params_from_numpy(cfg, arrays["params"], device="cpu", mesh=mesh)
                res["steps"] = _steps(cfg, model, arrays["toks"], arrays["dec"], routes)
                if tuple(shape) == B1_MESH:
                    res["b1"] = _steps(cfg, model, arrays["toks"][:1], arrays["dec"][:1, :1],
                                       routes)
                del model
                init = T.init_params(torch.Generator().manual_seed(0), cfg)
                res["init"] = [{n: _np(blk["moe"][n]) for n in EXPERT_LEAVES}
                               for blk in init.blocks if "moe" in blk]
            if tuple(shape) == LOCAL_MESH:
                for case, (arch, moe_ep, n_experts) in LOCAL_CASES.items():
                    cfg, arrays = _cfg(arch, n_experts), inputs[case]
                    with ctx.mesh_context(mesh, moe_ep=moe_ep):
                        rows = ctx.data_rows(cfg, B) or slice(0, B)
                        model = lm_params_from_numpy(cfg, arrays["params"], device="cpu",
                                                     mesh=mesh if moe_ep else None)
                        out[case] = {"rows": (rows.start, rows.stop),
                                     "steps": _steps(cfg, model, arrays["toks"], arrays["dec"],
                                                     routes)}
            if tuple(shape) == (1, 2):
                out["serve"] = serve(_cfg("jamba-v0.1-52b"), device="cpu", **SERVE)["outputs"]
    finally:
        undo()
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
    "import sys; sys.path[:0] = [{src!r}, {tests!r}]; import test_torch_expert_parallel as m; "
    "m._rank_main(*sys.argv[1:])"
)


def _spawn_world(world: int, base: pathlib.Path, script: str | None = None) -> list:
    """The ranks of a gloo world of ``world``, each ``script`` (default
    this module's ``_rank_main``) in its own interpreter."""
    store = base / f"store{world}"
    store.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    script = script or _RANK_SCRIPT.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"))
    return [subprocess.Popen([sys.executable, "-c", script, str(r), str(world), str(store),
                              str(base)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _join(procs: list, deadline: float, what: str) -> None:
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
        assert p.returncode == 0, f"{what} rank {r} failed:\n{log[-4000:]}"


# ---------------------------------------------------------------------------
# the JAX reference, in one subprocess with 4 forced host devices
# ---------------------------------------------------------------------------

_JAX_CODE = """
import dataclasses, math, pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, PartitionSpec as P

from repro.configs import get_config
from repro.launch import context as ctx
from repro.models import layers as JL
from repro.models.api import get_model

ARCHS, MESHES, B1_MESH = {archs!r}, {meshes!r}, {b1!r}
LOCAL_MESH, LOCAL_CASES = {local_mesh!r}, {local_cases!r}
with open({base!r} + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
REC, TAG = {{}}, [None]
jax_ep = JL.moe_apply_ep


def ep_recorded(p, x, cfg):
    # moe_apply_ep's routing lines in a shard_map of their own: each
    # shard's (data index, model index, routed ids, kept mask)
    mesh, dp = ctx.get_mesh(), ctx.dp_spec()
    n_mp, e, k = mesh.shape["model"], cfg.n_experts, cfg.top_k
    e_local = e // n_mp
    if x.shape[0] % math.prod(mesh.shape[a] for a in ctx.dp_axes()):
        dp = None

    def routes(router, xl):
        nl = xl.shape[0] * xl.shape[1]
        probs = jax.nn.softmax(xl.reshape(nl, -1).astype(jnp.float32) @ router, axis=-1)
        _, idx = jax.lax.top_k(probs, k)
        j = jax.lax.axis_index("model")
        rel = idx - j * e_local
        mine = (rel >= 0) & (rel < e_local)
        cap = max(1, int(math.ceil(nl * k * cfg.capacity_factor / e)))
        flat_rel = jnp.where(mine, rel, e_local).reshape(-1)
        onehot = jax.nn.one_hot(flat_rel, e_local + 1, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0), flat_rel[:, None], axis=1)[:, 0] - 1
        keep = (pos < cap) & (flat_rel < e_local)
        jax.debug.callback(lambda i, j, a, b: REC.setdefault((TAG[0], int(i), int(j)), []).append(
            (np.asarray(a), np.asarray(b))), jax.lax.axis_index("data"), j, idx, keep)
        return xl

    jax.shard_map(routes, mesh=mesh, in_specs=(P(), P(dp, None, None)),
                  out_specs=P(dp, None, None), check_vma=False)(p["router"], x)
    return jax_ep(p, x, cfg)


JL.moe_apply_ep = ep_recorded
pool = ThreadPoolExecutor(8)


def lowered(mesh, fn, *args, moe_ep=True):
    with ctx.mesh_context(mesh, moe_ep=moe_ep):
        return pool.submit(jax.jit(fn).lower(*args).compile)


def run(tag, fut, *args):
    TAG[0] = tag
    out = fut.result()(*args)
    jax.effects_barrier()
    return out


def routes_of(tag):
    return {{(i, j): v for (t, i, j), v in REC.items() if t == tag}}


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:math.prod(shape)])


def cfg_of(arch, n_experts=None):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return cfg if n_experts is None else dataclasses.replace(cfg, n_experts=n_experts)


jobs = []
for arch in ARCHS:
    cfg = cfg_of(arch)
    bundle, a = get_model(cfg), inputs[arch]
    for shape in MESHES:
        mesh = mesh_of(shape)
        runs = [("b4", a["toks"], a["dec"])]
        if shape == B1_MESH:
            runs.append(("b1", a["toks"][:1], a["dec"][:1, :1]))
        jobs.append((arch, shape, cfg, bundle, mesh, a,
                     lowered(mesh, lambda p, x, cfg=cfg: JL.moe_apply(p, x, cfg), a["moe"], a["x"]),
                     [(name, toks, dec, lowered(mesh, bundle.make_prefill_step(), a["params"],
                                                 {{"tokens": toks}}))
                      for name, toks, dec in runs]))
local_jobs = []
for case, (arch, moe_ep, n_experts) in LOCAL_CASES.items():
    cfg, mesh, a = cfg_of(arch, n_experts), mesh_of(LOCAL_MESH), inputs[case]
    bundle = get_model(cfg)
    local_jobs.append((case, mesh, moe_ep, bundle, a,
                       lowered(mesh, bundle.make_prefill_step(), a["params"], {{"tokens": a["toks"]}},
                               moe_ep=moe_ep)))

out, pending = {{}}, []
for arch, shape, cfg, bundle, mesh, a, moe_fut, runs in jobs:
    res = out.setdefault(arch, {{}}).setdefault(shape, {{}})
    tag = (arch, shape, "moe")
    y, aux = run(tag, moe_fut, a["moe"], a["x"])
    res["moe"] = (np.asarray(y), float(aux), routes_of(tag))
    for name, toks, dec, fut in runs:
        tag = (arch, shape, name, 0)
        logits, cache = run(tag, fut, a["params"], {{"tokens": toks}})
        res[name] = [(np.asarray(logits), jax.device_get(cache), routes_of(tag))]
        pending.append((res[name], tag, dec, cache,
                        lowered(mesh, bundle.make_decode_step(), a["params"], cache,
                                jnp.asarray(dec[:, :1]))))
for case, mesh, moe_ep, bundle, a, fut in local_jobs:
    tag = (case, LOCAL_MESH, "b4", 0)
    logits, cache = run(tag, fut, a["params"], {{"tokens": a["toks"]}})
    res = out.setdefault(case, {{}}).setdefault(LOCAL_MESH, {{}})
    res["b4"] = [(np.asarray(logits), jax.device_get(cache), routes_of(tag))]
    pending.append((res["b4"], tag, a["dec"], cache,
                    lowered(mesh, bundle.make_decode_step(), a["params"], cache,
                            jnp.asarray(a["dec"][:, :1]), moe_ep=moe_ep)))
for steps, tag, dec, cache, fut in pending:
    for t in range(dec.shape[1]):
        tag = tag[:-1] + (t + 1,)
        logits, cache = run(tag, fut, inputs[tag[0]]["params"], cache, jnp.asarray(dec[:, t:t + 1]))
        steps.append((np.asarray(logits), jax.device_get(cache), routes_of(tag)))
with open({base!r} + "/jax.pkl", "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _tree_of(node):
    """A block (nested ``ParamTree``s or dicts) as nested dicts of numpy
    arrays."""
    if isinstance(node, (dict, torch.nn.Module)):
        return {k: _tree_of(v) for k, v in node.items()}
    return _np(node)


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _jax_tree(cfg, model) -> dict:
    """A port model as the JAX package's parameter tree of numpy arrays:
    the prologue blocks, then one stack entry per position of the period,
    its blocks stacked on a leading axis of periods
    (``transformer.layer_plan``; ``lm_params_from_numpy`` reads it back)."""
    n_pro, p, n_periods = T.layer_plan(cfg)
    blocks = [_tree_of(blk) for blk in model.blocks]
    tree = {"embed": _np(model.embed), "final_norm": _np(model.final_norm),
            "prologue": blocks[:n_pro],
            "stack": [_stack(blocks[n_pro + j::p]) for j in range(p)] if n_periods else []}
    if model.head is not None:  # none under tied embeddings
        tree["head"] = _np(model.head)
    return tree


def _inputs() -> dict:
    """Each reduced float32 arch's weights (``init_params`` from seed 0, in
    the JAX package's tree), one MoE layer's (``init_moe``, seed 1), and
    numpy inputs from a seed: the MoE layer's x (B, S, D), the prompt
    tokens (B, S) and the decode tokens (B, 2); each of LOCAL_CASES its
    arch's, or with other experts its own weights and tokens."""
    out = {}
    for n, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        rng = np.random.default_rng(n)
        out[arch] = {
            "params": _jax_tree(cfg, T.init_params(torch.Generator().manual_seed(0), cfg)),
            "moe": _tree_of(L.init_moe(torch.Generator().manual_seed(1), cfg)),
            "x": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            "toks": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "dec": rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32),
        }
    for n, (case, (arch, _, n_experts)) in enumerate(LOCAL_CASES.items()):
        if n_experts is None:
            out[case] = out[arch]
            continue
        cfg, rng = _cfg(arch, n_experts), np.random.default_rng(100 + n)
        out[case] = {
            "params": _jax_tree(cfg, T.init_params(torch.Generator().manual_seed(0), cfg)),
            "toks": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "dec": rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32),
        }
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's outputs by arch and mesh, the port's by mesh as a list of
    ranks, the unsharded port's expert leaves by arch, the tokens of the
    serving run without a mesh)."""
    pytest.importorskip("jax")
    from _subproc import run_forced

    base = tmp_path_factory.mktemp("ep")
    inputs = _inputs()
    with open(base / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    code = _JAX_CODE.format(archs=ARCHS, meshes=MESHES, b1=B1_MESH, local_mesh=LOCAL_MESH,
                            local_cases=LOCAL_CASES, base=str(base))
    jax_err: list = []

    def jax_ref():
        try:
            run_forced(code, 4, timeout=SPAWN_TIMEOUT_S)
        except BaseException as e:  # noqa: BLE001 - raised again in the test's thread
            jax_err.append(e)

    ref = threading.Thread(target=jax_ref)
    ref.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    worlds = {w: _spawn_world(w, base) for w in WORLDS}
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = {_key((1, 1)): [_port_mesh_run((1, 1), inputs)]}
        serve11 = serve(_cfg("jamba-v0.1-52b"), device="cpu", **SERVE)["outputs"]
        unsharded = {arch: [{n: _np(blk["moe"][n]) for n in EXPERT_LEAVES} for blk in
                            T.init_params(torch.Generator().manual_seed(0), _cfg(arch)).blocks
                            if "moe" in blk] for arch in ARCHS}
    finally:
        torch.set_num_threads(before)
        for w, procs in worlds.items():
            _join(procs, deadline, f"gloo world {w}")
        ref.join(max(deadline - time.monotonic(), 1))
    assert not ref.is_alive(), "the JAX reference did not finish"
    if jax_err:
        raise jax_err[0]
    for w, shapes in WORLDS.items():
        ranks = []
        for r in range(w):
            with open(base / f"port_w{w}_r{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        for shape in shapes:
            port[_key(shape)] = [rk[_key(shape)] for rk in ranks]
    with open(base / "jax.pkl", "rb") as f:
        jax_out = pickle.load(f)
    return jax_out, port, unsharded, serve11


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    gap, scale = np.abs(got - want).max(), np.abs(want).max()
    assert gap <= rel * scale, (what, gap, scale)


def _model_cut(cfg, name: str, a: np.ndarray, model) -> np.ndarray:
    """A layer's cache leaf as the rank at ``model`` = (n, j) of a
    tensor-parallel mesh holds it: a GQA ``k``/``v`` its kv heads, Mamba's
    ``conv`` and ``ssm`` its d_inner block (``launch.sharding.model_block``
    of ``wk`` and ``conv_w``); the rest whole."""
    if model is None or name not in ("k", "v", "conv", "ssm") or (name in ("k", "v")
                                                                   and cfg.attn_type == "mla"):
        return a
    mesh = _StubMesh(1, *model)
    if name in ("k", "v"):
        hd = cfg.head_dim_
        block = model_block("blocks/0/mixer/wk", (cfg.d_model, cfg.n_kv_heads * hd), mesh, cfg)
        return a if block is None else a[:, :, block[1][0].start // hd:block[1][0].stop // hd]
    block = model_block("blocks/0/mixer/conv_w", (cfg.d_conv, cfg.d_inner), mesh, cfg)
    if block is None:
        return a
    return a[..., block[1][0]] if name == "conv" else a[:, block[1][0]]


def _jax_cache_layers(cfg, jcache, rows: slice, model=None) -> list:
    """JAX's cache as per-layer dicts in execution order, each batch-led
    leaf cut to ``rows`` (``kv_pos`` has no batch axis) and, for the rank
    at ``model`` = (n, j) of a tensor-parallel mesh, to its kv heads and
    d_inner block (``_model_cut``)."""
    n_pro, p, n_periods = T.layer_plan(cfg)

    def take(name, node, i=None):
        a = np.asarray(node) if i is None else np.asarray(node)[i]
        return a if a.ndim < 2 else _model_cut(cfg, name, a[rows], model)

    layers = [{k: take(k, v) for k, v in c.items()} for c in jcache["prologue"]]
    return layers + [{k: take(k, v, i) for k, v in jcache["stack"][j].items()}
                     for i in range(n_periods) for j in range(p)]


def _assert_routes(got: list, want: list, what: str) -> None:
    """One rank's MoE calls (ids, kept mask) equal to its JAX shard's."""
    assert len(got) == len(want), (what, len(got), len(want))
    for c, ((gi, gk), (wi, wk)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gi, wi, err_msg=f"{what} call {c} routed ids")
        np.testing.assert_array_equal(gk, wk, err_msg=f"{what} call {c} kept mask")


def _assert_steps(cfg, got: list, want: list, coords, rows, what: str, n_mp: int) -> None:
    """Logits, the rank's cache (its rows, and on a ``model`` axis of
    ``n_mp`` > 1 its kv heads and d_inner block: the model is
    tensor-parallel) and its routes against JAX's."""
    assert len(got) == len(want)
    rel = _rel(cfg.name)
    for t, ((logits, cache, routes), (jlogits, jcache, jroutes)) in enumerate(zip(got, want)):
        step = f"{what} step {t}"
        _close(logits, jlogits, rel, f"{step} logits")
        layers = _jax_cache_layers(cfg, jcache, rows, (n_mp, coords[1]))
        assert len(cache["layers"]) == len(layers) and cache["pos"] == int(jcache["pos"])
        for i, (tc, jc) in enumerate(zip(cache["layers"], layers)):
            assert set(tc) == set(jc), (step, i)
            for name in jc:
                _close(tc[name], jc[name], rel, f"{step} layer {i} {name}")
        _assert_routes(routes, jroutes.get(coords, []), step)


@pytest.mark.parametrize("shape", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax_rank_by_rank(runs, arch, shape):
    """The MoE layer: each rank's rows of y within 1e-5 of max of JAX's
    (float32 sums over k and over ``model``), its routes and kept mask
    JAX's shard's, aux JAX's (which returns data shard 0's when there are
    several: the port returns each rank's own)."""
    jax_out, port, _, _ = runs
    jy, jaux, jroutes = jax_out[arch][shape]["moe"]
    assert sorted(jroutes) == sorted(rk["coords"] for rk in port[_key(shape)])
    for rk in port[_key(shape)]:
        y, aux, routes = rk[arch]["moe"]
        rows = slice(*rk[arch]["rows"])
        _close(y, jy[rows], F32_REL, f"{arch} {shape} rank {rk['coords']} y")
        _assert_routes(routes, jroutes[rk["coords"]], f"{arch} {shape} rank {rk['coords']} moe")
        if rk["coords"][0] == 0:
            assert abs(aux - jaux) <= F32_REL * abs(jaux), (arch, shape, aux, jaux)


@pytest.mark.parametrize("shape", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_rank_by_rank(runs, arch, shape):
    """Prefill and two decode steps at batch 4: each rank's gathered logits
    and its cache shard within 1e-5 of max of JAX's (2^-8 for jamba),
    every MoE call's routes and kept mask JAX's shard's; every rank's
    logits bitwise equal."""
    jax_out, port, _, _ = runs
    cfg = _cfg(arch)
    ranks = port[_key(shape)]
    for rk in ranks:
        _assert_steps(cfg, rk[arch]["steps"], jax_out[arch][shape]["b4"], rk["coords"],
                      slice(*rk[arch]["rows"]), f"{arch} {shape} rank {rk['coords']}", shape[1])
        for (logits, _, _), (first, _, _) in zip(rk[arch]["steps"], ranks[0][arch]["steps"]):
            np.testing.assert_array_equal(logits, first)
    n_dp = shape[0]
    want_rows = [(i * B // n_dp, (i + 1) * B // n_dp) for i in range(n_dp)]
    assert sorted({rk[arch]["rows"] for rk in ranks}) == want_rows


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_one_replicates_tokens_on_2x2(runs, arch):
    """A batch of 1 on (2, 2): 1 % 2 != 0, so JAX replicates the tokens over
    the data axis and every rank runs the whole batch; prefill and one
    decode step match JAX's as above, every rank's logits equal."""
    jax_out, port, _, _ = runs
    cfg = _cfg(arch)
    ranks = port[_key(B1_MESH)]
    for rk in ranks:
        _assert_steps(cfg, rk[arch]["b1"], jax_out[arch][B1_MESH]["b1"], rk["coords"],
                      slice(0, 1), f"{arch} b1 rank {rk['coords']}", B1_MESH[1])
        np.testing.assert_array_equal(rk[arch]["b1"][-1][0], ranks[0][arch]["b1"][-1][0])


@pytest.mark.parametrize("case", LOCAL_CASES)
def test_local_moe_under_a_mesh_runs_the_whole_batch_on_2x2(runs, case):
    """Where ``moe_apply`` takes ``moe_apply_local`` under (2, 2) (the
    expert-parallel path off, or a ``model`` axis of 2 over 5 experts), JAX
    counts capacity over the whole global batch, so every rank runs all 4
    rows: prefill and two decode steps match JAX's under the same mesh as
    above, no rank makes an expert-parallel call (JAX none either), and
    every rank's logits are bitwise equal."""
    jax_out, port, _, _ = runs
    arch, moe_ep, n_experts = LOCAL_CASES[case]
    cfg = _cfg(arch, n_experts)
    ranks = port[_key(LOCAL_MESH)]
    want = jax_out[case][LOCAL_MESH]["b4"]
    assert all(not routes for _, _, routes in want)
    for rk in ranks:
        assert rk[case]["rows"] == (0, B)
        _assert_steps(cfg, rk[case]["steps"], want, rk["coords"], slice(0, B),
                      f"{case} rank {rk['coords']}", LOCAL_MESH[1] if moe_ep else 1)
        for (logits, _, _), (first, _, _) in zip(rk[case]["steps"], ranks[0][case]["steps"]):
            np.testing.assert_array_equal(logits, first)


def _dropped(routes_by_coords: dict) -> np.ndarray:
    """A prefill's dropped routes, (MoE calls, B*S*k) in batch order, from
    each rank's (coords -> [(ids, kept mask)] a call): a route is dropped
    where no model rank of its data shard keeps it."""
    by_data: dict = {}
    for (i, _), calls in routes_by_coords.items():
        keeps = np.stack([keep for _, keep in calls])
        by_data[i] = keeps if i not in by_data else by_data[i] | keeps
    return ~np.concatenate([by_data[i] for i in sorted(by_data)], axis=1)


def _port_dropped(port, arch, shape) -> np.ndarray:
    return _dropped({rk["coords"]: rk[arch]["steps"][0][2] for rk in port[_key(shape)]})


def _jax_dropped(jax_out, arch, shape) -> np.ndarray:
    return _dropped(jax_out[arch][shape]["b4"][0][2])


def test_2x2_drops_differ_from_the_unsharded_model_as_jaxs_do(runs):
    """On (2, 2) each data shard counts its experts' capacity over its own 2
    x 16 tokens, so it drops other routes than the unsharded model: the
    port's dropped routes differ from its (1, 1) run's in exactly the
    routes where JAX's (2, 2) differ from JAX's (1, 1), and they differ
    somewhere."""
    jax_out, port, _, _ = runs
    differing = 0
    for arch in ARCHS:
        ours = _port_dropped(port, arch, (2, 2)) ^ _port_dropped(port, arch, (1, 1))
        theirs = _jax_dropped(jax_out, arch, (2, 2)) ^ _jax_dropped(jax_out, arch, (1, 1))
        np.testing.assert_array_equal(ours, theirs, err_msg=arch)
        differing += int(ours.sum())
    assert differing > 0


@pytest.mark.parametrize("shape", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_keeps_each_ranks_experts(runs, arch, shape):
    """Under the mesh ``init_params`` draws as without one and keeps the
    rank's E/n_mp experts of each expert leaf; the model ranks' slices,
    concatenated in order, are bitwise the unsharded init, on every data
    rank (serving holds no ZeRO blocks: ``tests/test_torch_train_mesh.py``
    holds training's; the other leaves' tensor-parallel blocks are
    ``tests/test_torch_tensor_parallel.py``'s)."""
    _, port, unsharded, _ = runs
    ranks = port[_key(shape)]
    n_mp = shape[1]
    for i in range(shape[0]):
        row = sorted((rk for rk in ranks if rk["coords"][0] == i), key=lambda rk: rk["coords"][1])
        assert len(row) == n_mp
        for layer, whole in enumerate(unsharded[arch]):
            for name in EXPERT_LEAVES:
                parts = [rk[arch]["init"][layer][name] for rk in row]
                assert all(p.shape[0] == whole[name].shape[0] // n_mp for p in parts)
                np.testing.assert_array_equal(np.concatenate(parts), whole[name])


def test_serve_on_1x2_gives_every_rank_the_unsharded_tokens(runs):
    """``serve`` inside the mesh context on (1, 2) (reduced float32 jamba,
    continuous batching with a backfill): both ranks produce the tokens of
    the run without a mesh."""
    _, port, _, serve11 = runs
    outs = [rk["serve"] for rk in port[_key((1, 2))]]
    assert outs[0] == outs[1] == serve11 and len(serve11) == SERVE["requests"]


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh11():
    mesh = make_rank_mesh((1, 1), device="cpu")
    yield mesh
    mesh.close()
    assert not dist.is_initialized()


def test_seq_parallel_raises_and_the_context_is_restored(mesh11):
    """``seq_parallel=True`` (JAX's layout hint, which changes no value)
    opens the context like any other and leaves none behind; a context
    comes back after an exception and after a nested one."""
    cfg = _cfg("deepseek-moe-16b")
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 4, cfg.d_model), generator=torch.Generator().manual_seed(1))
    with ctx.mesh_context(mesh11):
        want = L.moe_apply(p, x, cfg)
    with ctx.mesh_context(mesh11, seq_parallel=True):
        assert ctx.get_mesh() is mesh11 and ctx.expert_parallel(cfg.n_experts)
        got = L.moe_apply(p, x, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ctx.get_mesh() is None
    with pytest.raises(RuntimeError, match="inside"):
        with ctx.mesh_context(mesh11, moe_ep=True):
            assert ctx.get_mesh() is mesh11 and ctx.moe_ep_enabled()
            assert ctx.dp_axes() == ("data",) and ctx.expert_parallel(4)
            with ctx.mesh_context(mesh11, moe_ep=False):
                assert not ctx.moe_ep_enabled() and ctx.get_mesh() is mesh11
            assert ctx.moe_ep_enabled()
            raise RuntimeError("inside")
    assert ctx.get_mesh() is None and not ctx.moe_ep_enabled()
    assert not ctx.expert_parallel(4) and ctx.dp_axes() == ("data",)
    with pytest.raises(ValueError, match="data axes"):
        with ctx.mesh_context(mesh11, dp_axes=("pod", "data")):
            pass
    assert ctx.get_mesh() is None


class _StubMesh:
    """A mesh of shape and coordinates alone (no process group)."""

    def __init__(self, data, model, j=0):
        self.shape = {"data": data, "model": model}
        self.coords = {"data": 0, "model": j}

    def group(self, axes):
        return None


def test_moe_apply_falls_back_to_local_where_model_does_not_divide_experts():
    """JAX's dispatch: a ``model`` axis of 3 over 4 experts takes
    ``moe_apply_local`` (bitwise), and ``init_moe`` keeps every expert."""
    cfg = _cfg("deepseek-moe-16b")
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want, _ = L.moe_apply_local(p, x, cfg)
    with ctx.mesh_context(_StubMesh(1, 3)):
        got, _ = L.moe_apply(p, x, cfg)
        assert L.init_moe(torch.Generator().manual_seed(0), cfg)["wg"].shape[0] == 4
    assert torch.equal(got, want)


@pytest.mark.parametrize("j", [0, 1])
def test_lm_params_from_numpy_keeps_the_ranks_experts(j):
    """``lm_params_from_numpy(mesh=)``: rank j of a ``model`` axis of 2
    holds experts [2j, 2j + 2) of every MoE layer's wg, wu and wd, bitwise
    the numpy tree's; every other leaf its tensor-parallel
    ``model_block`` (whole where the rule keeps it whole)."""
    cfg = _cfg("jamba-v0.1-52b")
    model = T.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = _StubMesh(1, 2, j)
    sharded = lm_params_from_numpy(cfg, _jax_tree(cfg, model), device="cpu", mesh=mesh)
    want = dict(model.named_parameters())
    for name, value in sharded.named_parameters():
        w = want.pop(name)
        if ".moe." in name and name.rsplit(".", 1)[1] in EXPERT_LEAVES:
            w = w[2 * j:2 * j + 2]
        else:
            block = model_block(name.replace(".", "/"), tuple(w.shape), mesh, cfg)
            w = w if block is None else cut(w, block)
        assert torch.equal(value, w), name
    assert not want and sum(".moe.w" in n for n, _ in sharded.named_parameters()) == 12


def test_make_production_mesh_names_the_world_it_needs():
    with pytest.raises(ValueError, match="world of 256"):
        make_production_mesh()
    with pytest.raises(ValueError, match="world of 512"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_rank_mesh((2, 2), device="cpu")


def test_rank_mesh_coordinates_and_index(mesh11):
    """Row-major coordinates (``jax.make_mesh``'s device order) and the
    index over a set of axes, on a world of 1."""
    assert isinstance(mesh11, RankMesh) and mesh11.shape == {"data": 1, "model": 1}
    assert mesh11.coords == {"data": 0, "model": 0} and mesh11.index(("data",)) == 0
    buf = torch.ones(3)
    mesh11.all_reduce(buf)
    assert torch.equal(buf, torch.ones(3))
    assert torch.equal(mesh11.all_gather(buf, "data"), buf)
    from repro_torch.launch.mesh import _digits

    assert [_digits(r, (2, 16, 16)) for r in (0, 17, 300)] == [[0, 0, 0], [0, 1, 1], [1, 2, 12]]


def test_gradients_under_the_expert_parallel_moe_raise(mesh11):
    """The expert-parallel MoE trains: on (1, 1) ``moe_apply_ep``'s output,
    aux and the gradients of x, the router, the experts and the shared
    experts (through ``mesh.psum`` and ``mesh.replicated``) are
    ``moe_apply_local``'s; on more ranks
    ``tests/test_torch_train_mesh.py`` holds them to JAX's."""
    cfg = _cfg("deepseek-moe-16b")
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    leaves = {"router": p["router"], "wg": p["wg"], "wd": p["wd"],
              "shared/wu": p["shared"]["wu"]}
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    out = []
    for under_mesh in (False, True):
        xg = x.clone().requires_grad_(True)
        for w in leaves.values():
            w.requires_grad_(True)
        with ctx.mesh_context(mesh11) if under_mesh else contextlib.nullcontext():
            y, aux = L.moe_apply(p, xg, cfg)
            g = torch.autograd.grad(torch.sum(y * dy) + aux, [xg, *leaves.values()])
        out.append((y.detach(), aux.detach(), g))
    (y0, a0, g0), (y1, a1, g1) = out
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    for name, a, b in zip(["x", *leaves], g0, g1):
        assert (a - b).abs().max() <= F32_REL * a.abs().max(), name
