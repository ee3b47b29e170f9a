"""Training under a (data, model) mesh of ranks — each leaf's 2-D block
(``launch/zero.py``: the tensor-parallel ``model_block`` and of that the
ZeRO block over the data axes), tensor parallelism's collectives under
autograd (``launch/tp.py``), the expert-parallel MoE's backward
(``models.layers.moe_apply_ep``), the global-batch train step
(``models.transformer.lm_objective``, ``models.whisper.whisper_objective``)
and ``launch/train.py --mesh`` — against the JAX package's sharded train
step, on the CPU.

The reference: one ``tests/_subproc.run_forced(code, 4)`` call jits the JAX
step (``value_and_grad`` of its ``lm_loss`` or ``whisper_loss``, the CLI's
optimizer, ``apply_updates``) with ``in_shardings`` from
``launch.sharding.tree_pspecs`` and ``batch_spec`` under
``launch.context.mesh_context``, on meshes built with Auto axes (as
``tests/test_torch_expert_parallel.py`` builds them), for the reduced
float32 granite-3-8b, deepseek-moe-16b and falcon-mamba-7b on (2, 2) and
(4, 1), deepseek-moe on (1, 4), granite on (1, 2), (1, 4) and on (2, 2)
under ``seq_parallel=True``, jamba-v0.1-52b and deepseek-v2-lite-16b (MLA)
on (1, 2) and (2, 2), jamba on (1, 2) and deepseek-v2-lite on (2, 2) under
``seq_parallel=True`` too, and whisper-tiny on (2, 1) and (2, 2); 3 steps each,
on batches of 4 x 32 (whisper: 4 x 32 tokens over 4 x 64 frames) whose
labels hold -1 in unequal counts across every data split (5, 0, 11 and 2 a
row). For deepseek-moe and moonshot-v1-16b-a3b (a dense first layer, shared
experts) it also runs the step unsharded and, on (2, 2) and (4, 1), the
unsharded model's NLL and aux gradients on each data shard's rows.

The port: one gloo world of 4 processes and one of 2 over ``FileStore``s
(each world's meshes in turn), spawned while JAX runs; each rank takes the
same weights through ``lm_params_from_numpy(..., mesh=, zero=True)`` (or
``whisper_params_from_numpy``) and trains under ``mesh_context``. On a
``model`` axis over 1 a decoder's non-expert leaves are tensor-parallel.
Asserted, rank by rank:

- every step's loss within 1e-5 of JAX's sharded step, every rank's equal
  (the sequence-parallel cases against JAX's step under
  ``seq_parallel=True``, which computes the values without it);
  the gradients (gathered) and the parameters after 3 steps within
  ``tests/_torch_train.py``'s contract (1e-5 of max, 2^-8 behind a scan);
- each rank's blocks of the parameters, gradients and both AdamW moments
  are its 2-D slices of the gathered trees (``model_block``, then
  ``param_spec``'s data entry within it, and ``expert_block``), and hold
  1 / (n_dp n_mp) of every leaf ``param_spec`` splits over both axes,
  nothing more, but for the leaves kept whole over ``model`` (the norms,
  the router, MLA's ``wdkv``/``wkr``, a kv head shared by ranks, every
  whisper leaf), which hold 1 / n_dp of it where it has a data entry;
  ``init_params`` (``init_whisper``) under the mesh keeps bitwise the
  unsharded init's blocks;
- the leaves whole over ``model`` (their parameters, gradients and
  moments) are bitwise equal across the ``model`` ranks of a data shard;
- under ``seq_parallel`` every block's input on a rank is (B_loc, S/n, D),
  its rows and its 1/n of the sequence; without it, (B_loc, S, D); where
  JAX does not apply it (a prefill, whisper, a sequence the ``model`` axis
  does not divide, on (1, 2)) the flag changes no bit;
- ``global_norm`` of the rank's blocks, under the mesh, equals every rank's
  and the unsharded norm of the gathered gradient within 1e-6;
- the aux rule (ROADMAP.md queue 3): JAX's sharded gradient is
  (1/n_dp) sum_d grad(NLL_d + 0.01 aux_d) of the unsharded model on each
  shard's rows, the NLL over the global count, and not the unsharded
  gradient nor the auxes' sum; its loss is the global NLL mean plus 0.01
  times data shard 0's aux;
- under a ``model`` axis, training an MoE whose leaves hold every expert
  raises;
- ``launch/mesh.py``'s five collectives under autograd (``gather_blocks``,
  ``psum``, ``replicated``, ``scatter_sum``, ``split``) and
  ``launch/tp.py``'s (``row``, ``enter``, ``gather`` and the
  sequence-parallel ``sp_gather`` both ways, ``sp_row``, ``sp_split``),
  outputs and gradients exactly, on a (2, 2) mesh of the world;
- ZeRO blocks are cut over the open ``mesh_context``'s data axes alone
  (a pod axis left out of them keeps whole copies), by ``init_params`` and
  ``lm_params_from_numpy`` alike, and only when asked for (``zero``);
- ``launch/train.py --mesh 2,1`` and ``--mesh 1,2`` as two gloo processes:
  the losses and the checkpoint (one file, written by rank 0) equal the
  unsharded CLI's within the bf16 contract;
- the cross-silo round over the mesh (``fl.cross_silo
  .make_mesh_fl_round_step``: a silo a data index, Eq. 1 through
  masked_aggregate's partial and combine modes and one all-reduce), two
  rounds of the reduced granite on (2, 1) in the world of 2, bitwise the
  single-process ``make_fl_round_step`` on the same inputs (run in rank 0
  after the mesh round).

The spawned ranks import this module, which imports no jax at top level.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.launch import context as ctx
from repro_torch.launch import zero
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.launch.sharding import data_block, expert_block, model_block, param_spec
from repro_torch.launch.tp import cut
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model, param_tree
from repro_torch.weights import EXPERT_LEAVES, lm_params_from_numpy, whisper_params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]

ARCHS = ("granite-3-8b", "deepseek-moe-16b", "falcon-mamba-7b")
TP_ARCHS = ("jamba-v0.1-52b", "deepseek-v2-lite-16b")
# case -> (arch, mesh, seq_parallel)
CASES = {**{f"{arch} {d}x{m}": (arch, (d, m), False) for arch in ARCHS for d, m in ((2, 2), (4, 1))},
         "deepseek-moe-16b 1x4": ("deepseek-moe-16b", (1, 4), False),
         "granite-3-8b 2x2 seq_parallel": ("granite-3-8b", (2, 2), True),
         "jamba-v0.1-52b 1x2 seq_parallel": ("jamba-v0.1-52b", (1, 2), True),
         "deepseek-v2-lite-16b 2x2 seq_parallel": ("deepseek-v2-lite-16b", (2, 2), True),
         **{f"granite-3-8b 1x{m}": ("granite-3-8b", (1, m), False) for m in (2, 4)},
         **{f"{arch} {d}x2": (arch, (d, 2), False) for arch in TP_ARCHS for d in (1, 2)},
         **{f"whisper-tiny 2x{m}": ("whisper-tiny", (2, m), False) for m in (1, 2)}}
WORLDS = (4, 2)  # the gloo worlds, each running the cases of its size
# leaves a model built for training keeps whole over ``model`` (a decoder's;
# a kv head shared by ranks too, and every whisper leaf)
WHOLE_LEAVES = ("norm1", "norm2", "final_norm", "router", "wdkv", "wkr")
# the aux rule, in JAX alone
RULE, RULE_MESHES = ("deepseek-moe-16b", "moonshot-v1-16b-a3b"), ((2, 2), (4, 1))
B, S, STEPS, LR = 4, 32, 3, 3e-4
MASKED = (5, 0, 11, 2)  # labels -1 at the head of each row: unequal counts in every data split
F32_REL, SCAN_REL, BF16_REL = 1e-5, 2.0 ** -8, 2.0 ** -5  # tests/_torch_train.py's
BF16_ULP = 2.0 ** -7  # a bf16 value's spacing is at most this share of it
STEP_ABS, NEAR_ZERO, SCAN_SHARE = 1e-6, 1e-4, 1e-4
NORM_REL = 1e-6
RULE_GAP = 1e-2  # the unsharded gradient and the summed auxes miss JAX's by more than this
SPAWN_TIMEOUT_S = 600
FRAMES = 64  # whisper's frames a row (the reduced encoder_seq)
SILO_WEIGHTS, SILO_ROUNDS, SILO_SHARED = (3.0, 1.0), 2, 1  # the cross-silo case on (2, 1)


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _tied_cfg():
    """granite-3-8b with tied embeddings: trained on (1, 2) against itself
    without a mesh (no JAX compile beside it)."""
    return dataclasses.replace(_cfg("granite-3-8b"), tie_embeddings=True)


def _np(t):
    return t.detach().numpy().copy() if isinstance(t, torch.Tensor) else t


def _optimizer():
    """The JAX CLI's optimizer for a run of STEPS steps (``launch.train``'s)."""
    return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(
        optim.cosine_schedule(LR, warmup_steps=2, total_steps=STEPS)))


# ---------------------------------------------------------------------------
# the port, one rank of the gloo world
# ---------------------------------------------------------------------------


def _recording(opt, into: list):
    """``opt`` whose in-place step first records the gradients it gets (this
    rank's blocks, summed over the data ranks) and their ``global_norm``."""
    def apply_(grads, state, params):
        into.append(({k: g.clone() for k, g in grads.items()}, float(optim.global_norm(grads))))
        return opt.apply_(grads, state, params)

    return optim.Optimizer(opt.init, opt.update, apply_)


def _port_case(arch, shape, seq_parallel, inputs, cfg=None, key=None) -> dict:
    """3 steps of ``arch`` (config ``cfg``, default the reduced float32 one;
    its inputs ``inputs[key]``, default ``arch``'s) under ``shape`` on this
    rank: its losses, its blocks of the gradients (each step), the
    parameters and both moments (after the steps), the recorded norms, and
    on rank 0 the gathered trees."""
    cfg, a = cfg or _cfg(arch), inputs[key or arch]
    carry = whisper_params_from_numpy if cfg.encoder_decoder else lm_params_from_numpy
    mesh = make_rank_mesh(shape, device="cpu")
    apply_block, block_inputs = T.apply_block, []

    def recording_block(p, x, *args, **kwargs):  # every block input, the recompute's too
        block_inputs.append(tuple(x.shape))
        return apply_block(p, x, *args, **kwargs)

    T.apply_block = recording_block
    try:
        with ctx.mesh_context(mesh, seq_parallel=seq_parallel):
            init = {k: _np(p) for k, p in param_tree(
                get_model(cfg).init(torch.Generator().manual_seed(0), zero=True)).items()}
            model = carry(cfg, a["params"], device="cpu", mesh=mesh, zero=True)
            seen: list = []
            opt = _recording(_optimizer(), seen)
            state = opt.init(param_tree(model))
            step = get_model(cfg).make_train_step(opt)
            losses = []
            for batch in a["batches"]:
                model, state, loss = step(model, state, {k: torch.from_numpy(v)
                                                         for k, v in batch.items()})
                losses.append(float(loss))
            params = param_tree(model)
            moments = {"mu": state[1].mu, "nu": state[1].nu}

            def gathered(blocks):
                return {k: _np(zero.whole(params[k], mesh, blocks[k])) for k in params}

            rows = ctx.local_batch(cfg, B)
            out = {"coords": (mesh.coords["data"], mesh.coords["model"]), "losses": losses,
                   "block_inputs": sorted(set(block_inputs)),
                   "local_stream": (rows, S // shape[1] if seq_parallel else S, cfg.d_model),
                   "norms": [n for _, n in seen],
                   "grads": [{k: _np(g) for k, g in grads.items()} for grads, _ in seen],
                   "params": {k: _np(p) for k, p in params.items()},
                   **{m: {k: _np(t) for k, t in tree.items()} for m, tree in moments.items()},
                   "split": {k: zero.split_axes(p) for k, p in params.items()}, "init": init}
            whole = {"grads": [gathered(grads) for grads, _ in seen], "params": gathered(params),
                     **{m: gathered(tree) for m, tree in moments.items()}}
            if mesh.rank == 0:
                out["whole"] = whole
    finally:
        T.apply_block = apply_block
        mesh.close()
    return out


def _collective_inputs(rank: int):
    """Rank ``rank``'s input and the weights of the loss of each collective
    of ``_collectives``; ``tp_row``'s matrix (``sp_row`` takes its first
    two columns twice); the TP weights of ``tp_row`` and ``tp_gather`` are
    the same on the two model ranks of a data index, as a loss downstream
    of them is. The sequence-parallel ones work on dim 1, two columns of
    the input a model rank."""
    t = torch.arange(8.0).reshape(2, 4) + 10 * rank
    i = rank // 2
    return t, {"gather": torch.arange(16.0).reshape(2, 8) + rank,
               "psum": torch.full((2, 4), rank + 1.0), "replicated": torch.full((2, 4), rank + 1.0),
               "scatter_sum": torch.arange(4.0).reshape(2, 2) + rank,
               "split": torch.arange(4.0).reshape(2, 2) * (rank + 1),
               "tp_row": torch.arange(6.0).reshape(2, 3) + i,
               "tp_enter": torch.full((2, 4), rank + 1.0),
               "tp_gather": torch.arange(16.0).reshape(2, 8) + 3 * i,
               "sp_gather_shares": torch.arange(16.0).reshape(2, 8) - rank,
               "sp_gather": torch.arange(16.0).reshape(2, 8) + 2 * i,
               "sp_row": torch.arange(4.0).reshape(2, 2) + rank,
               "sp_split": torch.arange(4.0).reshape(2, 2) - rank}, (
        torch.arange(12.0).reshape(4, 3) - rank)


def _sp_matrix(m: torch.Tensor) -> torch.Tensor:
    """``sp_row``'s (4, 4) matrix of a (4, 3) ``tp_row`` one."""
    return torch.cat([m[:, :2], m[:, :2]], dim=1)


def _collectives() -> dict:
    """On a (2, 2) mesh: each of ``launch/mesh.py``'s five collectives under
    autograd and ``launch/tp.py``'s (under the mesh context) applied to
    this rank's ``_collective_inputs``, the output and the gradient of the
    output's sum weighted by that collective's weights."""
    from repro_torch.launch import tp
    from repro_torch.launch.mesh import gather_blocks, psum, replicated, scatter_sum, split

    mesh = make_rank_mesh((2, 2), device="cpu")
    try:
        t, weights, w = _collective_inputs(mesh.rank)
        fns = {"gather": lambda x: gather_blocks(mesh, x, ("data",), 1),
               "psum": lambda x: psum(mesh, x, "model"),
               "replicated": lambda x: replicated(mesh, x, "model"),
               "scatter_sum": lambda x: scatter_sum(mesh, x, "model", 1),
               "split": lambda x: split(mesh, x, "model", 1),
               "tp_row": lambda x: tp.row(x, w), "tp_enter": tp.enter, "tp_gather": tp.gather,
               "sp_gather_shares": lambda x: tp.sp_gather(x, shares=True),
               "sp_gather": lambda x: tp.sp_gather(x, shares=False),
               "sp_row": lambda x: tp.sp_row(x, _sp_matrix(w)), "sp_split": tp.sp_split}
        out = {}
        with ctx.mesh_context(mesh):
            for name, fn in fns.items():
                x = t.clone().requires_grad_(True)
                y = fn(x)
                (g,) = torch.autograd.grad(torch.sum(y * weights[name]), [x])
                out[name] = (_np(y), _np(g))
    finally:
        mesh.close()
    return out


def _unchanged_case(inputs) -> dict:
    """On (1, 2), with ``seq_parallel`` off and on: one train step of the
    reduced granite on S - 1 tokens (the ``model`` axis does not divide
    them) and of whisper, and granite's prefill logits on S tokens; this
    rank's loss, updated parameters and logits of each."""
    out = {}
    mesh = make_rank_mesh((1, 2), device="cpu")
    try:
        for sp in (False, True):
            runs = {}
            with ctx.mesh_context(mesh, seq_parallel=sp):
                for arch, cut in (("granite-3-8b", S - 1), ("whisper-tiny", S)):
                    cfg, a = _cfg(arch), inputs[arch]
                    carry = whisper_params_from_numpy if cfg.encoder_decoder else lm_params_from_numpy
                    model = carry(cfg, a["params"], device="cpu", mesh=mesh, zero=True)
                    opt = _optimizer()
                    state = opt.init(param_tree(model))
                    batch = {k: torch.from_numpy(v[:, :cut] if k != "frames" else v)
                             for k, v in a["batches"][0].items()}
                    model, state, loss = get_model(cfg).make_train_step(opt)(model, state, batch)
                    runs[arch] = (float(loss), {k: _np(p) for k, p in param_tree(model).items()})
                cfg = _cfg("granite-3-8b")
                model = lm_params_from_numpy(cfg, inputs["granite-3-8b"]["params"], device="cpu",
                                             mesh=mesh)
                tokens = torch.from_numpy(inputs["granite-3-8b"]["batches"][0]["tokens"])
                runs["prefill"] = _np(T.forward(model, cfg, tokens, mode="prefill")[0])
            out[sp] = runs
    finally:
        mesh.close()
    return out


def _cross_silo_case(inputs) -> dict:
    """``SILO_ROUNDS`` rounds of the cross-silo round of the reduced float32
    granite over a (2, 1) mesh (``make_mesh_fl_round_step``; silo i = data
    index i on rows [2i, 2i + 2) of each batch, weights ``SILO_WEIGHTS``,
    the first ``SILO_SHARED`` period shared, AdamW): this rank's losses and
    parameters; on rank 0 also the single-process round's on the same
    inputs (``make_fl_round_step`` over both silos, one torch thread)."""
    from repro_torch.fl import cross_silo as xs

    cfg, a = _cfg("granite-3-8b"), inputs["granite-3-8b"]
    bundle, opt = get_model(cfg), optim.adamw(LR)
    weights = torch.tensor(SILO_WEIGHTS)
    batches = a["batches"][:SILO_ROUNDS]
    mesh = make_rank_mesh((2, 1), device="cpu")
    try:
        with xs.silo_context(mesh):
            model = lm_params_from_numpy(cfg, a["params"], device="cpu", mesh=mesh)
        state = opt.init(param_tree(model))
        step = xs.make_mesh_fl_round_step(cfg, bundle, opt, SILO_SHARED, mesh)
        i, losses = mesh.index("data"), []
        for batch in batches:
            rows = {k: torch.from_numpy(v[2 * i:2 * i + 2]) for k, v in batch.items()}
            model, state, loss = step(model, state, rows, weights)
            losses.append(float(loss))
        out = {"silo": i, "losses": losses,
               "params": {k: _np(p) for k, p in param_tree(model).items()}}
    finally:
        mesh.close()
    if mesh.rank == 0:
        silo = xs.silo_params_from_model(lm_params_from_numpy(cfg, a["params"], device="cpu"), 2)
        states = xs.init_silo_opt(opt, silo)
        step = xs.make_fl_round_step(cfg, bundle, opt, SILO_SHARED, agg="fp32")
        single = []
        for batch in batches:
            stacked = {k: torch.from_numpy(v).reshape(2, 2, *v.shape[1:]) for k, v in batch.items()}
            silo, states, loss = step(silo, states, stacked, weights)
            single.append(float(loss))
        out["single"] = {"losses": single, "params": [
            {k: _np(p) for k, p in param_tree(m).items()} for m in silo.models]}
    return out


def _rank_main(rank: str, world: str, store_dir: str, base: str) -> None:
    """One spawned rank: join the gloo world of ``world`` ranks, run every
    case whose mesh has that many (and, in the world of 4, the
    collectives), save."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(os.path.join(base, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(store_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        out = {case: _port_case(*spec, inputs) for case, spec in CASES.items()
               if spec[1][0] * spec[1][1] == world}
        if world == 4:
            out["collectives"] = _collectives()
        if world == 2:
            out["tied 1x2"] = _port_case("granite-3-8b", (1, 2), False, inputs, _tied_cfg(),
                                         "tied")
            out["cross_silo 2x1"] = _cross_silo_case(inputs)
            out["unchanged 1x2"] = _unchanged_case(inputs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(base, f"port_w{world}_r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


_RANK_SCRIPT = (
    "import sys; sys.path[:0] = [{src!r}, {tests!r}]; import test_torch_train_mesh as m; "
    "m._rank_main(*sys.argv[1:])"
)


def _spawn(argv_of, n: int, env_of=None, cwd=None) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(argv_of(r), env={**env, **(env_of(r) if env_of else {})}, cwd=cwd,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def _join(procs: list, deadline: float, what: str) -> list:
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
    return logs


# ---------------------------------------------------------------------------
# the JAX reference, in one subprocess with 4 forced host devices
# ---------------------------------------------------------------------------

_JAX_CODE = """
import dataclasses, math, pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

from repro import optim
from repro.configs import get_config
from repro.launch import context as ctx
from repro.launch.sharding import batch_spec, tree_shardings
from repro.models.api import get_model
from repro.models.transformer import forward

CASES, RULE, RULE_MESHES, STEPS, LR = {cases!r}, {rule!r}, {rule_meshes!r}, {steps!r}, {lr!r}
with open({base!r} + "/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
pool = ThreadPoolExecutor(8)


def cfg_of(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:math.prod(shape)])


def opt_of():
    return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(
        optim.cosine_schedule(LR, warmup_steps=2, total_steps=STEPS)))


def step_of(cfg, opt):
    loss_fn = get_model(cfg).loss_fn

    def step(params, state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, state = opt.update(grads, state, params)
        return optim.apply_updates(params, updates), state, loss, grads

    return step


def start(arch, shape, seq_parallel=False):
    # the step lowered on this thread (under the mesh context), compiled in the pool
    cfg, a, opt = cfg_of(arch), inputs[arch], opt_of()
    params = jax.tree.map(jnp.asarray, a["params"])
    state = opt.init(params)
    step = step_of(cfg, opt)
    if shape is None:
        return params, state, pool.submit(jax.jit(step).lower(params, state, a["batches"][0]).compile)
    mesh = mesh_of(shape)
    with ctx.mesh_context(mesh, seq_parallel=seq_parallel):
        psh, ssh = tree_shardings(params, mesh, ("data",)), tree_shardings(state, mesh, ("data",))
        bsh = {{k: NamedSharding(mesh, batch_spec(k, v.shape, mesh, ("data",)))
               for k, v in a["batches"][0].items()}}
        fn = jax.jit(step, in_shardings=(psh, ssh, bsh),
                     out_shardings=(psh, ssh, NamedSharding(mesh, P()), psh))
        params, state = jax.device_put(params, psh), jax.device_put(state, ssh)
        return params, state, pool.submit(fn.lower(params, state, a["batches"][0]).compile)


def finish(arch, job, steps=STEPS):
    params, state, fut = job
    fn = fut.result()
    losses, grads = [], []
    for batch in inputs[arch]["batches"][:steps]:
        params, state, loss, g = fn(params, state, batch)
        losses.append(float(loss))
        grads.append(jax.device_get(g))
    return {{"losses": losses, "grads": grads, "params": jax.device_get(params),
            "nu": jax.device_get(state[1].nu)}}


def shard_terms_of(cfg):
    # the unsharded model on one data shard's rows: its NLL sum over the
    # global count of labels, its aux, and the gradient of each
    def terms(params, tokens, labels, count):
        logits, _, aux = forward(params, cfg, tokens, mode="train")
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.maximum(labels, 0)[..., None], axis=-1)[..., 0]
        return jnp.sum(nll * (labels >= 0)) / count, aux

    def both(params, tokens, labels, count):
        (nll, aux), vjp = jax.vjp(lambda p: terms(p, tokens, labels, count), params)
        one = jnp.ones((), jnp.float32)
        return nll, aux, vjp((one, 0 * one))[0], vjp((0 * one, one))[0]

    return jax.jit(both)


jobs = {{case: start(arch, shape, sp) for case, (arch, shape, sp) in CASES.items()}}
plain = {{arch: start(arch, None) for arch in RULE}}
rule_jobs = {{(arch, shape): start(arch, shape) for arch in RULE for shape in RULE_MESHES
             if (arch, shape, False) not in CASES.values()}}
out = {{"cases": {{case: finish(CASES[case][0], job) for case, job in jobs.items()}},
       "plain": {{arch: finish(arch, job) for arch, job in plain.items()}}, "rule": {{}}}}
for arch in RULE:
    cfg, a = cfg_of(arch), inputs[arch]
    terms = shard_terms_of(cfg)
    params = jax.tree.map(jnp.asarray, a["params"])
    batch = a["batches"][0]
    count = np.float32(max((batch["labels"] >= 0).sum(), 1))
    for shape in RULE_MESHES:
        n_dp = shape[0]
        case = next((c for c, spec in CASES.items() if spec == (arch, shape, False)), None)
        sharded = out["cases"][case] if case else finish(arch, rule_jobs[(arch, shape)], 1)
        rows = [slice(i * len(batch["tokens"]) // n_dp, (i + 1) * len(batch["tokens"]) // n_dp)
                for i in range(n_dp)]
        shards = [terms(params, batch["tokens"][r], batch["labels"][r], count) for r in rows]
        add = lambda trees: jax.tree.map(lambda *x: sum(x[1:], x[0]), *trees)
        g_nll, g_aux = add([s[2] for s in shards]), add([s[3] for s in shards])
        out["rule"][(arch, shape)] = {{
            "loss": sharded["losses"][0], "grads": sharded["grads"][0],
            "plain": out["plain"][arch]["grads"][0],
            "mean": jax.device_get(jax.tree.map(lambda n, x: n + 0.01 / n_dp * x, g_nll, g_aux)),
            "sum": jax.device_get(jax.tree.map(lambda n, x: n + 0.01 * x, g_nll, g_aux)),
            "nll": float(sum(s[0] for s in shards)), "aux0": float(shards[0][1])}}
with open({base!r} + "/jax.pkl", "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def _jax_tree(cfg, model) -> dict:
    """A port model as the JAX package's parameter tree of numpy arrays
    (``tests/test_torch_expert_parallel.py``'s)."""
    from test_torch_expert_parallel import _jax_tree as tree_of

    return tree_of(cfg, model)


def _jax_whisper_tree(model) -> dict:
    """A port whisper model as the JAX package's parameter tree of numpy
    arrays (the same names; the layers a list)."""
    from test_torch_expert_parallel import _tree_of

    tree = {k: _np(v) for k, v in model.named_parameters(recurse=False)}
    return tree | {k: [_tree_of(lyr) for lyr in v] for k, v in model.named_children()}


def _inputs() -> dict:
    """Each arch's weights (its init from seed 0, float32, in the JAX
    package's tree) and STEPS batches of B x S numpy tokens and labels (and
    for whisper B x FRAMES x d frames), the labels -1 at the head of row r
    for MASKED[r] places."""
    out = {}
    archs = dict.fromkeys([*ARCHS, *RULE, *(c[0] for c in CASES.values())])
    for n, (arch, cfg) in enumerate([*((a, _cfg(a)) for a in archs), ("tied", _tied_cfg())]):
        rng = np.random.default_rng(10 + n)
        batches = []
        for _ in range(STEPS):
            labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for r, k in enumerate(MASKED):
                labels[r, :k] = -1
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                     "labels": labels}
            if cfg.encoder_decoder:
                batch = {"frames": rng.standard_normal((B, FRAMES, cfg.d_model)).astype(
                    np.float32), **batch}
            batches.append(batch)
        model = get_model(cfg).init(torch.Generator().manual_seed(0))
        out[arch] = {"params": _jax_whisper_tree(model) if cfg.encoder_decoder
                     else _jax_tree(cfg, model), "batches": batches}
    return out


def _tied_unsharded(inputs) -> dict:
    """The tied granite's 3 steps without a mesh, one torch thread: losses,
    each step's gradients, the parameters and AdamW's nu after them."""
    cfg, a = _tied_cfg(), inputs["tied"]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = lm_params_from_numpy(cfg, a["params"], device="cpu")
        seen: list = []
        opt = _recording(_optimizer(), seen)
        state = opt.init(param_tree(model))
        step = get_model(cfg).make_train_step(opt)
        losses = []
        for batch in a["batches"]:
            model, state, loss = step(model, state, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()})
            losses.append(float(loss))
    finally:
        torch.set_num_threads(before)
    return {"losses": losses, "grads": [{k: _np(g) for k, g in grads.items()} for grads, _ in seen],
            "params": {k: _np(p) for k, p in param_tree(model).items()},
            "nu": {k: _np(t) for k, t in state[1].nu.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's outputs, the port's by case as a list of ranks, the tied
    granite's run without a mesh)."""
    pytest.importorskip("jax")
    from _subproc import run_forced

    base = tmp_path_factory.mktemp("train_mesh")
    inputs = _inputs()
    with open(base / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    code = _JAX_CODE.format(cases=CASES, rule=RULE, rule_meshes=RULE_MESHES, steps=STEPS, lr=LR,
                            base=str(base))
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
    procs = []
    try:
        for world in WORLDS:  # both worlds at once
            store = base / f"store{world}"
            store.mkdir()
            procs.append(_spawn(lambda r, w=world, st=store: [
                sys.executable, "-c", script, str(r), str(w), str(st), str(base)], world))
        tied = _tied_unsharded(inputs)
        for world, ps in zip(WORLDS, procs):
            _join(ps, deadline, f"gloo world {world}")
    finally:
        for ps in procs:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ref.join(max(deadline - time.monotonic(), 1))
    assert not ref.is_alive(), "the JAX reference did not finish"
    if jax_err:
        raise jax_err[0]
    port = {}
    for world in WORLDS:
        ranks = []
        for r in range(world):
            with open(base / f"port_w{world}_r{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        port.update({key: [rk[key] for rk in ranks] for key in ranks[0]})
    with open(base / "jax.pkl", "rb") as f:
        jax_out = pickle.load(f)
    return jax_out, port, tied


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _named(cfg, tree) -> dict:
    """A JAX parameter-shaped tree (weights, gradients, moments) by the
    port's parameter names, as float64 numpy arrays."""
    carry = whisper_params_from_numpy if cfg.encoder_decoder else lm_params_from_numpy
    return {k: v.detach().to(torch.float64).numpy()
            for k, v in param_tree(carry(cfg, tree, device="cpu")).items()}


def _gap(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


class _Coords:
    """The shape and coordinates of one rank, as ``param_spec``,
    ``expert_block``, ``data_block`` and ``mesh_context`` read a mesh (no
    process group); axes (data, model) unless ``names`` says otherwise."""

    def __init__(self, shape, coords, names=("data", "model")):
        self.shape = dict(zip(names, shape))
        self.coords = dict(zip(names, coords))

    def index(self, axes) -> int:
        i = 0
        for a in (a for a in self.shape if a in axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        return None


def _block(name: str, whole: np.ndarray, cfg, shape, coords) -> np.ndarray:
    """The rank at ``coords``' 2-D block of a whole leaf: its experts
    (``expert_block``) or its ``model_block`` (a decoder's, as built for
    training), and of that its slice of ``param_spec``'s data entry
    (``data_block``, cut within the model block where both name one dim)."""
    mesh = _Coords(shape, coords)
    path = name.replace(".", "/")
    leaf = path.rsplit("/", 1)[-1]
    mine = None
    if "/moe/" in f"/{path}/" and leaf in EXPERT_LEAVES and whole.ndim == 3:
        rows = expert_block(cfg.n_experts, mesh)
        whole = whole if rows is None else whole[rows]
        full = (cfg.n_experts, *whole.shape[1:])
    else:
        full = whole.shape
        if not cfg.encoder_decoder:
            mine = model_block(path, full, mesh, cfg, train=True)
            whole = whole if mine is None else cut(torch.from_numpy(whole), mine).numpy()
    blk = data_block(path, full, mesh, ("data",), mine)
    if blk is not None:
        whole = np.take(whole, range(blk[1].start, blk[1].stop), axis=blk[0])
    return whole


def _whole_over_model(name: str, cfg, n_mp: int) -> bool:
    """Whether a model built for training keeps the leaf whole over a
    ``model`` axis of ``n_mp`` ranks (where ``param_spec`` splits it)."""
    leaf = name.rsplit(".", 1)[-1]
    return (cfg.encoder_decoder or leaf in WHOLE_LEAVES
            or (leaf in ("wk", "wv") and ".mixer." in name and cfg.n_kv_heads < n_mp))


def _held_share(name: str, full: tuple, cfg, shape) -> int:
    """The share of the whole leaf a rank holds by ``param_spec``'s blocks
    (1 / (n_dp n_mp) where it splits over both axes), a leaf kept whole
    over ``model`` counting 1 there, as 1 / that."""
    spec = param_spec(name.replace(".", "/"), full, _Coords(shape, (0, 0)), ("data",))
    return ((shape[0] if "data" in spec else 1)
            * (shape[1] if "model" in spec and not _whole_over_model(name, cfg, shape[1]) else 1))


def _assert_params(cfg, got: dict, want: dict, nu: dict) -> None:
    """``tests/_torch_train.py``'s check of the parameters after the steps."""
    n_over = n_total = 0
    for name, w in want.items():
        d = np.abs(np.asarray(got[name], np.float64) - w)
        over = d > STEP_ABS
        n_over += int(over.sum())
        n_total += d.size
        assert d.max() <= LR, (name, float(d.max()))
        if not cfg.ssm and over.any():
            rms = np.sqrt(nu[name])
            assert (rms[over] < NEAR_ZERO * rms.max()).all(), (name, rms[over] / rms.max())
    assert n_over <= (SCAN_SHARE * n_total if cfg.ssm else n_total), (n_over, n_total)


@pytest.mark.parametrize("case", CASES)
def test_train_steps_match_jax_rank_by_rank(runs, case):
    """3 steps under the mesh against JAX's sharded step: each loss within
    1e-5, every rank's equal; the gathered gradients within 1e-5 of each
    leaf's max (2^-8 behind a scan) at every step; the parameters after the
    steps within ``tests/_torch_train.py``'s contract."""
    jax_out, ranks = runs[0], runs[1][case]
    arch, _, _ = CASES[case]
    cfg, want = _cfg(arch), jax_out["cases"][case]
    rel = SCAN_REL if cfg.ssm else F32_REL
    for rk in ranks:
        assert rk["losses"] == ranks[0]["losses"], (case, rk["coords"])
    for got, jl in zip(ranks[0]["losses"], want["losses"]):
        assert abs(got - jl) <= F32_REL * abs(jl), (case, ranks[0]["losses"], want["losses"])
    whole = ranks[0]["whole"]
    for t, (g, jg) in enumerate(zip(whole["grads"], want["grads"])):
        for name, w in _named(cfg, jg).items():
            assert _gap(g[name], w) <= rel, (case, t, name, _gap(g[name], w))
    _assert_params(cfg, whole["params"], _named(cfg, want["params"]), _named(cfg, want["nu"]))


def test_tied_granite_on_1x2_matches_the_unsharded_model(runs):
    """Tied embeddings trained on a model axis of 2 (the head a row product
    over the rank's d columns of ``embed``, the embedding's gradient the
    lookup's and the head's): 3 steps against the port's tied model without
    a mesh, each loss within 1e-5 and every rank's equal, the gathered
    gradients within 1e-5 of each leaf's max at every step, the parameters
    within ``tests/_torch_train.py``'s contract."""
    ranks, want = runs[1]["tied 1x2"], runs[2]
    cfg = _tied_cfg()
    assert "head" not in ranks[0]["params"] and "head" not in want["params"]
    for rk in ranks:
        assert rk["losses"] == ranks[0]["losses"], rk["coords"]
    for got, wl in zip(ranks[0]["losses"], want["losses"]):
        assert abs(got - wl) <= F32_REL * abs(wl), (ranks[0]["losses"], want["losses"])
    whole = ranks[0]["whole"]
    for t, (g, wg) in enumerate(zip(whole["grads"], want["grads"])):
        for name, w in wg.items():
            assert _gap(g[name], w) <= F32_REL, (t, name, _gap(g[name], w))
    _assert_params(cfg, whole["params"], want["params"], want["nu"])


def test_cross_silo_round_on_the_mesh_is_bitwise_the_single_process_round(runs):
    """The mesh round (a silo a data rank, Eq. 1 through the partial and
    combine modes over one all-reduce) on (2, 1): after two rounds each
    rank's parameters are bitwise silo i's of the single-process round on
    the same inputs, the shared ones equal on both ranks, the personal ones
    apart, and the mean loss the single-process round's."""
    ranks = runs[1]["cross_silo 2x1"]
    single = ranks[0]["single"]
    for rk in ranks:
        want = single["params"][rk["silo"]]
        assert set(rk["params"]) == set(want)
        for name, got in rk["params"].items():
            assert np.array_equal(got, want[name]), (rk["silo"], name)
        assert rk["losses"] == single["losses"], (rk["losses"], single["losses"])
    a, b = (rk["params"] for rk in ranks)
    assert np.array_equal(a["embed"], b["embed"])
    assert not np.array_equal(a["head"], b["head"])


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_blocks_of_params_grads_and_moments(runs, case):
    """Each rank's parameters, gradients (every step) and both AdamW
    moments are its 2-D blocks of the gathered trees: the rank's experts of
    an expert leaf or its model block, and of that its slice of
    ``param_spec``'s data entry, of exactly that shape; a rank holds
    1 / (n_dp n_mp) of each leaf ``param_spec`` splits over both axes (the
    leaves kept whole over ``model`` 1 / n_dp of it); the split axes it
    records name the same layout."""
    ranks = runs[1][case]
    arch, shape, _ = CASES[case]
    cfg, whole = _cfg(arch), ranks[0]["whole"]
    n_split = 0
    for rk in ranks:
        pairs = [(rk["params"], whole["params"]), (rk["mu"], whole["mu"]),
                 (rk["nu"], whole["nu"]), *zip(rk["grads"], whole["grads"])]
        for blocks, trees in pairs:
            for name, w in trees.items():
                want = _block(name, w, cfg, shape, rk["coords"])
                np.testing.assert_array_equal(blocks[name], want, err_msg=f"{case} {name}")
        for name, w in whole["params"].items():
            share = _held_share(name, w.shape, cfg, shape)
            assert rk["params"][name].size * share == w.size, (case, name, share)
        for name, axes in rk["split"].items():
            smaller = rk["params"][name].shape != whole["params"][name].shape
            assert bool(axes) == smaller, (case, name, axes)
            share = _held_share(name, whole["params"][name].shape, cfg, (1, shape[1]))
            assert ("model" in axes) == (share > 1), (case, name, axes)
            n_split += smaller
    assert n_split > 0 or shape == (1, 1)


@pytest.mark.parametrize("case", [c for c, (arch, shape, _) in CASES.items()
                                  if shape[1] > 1 and arch != "whisper-tiny"])
def test_sequence_parallel_splits_each_blocks_input(runs, case):
    """Every decoder block's input on every rank (forward and recompute) is
    (B_loc, S/n, D) under ``seq_parallel``, the rank's rows and its 1/n of
    the sequence on a ``model`` axis of n, and (B_loc, S, D) without it."""
    _, shape, seq_parallel = CASES[case]
    for rk in runs[1][case]:
        rows, s, d = rk["local_stream"]
        assert s == (S // shape[1] if seq_parallel else S) and rows in (B, B // shape[0])
        assert rk["block_inputs"] == [(rows, s, d)], (case, rk["coords"], rk["block_inputs"])


def test_seq_parallel_changes_no_bit_where_jax_does_not_apply_it(runs):
    """On (1, 2) the flag leaves bitwise unchanged what JAX runs without
    the layout: granite's train step on a sequence the ``model`` axis does
    not divide, whisper's train step and granite's prefill (each rank's
    loss, parameters after the step and logits)."""
    for rk in runs[1]["unchanged 1x2"]:
        off, on = rk[False], rk[True]
        assert np.array_equal(off["prefill"], on["prefill"])
        for arch in ("granite-3-8b", "whisper-tiny"):
            assert off[arch][0] == on[arch][0], arch
            for name, p in off[arch][1].items():
                assert np.array_equal(p, on[arch][1][name]), (arch, name)


@pytest.mark.parametrize("case", [c for c, (_, shape, _) in CASES.items() if shape[1] > 1])
def test_leaves_whole_over_model_are_bitwise_equal_across_model_ranks(runs, case):
    """The leaves a rank holds whole over ``model`` (the norms, the router,
    MLA's ``wdkv``/``wkr``, a shared kv head, every whisper leaf; no
    gradient is summed over ``model`` but the norms' of a sequence-parallel
    step, by one all-reduce) have the same bits on every ``model`` rank of
    a data shard: their parameters and both moments after the steps and
    their gradients at every step."""
    ranks = runs[1][case]
    n_whole = 0
    for rk in ranks:
        first = next(r for r in ranks if r["coords"][0] == rk["coords"][0])
        for name, axes in rk["split"].items():
            if "model" in axes:
                continue
            n_whole += 1
            for key in ("params", "mu", "nu"):
                np.testing.assert_array_equal(rk[key][name], first[key][name],
                                              err_msg=f"{case} {key} {name} {rk['coords']}")
            for t, (g, g0) in enumerate(zip(rk["grads"], first["grads"])):
                np.testing.assert_array_equal(g[name], g0[name],
                                              err_msg=f"{case} grad {t} {name} {rk['coords']}")
    assert n_whole > 0


@pytest.mark.parametrize("case", CASES)
def test_init_params_keeps_each_ranks_blocks(runs, case):
    """Under the mesh ``init_params`` (``init_whisper``) draws as without
    one and keeps, of every leaf, the rank's 2-D block (its experts or its
    model block, and its slice of the data entry): bitwise the unsharded
    init's block."""
    ranks = runs[1][case]
    arch, shape, _ = CASES[case]
    cfg = _cfg(arch)
    whole = {k: _np(p) for k, p in param_tree(
        get_model(cfg).init(torch.Generator().manual_seed(0))).items()}
    for rk in ranks:
        assert set(rk["init"]) == set(whole)
        for name, w in whole.items():
            np.testing.assert_array_equal(rk["init"][name],
                                          _block(name, w, cfg, shape, rk["coords"]),
                                          err_msg=f"{case} {name}")


@pytest.mark.parametrize("case", CASES)
def test_global_norm_under_the_mesh_is_the_unsharded_norm(runs, case):
    """``global_norm`` of a rank's gradient blocks (a ``SplitTree``: each
    leaf's squares summed once over the axes it is split over) equals every
    other rank's and the plain norm of the gathered gradient within 1e-6."""
    ranks = runs[1][case]
    whole = ranks[0]["whole"]["grads"]
    for rk in ranks:
        assert rk["norms"] == ranks[0]["norms"]
    for norm, grads in zip(ranks[0]["norms"], whole):
        want = float(optim.global_norm({k: torch.from_numpy(v) for k, v in grads.items()}))
        assert abs(norm - want) <= NORM_REL * want, (case, norm, want)


@pytest.mark.parametrize("shape", RULE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", RULE)
def test_jax_sharded_step_takes_the_mean_of_the_shards_aux(runs, arch, shape):
    """JAX's expert-parallel MoE returns its aux from a shard_map with
    ``out_specs=P()`` and ``check_vma=False``; with several data shards its
    sharded step's gradient is (1/n_dp) sum_d grad(NLL_d + 0.01 aux_d), the
    unsharded model on each shard's rows and the NLL over the global count
    of labels (within 1e-5 of each leaf's max), which is neither the
    unsharded gradient nor the auxes' sum (each misses some leaf by more
    than 1e-2 of its max); its loss is the global NLL mean plus 0.01 times
    data shard 0's aux (within 1e-6). The port implements this rule
    (``lm_objective``; ``test_train_steps_match_jax_rank_by_rank``)."""
    jax_out, _, _ = runs
    cfg, r = _cfg(arch), jax_out["rule"][(arch, shape)]
    got = _named(cfg, r["grads"])
    mean, summed, plain = (_named(cfg, r[k]) for k in ("mean", "sum", "plain"))
    for name, w in mean.items():
        assert _gap(got[name], w) <= F32_REL, (name, _gap(got[name], w))
    assert max(_gap(got[n], summed[n]) for n in got) > RULE_GAP
    assert max(_gap(got[n], plain[n]) for n in got) > RULE_GAP
    want = r["nll"] + 0.01 * r["aux0"]
    assert abs(r["loss"] - want) <= NORM_REL * abs(want), (r["loss"], want)


def _collective_case(runs):
    """Every rank's collective outputs, the inputs of each rank, its
    matrix, and the weights of each collective by rank."""
    inputs = [_collective_inputs(r) for r in range(4)]
    return (runs[1]["collectives"], [x.numpy() for x, _, _ in inputs],
            [m.numpy() for _, _, m in inputs],
            {name: [ws[name].numpy() for _, ws, _ in inputs] for name in inputs[0][1]})


def _assert_collectives(got: dict, want: dict, r: int) -> None:
    for name, (y, g) in want.items():
        np.testing.assert_array_equal(got[name][0], y, err_msg=f"rank {r} {name} output")
        np.testing.assert_array_equal(got[name][1], g, err_msg=f"rank {r} {name} gradient")


def test_collectives_under_autograd(runs):
    """On a (2, 2) mesh of the gloo world (rank r at data i = r // 2, model
    j = r % 2): ``gather_blocks`` over data on dim 1 concatenates the data
    ranks' inputs and its gradient is the data ranks' weights summed, rank
    i's block kept; ``psum`` over ``model`` sums
    the model ranks' inputs with the identity for its gradient;
    ``replicated`` is the identity whose gradient sums the model ranks'
    weights; ``scatter_sum`` over ``model`` on dim 1 sums the model ranks'
    inputs and keeps rank j's block of columns, its gradient the model
    ranks' weights concatenated; ``split`` keeps rank j's block of its own
    input, its gradient the same concatenation. Exactly (small integers in
    float32)."""
    ranks, t, _, w = _collective_case(runs)
    for r, got in enumerate(ranks):
        i, j = divmod(r, 2)
        data, model = [j, 2 + j], [2 * i, 2 * i + 1]  # the ranks of r's data and model groups
        _assert_collectives(got, {
            "gather": (np.concatenate([t[k] for k in data], axis=1),
                       sum(w["gather"][k] for k in data)[:, 4 * i:4 * i + 4]),
            "psum": (sum(t[k] for k in model), w["psum"][r]),
            "replicated": (t[r], sum(w["replicated"][k] for k in model)),
            "scatter_sum": (sum(t[k] for k in model)[:, 2 * j:2 * j + 2],
                            np.concatenate([w["scatter_sum"][k] for k in model], axis=1)),
            "split": (t[r][:, 2 * j:2 * j + 2],
                      np.concatenate([w["split"][k] for k in model], axis=1)),
        }, r)


def test_tensor_parallel_collectives_under_autograd(runs):
    """``launch/tp.py``'s three collectives under the (2, 2) mesh's context
    (rank r at data i = r // 2, model j = r % 2), the weights of the loss
    of ``row`` and ``gather`` equal on the two model ranks of a data index,
    as every loss downstream of them is: ``row(x, w)`` is the model ranks'
    ``x @ w`` summed, and its gradient the rank's own ``weights @ w.T``
    (the identity through the sum); ``enter`` is the identity, and its
    gradient the model ranks' weights summed; ``gather`` concatenates the
    model ranks' inputs on the last dim, and its gradient is the rank's
    columns of the weights, not summed: a reduce-scatter there would
    double them. The sequence-parallel pair, on dim 1: ``sp_gather``
    concatenates the model ranks' inputs, its gradient with ``shares`` the
    model ranks' weights summed and rank j's block kept, without them rank
    j's block of its own weights; ``sp_row`` is rank j's block of columns
    of the model ranks' ``x @ w`` summed, its gradient the model ranks'
    weights concatenated times the rank's ``w.T``; ``sp_split`` keeps rank
    j's block, its gradient the model ranks' weights concatenated. Exactly
    (small integers in float32)."""
    ranks, t, m, w = _collective_case(runs)
    for r, got in enumerate(ranks):
        i, j = divmod(r, 2)
        model = [2 * i, 2 * i + 1]
        gathered = w["tp_gather"][r][:, 4 * j:4 * j + 4]
        assert not np.array_equal(gathered, 2 * gathered)
        sp = [_sp_matrix(torch.from_numpy(m[k])).numpy() for k in range(4)]
        _assert_collectives(got, {
            "tp_row": (sum(t[k] @ m[k] for k in model), w["tp_row"][r] @ m[r].T),
            "tp_enter": (t[r], sum(w["tp_enter"][k] for k in model)),
            "tp_gather": (np.concatenate([t[k] for k in model], axis=1), gathered),
            "sp_gather_shares": (np.concatenate([t[k] for k in model], axis=1),
                                 sum(w["sp_gather_shares"][k] for k in model)[:, 4 * j:4 * j + 4]),
            "sp_gather": (np.concatenate([t[k] for k in model], axis=1),
                          w["sp_gather"][r][:, 4 * j:4 * j + 4]),
            "sp_row": (sum(t[k] @ sp[k] for k in model)[:, 2 * j:2 * j + 2],
                       np.concatenate([w["sp_row"][k] for k in model], axis=1) @ sp[r].T),
            "sp_split": (t[r][:, 2 * j:2 * j + 2],
                         np.concatenate([w["sp_split"][k] for k in model], axis=1)),
        }, r)


def test_training_with_every_expert_on_a_model_rank_raises():
    """Under a ``model`` axis of 2, an MoE whose expert leaves hold every
    expert (a model carried without ``mesh=``) would train only this rank's
    experts and let the others drift apart across ranks: under autograd
    ``moe_apply_ep`` refuses it; without gradients it serves."""
    from repro_torch.models import layers as L

    cfg = _cfg("deepseek-moe-16b")
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator().manual_seed(1))
    with ctx.mesh_context(_Coords((1, 2), (0, 0))):
        p["wg"].requires_grad_(True)
        with pytest.raises(ValueError, match="this rank's experts"):
            L.moe_apply_ep(p, x, cfg)


@pytest.mark.parametrize("dp_axes", [("data",), ("pod", "data")], ids="+".join)
def test_zero_blocks_take_the_open_contexts_data_axes(dp_axes):
    """On a (pod 2, data 2, model 1) mesh, rank (1, 0, 0): ``init_params``
    and ``lm_params_from_numpy`` with ``zero`` cut every leaf over the data
    axes the open ``mesh_context`` names (the one place they are decided),
    and alike: over ``data`` alone a pod keeps its copy (data index 0 of
    2), over (pod, data) the block is index 2 of 4. Without ``zero``
    (serving) every leaf stays whole; ``zero`` outside a context, or with a
    mesh the context does not hold, raises."""
    cfg = _cfg("granite-3-8b")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    whole = T.init_params(gen(), cfg)
    tree = _jax_tree(cfg, whole)
    mesh = _Coords((2, 2, 1), (1, 0, 0), names=("pod", "data", "model"))
    n = 2 if dp_axes == ("data",) else 4
    i = mesh.index(dp_axes)
    with ctx.mesh_context(mesh, dp_axes=dp_axes):
        drawn = param_tree(T.init_params(gen(), cfg, zero=True))
        loaded = param_tree(lm_params_from_numpy(cfg, tree, device="cpu", mesh=mesh, zero=True))
        served = param_tree(lm_params_from_numpy(cfg, tree, device="cpu", mesh=mesh))
        with pytest.raises(ValueError, match="mesh_context"):
            lm_params_from_numpy(cfg, tree, device="cpu", mesh=_Coords((2, 2), (0, 0)), zero=True)
    with pytest.raises(ValueError, match="mesh_context"):
        T.init_params(gen(), cfg, zero=True)
    n_split = 0
    for name, w in param_tree(whole).items():
        assert torch.equal(served[name], w), name
        dims = [d for d, (a, b) in enumerate(zip(drawn[name].shape, w.shape)) if a != b]
        want = w
        if dims:
            size = w.shape[dims[0]] // n
            want = w.narrow(dims[0], i * size, size)
            assert drawn[name].zero_axes == dp_axes and drawn[name].zero_dim == dims[0], name
            n_split += 1
        assert len(dims) <= 1 and torch.equal(drawn[name], want), name
        assert torch.equal(loaded[name], want), name
    assert n_split > 0


# ---------------------------------------------------------------------------
# launch/train.py --mesh
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mesh", ["2,1", "1,2"])
def test_train_cli_mesh_matches_the_unsharded_cli(tmp_path, mesh):
    """``python -m repro_torch.launch.train --mesh 2,1`` (a row a rank) and
    ``--mesh 1,2`` (half the heads and d_ff columns a rank, the checkpoint
    gathered from model blocks) as two gloo processes (torchrun's
    environment) on the reduced granite-3-8b (bf16): both ranks' losses
    equal, within 2^-5 of the unsharded CLI's, and its ``--ckpt`` one
    checkpoint (the unsharded run's files),
    written by rank 0, every element within one bf16 rounding (2^-7 of its
    size) and two learning rates of the unsharded run's, at most 1e-4 of
    them beyond one: a row a rank rounds the bf16 products otherwise, an
    update then rounds a parameter to the neighbouring bf16 value (up to
    one ulp, on 0.6-5% of a leaf's elements), and where a gradient element
    cancels to near zero AdamW moves it by up to a learning rate either way
    (measured: 15 of 1.44 M elements beyond one rounding and one learning
    rate, by at most 1.2 learning rates, all in ``embed``)."""
    from repro_torch.checkpoint import load_pytree_auto
    from repro_torch.launch.train import main as train_main

    args = ["--arch", "granite-3-8b", "--reduced", "--device", "cpu", "--steps", "3"]
    port = str(_free_port())
    procs = _spawn(lambda r: [sys.executable, "-m", "repro_torch.launch.train", *args, "--mesh",
                              mesh, "--ckpt", str(tmp_path / "mesh")], 2,
                   env_of=lambda r: {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port})
    logs = _join(procs, time.monotonic() + 300, f"train --mesh {mesh}")
    stats = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = train_main([*args, "--ckpt", str(tmp_path / "plain")])
    finally:
        torch.set_num_threads(before)
    assert [s["rank"] for s in stats] == [0, 1] and stats[0]["losses"] == stats[1]["losses"]
    for got, want in zip(stats[0]["losses"], plain["losses"]):
        assert abs(got - want) <= BF16_REL * abs(want), (stats[0]["losses"], plain["losses"])
    assert stats[0]["ckpt"] and stats[1]["ckpt"] is None
    assert sorted(p.name for p in (tmp_path / "mesh").iterdir()) == sorted(
        p.name for p in (tmp_path / "plain").iterdir())
    got, want = (load_pytree_auto(str(tmp_path / d), "granite-3-8b") for d in ("mesh", "plain"))
    assert set(got) == set(want)
    n_over = n_total = 0
    for k in want:
        g, w = (torch.as_tensor(x).float() for x in (got[k], want[k]))
        excess = ((g - w).abs() - BF16_ULP * w.abs()) / LR
        assert g.shape == w.shape and float(excess.max()) <= 2, (k, float(excess.max()))
        n_over += int((excess > 1).sum())
        n_total += w.numel()
    assert n_over <= SCAN_SHARE * n_total, (n_over, n_total)
