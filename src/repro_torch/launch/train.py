"""Training entry point of the port for any architecture of the model zoo, in
one process or over a (data, model) mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --reduced \\
        --steps 20 --batch 2 --seq 64 [--device cpu] [--ckpt DIR]
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --layers 8 \\
        --batch 4 --seq 2048 --steps 4
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch granite-3-8b --mesh 2,2 --batch 8 --seq 2048 --steps 4

The JAX package's CLI (``repro.launch.train``) with its flags and defaults:
the arch's config (``--reduced`` for the smoke-test variant; ``--layers N``
cuts the depth to N layers, as ``launch/profile.py`` does), random weights
from ``--seed``, the optimizer ``chain(clip_by_global_norm(1.0),
adamw(cosine_schedule(lr, warmup max(2, steps // 10), steps)))``, and a fresh
batch every step, drawn by ``make_concrete_batch`` from a key split off the
seed's as the JAX CLI splits it (the batches are the JAX CLI's bit for bit;
the weights come from a ``torch.Generator`` and differ from its). It runs
on the CUDA card unless ``--device`` names another. The losses stay on the
device during the run and are read once at the end; a loss that is not
finite fails the run. ``--ckpt DIR`` saves the trained parameters through
``checkpoint.save_pytree``. ``train`` is the body, for any config: it
returns the losses, the parameter count, the per-step times (CUDA events on
the card), and the peak device memory.

``--mesh D,M`` trains under a ``launch.mesh.RankMesh`` of D data and M
model ranks, one process a rank, started by ``torchrun --nproc-per-node
D*M`` (one card and one NCCL rank each; gloo with ``--device cpu``), as the
JAX package's full configs train under its production mesh
(``launch/dryrun.py``): each rank holds its 2-D blocks of the parameters
and AdamW moments (on M > 1 a decoder's tensor-parallel blocks,
``launch/tp.py``, and of those the ZeRO blocks over the D data ranks) and
its experts (``launch/zero.py``), draws the same global batch, runs its
data shard of it and returns the global loss; whisper's leaves stay whole
over ``model``. Each
rank prints one JSON line: its losses, step ms (CUDA events), tok/s over
the global batch and its own peak bytes. ``--ckpt`` gathers whole leaves
(``zero.whole``: the model blocks put back in place) and rank 0 alone saves
them: the file an unsharded run would write. ``--seq-parallel`` opens the
mesh with JAX's ``seq_parallel``: on M > 1 dividing the sequence, a
decoder's residual stream between blocks is split over ``model``
(``models.transformer``; ``launch/tp.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time

import torch
import torch.distributed as dist

from repro_torch import random as prng
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import context as ctx
from repro_torch.launch import zero
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models.api import get_model, make_batch_specs, make_concrete_batch, param_tree
from repro_torch.optim import adamw, chain, clip_by_global_norm, cosine_schedule


def make_optimizer(lr: float, steps: int):
    """The JAX CLI's optimizer for a run of ``steps`` steps."""
    return chain(clip_by_global_norm(1.0),
                 adamw(cosine_schedule(lr, warmup_steps=max(2, steps // 10), total_steps=steps)))


def train(cfg: ModelConfig, *, steps: int = 20, batch: int = 2, seq: int = 64, lr: float = 3e-4,
          seed: int = 0, ckpt: str | None = None, device=None, log=print, mesh=None,
          seq_parallel: bool = False) -> dict:
    """``steps`` train steps of ``cfg`` from random weights (``seed``) on
    ``device`` (default the card), or on this rank of ``mesh`` (a
    ``launch.mesh.RankMesh``, on its device; every rank calls it). Returns
    {"losses", "n_params" (the whole model's), "step_ms", "peak_bytes"
    (None off the card; this rank's), "tok_per_s" (the global batch's),
    "ckpt" (None but on rank 0)}. ``seq_parallel``: the mesh context's
    (``launch.context.mesh_context``)."""
    dev = resolve_device(device) if mesh is None else mesh.device
    with (ctx.mesh_context(mesh, seq_parallel=seq_parallel) if mesh is not None
          else contextlib.nullcontext()):
        return _train(cfg, steps, batch, seq, lr, seed, ckpt, dev, log, mesh)


def _train(cfg, steps, batch, seq, lr, seed, ckpt, dev, log, mesh) -> dict:
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(seed), zero=mesh is not None)
    n_params = sum(math.prod(getattr(p, "full_shape", p.shape)) for p in model.parameters())
    log(f"{cfg.name}: {n_params / 1e6:.1f}M params, {cfg.n_layers} layers, {cfg.dtype}, on {dev}")
    opt = make_optimizer(lr, steps)
    opt_state = opt.init(param_tree(model))
    step_fn = bundle.make_train_step(opt)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    key = prng.PRNGKey(seed, device=dev)
    losses, marks = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        key, sub = prng.split(key)
        data = make_concrete_batch(cfg, "train", batch, seq, sub)
        start = _mark(cuda)
        model, opt_state, loss = step_fn(model, opt_state, data)
        marks.append((start, _mark(cuda)))
        losses.append(loss)
    losses = torch.stack(losses).cpu().tolist() if losses else []  # the run's one host read
    wall = time.perf_counter() - t0
    step_ms = [(a.elapsed_time(b) if cuda else 1e3 * (b - a)) for a, b in marks]
    for i in sorted({*range(0, steps, max(1, steps // 10)), steps - 1} - {-1}):
        log(f"  step {i:4d}  loss {losses[i]:.4f}  ({step_ms[i]:.1f} ms)")
    if not all(math.isfinite(x) for x in losses):
        raise FloatingPointError(f"{cfg.name}: loss not finite: {losses}")
    if losses:
        log(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} in {steps} steps ({wall:.2f} s)")
    tokens = math.prod(make_batch_specs(cfg, "train", batch, seq)["tokens"][0])
    out = {"losses": losses, "n_params": n_params, "step_ms": step_ms,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
           "tok_per_s": tokens * steps / max(wall, 1e-9), "ckpt": None}
    if ckpt:
        tree = {k: v.detach() if mesh is None else zero.whole(v, mesh)
                for k, v in param_tree(model).items()}
        if mesh is None or mesh.rank == 0:
            out["ckpt"] = save_pytree(tree, ckpt, cfg.name.replace("/", "_"))
            log(f"saved {out['ckpt']}")
    return out


def _mark(cuda: bool):
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch's depth to this many layers (0: the config's)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh", default=None,
                    help="D,M: train over a (data, model) mesh of D*M ranks, one process a rank "
                         "(torchrun --nproc-per-node D*M)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="with --mesh: the sequence-parallel layout (JAX's seq_parallel)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    run = dict(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, seed=args.seed,
               ckpt=args.ckpt)
    if not args.mesh:
        return train(cfg, device=args.device, **run)
    shape = tuple(int(n) for n in args.mesh.split(","))
    cpu = resolve_device(args.device).type == "cpu"
    dist.init_process_group("gloo" if cpu else "nccl")  # torchrun's environment
    try:
        dev = torch.device("cpu") if cpu else torch.device("cuda", dist.get_rank()
                                                           % torch.cuda.device_count())
        if not cpu:
            torch.cuda.set_device(dev)
        mesh = make_rank_mesh(shape, device=dev)
        try:
            stats = train(cfg, mesh=mesh, log=print if mesh.rank == 0 else (lambda *_: None),
                          seq_parallel=args.seq_parallel, **run)
        finally:
            mesh.close()
        print(json.dumps({"rank": mesh.rank, "coords": mesh.coords, **{
            k: stats[k] for k in ("losses", "step_ms", "tok_per_s", "peak_bytes", "ckpt")}}))
    finally:
        dist.destroy_process_group()
    return stats


if __name__ == "__main__":
    main()
