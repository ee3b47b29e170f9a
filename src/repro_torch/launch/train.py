"""Single-process training driver of the port for any architecture of the
model zoo.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --reduced \\
        --steps 20 --batch 2 --seq 64 [--device cpu] [--ckpt DIR]
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --layers 8 \\
        --batch 4 --seq 2048 --steps 4

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
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch import random as prng
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model, make_batch_specs, make_concrete_batch, param_tree
from repro_torch.optim import adamw, chain, clip_by_global_norm, cosine_schedule


def make_optimizer(lr: float, steps: int):
    """The JAX CLI's optimizer for a run of ``steps`` steps."""
    return chain(clip_by_global_norm(1.0),
                 adamw(cosine_schedule(lr, warmup_steps=max(2, steps // 10), total_steps=steps)))


def train(cfg: ModelConfig, *, steps: int = 20, batch: int = 2, seq: int = 64, lr: float = 3e-4,
          seed: int = 0, ckpt: str | None = None, device=None, log=print) -> dict:
    """``steps`` train steps of ``cfg`` from random weights (``seed``) on
    ``device`` (default the card). Returns {"losses", "n_params",
    "step_ms", "peak_bytes" (None off the card), "tok_per_s", "ckpt"}."""
    dev = resolve_device(device)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
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
        out["ckpt"] = save_pytree({k: v.detach() for k, v in param_tree(model).items()}, ckpt,
                                  cfg.name.replace("/", "_"))
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
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                 seed=args.seed, ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
