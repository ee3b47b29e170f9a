"""Where a serving step's time goes on the card: one prefill and a few
decode steps of a decoder LM under ``torch.profiler``; with ``--train``, a
train step instead; with ``--fl``, an FL round.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch granite-3-8b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch moonshot-v1-16b-a3b --layers 4
    PYTHONPATH=src python -m repro_torch.launch.profile --arch jamba-v0.1-52b --layers 8
    PYTHONPATH=src python -m repro_torch.launch.profile --arch whisper-tiny
    PYTHONPATH=src python -m repro_torch.launch.profile --arch granite-3-8b --layers 8 --train
    PYTHONPATH=src python -m repro_torch.launch.profile --fl

Builds the arch at full width with random weights (``--layers N`` cuts its
depth to N layers, the first ``first_dense`` of them dense; jamba's 8 are one
period), runs a warm-up prefill and decode step, then traces one prefill of
4 prompts of 2048 tokens (the serving run of ``chip_smoke.py``; whisper's
batch is 1,500 frames and 448 decoder tokens a prompt) and ``--steps``
decode steps. For each
window it prints one JSON line: the device span (first kernel start to
last kernel end), the device's busy time (the sum of its kernels'
durations; one stream, so they do not overlap), the idle share of the
span, the number of kernels, and the kernels that took the most device
time. ``--train`` traces one train step of the CLI's optimizer
(``launch/train.py``) on a batch of 4 rows of 2048 tokens (whisper: 448
tokens over 1,500 frames) after a warm-up step, with its host wall time;
``profile_train_step(..., mesh=)`` traces it on every rank of a (data,
model) mesh of ranks (``chip_smoke.py --train-world``), where the
breakdown also sums the NCCL kernels (they run on their own stream, which
the compute stream waits for) and gives their share of the device span.
``--fl`` traces the ACSP-FL + DLD + int8 round on the UCI-HAR
stand-in at har-mlp's full width (``chip_smoke.py``'s main path): one eager
round, then one replay of a CUDA graph of ``--chunk`` rounds
(``repro_torch.fl.api.build_chunk_step``), each window with its host wall
time. ``profile_async_events`` traces a run of the async scheduler
(``chip_smoke.py``'s ``[async]`` calls it) and reports the device's busy
time and kernels an event. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import random as prng
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.context import mesh_context
from repro_torch.models.api import get_model, make_concrete_batch


def device_breakdown(prof, top: int = 8) -> dict:
    """Span, busy time, idle share and the top kernels of a profiled window
    (device kernels and copies; not the ranges the profiler records on the
    device for an annotation, such as NCCL's ``nccl:all_reduce``, which
    would count a collective's kernel twice); where NCCL kernels ran, their
    ms and their share of the span; the copy kernels' ms (every kernel
    named a copy: layout copies around collectives among them)."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return {"device_trace": "not measured (the profiler recorded no device kernels)"}
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    nccl = [us for name, (_, us) in by_name.items() if "nccl" in name.lower()]
    copies = [us for name, (_, us) in by_name.items()
              if "copy" in name.lower() and "nccl" not in name.lower()]
    return {
        "span_ms": (end - start) / 1e3,
        "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / max(end - start, 1e-9),
        "kernels": len(kernels),
        "copy_ms": sum(copies) / 1e3,
        **({"nccl_ms": sum(nccl) / 1e3, "nccl_share": sum(nccl) / max(end - start, 1e-9)}
           if nccl else {}),
        "top": [{"name": name[:120], "count": n, "ms": us / 1e3} for name, (n, us) in ranked],
    }


def profile_serving(cfg, *, batch: int = 4, prompt_len: int = 2048, steps: int = 8,
                    seed: int = 0) -> dict:
    """The prefill and decode windows' ``device_breakdown``s, on the card."""
    dev = resolve_device(None)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(seed))
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
    batch_toks = make_concrete_batch(cfg, "prefill", batch, prompt_len,
                                     prng.PRNGKey(seed + 1, device=dev))  # drawn on the card

    logits, cache = prefill(model, batch_toks)  # warm-up: allocator, cuBLAS plans
    logits, cache = decode(model, cache, torch.argmax(logits, -1)[:, None])
    del cache
    torch.cuda.synchronize()
    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        logits, cache = prefill(model, batch_toks)
        torch.cuda.synchronize()
    out["prefill"] = device_breakdown(prof)
    tok = torch.argmax(logits, -1)[:, None]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, cache = decode(model, cache, tok)
            tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
    out["decode"] = device_breakdown(prof)
    out["decode"]["steps"] = steps
    return out


def profile_train_step(cfg, *, batch: int = 4, seq: int = 2048, seed: int = 0,
                       mesh=None, seq_parallel: bool = False) -> dict:
    """``device_breakdown`` of one train step (the forward with its
    checkpointed blocks, the backward with their recompute, the optimizer)
    after a warm-up step, with its host wall ms, on the card (on this rank
    of ``mesh``, a ``launch.mesh.RankMesh``, when given: every rank calls
    it); its top 24 kernels, so that the backward kernels' grids show
    beside the GEMMs and the optimizer's elementwise passes.
    ``seq_parallel``: the mesh context's."""
    if mesh is not None:
        with mesh_context(mesh, seq_parallel=seq_parallel):
            return _profile_train_step(cfg, batch, seq, seed, mesh.device, zero=True)
    return _profile_train_step(cfg, batch, seq, seed, resolve_device(None), zero=False)


def _profile_train_step(cfg, batch, seq, seed, dev, zero) -> dict:
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.api import param_tree

    bundle = get_model(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(seed), zero=zero)
    opt = make_optimizer(3e-4, 4)
    opt_state = opt.init(param_tree(model))
    step = bundle.make_train_step(opt)
    key = prng.PRNGKey(seed + 1, device=dev)
    data = [make_concrete_batch(cfg, "train", batch, seq, k) for k in prng.split(key)]
    model, opt_state, _ = step(model, opt_state, data[0])  # warm-up: allocator, cuBLAS plans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt_state, loss = step(model, opt_state, data[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"train step": {"wall_ms": 1e3 * wall, "loss": float(loss),
                           **device_breakdown(prof, top=24)}}


def profile_fl_round(chunk: int = 5, seed: int = 0) -> dict:
    """``device_breakdown``s of one eager FL round and of one replay of a
    chunk of ``chunk`` rounds, with their host wall ms, on the card."""
    from repro_torch.data import make_har_dataset
    from repro_torch.fl import FLConfig, api
    from repro_torch.fl.sched import _setup_run, initial_state

    dev = resolve_device(None)
    data = make_har_dataset("uci-har", seed=seed)
    cfg = FLConfig(codec="int8", epochs=2, rounds=2 + 2 * chunk)
    su = _setup_run(data, cfg, dev, None, api.mlp_loss, api.mlp_accuracy, None, None, None)
    state = initial_state(su, data.n_clients)
    round_step = api.build_round_step(su.env, su.pipeline, cfg.execution)
    state, _ = round_step(state, 0)  # warm-up: allocator, cuBLAS plans
    torch.cuda.synchronize()
    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = round_step(state, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["fl round, eager"] = {"rounds": 1, "wall_ms": 1e3 * wall, **device_breakdown(prof)}
    step = api.build_chunk_step(round_step, chunk)
    ts = torch.arange(2, 2 + 2 * chunk, dtype=torch.int32, device=dev)
    state, _ = step(state, ts[:chunk])  # warm-up round, capture, first replay
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, ts[chunk:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out[f"fl chunk of {chunk} rounds, CUDA-graph replay"] = {
        "rounds": chunk, "wall_ms": 1e3 * wall, **device_breakdown(prof, top=12)}
    return out


def profile_async_events(data, cfg, device) -> dict:
    """``device_breakdown`` of one async ``run_federated`` of ``cfg.rounds``
    events on ``device`` (set-up and the first event included), with the
    busy ms, kernels and host wall ms an event."""
    from repro_torch.fl import run_federated

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        h = run_federated(data, cfg, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    row = device_breakdown(prof, top=10)
    n = len(h.accuracy_mean)
    row = {"events": n, "wall_ms_per_event": 1e3 * wall / n, **row}
    if "busy_ms" in row:
        row["busy_ms_per_event"] = row["busy_ms"] / n
        row["kernels_per_event"] = row["kernels"] / n
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch's depth to this many layers (0: full depth)")
    ap.add_argument("--fl", action="store_true",
                    help="trace the ACSP-FL round (UCI-HAR, har-mlp, int8) instead of serving")
    ap.add_argument("--chunk", type=int, default=5, help="rounds of the replayed chunk (--fl)")
    ap.add_argument("--train", action="store_true",
                    help="trace one train step (batch 4, seq 2048) instead of serving")
    args = ap.parse_args(argv)
    if args.fl:
        res = profile_fl_round(chunk=args.chunk)
        for window, row in res.items():
            print(json.dumps({"window": window, "device": torch.cuda.get_device_name(0), **row}))
        return res
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    res = profile_train_step(cfg) if args.train else profile_serving(cfg, steps=args.steps)
    for window, row in res.items():
        print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers, "window": window,
                          "device": torch.cuda.get_device_name(0), **row}))
    return res


if __name__ == "__main__":
    main()
