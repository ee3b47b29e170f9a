"""Batched serving entry point of the port: prefill queue + decode loop for
every architecture of the model zoo (falcon-mamba-7b, granite-3-8b,
chatglm3-6b, stablelm-12b, qwen2-vl-2b, deepseek-moe-16b,
moonshot-v1-16b-a3b, deepseek-v2-lite-16b, jamba-v0.1-52b, whisper-tiny).
Token-only LMs run continuous batching (``DecodeProgram`` under
``ContinuousBatcher``: finished lanes are back-filled by re-prefilling the
joined batch); a model whose prefill batch holds more than tokens (qwen2-vl's
vision embeddings and M-RoPE positions, whisper's audio frames) is served in
static waves of ``batch`` requests through ``greedy_decode``, each wave's
batch drawn from its own key, retiring together: the JAX launcher's two
paths.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --requests 8 --batch 4 --prompt-len 64 --max-new 32 [--device cpu] \\
        [--record DIR]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --mesh 1,4

The JAX package's CLI (``repro.launch.serve``) with the same flags and
defaults: it serves the arch's reduced config with random weights and
random prompts. The prompts are drawn from ``--seed`` exactly as the JAX
CLI draws them; the weights come from a ``torch.Generator``, so they differ
from the JAX CLI's. It runs on the CUDA card unless ``--device`` names
another. ``serve`` is the body, for any config (``chip_smoke.py`` calls it
at full width): it returns the latency stats, tokens, prefill count and the
per-call times of the prefill and decode steps. ``--record DIR`` (``record=``)
writes a serve record — manifest, ``requests.jsonl`` and a Perfetto trace
of the request spans — through ``repro_torch.serve.ServeRecorder``, as the
JAX CLI's ``--record`` does.

Under a mesh of ranks (``launch.context.mesh_context`` around ``serve`` on
every rank, one process a rank, e.g. under ``torchrun``) the ranks serve
in lockstep: the same requests, each rank its data shard of every step,
its experts of every MoE layer and, on a ``model`` axis over 1, its
tensor-parallel block of every other leaf (``launch/tp.py``), the greedy
decisions made on the gathered logits, which every rank holds. Rank 0
records; every rank returns its own stats, with the peak device memory of
every rank. ``--mesh D,M`` serves so under a ``launch.mesh.RankMesh`` of D
data and M model ranks started by ``torchrun --nproc-per-node D*M`` (one
card and one NCCL rank each; gloo with ``--device cpu``). Rank 0 prints.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch import random as prng
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import context as ctx
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models.api import get_model, make_concrete_batch
from repro_torch.serve import (
    ContinuousBatcher,
    DecodeProgram,
    ServeRecorder,
    ServeRequest,
    ServeResult,
    greedy_decode,
    latency_stats,
    token_only_prefill,
)


class _Timed:
    """A step function that keeps the time of each call (CUDA events around
    it on the card, read after the run; the host clock elsewhere) and
    whether every logit it returned was finite (a device flag, read after
    the run)."""

    def __init__(self, fn, device: torch.device):
        self.fn, self.cuda = fn, device.type == "cuda"
        self.events, self.host_ms = [], []
        self.finite = torch.ones((), dtype=torch.bool, device=device)

    def __call__(self, *args):
        if self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = self.fn(*args)
            end.record()
            self.events.append((start, end))
        else:
            t0 = time.perf_counter()
            out = self.fn(*args)
            self.host_ms.append(1e3 * (time.perf_counter() - t0))
        self.finite &= torch.isfinite(out[0]).all()
        return out

    def ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) for s, e in self.events]
        return list(self.host_ms)


def serve(cfg: ModelConfig, *, requests: int = 8, batch: int = 4, prompt_len: int = 64,
          max_new: int = 32, window: int = 0, temperature: float = 0.0, seed: int = 0,
          device=None, record: str | None = None) -> dict:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens on a
    randomly initialised ``cfg`` model with ``batch`` lanes, up to
    ``max_new`` tokens each. Returns ``latency_stats`` plus ``tokens``,
    ``tok_per_s``, ``prefill_calls``, ``lens`` (tokens per request),
    ``outputs`` (the generated ids per request), ``prefill_ms`` /
    ``decode_ms`` (each call's time: CUDA events on the card, the host
    clock elsewhere; ``timer`` says which) and ``logits_finite`` (every
    step's logits were finite). ``record`` is a directory for a serve
    record of the session (``stats["record"]`` names it). An arch whose
    prefill takes more than tokens is served in waves (``serve_waves``):
    ``prefill_calls`` then counts the waves. Under a mesh context the
    device defaults to the mesh's, only rank 0 records, and
    ``peak_bytes_by_rank`` lists each rank's peak allocated device memory
    (``torch.cuda.max_memory_allocated``; None on the CPU)."""
    mesh = ctx.get_mesh()
    dev = resolve_device(mesh.device if device is None and mesh is not None else device)
    if mesh is not None and mesh.rank != 0:
        record = None
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(seed))
    prefill = _Timed(bundle.make_prefill_step(window=window), dev)
    decode = _Timed(bundle.make_decode_step(window=window), dev)

    recorder = None
    if record:
        recorder = ServeRecorder(record, trace=True)
        recorder.open_session(
            artifact_meta={"arch": cfg.name, "kind": "lm-decode", "eos_token_id": cfg.eos_token_id},
            engine="decode", batch_size=batch,
            extra={"prompt_len": prompt_len, "max_new": max_new}, device=dev)

    t0 = time.time()
    if token_only_prefill(cfg):
        proto = make_concrete_batch(cfg, "prefill", requests, prompt_len, prng.PRNGKey(seed + 1))
        prompts = proto["tokens"].numpy()
        program = DecodeProgram(prefill, decode, params, batch, prompt_len,
                                eos_id=cfg.eos_token_id, temperature=temperature,
                                rng=prng.PRNGKey(seed + 2))
        reqs = [ServeRequest(rid=i, client_id=i, inputs=prompts[i], steps=max_new)
                for i in range(requests)]
        results = ContinuousBatcher(program, batch, recorder=recorder).run(reqs)
        n_tok, prefill_calls = program.tokens_out, program.prefill_calls
    else:
        results, n_tok, prefill_calls = serve_waves(
            cfg, prefill, decode, params, requests=requests, batch=batch, prompt_len=prompt_len,
            max_new=max_new, temperature=temperature, seed=seed, device=dev, recorder=recorder,
            t0=t0)
    results = sorted(results, key=lambda r: r.rid)
    dt = time.time() - t0

    stats = latency_stats(results)
    if recorder is not None:
        stats["record"] = recorder.close(dict(stats, tokens=int(n_tok),
                                              tok_per_s=n_tok / max(dt, 1e-9)))
    stats.update(
        tokens=int(n_tok),
        tok_per_s=n_tok / max(dt, 1e-9),
        prefill_calls=prefill_calls,
        lens=[r.steps for r in results],
        outputs=[r.output for r in results],
        prefill_ms=prefill.ms(),
        decode_ms=decode.ms(),
        timer="cuda-events" if dev.type == "cuda" else "host",
        logits_finite=bool(prefill.finite & decode.finite),
        device=str(dev),
        peak_bytes_by_rank=_peak_bytes_by_rank(dev, mesh),
    )
    return stats


def _peak_bytes_by_rank(dev: torch.device, mesh) -> list[int] | None:
    """Each rank's peak allocated device memory, in rank order (one
    all-gather over the mesh); None on the CPU."""
    if dev.type != "cuda":
        return None
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev)], dtype=torch.int64, device=dev)
    if mesh is not None:
        peak = mesh.all_gather(peak, mesh.axis_names)
    return [int(v) for v in peak.tolist()]


def serve_waves(cfg: ModelConfig, prefill, decode, params, *, requests: int, batch: int,
                prompt_len: int, max_new: int, temperature: float, seed: int,
                device: torch.device, recorder, t0: float):
    """The JAX launcher's wave path, for an arch whose prefill batch holds
    more than tokens: the requests in order, ``batch`` at a time; each wave
    splits ``PRNGKey(seed + 2)``'s chain into (next, batch key, decode
    key), draws its batch with ``make_concrete_batch`` on ``device`` (the
    JAX launcher's jitted draw runs on its device too; the same bits as a
    host draw, ``prompt_len`` positions: under the vision stub its vision
    tokens and then text; for an encoder-decoder ``encoder_seq`` frames and
    ``min(prompt_len, max_decoder_seq)`` decoder tokens) and runs
    ``greedy_decode`` on it; the wave's
    requests start together and finish together. Returns
    (``ServeResult``s, tokens generated, waves), times relative to
    ``t0``."""
    rng = prng.PRNGKey(seed + 2)
    queue, results, n_tok, waves = list(range(requests)), [], 0, 0
    while queue:
        wave, queue = queue[:batch], queue[batch:]
        rng, sub, s_dec = prng.split(rng, 3)
        inputs = make_concrete_batch(cfg, "prefill", len(wave), prompt_len, sub.to(device))
        t_wave = time.time() - t0
        seqs, n_gen = greedy_decode(prefill, decode, params, inputs, max_new,
                                    eos_id=cfg.eos_token_id, temperature=temperature, rng=s_dec)
        t_fin = time.time() - t0
        waves += 1
        n_tok += int(n_gen.sum())
        for rid, out in zip(wave, seqs):
            res = ServeResult(rid=rid, client_id=rid, output=out, enqueue_s=0.0, start_s=t_wave,
                              finish_s=t_fin, steps=len(out))
            results.append(res)
            if recorder is not None:
                recorder.on_request(res)
    return results, n_tok, waves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record", default=None, metavar="DIR",
                    help="write a serve record (manifest/requests/trace) here")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh", default=None,
                    help="D,M: serve over a (data, model) mesh of D*M ranks, one process a rank "
                         "(torchrun --nproc-per-node D*M)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    run = dict(requests=args.requests, batch=args.batch, prompt_len=args.prompt_len,
               max_new=args.max_new, window=args.window, temperature=args.temperature,
               seed=args.seed, record=args.record)
    if not args.mesh:
        return _report(cfg, serve(cfg, device=args.device, **run), args.record)
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
            with ctx.mesh_context(mesh):
                stats = serve(cfg, device=dev, **run)
        finally:
            mesh.close()
        if mesh.rank == 0:
            _report(cfg, stats, args.record)
    finally:
        dist.destroy_process_group()
    return stats


def _report(cfg: ModelConfig, stats: dict, record: str | None) -> dict:
    """Print a serving run's summary; returns its stats."""
    mode = "continuous" if token_only_prefill(cfg) else "waves"
    print(f"{mode}: {stats['n_requests']} requests, lens {stats['lens']}, "
          f"{stats['prefill_calls']} prefills")
    print(f"prefill {statistics.median(stats['prefill_ms']):.3f} ms, decode step "
          f"{statistics.median(stats['decode_ms']):.3f} ms (medians, {stats['timer']}, "
          f"{stats['device']})")
    print(f"\nserved {stats['n_requests']} requests, {stats['tokens']} tokens in "
          f"{stats['wall_s']:.1f}s ({stats['tok_per_s']:.1f} tok/s, {stats['device']}); "
          f"latency p50 {stats['latency_p50_ms']:.1f} ms, p99 {stats['latency_p99_ms']:.1f} ms")
    if stats.get("peak_bytes_by_rank"):
        print(f"peak GiB by rank {[round(b / 2**30, 2) for b in stats['peak_bytes_by_rank']]}")
    if record:
        print("serve record:", stats["record"])
    return stats


if __name__ == "__main__":
    main()
