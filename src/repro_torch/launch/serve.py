"""Batched serving entry point of the port: prefill queue + decode loop for a
decoder LM (falcon-mamba-7b, granite-3-8b, deepseek-moe-16b, moonshot-v1-16b-a3b,
deepseek-v2-lite-16b), with continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --requests 8 --batch 4 --prompt-len 64 --max-new 32 [--device cpu] \\
        [--record DIR]

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
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch import random as prng
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model, make_concrete_batch
from repro_torch.serve import (
    ContinuousBatcher,
    DecodeProgram,
    ServeRecorder,
    ServeRequest,
    latency_stats,
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
    record of the session (``stats["record"]`` names it)."""
    dev = resolve_device(device)
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
    proto = make_concrete_batch(cfg, "prefill", requests, prompt_len, prng.PRNGKey(seed + 1))
    prompts = proto["tokens"].numpy()
    program = DecodeProgram(prefill, decode, params, batch, prompt_len,
                            eos_id=cfg.eos_token_id, temperature=temperature,
                            rng=prng.PRNGKey(seed + 2))
    reqs = [ServeRequest(rid=i, client_id=i, inputs=prompts[i], steps=max_new)
            for i in range(requests)]
    results = sorted(ContinuousBatcher(program, batch, recorder=recorder).run(reqs),
                     key=lambda r: r.rid)
    dt = time.time() - t0

    stats = latency_stats(results)
    if recorder is not None:
        stats["record"] = recorder.close(dict(stats, tokens=int(program.tokens_out),
                                              tok_per_s=program.tokens_out / max(dt, 1e-9)))
    stats.update(
        tokens=int(program.tokens_out),
        tok_per_s=program.tokens_out / max(dt, 1e-9),
        prefill_calls=program.prefill_calls,
        lens=[r.steps for r in results],
        outputs=[r.output for r in results],
        prefill_ms=prefill.ms(),
        decode_ms=decode.ms(),
        timer="cuda-events" if dev.type == "cuda" else "host",
        logits_finite=bool(prefill.finite & decode.finite),
        device=str(dev),
    )
    return stats


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    stats = serve(cfg, requests=args.requests, batch=args.batch, prompt_len=args.prompt_len,
                  max_new=args.max_new, window=args.window, temperature=args.temperature,
                  seed=args.seed, device=args.device, record=args.record)
    print(f"continuous: {stats['n_requests']} requests, lens {stats['lens']}, "
          f"{stats['prefill_calls']} prefills")
    print(f"prefill {statistics.median(stats['prefill_ms']):.3f} ms, decode step "
          f"{statistics.median(stats['decode_ms']):.3f} ms (medians, {stats['timer']}, "
          f"{stats['device']})")
    print(f"\nserved {stats['n_requests']} requests, {stats['tokens']} tokens in "
          f"{stats['wall_s']:.1f}s ({stats['tok_per_s']:.1f} tok/s, {stats['device']}); "
          f"latency p50 {stats['latency_p50_ms']:.1f} ms, p99 {stats['latency_p99_ms']:.1f} ms")
    if args.record:
        print("serve record:", stats["record"])
    return stats


if __name__ == "__main__":
    main()
