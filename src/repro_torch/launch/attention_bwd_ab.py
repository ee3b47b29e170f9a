"""A/B of the bf16 attention backward kernel against variants of its source,
on the card:

    PYTHONPATH=src python -m repro_torch.launch.attention_bwd_ab VARIANT.cu [VARIANT2.cu ...]

Each variant is a copy of ``csrc/flash_attention_bwd_wgmma.cu`` with one
design change (it includes ``csrc/hopper.cuh``, found with ``-I``). It is
built with the port's nvcc flags under ``build/``, and for each of
``chip_smoke.py``'s five backward shapes (granite-3-8b's layer, whisper-tiny's
encoder and cross-attention, deepseek-v2-lite's MLA and stablelm-12b at
B 1) the repository's kernel and the variant run in the order variant,
repository, repository, variant on the same inputs: the median ms of 20
eager calls each (CUDA events), and whether the two give equal bits. Two
versions are compared only inside one run, on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.kernels.flash_attention.ops import _attention

LIB = "flash_attention_bwd_wgmma"


def shapes() -> dict:
    """(B, S, T, H, Hkv, Dqk, Dv, causal) of chip_smoke.py's [train_kernels]."""
    gr, wh = get_config("granite-3-8b"), get_config("whisper-tiny")
    ds, sl = get_config("deepseek-v2-lite-16b"), get_config("stablelm-12b")
    return {
        "granite": (4, 2048, 2048, gr.n_heads, gr.n_kv_heads, gr.head_dim_, gr.head_dim_, True),
        "whisper_enc": (4, wh.encoder_seq, wh.encoder_seq, wh.n_heads, wh.n_kv_heads,
                        wh.head_dim_, wh.head_dim_, False),
        "whisper_cross": (4, wh.max_decoder_seq, wh.encoder_seq, wh.n_heads, wh.n_kv_heads,
                          wh.head_dim_, wh.head_dim_, False),
        "mla": (1, 2048, 2048, ds.n_heads, ds.n_heads, ds.qk_nope_dim + ds.qk_rope_dim,
                ds.v_head_dim, True),
        "stablelm": (1, 2048, 2048, sl.n_heads, sl.n_kv_heads, sl.head_dim_, sl.head_dim_, True),
    }


def build_variant(src: Path) -> ctypes.CDLL:
    out = build.BUILD_DIR / f"ab-{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out),
                    str(src)], check=True)
    return ctypes.CDLL(str(out))


def eager_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd_ab: no CUDA device")
    dev = torch.device("cuda")
    repo = build.load(LIB)
    libs = {"repo": repo, **{v.name: build_variant(v) for v in args.variants}}
    gen = torch.Generator(device=dev).manual_seed(24)
    for key, (b, s, t, h, hkv, dq, dv, causal) in shapes().items():
        q, k, v, dout = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                         for shape in ((b, s, h, dq), (b, t, hkv, dq), (b, t, hkv, dv),
                                       (b, s, h, dv)))
        out, lse = _attention(q, k, v, causal, 0, with_lse=True)

        def run():
            return flash_attention_bwd(q, k, v, out, lse, dout, causal)
        row = {}
        for name in args.variants:
            ms, grads = {"repo": [], name.name: []}, {}
            for which in (name.name, "repo", "repo", name.name):
                build._loaded[LIB] = libs[which]  # flash_attention_bwd types the entry once
                grads[which] = run()
                ms[which].append(eager_ms(run, args.reps))
            row[name.name] = {"ms": ms, "bitwise_equal": all(
                torch.equal(a, c) for a, c in zip(grads["repo"], grads[name.name]))}
        build._loaded[LIB] = repo
        print(f"[ab] {key} [B, S, T, H, Hkv, Dqk, Dv, causal] {[b, s, t, h, hkv, dq, dv, causal]}: "
              f"{json.dumps(row)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(f"[ab] {torch.cuda.get_device_name(0)}; {smi}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
