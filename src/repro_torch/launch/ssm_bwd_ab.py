"""A/B of the selective scan's backward kernel against variants of its
source, on the card:

    PYTHONPATH=src python -m repro_torch.launch.ssm_bwd_ab VARIANT.cu [VARIANT2.cu ...]

Each variant is a copy of ``csrc/ssm_scan_bwd.cu`` with one design change
(the same C entries: ``repro_ssm_scan_bwd``, ``_block_channels`` and
``_occupancy``). It is built with the port's nvcc
flags under ``build/`` (its ptxas report printed), and for each of three
shapes — falcon-mamba-7b's layer at ``chip_smoke.py``'s S 2,048 and ragged
1,999 (B 4, di 8,192, ds 16) and the same layer at the reduced configs'
d_state 8 — the repository's kernel and the variant run in the order
variant, repository, repository, variant on the same bf16 inputs (the
forward kernel's chunk states, ``chip_smoke.py``'s distributions): the
median ms of 20 eager calls each (CUDA events), and whether the two give
equal bits. Two versions are compared only inside one run, on one card.
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
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
from repro_torch.kernels.ssm_scan.ops import ssm_scan_bwd_occupancy

LIB = "ssm_scan_bwd"
BATCH, SEQ, RAGGED = 4, 2048, 49  # chip_smoke.py's SERVE_RUN batch and prompt_len, S - 49


def shapes() -> dict:
    """(B, S, di, ds) of each A/B shape: chip_smoke.py's two [train_kernels]
    shapes, then falcon-mamba-7b's layer at d_state 8."""
    fm = get_config("falcon-mamba-7b")
    return {"falcon": (BATCH, SEQ, fm.d_inner, fm.d_state),
            "falcon_ragged": (BATCH, SEQ - RAGGED, fm.d_inner, fm.d_state),
            "falcon_ds8": (BATCH, SEQ, fm.d_inner, 8)}


def build_variant(src: Path) -> ctypes.CDLL:
    out = build.BUILD_DIR / f"ab-{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                          str(src)], check=True, capture_output=True, text=True)
    print(f"[ab] ptxas {src.name}:\n{log.stdout}{log.stderr}".rstrip(), flush=True)
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


def inputs(b: int, s: int, di: int, ds: int, dev: torch.device, seed: int = 25):
    """The backward's arguments at (b, s, di, ds), bf16 streams, as
    ``chip_smoke.py`` draws them: dt a softplus near 0.01, A = -exp(randn),
    the forward kernel's chunk states, a bf16 y's float32 cotangent."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    a, d = -torch.exp(randn(di, ds)), randn(di)
    dt, bm, cm, x = (t.to(torch.bfloat16) for t in (
        torch.nn.functional.softplus(randn(b, s, di) * 0.5 - 4.6), randn(b, s, ds),
        randn(b, s, ds), randn(b, s, di)))
    args = (dt, a, bm, cm, x, d)
    _, _, hs = ssm_scan(*args, y_dtype=torch.bfloat16, chunk_states=True)
    gy = randn(b, s, di).to(torch.bfloat16).float()
    return (*args, hs, gy)


def occupancy(lib) -> dict:
    build._loaded[LIB] = lib
    return {f"{'bf16' if dt is torch.bfloat16 else 'f32'} ds{ds}": ssm_scan_bwd_occupancy(ds, dt)
            for dt in (torch.float32, torch.bfloat16) for ds in (8, 16)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssm_bwd_ab: no CUDA device")
    dev = torch.device("cuda")
    repo = build.load(LIB)
    libs = {"repo": repo, **{v.name: build_variant(v) for v in args.variants}}
    for name, lib in libs.items():
        print(f"[ab] occupancy {name}: {json.dumps(occupancy(lib))}", flush=True)
    for key, (b, s, di, ds) in shapes().items():
        ins = inputs(b, s, di, ds, dev)

        def run():
            return ssm_scan_bwd(*ins)
        row = {}
        for name in args.variants:
            ms, grads = {"repo": [], name.name: []}, {}
            for which in (name.name, "repo", "repo", name.name):
                build._loaded[LIB] = libs[which]  # ssm_scan_bwd types the entry once
                grads[which] = run()
                ms[which].append(eager_ms(run, args.reps))
            row[name.name] = {"ms": ms, "bitwise_equal": all(
                torch.equal(a, c) for a, c in zip(grads["repo"], grads[name.name]))}
        build._loaded[LIB] = repo
        print(f"[ab] {key} [B, S, di, ds] {[b, s, di, ds]}: {json.dumps(row)}", flush=True)
        del ins
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(f"[ab] {torch.cuda.get_device_name(0)}; {smi}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
