"""Build the port's CUDA kernels with nvcc at first use and load them with
ctypes.

Each source under ``repro_torch/csrc/`` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) under ``build/repro_torch/`` at the repository root, named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags:
editing a source or a header rebuilds it, and a checkout builds everything
on its first kernel call. ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for all of them.

Flags: ``sm_90a`` (Hopper), C++17, ``-O3``, and no ``--use_fast_math``:
the kernels' parity contracts rest on IEEE division and rounding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCES = {
    "quantize": "quantize.cu",
    "masked_aggregate": "masked_aggregate.cu",
    "ssm_scan": "ssm_scan.cu",
    "ssm_scan_bwd": "ssm_scan_bwd.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_wgmma": "flash_attention_wgmma.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "flash_attention_bwd_wgmma": "flash_attention_bwd_wgmma.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parents[1] / "build" / "repro_torch"

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the
    PATH, or the toolkit's default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")


def library_path(name: str) -> Path:
    text = (CSRC / SOURCES[name]).read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None, verbose: bool = False) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` each, all started together. Returns the wall seconds each new
    build took (built ones are absent). ``verbose`` adds ``-Xptxas -v`` and
    prints the compiler's report (registers, shared memory, spills)."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    seconds = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        if verbose and log:
            print(f"[nvcc {name}]\n{log.rstrip()}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use and loaded once."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
