#!/usr/bin/env python
"""Time host-bound phases of ``chip_smoke.py`` for two or more checkouts
on one machine, each in a process of its own, in the order given (parent,
change, change, parent compares two commits within one call).

For each checkout: its kernels are built from its own sources, then
``phase_serve`` (granite-3-8b, falcon-mamba-7b) and ``phase_async`` of its
own ``chip_smoke.py`` run, and one line ``AB <checkout> {"granite-3-8b":
s, "falcon-mamba-7b": s, "async": s}`` gives each call's wall seconds
(each phase also prints its own lines). Needs a card.

Usage (checkouts unpacked with ``git archive`` under ``build/``):
    python3 tools/chip_ab.py build/parent build/change build/change build/parent
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

PHASES = ("granite-3-8b", "falcon-mamba-7b")


def one(tree: str) -> None:
    """Build and time the phases of the checkout at ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    os.chdir(tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import torch

    dev = torch.device("cuda")
    card = cs.phase_environment()
    cs.phase_build()
    out = {}
    for arch in PHASES:
        t0 = time.perf_counter()
        cs.phase_serve(dev, arch)
        out[arch] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    cs.phase_async(dev, card)
    out["async"] = round(time.perf_counter() - t0, 2)
    print(f"AB {os.path.basename(tree)} {json.dumps(out)}", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return 0
    rc = 0
    for tree in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
