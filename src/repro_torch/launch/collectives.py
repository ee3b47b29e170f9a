"""Collective traffic of a ``torch.profiler`` trace — the counterpart of the
JAX package's ``launch/collectives.py``.

The JAX package sums the operand sizes of every collective in optimized
HLO. The port has no HLO: ``collective_bytes`` reads the Chrome trace that
``torch.profiler`` exports for a run recorded with ``record_shapes=True``.
Two kinds of events carry a collective's size there:

- ``record_param_comms`` (NCCL): its ``Collective name``, ``In msg
  nelems`` and ``dtype``;
- the backend's own annotation ``<backend>:<op>`` (gloo's
  ``gloo:all_reduce``; NCCL's ``nccl:all_reduce``): its ``Input Dims`` and
  ``Input type``.

A trace with any ``record_param_comms`` event is read from those alone
(NCCL records both kinds for one collective); otherwise from the
annotations. The sizes are the operand bytes each rank hands the
collective, what the JAX package's per-device sums count. Collectives
replayed inside a CUDA graph leave no host event, so trace an eager round.
The port has no HLO to read: the dry run (``launch/dryrun.py``) counts the
same operand bytes as ``launch.mesh``'s collectives report them
(``launch/cost_analysis.py``), and a traced run's sum here equals its
``collective_bytes`` (``chip_smoke.py``'s cross-silo world case).
"""

from __future__ import annotations

import json
import math
import os
from collections import defaultdict

__all__ = ["collective_breakdown_str", "collective_bytes"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# the traces' operation names -> the JAX package's kinds
_KINDS = {
    "allreduce": "all-reduce", "all_reduce": "all-reduce",
    "allgather": "all-gather", "all_gather": "all-gather", "_allgather_base": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather", "all_gather_into_tensor": "all-gather",
    "reduce_scatter": "reduce-scatter", "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all": "all-to-all", "alltoall": "all-to-all", "alltoall_base": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "broadcast": "broadcast",
}

_DTYPE_BYTES = {
    "float": 4, "float32": 4, "Float": 4, "double": 8, "float64": 8, "Double": 8,
    "c10::Half": 2, "half": 2, "float16": 2, "Half": 2,
    "c10::BFloat16": 2, "bfloat16": 2, "BFloat16": 2,
    "long int": 8, "int64": 8, "Long": 8, "int": 4, "int32": 4, "Int": 4,
    "short int": 2, "int16": 2, "Short": 2,
    "signed char": 1, "int8": 1, "Char": 1, "unsigned char": 1, "uint8": 1, "Byte": 1,
    "bool": 1, "Bool": 1,
}


def _events(trace) -> list:
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return [e for e in trace if isinstance(e, dict) and e.get("ph") == "X"]


def _kind(op: str) -> str:
    return _KINDS.get(op, op.replace("_", "-"))


def collective_bytes(trace) -> dict:
    """Returns {'total': bytes, per-op-kind: bytes, 'count': n_ops} of a
    torch.profiler Chrome trace (a path, the loaded JSON, or its event
    list), kinds named as in the JAX package (``all-reduce``, ...)."""
    events = _events(trace)
    comms = [e for e in events if e.get("name") == "record_param_comms"]
    out: dict = defaultdict(int)
    count = 0
    if comms:
        for e in comms:
            args = e.get("args", {})
            name = str(args.get("Collective name", ""))
            if not name or name in ("init", "barrier", "wait"):
                continue
            size = int(args.get("In msg nelems", 0)) * _DTYPE_BYTES.get(str(args.get("dtype")), 4)
            out[_kind(name)] += size
            out["total"] += size
            count += 1
    else:
        for e in events:
            backend, _, op = str(e.get("name", "")).partition(":")
            if backend not in ("gloo", "nccl", "mpi", "ucc") or op not in _KINDS:
                continue
            args = e.get("args", {})
            dims, types = args.get("Input Dims", []), args.get("Input type", [])
            size = sum(math.prod(d) * _DTYPE_BYTES.get(str(t), 4)
                       for d, t in zip(dims, types) if isinstance(d, list))
            out[_kind(op)] += size
            out["total"] += size
            count += 1
    out["count"] = count
    return dict(out)


def collective_breakdown_str(stats: dict) -> str:
    parts = [f"total={stats.get('total', 0)/1e6:.1f}MB ops={stats.get('count', 0)}"]
    for k in _COLLECTIVES:
        if stats.get(k):
            parts.append(f"{k}={stats[k]/1e6:.1f}MB")
    return " ".join(parts)
