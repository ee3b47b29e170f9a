"""What the kernels' wrappers and the mesh's collectives report to a cost
counter (``launch/cost_analysis.CostCounter``) while one is open: nothing
is recorded when none is.

``is_fake(t)`` tells a dry run's ``FakeTensor`` (a shape, dtype and device
with no memory behind it) from a real tensor; a wrapper given one takes its
fake branch and calls ``record_launch`` in place of its kernel.
``record_collective`` is called by every collective of ``launch/mesh.py``,
real or fake, with whether its group stays within one host's NVLink
domain. The bytes of a launch are its tensors' bytes: each input read
once, each output written once.
"""

from __future__ import annotations

__all__ = ["SINKS", "is_fake", "record_collective", "record_launch", "record_recompute_collective",
           "record_row_recompute", "tensor_bytes"]

SINKS: list = []  # the counters open now, innermost last


def is_fake(t) -> bool:
    """Whether ``t`` is a ``FakeTensor``: a dry run's tensor."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def tensor_bytes(*tensors) -> int:
    """The bytes of ``tensors``' elements (None: nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def record_launch(name: str, flops: float, *tensors) -> None:
    """One launch of kernel ``name``: its products' flops, and the bytes of
    ``tensors`` (its inputs and outputs, None skipped), for every open
    counter."""
    if not SINKS:
        return
    n_bytes = float(tensor_bytes(*tensors))
    for sink in SINKS:
        sink.launches[name] += 1
        sink.kernel_flops[name] += float(flops)
        sink.kernel_bytes[name] += n_bytes


_RING = {"all-reduce": lambda n: 2.0 * (n - 1) / n, "reduce-scatter": lambda n: (n - 1) / n,
         "all-gather": lambda n: float(n - 1)}


def record_collective(kind: str, n_bytes: float, within_host: bool = True,
                      n_ranks: int = 1) -> None:
    """One collective of ``kind`` (the JAX package's name) over operands of
    ``n_bytes`` on this rank, over a group of ``n_ranks`` within one host
    (NVLink) or across hosts (the network), for every open counter; its
    wire bytes are what a ring sends from this rank: 2 (n-1)/n of the
    operand for an all-reduce, (n-1)/n for a reduce-scatter, (n-1) times
    the rank's block for an all-gather."""
    for sink in SINKS:
        sink.collectives[kind] += float(n_bytes)
        sink.wire_bytes[kind] += _RING[kind](n_ranks) * float(n_bytes)
        sink.collective_count[kind] += 1
        sink.link_bytes["nvlink" if within_host else "network"] += float(n_bytes)


def record_row_recompute(flops: float) -> None:
    """A tensor-parallel row product run again in a checkpoint's
    recompute (its flops are dispatched and counted as well)."""
    for sink in SINKS:
        sink.row_recompute_flops += float(flops)


def record_recompute_collective(kind: str, n_bytes: float) -> None:
    """A collective of a block's forward run again in a checkpoint's
    recompute (``record_collective`` reports its bytes as well)."""
    for sink in SINKS:
        sink.recompute_collectives[kind] += float(n_bytes)
