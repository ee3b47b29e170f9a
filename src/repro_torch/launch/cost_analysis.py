"""Per-rank cost analysis of one step — the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

The JAX package compiles a step and reads the optimized HLO: it sums
``2*M*N*K`` over every dot (loop bodies times their trip counts), an HBM
traffic model over the materialized instructions, and the operand bytes of
every collective. The port has no compiler and no HLO. It runs the step
itself, eagerly, and counts what it dispatches: ``CostCounter`` is a
``TorchDispatchMode`` that sees every aten op of the step (the backward's
and ``torch.utils.checkpoint``'s recompute included), and the kernels'
wrappers and the mesh's collectives report to it (``repro_torch.cost``).
Under a ``FakeTensorMode`` (``launch/dryrun.py``) nothing runs and nothing
is allocated, so a step at the production shapes is counted on any host.

Terms, per rank (one process of the mesh):

  flops            — 2*M*N*K for every product the step dispatches
                     (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
                     ``dot``; a convolution 2 * output elements * kernel
                     elements a channel), plus each hand-written kernel's
                     own products as its wrapper reports them
                     (``kernel_flops`` keeps those apart, by kernel)
  bytes            — operand plus output bytes of every dispatched op that
                     is not a view or an allocation, and of every kernel
                     launch. Eager PyTorch fuses nothing, so this is larger
                     than the JAX package's count of the same step, which
                     charges a fusion's reads and writes once
  peak_bytes       — the most bytes of live storage at once through the
                     step: the arguments, every tensor the step makes while
                     it lives (saved activations and recomputed ones
                     included), freed when its storage is
  collective_bytes — the operand bytes each rank hands its collectives,
                     ``collectives`` by the JAX package's kinds
                     (``all-reduce``, ``all-gather``, ``reduce-scatter``),
                     as ``launch.mesh`` reports them, and ``link_bytes``
                     the same bytes by the link they cross: ``nvlink``
                     for a group within one host, ``network`` across hosts;
                     ``wire_bytes`` by kind what a ring algorithm sends
                     from the rank for them (``repro_torch.cost``)
  launches         — kernel launches by kernel, as the wrappers report them
  row_recompute_flops — the share of ``flops`` that ``launch/tp.py``'s
                     row products spend again in ``torch.utils.checkpoint``'s
                     recompute: a custom autograd Function runs its whole
                     forward there, where XLA's remat drops a product whose
                     output the backward does not read
  recompute_collectives — the share of ``collectives``, by kind, that the
                     same recompute runs again: a block's forward
                     collectives (ZeRO's gathers, TP's sums, a
                     sequence-parallel stream's gathers and reduce-scatters)
                     up to the last one whose output the backward reads

``analyze(fn, *args)`` runs ``fn(*args)`` under a counter and returns those
terms with the JAX package's keys.
"""

from __future__ import annotations

import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.cost import SINKS, tensor_bytes

__all__ = ["CostCounter", "analyze", "storage_bytes"]

_aten = torch.ops.aten
_PRODUCTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm, _aten.mv, _aten.dot, _aten.addmv,
             _aten.addbmm}
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
                _aten.new_empty_strided}
_CONVOLUTIONS = {_aten.convolution, _aten.convolution_backward}


def storage_bytes(tensors) -> int:
    """The bytes of the distinct storages behind ``tensors`` (a pytree)."""
    seen, total = set(), 0
    for t in tree_flatten(tensors)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


def _product_flops(func, args, out) -> float:
    """2*M*N*K of one product op (the output's elements times twice the
    contracted length)."""
    packet = func.overloadpacket
    if packet in (_aten.addmm, _aten.baddbmm, _aten.addmv, _aten.addbmm):
        a = args[1]
    else:
        a = args[0]
    k = a.shape[-1] if packet not in (_aten.dot,) else a.shape[0]
    if packet is _aten.addbmm:
        return 2.0 * out.numel() * k * a.shape[0]
    return 2.0 * out.numel() * k


def _conv_flops(func, args, out) -> float:
    """2 * output elements * the kernel's elements a channel group (the
    JAX package's rule for a convolution), for the forward; the backward's
    two products are counted as two such."""
    if func.overloadpacket is _aten.convolution:
        w = args[1]
        return 2.0 * out.numel() * math.prod(w.shape[1:])
    grad, _, w = args[0], args[1], args[2]
    return 2.0 * 2.0 * grad.numel() * math.prod(w.shape[1:])


class CostCounter(TorchDispatchMode):
    """Counts one step's costs (module docstring) while it is open.
    ``track(tensors)`` marks tensors made before the counter opened (the
    step's arguments) as live, so the peak starts from them."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.launches: dict = defaultdict(int)
        self.kernel_flops: dict = defaultdict(float)
        self.kernel_bytes: dict = defaultdict(float)
        self.collectives: dict = defaultdict(float)
        self.collective_count: dict = defaultdict(int)
        self.wire_bytes: dict = defaultdict(float)
        self.link_bytes: dict = defaultdict(float)
        self.row_recompute_flops = 0.0
        self.recompute_collectives: dict = defaultdict(float)
        self.live = 0
        self.peak = 0
        self._refs: dict = {}

    def track(self, tensors) -> int:
        """Mark the storages behind ``tensors`` live; returns the bytes
        added."""
        added = 0
        for t in tree_flatten(tensors)[0]:
            if isinstance(t, torch.Tensor):
                added += self._see(t.untyped_storage())
        return added

    def _see(self, st) -> int:
        key = id(st)
        if key in self._refs:
            return 0
        n = st.nbytes()

        def freed(_, key=key, n=n):
            if self._refs.pop(key, None) is not None:
                self.live -= n

        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def __enter__(self):
        SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        SINKS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if packet in _PRODUCTS:
            self.flops += _product_flops(func, args, outs[0])
        elif packet in _CONVOLUTIONS:
            self.flops += _conv_flops(func, args, outs[0])
        if not func.is_view and packet not in _ALLOCATIONS:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes += tensor_bytes(*ins, *outs)
        for t in outs:
            self._see(t.untyped_storage())
        return out

    def result(self) -> dict:
        """The terms with the JAX package's keys, plus ``peak_bytes``,
        ``launches``, ``kernel_flops``, ``collective_count``, ``wire_bytes``, ``link_bytes``,
        ``row_recompute_flops`` and ``recompute_collectives``."""
        return {
            "flops": self.flops + sum(self.kernel_flops.values()),
            "bytes": self.bytes + sum(self.kernel_bytes.values()),
            "collective_bytes": float(sum(self.collectives.values())),
            "collectives": {k: float(v) for k, v in self.collectives.items()},
            "collective_count": dict(self.collective_count),
            "wire_bytes": {k: float(v) for k, v in self.wire_bytes.items()},
            "link_bytes": {k: float(v) for k, v in self.link_bytes.items()},
            "peak_bytes": int(self.peak),
            "launches": dict(self.launches),
            "kernel_flops": {k: float(v) for k, v in self.kernel_flops.items()},
            "row_recompute_flops": self.row_recompute_flops,
            "recompute_collectives": {k: float(v) for k, v in self.recompute_collectives.items()},
        }


def analyze(fn, *args, held=None, **kwargs) -> tuple[dict, object]:
    """``(terms, fn's result)`` of ``fn(*args, **kwargs)`` run under a
    ``CostCounter``. ``args`` and ``held`` (a pytree of the tensors behind
    arguments the pytree cannot see into, such as a module's parameters)
    count as live from the start: ``terms["argument_bytes"]`` is their
    storage, ``terms["output_bytes"]`` the storage of the result that is
    not an argument's."""
    counter = CostCounter()
    arg_bytes = counter.track((args, kwargs, held))
    arg_ids = {id(t.untyped_storage()) for t in tree_flatten((args, kwargs, held))[0]
               if isinstance(t, torch.Tensor)}
    with counter:
        out = fn(*args, **kwargs)
    terms = counter.result()
    seen, out_bytes = set(), 0
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in arg_ids and id(st) not in seen:
                seen.add(id(st))
                out_bytes += st.nbytes()
    terms["argument_bytes"] = int(arg_bytes)
    terms["output_bytes"] = int(out_bytes)
    return terms, out
