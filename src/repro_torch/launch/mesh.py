"""The meshes of the port — the port of the JAX package's
``launch/mesh.py`` (``make_production_mesh``, ``make_cohort_mesh``,
``data_axes``).

The JAX package's 1-D ``cohort`` mesh is a set of devices that one
``shard_map`` program spans. Here it is the ranks of a ``torch.distributed``
process group, one process a rank: ``CohortMesh`` names the group, this
process's rank, the world size D, the rank's device and the backend, and
issues the sharded round's collectives (``all_reduce``). The sharded FL
round (``repro_torch.fl.shard``) runs on it.

A world of D > 1 is started from outside, one process a rank
(``torchrun --nproc-per-node D`` or ``torch.multiprocessing.spawn`` with
``init_process_group``); a world of 1 with no group opens its own, over a
``FileStore`` in a temporary directory (gloo on the CPU, NCCL on the card),
and ``CohortMesh.close`` removes it.

The production mesh (``make_production_mesh``: ``data`` x ``model``, and
``pod`` for two pods) and its dev-scale shapes (``make_rank_mesh``) are a
``RankMesh``: the ranks of the world laid out row-major over named axes, as
``jax.make_mesh`` lays out its devices, rank r at coordinates
``coords``. It makes one process group per set of axes asked for (the
``model`` group: the ranks that share every other coordinate; the data
group: those that share the ``model`` one), on every rank in the same
order. ``launch.context.mesh_context`` opens it for the model code: the
expert-parallel MoE sums its partial outputs over the ``model`` group and
the decoder's steps gather their logits over the data group.

Training runs its collectives under autograd through six functions:
``gather_blocks`` (an all-gather whose backward is a reduce-scatter: a
ZeRO block of a leaf at use, ``launch/zero.py``; a sequence-parallel
stream entering a block of which every use is a rank's share),
``gather_slices`` (an all-gather whose backward keeps this rank's slice of
the gradient: a tensor-parallel column split made whole, or a
sequence-parallel stream made whole, whose gradient every rank holds
alike), ``psum`` (an all-reduce whose backward is the identity: the
expert-parallel MoE's partial outputs, a row-split product's partials),
``replicated`` (the identity whose backward is an all-reduce: the MoE's
tokens and gates, of which each ``model`` rank uses its experts' share,
and a tensor-parallel block's input), ``scatter_sum`` (a reduce-scatter
whose backward is an all-gather: a row product's partials summed into a
sequence-parallel stream) and ``split`` (this rank's block, no
collective, whose backward is an all-gather: a whole stream entering a
sequence-parallel one). Under ``torch.no_grad`` (serving) each is the
plain collective, or nothing for ``replicated``. A collective that fails
raises; none falls back to a local result. ``RankMesh``'s ``all_gather``
and ``reduce_scatter`` copy a tensor once to lay the ranks' blocks of a
dim one after another (not at all along the leading dim or a (1, S, D)
stream's sequence).

Every collective of a mesh (``CohortMesh.all_reduce``, ``RankMesh``'s
``all_reduce``, ``all_gather`` and ``reduce_scatter``, which the
functions above call, forward and backward) reports its operand bytes on
this rank, keyed by the JAX package's kinds, and whether its group lies
within one host of ``HW["gpus_per_host"]`` ranks (NVLink) or spans hosts
(the network), to the open cost counters (``repro_torch.cost``); a
forward that ``torch.utils.checkpoint`` runs again in the backward reports
its collective once more as a recompute.

``fake_world(size, rank)`` opens a world of ``size`` ranks as rank
``rank`` over torch's fake process group, whose collectives move nothing:
a dry run (``launch/dryrun.py``) builds the production mesh in it and
traces one rank's step on fake tensors. It never serves a real run.

``HW`` holds the H100 SXM's data-sheet figures, for the dry run's roofline
terms (the JAX module's table holds a TPU's and is not carried over).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.cost import record_collective, record_recompute_collective, tensor_bytes

__all__ = ["HW", "CohortMesh", "RankMesh", "data_axes", "fake_world", "gather_blocks",
           "gather_slices", "make_cohort_mesh", "make_production_mesh", "make_rank_mesh", "psum",
           "rank_device", "replicated", "scatter_sum", "split", "within_host"]

# NVIDIA H100 SXM5 80 GB data sheet (700 W): dense bf16 tensor-core rate,
# HBM3 rate, and NVLink 4's 900 GB/s a GPU (both directions; 450 GB/s each
# way), the rate a collective's operand bytes move at between the cards of
# one host. Across hosts they move over the network: the DGX H100 data
# sheet's eight single-port ConnectX-7 400 Gb/s adapters, one a GPU, so
# 50 GB/s a GPU each way, in hosts of 8 GPUs. Data-sheet figures, not
# measurements.
HW = {
    "device": "NVIDIA H100 80GB HBM3",
    "peak_flops_bf16": 989e12,   # FLOP/s
    "peak_flops_fp32": 67e12,    # FLOP/s, CUDA cores
    "hbm_bw": 3.35e12,           # B/s
    "link_bw": 450e9,            # B/s each way, NVLink 4 (18 links), within a host
    "network_bw": 50e9,          # B/s each way, one ConnectX-7 (400 Gb/s) a GPU, across hosts
    "gpus_per_host": 8,
    "hbm_bytes": 80e9,           # B
    "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5 column; NVIDIA DGX H100 data sheet",
}


def within_host(ranks) -> bool:
    """Whether the world ranks ``ranks`` lie in one host of
    ``HW["gpus_per_host"]`` consecutive ranks (their collectives cross
    NVLink only)."""
    return len({r // HW["gpus_per_host"] for r in ranks}) <= 1


class CohortMesh:
    """A 1-D ``cohort`` axis over the ranks of a process group.

    ``group`` is the process group (None: the default one), ``rank`` this
    process's rank in it, ``world`` its size D, ``device`` the device this
    rank computes on, ``backend`` ``"gloo"`` or ``"nccl"``. ``shape``,
    ``axis_names`` and ``size`` read like the JAX mesh's."""

    axis_names = ("cohort",)

    def __init__(self, group, rank: int, world: int, device: torch.device, backend: str,
                 store_dir: str | None = None):
        self.group = group
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.backend = str(backend)
        self._store_dir = store_dir  # set when this mesh opened the group itself

    @property
    def shape(self) -> dict:
        return {"cohort": self.world}

    @property
    def size(self) -> int:
        return self.world

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives: NCCL's
        can; gloo copies CUDA tensors through the host and cannot."""
        return self.backend == "nccl"

    def all_reduce(self, buf: torch.Tensor) -> torch.Tensor:
        """Sum ``buf`` over the ranks, in place (one collective)."""
        record_collective("all-reduce", tensor_bytes(buf), within_host(range(self.world)),
                          self.world)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf

    def close(self) -> None:
        """Destroy the world-1 group this mesh opened (nothing for a group
        the caller started)."""
        _close_world_of_one(self._store_dir)
        self._store_dir = None

    def __repr__(self) -> str:
        return (f"CohortMesh(cohort={self.world}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend!r})")


class RankMesh:
    """The world's ranks over named axes: ``shape`` maps each axis name to
    its size (so the ``launch/sharding.py`` rules take the mesh as they
    take a JAX one), rank r sits at ``coords``, r's row-major digits over
    the axes, and computes on ``device``. ``group(axes)`` is the process
    group of the ranks that differ from this one only along ``axes``."""

    def __init__(self, axis_names, sizes, rank: int, device: torch.device, backend: str,
                 store_dir: str | None = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in sizes)))
        self.world = math.prod(self.shape.values())
        self.rank = int(rank)
        self.coords = dict(zip(self.axis_names, _digits(self.rank, self.shape.values())))
        self.device = torch.device(device)
        self.backend = str(backend)
        self._store_dir = store_dir  # set when this mesh opened the world-1 group itself
        self._groups: dict = {}
        self._within_host: dict = {}  # by axes: this rank's group within one host
        self.group(("model",))
        self.group(tuple(a for a in self.axis_names if a != "model"))

    @property
    def size(self) -> int:
        return self.world

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh axes {self.axis_names} have no {unknown}")
        return tuple(a for a in self.axis_names if a in axes)  # the mesh's order

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group along ``axes``: the ranks whose coordinates
        off ``axes`` are this rank's, ordered by their index over ``axes``.
        Made on first use; every rank makes every such group, in the same
        order, so every rank must ask for the same axes in the same order."""
        axes = self._axes(axes)
        if axes not in self._groups:
            strides = {a: math.prod(list(self.shape.values())[i + 1:])
                       for i, a in enumerate(self.axis_names)}
            other = [a for a in self.axis_names if a not in axes]
            mine = None
            for fixed in itertools.product(*(range(self.shape[a]) for a in other)):
                base = sum(c * strides[a] for a, c in zip(other, fixed))
                ranks = [base + sum(c * strides[a] for a, c in zip(axes, along))
                         for along in itertools.product(*(range(self.shape[a]) for a in axes))]
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = g
                    self._within_host[axes] = within_host(ranks)
            self._groups[axes] = mine
        return self._groups[axes]

    def all_reduce(self, buf: torch.Tensor, axes="model") -> torch.Tensor:
        """Sum ``buf`` over the ranks along ``axes``, in place (one
        collective)."""
        group = self.group(axes)
        record_collective("all-reduce", tensor_bytes(buf), self._within_host[self._axes(axes)],
                          self.axis_size(axes))
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf

    def axis_size(self, axes) -> int:
        """The number of ranks along ``axes``."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` along ``axes``, concatenated on ``dim`` in
        their order (one collective). The ranks' blocks arrive one after
        another, so the result is copied once to put them on ``dim`` (not
        at all where the dims before ``dim`` hold one element: a leading
        dim, or a (1, S, D) stream's sequence)."""
        dim %= t.ndim
        n = self.axis_size(axes)
        x = t.contiguous()
        out = x.new_empty((n * x.numel(),))
        group = self.group(axes)
        record_collective("all-gather", tensor_bytes(x), self._within_host[self._axes(axes)], n)
        dist.all_gather_into_tensor(out, x.view(-1), group=group)
        shape = (*t.shape[:dim], n * t.shape[dim], *t.shape[dim + 1:])
        blocks = out.view(n, *t.shape)
        if math.prod(t.shape[:dim]) == 1:
            return blocks.view(shape)
        return blocks.movedim(0, dim).reshape(shape)

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """``t`` summed over the ranks along ``axes``, and of the sum this
        rank's block of ``dim``: block i of n equal ones for the rank at
        index i over ``axes`` (one collective). The blocks are laid one
        after another first: one copy of ``t`` (none where the dims before
        ``dim`` hold one element)."""
        dim %= t.ndim
        n = self.axis_size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} over {n} ranks")
        size = t.shape[dim] // n
        x = t.reshape(*t.shape[:dim], n, size, *t.shape[dim + 1:]).movedim(dim, 0).contiguous()
        out = x.new_empty((*t.shape[:dim], size, *t.shape[dim + 1:]))
        group = self.group(axes)
        record_collective("reduce-scatter", tensor_bytes(x), self._within_host[self._axes(axes)],
                          n)
        dist.reduce_scatter_tensor(out.view(-1), x.view(-1), op=dist.ReduceOp.SUM, group=group)
        return out

    def close(self) -> None:
        """Destroy the groups this mesh made, and the world-1 group it
        opened (nothing of a world the caller started)."""
        if dist.is_initialized():
            for g in self._groups.values():
                if g is not None:
                    dist.destroy_process_group(g)
        self._groups, self._within_host = {}, {}
        _close_world_of_one(self._store_dir)
        self._store_dir = None

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return (f"RankMesh({axes}, rank={self.rank} at {self.coords}, device={self.device}, "
                f"backend={self.backend!r})")


# ---------------------------------------------------------------------------
# collectives under autograd (training under a RankMesh)
# ---------------------------------------------------------------------------


def _noted(kind: str, t: torch.Tensor) -> None:
    """Report the collective an autograd Function's forward is about to
    run over ``t`` to the open cost counters as a recompute where that
    forward runs inside the backward: ``torch.utils.checkpoint``'s
    recompute of a block."""
    if torch._C._current_graph_task_id() != -1:
        record_recompute_collective(kind, tensor_bytes(t))


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mesh, axes, dim):
        fctx.mesh, fctx.axes, fctx.dim = mesh, axes, dim
        _noted("all-gather", t)
        return mesh.all_gather(t, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return fctx.mesh.reduce_scatter(g, fctx.axes, fctx.dim), None, None, None


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mesh, axes, dim):
        fctx.mesh, fctx.axes, fctx.dim, fctx.size = mesh, axes, dim, t.shape[dim]
        _noted("all-gather", t)
        return mesh.all_gather(t, axes, dim)

    @staticmethod
    def backward(fctx, g):
        i = fctx.mesh.index(fctx.axes)
        return g.narrow(fctx.dim, i * fctx.size, fctx.size).contiguous(), None, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mesh, axes, dim, dtype):
        fctx.mesh, fctx.axes, fctx.dim, fctx.dtype = mesh, axes, dim, t.dtype
        _noted("reduce-scatter", t)
        return mesh.reduce_scatter(t, axes, dim).to(dtype)

    @staticmethod
    def backward(fctx, g):  # gathered in the output's dtype, then cast to the input's
        return fctx.mesh.all_gather(g, fctx.axes, fctx.dim).to(fctx.dtype), None, None, None, None


def _block_of(mesh, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of ``t`` (block i of n equal ones at
    index i over ``axes``), a copy."""
    size = t.shape[dim] // mesh.axis_size(axes)
    return t.narrow(dim, mesh.index(axes) * size, size).clone(memory_format=torch.contiguous_format)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mesh, axes, dim):
        fctx.mesh, fctx.axes, fctx.dim = mesh, axes, dim
        return _block_of(mesh, t, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return fctx.mesh.all_gather(g, fctx.axes, fctx.dim), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mesh, axes):
        _noted("all-reduce", t)
        return mesh.all_reduce(t.clone(), axes)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mesh, axes):
        fctx.mesh, fctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(fctx, g):
        return fctx.mesh.all_reduce(g.clone(), fctx.axes), None, None


def gather_blocks(mesh: RankMesh, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The whole of a leaf split over ``axes`` on ``dim`` from this rank's
    block ``t`` (an all-gather); its backward sums the whole leaf's gradient
    over those ranks and keeps this rank's block (a reduce-scatter)."""
    if not torch.is_grad_enabled():  # serving: no autograd node
        return mesh.all_gather(t, axes, dim)
    return _GatherBlocks.apply(t, mesh, axes, dim)


def gather_slices(mesh: RankMesh, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axes``, concatenated on ``dim`` (an
    all-gather); its backward keeps this rank's slice of the gradient and
    sums nothing: the gradient of a whole tensor that every rank along
    ``axes`` then uses alike is the same on each, so a reduce-scatter
    (``gather_blocks``' backward) would multiply it by their number."""
    if not torch.is_grad_enabled():
        return mesh.all_gather(t, axes, dim)
    return _GatherSlices.apply(t, mesh, axes, dim)


def scatter_sum(mesh: RankMesh, t: torch.Tensor, axes, dim: int,
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """``t`` summed over the ranks along ``axes``, of which this rank keeps
    its block of ``dim`` (a reduce-scatter), cast to ``dtype`` (default
    ``t``'s); its backward all-gathers the blocks' gradients, in ``dtype``,
    which every rank then holds alike, and casts them to ``t``'s dtype: a
    row product's float32 partials summed into a bf16 sequence-parallel
    stream (``launch/tp.py``), whose gradients cross the wire in bf16 (the
    gradient of a cast to bf16 is bf16's values: exact)."""
    dtype = dtype or t.dtype
    if not torch.is_grad_enabled():
        return mesh.reduce_scatter(t, axes, dim).to(dtype)
    return _ScatterSum.apply(t, mesh, axes, dim, dtype)


def split(mesh: RankMesh, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of ``t``, which every rank along
    ``axes`` holds alike (a copy, no collective); its backward all-gathers
    the blocks' gradients, so that what made ``t`` gets the whole gradient
    on every rank alike: a whole stream entering a sequence-parallel one
    (``launch/tp.py``)."""
    if not torch.is_grad_enabled():
        return _block_of(mesh, t, axes, dim)
    return _Split.apply(t, mesh, axes, dim)


def psum(mesh: RankMesh, t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` summed over the ranks along ``axes`` (an all-reduce), with the
    identity for its backward: JAX's ``psum`` under ``check_vma=False``,
    whose result every rank along ``axes`` then uses alike. Under
    ``torch.no_grad`` (serving) it sums ``t`` in place and returns it."""
    if not torch.is_grad_enabled():
        return mesh.all_reduce(t, axes)
    return _Psum.apply(t, mesh, axes)


def replicated(mesh: RankMesh, t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` itself, whose gradient is summed over the ranks along ``axes``
    (an all-reduce in the backward): the transpose of a ``shard_map`` input
    that every rank along ``axes`` holds alike, which JAX sums over the
    axes its spec leaves out. A rank that uses ``t`` for its share of a
    sum (its experts) gets the gradient of the whole sum."""
    if not torch.is_grad_enabled():
        return t
    return _Replicated.apply(t, mesh, axes)


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A world of ``size`` ranks, this process rank ``rank``, over torch's
    fake process group (``torch.testing._internal.distributed.fake_pg``):
    every collective returns at once and moves nothing, so one process
    traces one rank's step of a mesh of any size (a dry run). Raises if a
    process group is already open (a real world must not meet a fake one);
    destroys the fake group on exit."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers "fake")

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already open in this process; a "
                           "dry run traces in a process of its own")
    dist.init_process_group("fake", store=dist.HashStore(), rank=int(rank),
                            world_size=int(size))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _open_world_of_one(backend: str) -> str:
    """Open a world-1 process group over a ``FileStore`` in a new temporary
    directory; returns the directory."""
    store_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                            rank=0, world_size=1)
    return store_dir


def _close_world_of_one(store_dir: str | None) -> None:
    """Destroy the group ``_open_world_of_one`` opened and remove its
    directory (nothing for None)."""
    if store_dir is not None:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)


def _digits(r: int, sizes) -> list[int]:
    out = []
    for n in reversed(list(sizes)):
        out.append(r % n)
        r //= n
    return out[::-1]


def make_rank_mesh(shape, axes=("data", "model"), device=None, backend: str | None = None
                   ) -> RankMesh:
    """A mesh of ``shape`` over the world's ranks (dev scale: (1, 1) in
    process, (1, 2), (1, 4), (2, 2), (4, 1), ...): the product of
    ``shape`` must be the world size. With no process group initialized, a
    world of 1 opens its own over a ``FileStore`` in a temporary directory
    (``backend``, else gloo for a CPU ``device`` and NCCL for a CUDA one;
    "cpu:gloo,cuda:nccl" takes both), which ``RankMesh.close`` destroys; a
    larger one raises. ``device`` defaults to ``rank_device()``."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"make_rank_mesh: shape {shape} for axes {axes}")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"make_rank_mesh: a {shape} mesh needs {n} ranks but no torch.distributed "
                f"process group is initialized; start one process a rank (torchrun "
                f"--nproc-per-node {n} ...) and build the mesh on every rank")
        dev = rank_device(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        return RankMesh(axes, shape, 0, dev, backend, store_dir=_open_world_of_one(backend))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"make_rank_mesh: a {shape} mesh needs a world of {n} ranks; the "
                         f"process group has {world}")
    backend = str(dist.get_backend())
    dev = rank_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"make_rank_mesh: an NCCL group needs CUDA tensors, got device {dev}")
    return RankMesh(axes, shape, dist.get_rank(), dev, backend)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> RankMesh:
    """16x16 single pod, or 2x16x16 across two pods: one rank a chip, over
    a world of 256 or 512 ranks started one process a rank.

    Axes:
      pod   — inter-pod data parallelism (DCN-ish; FL silo groups span it)
      data  — intra-pod data parallel / ZeRO / FL silo axis
      model — tensor/expert parallel
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"make_production_mesh: the {'x'.join(map(str, shape))} mesh needs a "
                         f"world of {n} ranks (torchrun --nnodes ... with {n} processes in "
                         f"all), got {world or 'no process group'}")
    return make_rank_mesh(shape, axes, device=device)


def rank_device(device=None) -> torch.device:
    """The device a rank runs on: ``device`` if given, else
    ``cuda:{rank % device_count}`` (rank 0 without a process group); raises
    without a card when none was asked for (``resolve_device``)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_cohort_mesh(n_devices: int | None = None, group=None, device=None) -> CohortMesh:
    """1-D mesh for sharding the FL cohort axis (``repro_torch.fl.shard``).

    Axes:
      cohort — data parallelism over the (K, ...) gathered client lanes;
               global params and the (C, ...) server slabs stay replicated
               on every rank.

    ``n_devices`` of None/0/-1 takes the world size of ``group`` (the
    default group when None); a positive count must equal it. With no group
    initialized, ``n_devices`` None or 1 opens a world-1 group over a
    ``FileStore`` in a temporary directory (gloo for a CPU ``device``, NCCL
    for a CUDA one), which ``CohortMesh.close`` destroys; a larger count
    raises. ``device`` defaults to ``rank_device()``.
    """
    n = None if n_devices in (None, 0, -1) else int(n_devices)
    if n is not None and n < 1:
        raise ValueError(f"make_cohort_mesh: need >= 1 device, got {n_devices!r}")
    if group is None and not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(
                f"make_cohort_mesh: {n} devices requested but no torch.distributed process "
                f"group is initialized; start one process a rank (torchrun --nproc-per-node "
                f"{n} ..., or torch.multiprocessing.spawn with init_process_group) and call "
                f"run_federated on every rank")
        dev = rank_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        return CohortMesh(None, 0, 1, dev, backend, store_dir=_open_world_of_one(backend))
    world = dist.get_world_size(group)
    if n is not None and n > world:
        raise ValueError(
            f"make_cohort_mesh: {n} devices requested but only {world} visible (the process "
            f"group has {world} ranks; start {n} with torchrun --nproc-per-node {n})")
    if n is not None and n != world:
        raise ValueError(f"make_cohort_mesh: {n} devices requested but the process group has "
                         f"{world} ranks; the cohort mesh spans the whole group")
    backend = str(dist.get_backend(group))
    dev = rank_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"make_cohort_mesh: an NCCL group needs CUDA tensors, got device {dev}")
    return CohortMesh(group, dist.get_rank(group), world, dev, backend)


def data_axes(multi_pod: bool = False):
    return ("pod", "data") if multi_pod else ("data",)
