"""The cohort mesh of the port — the port of the JAX package's
``launch/mesh.py`` (``make_cohort_mesh``, ``data_axes``).

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

``make_production_mesh`` (the 16x16 production mesh) comes with the model
zoo's training (ROADMAP.md queue 1 item 14.8); the JAX module's ``HW``
table holds TPU figures and is not carried over.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["CohortMesh", "data_axes", "make_cohort_mesh", "rank_device"]


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
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf

    def close(self) -> None:
        """Destroy the world-1 group this mesh opened (nothing for a group
        the caller started)."""
        if self._store_dir is not None:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None

    def __repr__(self) -> str:
        return (f"CohortMesh(cohort={self.world}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend!r})")


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
        store_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                                rank=0, world_size=1)
        return CohortMesh(None, 0, 1, dev, backend, store_dir=store_dir)
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
