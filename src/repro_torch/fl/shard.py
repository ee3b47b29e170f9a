"""Sharded cohort rounds over ``torch.distributed`` — the port of the JAX
package's ``fl/shard.py`` (``build_sharded_round_step``).

The round step (``repro_torch.fl.api``) is gather -> per-lane compute on
(K, ...) lanes -> aggregate -> scatter, so the cohort axis is a ready-made
data-parallel axis: every compute phase (the personalizer's train model,
the trainer, the transmit phase) is lane-local, and only the aggregator
reduces across lanes. Where the JAX package ``shard_map``s the compute over
a device mesh, the port runs one process a rank of a process group
(``repro_torch.launch.mesh.CohortMesh``), each with the full replicated
(C, ...) server state:

- every rank gathers the cohort exactly as the unsharded step does, then
  computes only its block of K/D lanes ``[r*K/D, (r+1)*K/D)``
  (``launch.sharding.lane_block``);
- the aggregator runs with ``axis_name=mesh``: each rank reduces its lanes
  to partial sums (masked_aggregate's partial mode), ONE all-reduce of the
  rank-slotted buffer gathers them, and the combine mode sums them in rank
  order, so the new global model is the same on every rank;
- ONE more all-reduce gathers the lanes' new local models, EF residuals,
  update norms and guard rejections, so every rank scatters all K lanes
  into its replicated state;
- evaluation, selection and the layer policy run on every rank unchanged.

The collective primitive is ``all_reduce(SUM)`` over a ``(D, n)`` float32
buffer whose every row but this rank's is -0.0: ``x + (-0.0) == x`` for
every float32 (+0 and -0 included), so the sum is bitwise whatever order
the backend reduces in, and the same code runs on NCCL, on gloo with CPU
tensors and on gloo with CUDA tensors (whose gloo support covers
``all_reduce`` and ``broadcast``, not ``all_gather``). It moves about twice
the bytes an all-gather would on NCCL (ROADMAP.md queue 2).

Contracts (tests/test_torch_shard.py):

- at D = 1 the sharded step is bitwise the unsharded step (the rank-order
  combine adds its one partial to 0);
- at D > 1 every lane computes the same numbers on the same inputs, and
  the reduction is bitwise the port's edge mode with ``edge_ids = lane //
  (K/D)`` and ``n_edges = D`` (a rank's partial is an edge's partial); the
  committed goldens hold to <= 1 ulp of ``accuracy_mean`` with the
  selections exact, the JAX package's D > 1 contract;
- the step is still ``(RoundState, t) -> (RoundState, out)`` with no host
  read, so ``api.build_chunk_step`` captures chunks of it in a CUDA graph
  under NCCL (collectives included); gloo on CUDA tensors cannot be
  captured and ``build_chunk_step`` refuses it.

Per-client rng streams need no care: keys are split over the population
and gathered by the lane's client id (``phases.client_keys``), so a rank
holding a block of lanes derives the keys those clients use anywhere.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ExecutionConfig
from repro_torch.fl import phases
from repro_torch.fl.api import RoundPipeline, compose_round_step
from repro_torch.kernels.masked_aggregate import partial_layout
from repro_torch.launch.mesh import make_cohort_mesh
from repro_torch.launch.sharding import lane_block
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["build_sharded_round_step", "shard_collective_bytes"]


def _sharded_aggregator(aggregator: phases.Aggregator, mesh) -> phases.Aggregator:
    """The same aggregator phase, reducing over the mesh's ranks."""
    if getattr(aggregator, "axis_name", "missing") is mesh:
        return aggregator
    try:
        return dataclasses.replace(aggregator, axis_name=mesh)
    except (TypeError, ValueError) as e:
        raise TypeError(
            f"sharded execution needs an Aggregator with an `axis_name` "
            f"field (rank-local partial sums + one all-reduce); "
            f"{type(aggregator).__name__} has none"
        ) from e


class _RankLanes:
    """This rank's block of the K cohort lanes, and the all-reduce that
    gathers every rank's lane results back to K lanes."""

    def __init__(self, mesh, cohort_k: int):
        self.mesh = mesh
        self.cohort_k = cohort_k
        self.block = lane_block(cohort_k, mesh.world, mesh.rank)

    def gather(self, new_local, residual, update_norm, n_rejected):
        """``(new_local, residual, update_norm, n_rejected)`` of all K lanes
        (the first three float32, (K, ...)) from this rank's (K/D, ...)
        ones and its rejection count, through one all-reduce of a
        rank-slotted float32 buffer."""
        lanes = tree_leaves(new_local) + tree_leaves(residual) + [update_norm]
        for leaf in lanes:
            if leaf.dtype != torch.float32:
                raise TypeError(f"sharded lanes travel as float32, got a {leaf.dtype} leaf")
        parts = [leaf.reshape(-1) for leaf in lanes] + [n_rejected.reshape(1).to(torch.float32)]
        mesh = self.mesh
        width = sum(p.numel() for p in parts)
        buf = torch.full((mesh.world, width), -0.0, dtype=torch.float32, device=update_norm.device)
        torch.cat(parts, out=buf[mesh.rank])
        mesh.all_reduce(buf)
        full, at = [], 0
        for leaf in lanes:
            n = leaf.numel()
            full.append(buf[:, at:at + n].reshape((self.cohort_k,) + tuple(leaf.shape[1:])))
            at += n
        n_rej = buf[:, at].sum().to(torch.int32)
        n_loc = len(tree_leaves(new_local))
        n_res = len(tree_leaves(residual))
        return (None if new_local is None else tree_unflatten(new_local, full[:n_loc]),
                None if residual is None else tree_unflatten(residual, full[n_loc:n_loc + n_res]),
                full[-1], n_rej)


def shard_collective_bytes(global_params, n_rows: int, world: int, lanes_per_rank: int,
                           stateful: bool, lossy: bool) -> int:
    """The bytes a sharded round hands its two all-reduces on each rank:
    the ``(D, width)`` partial buffer of the aggregation (``n_rows`` weight
    rows: 1 for FedAvg, L for masked-partial) and the ``(D, n)`` lane buffer
    (each lane's new local model if ``stateful``, its EF residual if
    ``lossy``, its update norm, and the rank's rejection count), float32."""
    sizes = [leaf.numel() for leaf in tree_leaves(global_params)]
    _, _, width = partial_layout(sizes, n_rows)
    per_lane = sum(sizes) * (int(stateful) + int(lossy)) + 1
    return 4 * world * (width + lanes_per_rank * per_lane + 1)


def build_sharded_round_step(
    env: phases.RoundEnv,
    pipeline: RoundPipeline,
    execution: ExecutionConfig | None = None,
    mesh=None,
):
    """Compose a RoundPipeline into a cohort-sharded round step: the
    ``(RoundState, t) -> (RoundState, out)`` of ``api.build_round_step``
    (same phase order, key splits and ``out`` records) with the compute
    phases on this rank's K/D lanes and two all-reduces a round.

    ``mesh`` defaults to ``make_cohort_mesh(execution.cohort_devices)``
    (0 or -1: the whole process group; with no group and a count of 1, a
    world-1 group it opens on the environment's device, closed by
    ``round_step.mesh.close()``). K must be a multiple of the rank count:
    raise early rather than pad lanes. The step exposes ``mesh`` (the
    scheduler records its shape in the run manifest) and
    ``lanes_per_device``."""
    execution = execution or ExecutionConfig()
    opened = mesh is None
    if opened:
        n = execution.cohort_devices
        mesh = make_cohort_mesh(None if n in (0, -1) else n, device=env.device)
    try:
        if "cohort" not in mesh.shape:
            raise ValueError(f"mesh has no 'cohort' axis: {mesh!r}")
        n_shards = mesh.shape["cohort"]
        cohort_k = execution.resolved_cohort(env.n_clients)
        if cohort_k % n_shards != 0:
            raise ValueError(
                f"cohort lanes must divide the mesh: K={cohort_k} over "
                f"{n_shards} 'cohort' devices leaves a remainder — pick "
                f"cohort_size (or population) a multiple of the device count"
            )
        sharded = dataclasses.replace(pipeline,
                                      aggregator=_sharded_aggregator(pipeline.aggregator, mesh))
    except (TypeError, ValueError):
        if opened:
            mesh.close()
        raise
    round_step = compose_round_step(env, sharded, execution, lanes=_RankLanes(mesh, cohort_k))
    round_step.mesh = mesh
    round_step.lanes_per_device = cohort_k // n_shards
    return round_step
