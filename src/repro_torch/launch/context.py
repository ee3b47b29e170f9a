"""The mesh context of the port — the port of the JAX package's
``launch/context.py``.

Model code reads it: under ``mesh_context(mesh)`` the MoE takes its
expert-parallel path (``models.layers.moe_apply_ep``), the decoder's steps
run this rank's data shard of the batch and all-gather the logits
(``models.transformer.make_prefill_step`` / ``make_decode_step``), the
train step runs the same shard and takes the global batch's loss
(``models.transformer.lm_objective``), and ``init_params`` /
``init_cache`` keep this rank's blocks of the weights (for serving its
tensor-parallel blocks, for training its ZeRO blocks) and its shard of the
cache. Without a mesh every hook is a no-op, as in JAX.

The JAX package runs one SPMD program over global arrays; the port runs one
process a rank of a ``launch.mesh.RankMesh``. A model built on a ``model``
axis over 1 (``tensor_parallel()``) holds this rank's
``launch.sharding.model_block`` of each non-expert leaf and the ``model``
shard of each expert leaf's E axis (``launch.sharding.expert_block``); its
layers compute their share of each product and sum the row products'
float32 partials over ``model`` (``launch/tp.py``), and a served model's
caches hold the rank's kv heads and d_inner block. A model built for
training (``zero=True``) holds, of that block, its ZeRO block
(``launch/zero.py``: split over ``dp_axes()``, the data axes this context
names, where ``launch.sharding.param_spec`` gives the leaf a data entry,
gathered at use); its ``model`` ranks compute the same objective on the
same rows, and TP's collectives carry the backward (``launch/tp.py``).
Beyond the rounding of the row products'
sums, only the MoE changes values under a mesh: JAX's ``moe_apply_ep``
splits its tokens over the data axes where they divide the batch (``B %
n_dp == 0``), and each data shard then routes its own tokens and counts
capacity over them, while ``moe_apply_local`` counts it over the whole
global batch. So the steps, the train step included,
split the batch exactly where the MoE takes ``moe_apply_ep`` and the data
axes divide it, or where the model has no MoE (its rows are then
independent), and every rank takes the whole batch otherwise
(``data_rows``). Every other sharding of the JAX model code
(``constrain``) is layout alone, and but for one has no counterpart here.
That one is ``seq_parallel``, which JAX reads only in training
(``transformer.apply_block``: each block's input pinned to ``("dp",
"model", None)``): ``seq_split`` says where the port applies it, its
sequence-parallel layout (``models.transformer``, ``launch/tp.py``): the
residual stream between blocks split over ``model`` along the sequence,
TP's all-reduces turned into reduce-scatters and all-gathers. It changes
where values are computed, not what they are (beyond the rounding of the
row products' sums), as in JAX.
A context with no data axes (``dp_axes=()``: the cross-silo round's
silos, ``fl.cross_silo.silo_context``) runs every rank on its own rows.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.launch.sharding import expert_block

__all__ = ["data_rows", "dp_axes", "expert_parallel", "expert_rows", "gather_rows", "get_mesh",
           "local_batch", "mesh_context", "moe_ep_enabled", "n_data", "n_model",
           "seq_parallel_enabled", "seq_split", "tensor_parallel"]

_MESH = None
_DP_AXES: tuple[str, ...] = ("data",)
_MOE_EP: bool = True
_SEQ_PARALLEL: bool = False


@contextlib.contextmanager
def mesh_context(mesh, dp_axes=("data",), moe_ep: bool = True, seq_parallel: bool = False):
    """Open ``mesh`` (a ``RankMesh``) for the model code within; the
    previous context comes back on exit, after an exception too. The data
    axes' process group is made here, on every rank in the same order.
    ``seq_parallel`` asks for JAX's sequence-parallel layout in training
    (JAX's ``constrain`` pins each block's input's sequence dim over
    ``model``): a train step splits its residual stream over ``model``
    where ``seq_split`` says so, and nothing else changes."""
    global _MESH, _DP_AXES, _MOE_EP, _SEQ_PARALLEL
    dp_axes = tuple(dp_axes)
    missing = [a for a in dp_axes if a not in mesh.shape]
    if missing or "model" not in mesh.shape:
        raise ValueError(f"mesh_context: the mesh's axes are {tuple(mesh.shape)}; it needs "
                         f"'model' and the data axes {dp_axes}")
    if dp_axes:  # none: every data rank alone (the cross-silo round's silos)
        mesh.group(dp_axes)
    prev = (_MESH, _DP_AXES, _MOE_EP, _SEQ_PARALLEL)
    _MESH, _DP_AXES, _MOE_EP, _SEQ_PARALLEL = mesh, dp_axes, bool(moe_ep), bool(seq_parallel)
    try:
        yield mesh
    finally:
        _MESH, _DP_AXES, _MOE_EP, _SEQ_PARALLEL = prev


def get_mesh():
    return _MESH


def dp_axes() -> tuple[str, ...]:
    return _DP_AXES


def moe_ep_enabled() -> bool:
    return _MESH is not None and _MOE_EP


def seq_parallel_enabled() -> bool:
    """Whether the open mesh context asks for the sequence-parallel layout
    (JAX's function of the same name)."""
    return _MESH is not None and _SEQ_PARALLEL


def seq_split(s: int) -> bool:
    """Whether a train step's residual stream of ``s`` positions is split
    over ``model`` between blocks: under ``seq_parallel``, on a ``model``
    axis of n > 1 ranks that divides ``s`` (``s >= n``). This is JAX's own
    rule (``constrain`` leaves a dim whole where the axis does not divide
    it), not a fallback; a (d, 1) mesh, prefill, decode and whisper never
    split (the callers ask only for a decoder's train step)."""
    n = n_model()
    return seq_parallel_enabled() and n > 1 and s % n == 0 and s >= n


def expert_parallel(n_experts: int) -> bool:
    """Whether an MoE of ``n_experts`` experts takes ``moe_apply_ep``: under
    an expert-parallel mesh context whose ``model`` axis divides them
    (JAX's dispatch in ``moe_apply``)."""
    return moe_ep_enabled() and n_experts % _MESH.shape["model"] == 0


def n_data() -> int:
    """Ranks over the data axes (1 without a mesh)."""
    return 1 if _MESH is None else math.prod(_MESH.shape[a] for a in _DP_AXES)


def n_model() -> int:
    """Ranks over the ``model`` axis (1 without a mesh)."""
    return 1 if _MESH is None else _MESH.shape["model"]


def tensor_parallel() -> bool:
    """Whether a model built here (``init_params``, ``init_cache``) is
    tensor-parallel: under a mesh whose ``model`` axis is over 1, for
    serving and for training alike."""
    return n_model() > 1


def data_rows(cfg, batch: int) -> slice | None:
    """The rows ``[i B / n_dp, (i + 1) B / n_dp)`` of a global batch of
    ``batch`` of model ``cfg`` that this rank (data index i) runs, or None
    where it runs them all: no mesh, one data rank, ``B % n_dp != 0`` (JAX's
    ``moe_apply_ep`` then replicates the tokens over the data axes), or an
    MoE that takes ``moe_apply_local`` (which counts capacity over the whole
    global batch)."""
    n = n_data()
    if n == 1 or batch % n != 0 or (cfg.n_experts and not expert_parallel(cfg.n_experts)):
        return None
    i = _MESH.index(_DP_AXES)
    size = batch // n
    return slice(i * size, (i + 1) * size)


def local_batch(cfg, batch: int) -> int:
    """The rows of a global batch of ``batch`` that this rank holds."""
    return batch if data_rows(cfg, batch) is None else batch // n_data()


def gather_rows(cfg, t: torch.Tensor, batch: int) -> torch.Tensor:
    """This rank's rows of a global batch of ``batch`` -> every rank's, in
    order, along dim 0 (one all-gather over the data axes); ``t`` itself
    where every rank holds the whole batch."""
    if data_rows(cfg, batch) is None:
        return t
    return _MESH.all_gather(t, _DP_AXES)


def expert_rows(n_experts: int) -> slice | None:
    """The experts of an expert leaf's E axis this rank holds under an
    expert-parallel mesh, or None (every expert) outside one."""
    return expert_block(n_experts, _MESH) if moe_ep_enabled() else None
