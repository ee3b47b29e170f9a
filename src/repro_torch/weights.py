"""Carry weights and round state over from numpy into the port.

``params_from_numpy`` takes a layered model (``[{'w','b'}, ...]``) whose
leaves are numpy arrays — e.g. the JAX package's parameters after
``jax.device_get`` — and returns the port's layered model on ``device``.
``state_from_numpy`` does the same for a whole round state (any NamedTuple
with ``RoundState``'s fields), so both packages can compute from the same
weights, keys and per-client lanes. ``lm_params_from_numpy`` turns the JAX
package's decoder-LM parameter tree (``models/transformer.init_params``)
into the port's ``DecoderLM``, ``whisper_params_from_numpy`` its
encoder-decoder's (``models/whisper.init_whisper``) into a
``WhisperModel``, ``silo_params_from_numpy`` the cross-silo round's tree
(every leaf with a leading silo axis) into a ``fl.cross_silo.SiloParams``.
``servable_from_numpy`` turns the JAX package's ``ServableArtifact``
(``serve/artifact.py``), as numpy arrays,
into the port's, so both serving engines can score the same personalized
models. Like every entry point they default to the CUDA card and raise
without one; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.fl.api import RoundState
from repro_torch.launch import context as ctx
from repro_torch.launch import tp
from repro_torch.launch import zero as Z
from repro_torch.launch.sharding import expert_block
from repro_torch.launch.zero import EXPERT_LEAVES
from repro_torch.models.transformer import DecoderLM, check_supported, layer_plan
from repro_torch.models.whisper import WhisperModel
from repro_torch.tree import tree_map

__all__ = ["params_from_numpy", "state_from_numpy", "lm_params_from_numpy",
           "whisper_params_from_numpy", "silo_params_from_numpy", "servable_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype == np.uint32:  # threefry key words: the port holds them in int64
        a = a.astype(np.int64)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)  # a copy: jax.device_get arrays are read-only


def params_from_numpy(layers, device=None):
    """Layered numpy parameters -> the same tree of tensors on ``device``
    (dtypes kept)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), layers)


def state_from_numpy(state, device=None) -> RoundState:
    """A round state of numpy leaves (fields named as ``RoundState``'s;
    ``None`` fields stay ``None``) -> the port's ``RoundState`` on
    ``device``."""
    dev = resolve_device(device)
    fields = {}
    for name in RoundState._fields:
        value = getattr(state, name)
        fields[name] = None if value is None else tree_map(lambda a: _tensor(a, dev), value)
    return RoundState(**fields)


def lm_params_from_numpy(cfg: ModelConfig, tree, device=None, mesh=None, zero: bool = False):
    """The JAX package's decoder-LM parameters (``embed``, ``final_norm``,
    ``head`` but under tied embeddings, ``vision_proj`` under the vision
    stub, the ``prologue`` blocks, and one ``stack`` entry per position
    of the period whose leaves carry a leading axis of periods), as numpy
    arrays, -> the port's ``DecoderLM`` on ``device``, one block per layer
    in ``transformer.layer_plan``'s order: the prologue, then period entry
    j at index i for layer ``len(prologue) + i * p + j`` (dtypes and bits
    kept; nested dicts such as an MoE's ``shared`` experts as they are).
    With a ``mesh`` (a ``launch.mesh.RankMesh``), each expert leaf keeps
    only this rank's experts (``launch.sharding.expert_block``) and, where
    the mesh's ``model`` axis is over 1, each other leaf its
    tensor-parallel block (``launch/tp.hold``: Mamba's ``in_proj`` the x
    and then the z columns of the rank's d_inner block), so the model is
    the one ``init_params`` makes under that mesh. With ``zero``
    (training), each leaf keeps, beside the rank's experts, this rank's 2-D
    block: of its tensor-parallel block (a kv head shared by ranks held
    whole), the ZeRO block over the data axes of the open
    ``mesh_context``, which must hold ``mesh`` (``launch/zero.py``), so
    the model is the one ``init_params(zero=True)`` makes there."""
    dev = resolve_device(device)
    check_supported(cfg)
    n_pro, p, n_periods = layer_plan(cfg)
    if len(tree["prologue"]) != n_pro or len(tree["stack"]) != (p if n_periods else 0):
        raise ValueError(f"{cfg.name}: expected {n_pro} prologue blocks and "
                         f"{p if n_periods else 0} stack entries, got {len(tree['prologue'])} "
                         f"and {len(tree['stack'])}")
    rows = None if mesh is None else expert_block(cfg.n_experts, mesh)
    if zero and (mesh is None or ctx.get_mesh() is not mesh):
        raise ValueError("lm_params_from_numpy(zero=True) splits the leaves over the data axes "
                         "of the open mesh_context, which must hold mesh")

    split = mesh is not None and not zero and mesh.shape["model"] > 1

    def held(path, t):
        if zero:
            return Z.shard(t, path, cfg)
        return tp.hold(t, path, cfg, mesh) if split else t

    def block(path, blk):
        if rows is not None and "moe" in blk:
            moe = blk["moe"]
            blk = dict(blk, moe=dict(moe, **{n: np.asarray(moe[n])[rows] for n in EXPERT_LEAVES}))
        return held(path, tree_map(lambda a: _tensor(a, dev), blk))

    blocks = [tree_map(lambda a, i=i: np.asarray(a)[i], tree["stack"][j])
              for i in range(n_periods) for j in range(p)]
    blocks = [block(f"blocks/{i}", blk) for i, blk in enumerate(list(tree["prologue"]) + blocks)]
    names = ("embed", "final_norm") if cfg.tie_embeddings else ("embed", "final_norm", "head")
    lm = {name: held(name, _tensor(tree[name], dev)) for name in names}
    lm["blocks"] = blocks
    if "vision_proj" in tree:  # the vision stub's projection
        lm["vision_proj"] = held("vision_proj", _tensor(tree["vision_proj"], dev))
    return DecoderLM(cfg, lm)


def whisper_params_from_numpy(cfg: ModelConfig, tree, device=None, mesh=None,
                              zero: bool = False):
    """The JAX package's whisper parameters (``enc_pos``, the ``encoder``
    layers, ``enc_norm``, ``embed``, the ``decoder`` layers,
    ``final_norm``, ``head``), as numpy arrays, -> the port's
    ``WhisperModel`` on ``device`` (dtypes and bits kept). With ``zero``
    (training under a mesh), each leaf keeps only this rank's ZeRO block
    over the data axes of the open ``mesh_context``, which must hold
    ``mesh`` (``launch/zero.py``; whisper's leaves stay whole over
    ``model``), so the model is the one ``init_whisper(zero=True)`` makes
    there; without ``zero`` a ``mesh`` changes nothing."""
    dev = resolve_device(device)
    if zero and (mesh is None or ctx.get_mesh() is not mesh):
        raise ValueError("whisper_params_from_numpy(zero=True) splits the leaves over the data "
                         "axes of the open mesh_context, which must hold mesh")
    held = (lambda path, t: Z.shard(t, path, cfg)) if zero else (lambda path, t: t)
    out = {name: [held(f"{name}/{i}", tree_map(lambda a: _tensor(a, dev), lyr))
                  for i, lyr in enumerate(value)] if name in ("encoder", "decoder")
           else held(name, _tensor(value, dev)) for name, value in tree.items()}
    return WhisperModel(cfg, out)


def silo_params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The JAX package's stacked silo parameters (``fl/cross_silo.py``: the
    model's tree with a leading silo axis on every leaf, so a stack leaf is
    (S, n_periods, ...)), as numpy arrays, -> the port's ``SiloParams`` on
    ``device``: silo s is ``lm_params_from_numpy`` (or
    ``whisper_params_from_numpy``) of the tree's slice s, and each name
    holds the S slices stacked (dtypes and bits kept)."""
    from repro_torch.fl.cross_silo import SiloParams
    from repro_torch.models.transformer import param_tree

    dev = resolve_device(device)
    one = whisper_params_from_numpy if cfg.encoder_decoder else lm_params_from_numpy
    n_silos = np.asarray(tree["embed"]).shape[0]
    silos = [param_tree(one(cfg, tree_map(lambda a, s=s: np.asarray(a)[s], tree), dev))
             for s in range(n_silos)]
    return SiloParams(cfg, {name: torch.stack([m[name].detach() for m in silos])
                            for name in silos[0]})


def servable_from_numpy(artifact, device=None):
    """A servable artifact whose leaves are numpy arrays (or tensors) —
    e.g. the JAX package's ``ServableArtifact`` after ``jax.device_get``,
    or the tree ``serve.load_servable`` read — -> the port's
    ``ServableArtifact`` on ``device``: the layered global model, the
    (C, ...) local slabs (or None), the (C, L) bool share mask, and a copy
    of ``meta`` (dtypes and bits kept)."""
    from repro_torch.serve.artifact import ServableArtifact

    dev = resolve_device(device)
    local = artifact.local_params
    return ServableArtifact(
        global_params=tree_map(lambda a: _tensor(a, dev), list(artifact.global_params)),
        local_params=None if local is None else tree_map(lambda a: _tensor(a, dev), list(local)),
        share_mask=_tensor(artifact.share_mask, dev).to(torch.bool),
        meta=dict(artifact.meta),
    )
