"""Sharding rules of the port — the port of the JAX package's
``launch/sharding.py``.

Path-based rules for parameters, optimizer states, batches and caches over
the production mesh (``param_spec``, ``tree_pspecs``, ``batch_spec``,
``cache_spec``, ``cache_pspecs``): for each leaf, a tuple with one entry a
dim, an axis name, a tuple of axis names or None — the entries the JAX
package's ``PartitionSpec`` holds. A mesh is any object whose ``shape``
maps axis names to sizes. Baseline policy, as in the JAX package:

  - params / optimizer moments: 2-D sharded — one dim over the data axes
    (ZeRO/FSDP), one over `model` (TP/EP). Expert axes always go to `model`
    (expert parallelism). A dim is sharded only if divisible.
  - activations: batch over data axes.
  - decode KV caches: batch over data (when divisible), seq over model.
  - norms / biases / scalars: replicated.

The rule is *path-aware* (expert weights, embeddings) and works unchanged
for optimizer-state trees because their paths embed the parameter paths.

Cohort lanes (``repro_torch.fl.shard``): ``lane_spec`` and
``tree_lane_pspecs`` give the contiguous block of lanes ``[r*K/D,
(r+1)*K/D)`` that rank r of a ``CohortMesh`` holds, as a ``slice``, for a
leaf or a tree; they raise where D does not divide K (the JAX package
replicates such a leaf; the sharded round refuses it earlier).

Expert parallelism (``launch.context``, ``models.layers.moe_apply_ep``):
``expert_block`` gives the experts ``[j*E/n, (j+1)*E/n)`` of an expert
leaf's E axis that the rank at ``model`` coordinate j of a ``RankMesh``
holds: the ``model`` entry ``param_spec`` gives that axis, the only
``model`` entry of the production rules the port applies to weights.

Tensor parallelism (``launch/tp.py``): ``model_block`` gives the dim of a
decoder leaf that this rank splits over ``model`` and its block of it
(Megatron's column/row pairs, which hold the bytes of ``param_spec``'s
``model`` entries on other dims); port-side, like ``data_block``.

ZeRO (``launch/zero.py``): ``data_block`` gives the dim of a leaf that
``param_spec`` splits over the data axes and the block of it this rank
holds, within the rank's ``model_block`` where the leaf has one: the 2-D
block of a model built for training, of which parameters, gradients and
both AdamW moments are held.
"""

from __future__ import annotations

import math
from typing import Any

__all__ = ["batch_spec", "cache_pspecs", "cache_spec", "data_block", "expert_block", "lane_block",
           "lane_spec", "model_block", "model_blocks", "param_spec", "tree_lane_pspecs",
           "tree_pspecs"]


def _map_with_path(fn, tree, path=()):
    """``fn("a/b/0", leaf)`` over the leaves of nested dicts, lists, tuples
    and named tuples (a path part is a dict key, a list index or a field
    name, as the JAX package's ``_path_str``); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def param_spec(path: str, shape: tuple[int, ...], mesh, dp_axes) -> tuple:
    """Spec for one parameter (or optimizer-moment) leaf."""
    nd = len(shape)
    if nd == 0:
        return ()
    dp = (dp_axes if len(dp_axes) > 1 else dp_axes[0]) if dp_axes else None
    n_dp = _axis_size(mesh, dp_axes) if dp_axes else 0
    n_mp = mesh.shape["model"]

    stacked = "/stack/" in f"/{path}/"  # leading period axis — never sharded
    lead = 1 if stacked else 0
    spec: list[Any] = [None] * nd

    leaf_name = path.rsplit("/", 1)[-1]
    # mamba mixer params: the CONTRACTION/feature dim is d_inner, which must
    # align with the activations' model sharding
    mamba_rules = {
        "x_proj": ("model", None),        # (di, dtr+2ds)
        "out_proj": ("model", dp),        # (di, d)
        "A_log": ("model", None),         # (di, ds)
        "D": ("model",),                  # (di,)
        "dt_bias": ("model",),            # (di,)
        "conv_w": (None, "model"),        # (dc, di)
        "conv_b": ("model",),             # (di,)
    }
    if leaf_name in mamba_rules and "mixer" in path:
        rule = mamba_rules[leaf_name]
        if nd - lead == len(rule):
            full = [None] * lead + list(rule)
            out = []
            for dim, s in zip(shape, full):
                if s == "model":
                    out.append("model" if dim % n_mp == 0 and dim >= n_mp else None)
                elif s is not None and dp:
                    out.append(dp if dim % n_dp == 0 and dim >= n_dp else None)
                else:
                    out.append(None)
            return tuple(out)

    is_expert = any(f"/{k}/" in f"/{path}/" for k in ("moe",)) and leaf_name in ("wg", "wu", "wd")
    if is_expert and nd - lead == 3:
        # (E, d_in, d_out): experts -> model (EP), d_in -> data (ZeRO)
        if shape[lead] % n_mp == 0:
            spec[lead] = "model"
        if dp and shape[lead + 1] % n_dp == 0:
            spec[lead + 1] = dp
        return tuple(spec)

    # generic: last dim -> model, first non-layer dim -> data
    if nd - lead >= 1 and shape[-1] % n_mp == 0 and shape[-1] >= n_mp:
        spec[-1] = "model"
    if (dp and nd - lead >= 2 and shape[lead] % n_dp == 0 and shape[lead] >= n_dp
            and spec[lead] is None):
        spec[lead] = dp
    return tuple(spec)


def tree_pspecs(tree, mesh, dp_axes) -> Any:
    """Spec tree mirroring ``tree`` (only each leaf's ``.shape`` is read)."""
    return _map_with_path(lambda p, l: param_spec(p, tuple(l.shape), mesh, dp_axes), tree)


# ---------------------------------------------------------------------------
# cohort lanes (repro_torch.fl.shard)
# ---------------------------------------------------------------------------


def lane_block(k: int, world: int, rank: int) -> slice:
    """The lanes ``[rank*K/D, (rank+1)*K/D)`` of K lanes that ``rank`` of
    ``world`` holds; raises where D does not divide K."""
    if k % world != 0:
        raise ValueError(f"cohort lanes must divide the mesh: K={k} over {world} 'cohort' "
                         f"ranks leaves a remainder")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    n = k // world
    return slice(rank * n, (rank + 1) * n)


def lane_spec(shape: tuple[int, ...], mesh, axis: str = "cohort") -> slice:
    """The block of the leading (lane) axis of a ``shape`` leaf that this
    rank of ``mesh`` holds."""
    if len(shape) == 0:
        raise ValueError("a lane-stacked leaf has a leading lane axis; got a scalar")
    return lane_block(int(shape[0]), mesh.shape[axis], mesh.rank)


def tree_lane_pspecs(tree, mesh, axis: str = "cohort") -> Any:
    """``lane_spec`` over every leaf of a lane-stacked tree."""
    return _map_with_path(lambda p, l: lane_spec(tuple(l.shape), mesh, axis), tree)


def expert_block(n_experts: int, mesh) -> slice | None:
    """The experts of an expert leaf's E axis that this rank of ``mesh``
    holds (``mesh.coords["model"]`` j of n: ``[j*E/n, (j+1)*E/n)``), or None
    where ``param_spec`` leaves the axis whole (n does not divide E)."""
    n = mesh.shape["model"]
    if n_experts % n != 0:
        return None
    size = n_experts // n
    j = mesh.coords["model"]
    return slice(j * size, (j + 1) * size)


def data_block(path: str, shape: tuple[int, ...], mesh, dp_axes,
               model: tuple[int, tuple[slice, ...]] | None = None) -> tuple[int, slice] | None:
    """The dim of a parameter leaf of ``shape`` (the whole leaf's) that
    ``param_spec`` splits over the data axes ``dp_axes`` (ZeRO: the first
    non-layer dim of a generic leaf, d_in of an expert leaf, the Mamba
    rules' data entries), and the block of it that this rank of ``mesh``
    holds of the rank's ``model`` block (``model_block``'s; None: the
    whole leaf): ``[i*n/D, (i+1)*n/D)`` at index i over the data axes of
    the n elements the model block keeps on that dim, which are the whole
    dim where the model block lies on another (an expert leaf's E axis,
    ``wq``'s columns). Where both name one dim (the row pairs ``wo`` and
    ``wd``, whose ``model`` block ``param_spec`` would put on their output
    dim) the data block is cut within the model block, so the all-gather
    over the data axes rebuilds the model block and nothing else. None
    where the leaf stays whole over the data axes: no data entry, a dim
    (or model block) the data axes do not divide, or one data rank."""
    n = _axis_size(mesh, dp_axes)
    if n == 1:
        return None
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    dims = [d for d, s in enumerate(param_spec(path, shape, mesh, dp_axes)) if s == dp]
    if not dims:
        return None
    dim = dims[0]
    size = shape[dim] if model is None or model[0] != dim else sum(
        s.stop - s.start for s in model[1])
    if size % n:
        return None
    size //= n
    i = mesh.index(dp_axes)
    return dim, slice(i * size, (i + 1) * size)


_MAMBA_DIMS = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_proj": 1, "dt_bias": 0,
               "A_log": 0, "D": 0, "out_proj": 0}


def _block(dim: int, n: int, j: int, size: int, unit: int = 1) -> tuple[int, tuple[slice, ...]]:
    """Block j of n equal ones of ``size`` units of ``unit`` elements on
    ``dim``."""
    per = size // n * unit
    return dim, (slice(j * per, (j + 1) * per),)


class _AtModel:
    """``mesh``'s shape with its ``model`` coordinate set to ``j``: what
    ``model_block`` reads of another rank."""

    def __init__(self, mesh, j: int):
        self.shape = mesh.shape
        self.coords = dict(mesh.coords, model=j)


def model_blocks(path: str, shape: tuple[int, ...], mesh, cfg,
                 train: bool = False) -> tuple | None:
    """Every ``model`` rank's ``model_block`` of the leaf, in rank order
    (None where the leaf stays whole over ``model``): where each lies in
    the whole leaf, to put gathered blocks back (``zero.whole``)."""
    if model_block(path, shape, mesh, cfg, train) is None:
        return None
    return tuple(model_block(path, shape, _AtModel(mesh, j), cfg, train)
                 for j in range(mesh.shape["model"]))


def model_block(path: str, shape: tuple[int, ...], mesh, cfg,
                train: bool = False) -> tuple[int, tuple[slice, ...]] | None:
    """The dim of a decoder leaf of ``cfg`` (``path`` as the port's
    ``DecoderLM`` names it, one block a layer: ``embed``,
    ``blocks/3/mixer/wq``, ``blocks/1/moe/shared/wd``, ...; ``shape`` the
    whole leaf's) that this rank of ``mesh`` splits over ``model`` (n ranks,
    coordinate j), and its block of that dim: slices of it, concatenated in
    order; None where the leaf stays whole (n = 1, or the rule below).
    Port-side: JAX's tensor parallelism is a layout (``param_spec``'s
    ``model`` entries, the collectives XLA's), and taking its blocks
    literally would all-gather full activations before ``wo``, ``wd`` and
    ``out_proj``, whose ``model`` entry is their output dim. The port holds
    Megatron's pairs instead, a column-split product and then a row-split
    one whose float32 partials one all-reduce sums (``launch/tp.py``); a
    rank holds the bytes of JAX's blocks but for the leaves kept whole:

    - GQA: ``wq`` the columns of the rank's H/n q heads, ``wk``/``wv`` those
      of the kv heads they read (where ``Hkv < n``, the one kv head its q
      heads share, which JAX splits n ways; in a model built for training,
      ``train``, ``wk`` and ``wv`` whole instead: each rank projects every
      kv head and keeps its own, whose gradient then sums every rank's
      share, ``tp.kv_rows``), ``wo`` the rows of its heads; the whole
      attention where n does not divide H, or where the rank's heads and
      a kv group straddle (neither divides the other).
    - MLA: ``wq``, ``wuk``, ``wuv`` the rank's heads' columns, ``wo`` their
      rows; ``wdkv`` and ``wkr`` whole (its compressed cache ``c_kv`` and
      ``k_rope`` too: a sequence split needs an lse merge).
    - Mamba: ``in_proj`` (d, 2 di) the x columns of d_inner block j then its
      z columns (JAX's contiguous block would give a rank x or z alone);
      ``conv_w``, ``conv_b``, ``dt_bias``, ``D``, ``A_log``, ``dt_proj``
      block j of d_inner; ``x_proj`` and ``out_proj`` its rows.
    - SwiGLU (a dense ``ffn``, an MoE's ``shared`` experts): ``wg``/``wu``
      columns, ``wd`` rows of d_ff.
    - ``embed`` (V, d) and ``vision_proj`` (d, d) d columns; ``head`` (d, V)
      V columns.
    - Whole: the 1-D norms of width d, the float32 ``router`` (JAX splits
      all three over ``model``), MLA's ``wdkv`` and ``wkr``, a shared kv
      head's ``wk`` and ``wv`` in training, and the expert leaves, whose E
      axis ``expert_block`` splits. Whisper's leaves are all whole (its H =
      6 heads divide no ``model`` axis of 4; ``launch/zero.py``).

    The caches follow (``launch/tp.py``): a GQA cache holds the rank's kv
    heads (JAX's ``cache_spec`` splits its sequence over ``model``, the
    flash-decode layout: the same bytes, but a decode step would gather q
    and merge an lse a layer), Mamba's ``conv`` and ``ssm`` its d_inner
    block (``cache_spec``'s)."""
    n = mesh.shape["model"]
    if n == 1:
        return None
    j = mesh.coords["model"]
    parts = path.split("/")
    leaf = parts[-1]
    if path in ("embed", "vision_proj", "head"):
        return _block(1, n, j, shape[1]) if shape[1] % n == 0 else None
    if "moe" in parts and leaf in ("wg", "wu", "wd") and len(shape) == 3 or leaf == "router":
        return None
    if "mixer" in parts and leaf in _MAMBA_DIMS:
        di = cfg.d_inner
        if di % n:
            return None
        if leaf == "in_proj":
            per = di // n
            return 1, (slice(j * per, (j + 1) * per), slice(di + j * per, di + (j + 1) * per))
        return _block(_MAMBA_DIMS[leaf], n, j, di)
    if "mixer" in parts and cfg.attn_type == "mla":
        h = cfg.n_heads
        if h % n or leaf not in ("wq", "wuk", "wuv", "wo"):
            return None
        unit = {"wq": cfg.qk_nope_dim + cfg.qk_rope_dim, "wuk": cfg.qk_nope_dim,
                "wuv": cfg.v_head_dim, "wo": cfg.v_head_dim}[leaf]
        return _block(0 if leaf == "wo" else 1, n, j, h, unit)
    if "mixer" in parts and leaf in ("wq", "wk", "wv", "wo"):
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        g = h // hkv
        if h % n or (h // n) % g and g % (h // n):
            return None
        if leaf in ("wq", "wo"):
            return _block(0 if leaf == "wo" else 1, n, j, h, hd)
        if train and hkv < n:  # a kv head shared by ranks: whole
            return None
        q0, q1 = j * (h // n), (j + 1) * (h // n)
        return 1, (slice(q0 // g * hd, ((q1 - 1) // g + 1) * hd),)
    if leaf in ("wg", "wu", "wd") and len(shape) == 2:
        dim = 0 if leaf == "wd" else 1
        return _block(dim, n, j, shape[dim]) if shape[dim] % n == 0 else None
    return None


# ---------------------------------------------------------------------------
# batches & caches
# ---------------------------------------------------------------------------


def batch_spec(name: str, shape: tuple[int, ...], mesh, dp_axes) -> tuple:
    n_dp = _axis_size(mesh, dp_axes)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    if len(shape) == 0:
        return ()
    if shape[0] % n_dp == 0 and shape[0] >= n_dp:
        return tuple([dp] + [None] * (len(shape) - 1))
    return tuple([None] * len(shape))


def cache_spec(path: str, shape: tuple[int, ...], mesh, dp_axes) -> tuple:
    """Decode caches: batch -> data, seq -> model (flash-decode layout);
    SSM state: batch -> data, d_inner -> model."""
    n_dp = _axis_size(mesh, dp_axes)
    n_mp = mesh.shape["model"]
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    leaf = path.rsplit("/", 1)[-1]
    stacked = "/stack/" in f"/{path}/"
    lead = 1 if stacked else 0
    spec: list[Any] = [None] * len(shape)
    if len(shape) == 0:
        return ()

    if leaf in ("k", "v", "c_kv", "k_rope"):
        # (B, T, ...) [+ leading period axis]
        if shape[lead] % n_dp == 0 and shape[lead] >= n_dp:
            spec[lead] = dp
        if shape[lead + 1] % n_mp == 0 and shape[lead + 1] >= n_mp:
            spec[lead + 1] = "model"
        return tuple(spec)
    if leaf == "kv_pos":
        if shape[lead] % n_mp == 0 and shape[lead] >= n_mp:
            spec[lead] = "model"
        return tuple(spec)
    if leaf in ("conv", "ssm"):
        # (B, dc-1, di) / (B, di, ds)
        if shape[lead] % n_dp == 0 and shape[lead] >= n_dp:
            spec[lead] = dp
        di_dim = lead + 2 if leaf == "conv" else lead + 1
        if di_dim < len(shape) and shape[di_dim] % n_mp == 0:
            spec[di_dim] = "model"
        return tuple(spec)
    if leaf == "enc_out":
        if shape[0] % n_dp == 0 and shape[0] >= n_dp:
            spec[0] = dp
        if shape[-1] % n_mp == 0:
            spec[-1] = "model"
        return tuple(spec)
    return tuple(spec)  # pos scalar etc: replicated


def cache_pspecs(cache_tree, mesh, dp_axes):
    return _map_with_path(lambda p, l: cache_spec(p, tuple(l.shape), mesh, dp_axes), cache_tree)
