"""Dependency-free checkpointing — the port of the JAX package's
``checkpoint/checkpoint.py``.

A tree (nested NamedTuples, tuples, lists and dicts of tensors; ``None``
subtrees hold nothing) is saved as one ``.npz`` of its leaves keyed by
their path (``state/global_params/0/w``) and a JSON manifest of the keys,
dtypes and shapes beside it. Loading fills a template of the same
structure and puts every leaf on its template leaf's device and dtype
(bfloat16 round-trips through the float32 the ``.npz`` stores). Host
arrays (the schedulers' float64 accounting lanes) are saved verbatim. The
file names are the JAX package's (``round_{r:05d}``, ``hist_{r:05d}``);
the FL-state files are not meant to be read by the other package.
``load_pytree_auto`` needs no template: it rebuilds nested dicts and
lists from the key paths, and reads a directory written by either
package's ``save_pytree`` (the key paths are the same; the manifest's
dtypes are numpy's names in the JAX package's, torch's in the port's).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "load_pytree_auto", "save_host_arrays",
           "load_host_arrays", "save_fl_state", "load_fl_state"]


def _leaves_with_paths(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a tree in a fixed order: NamedTuple fields
    by name, dict keys sorted, list and tuple items by index."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, sub in items:
        out += _leaves_with_paths(sub, f"{prefix}/{name}" if prefix else name)
    return out


def _rebuild(template, leaves):
    """``template``'s structure filled from the iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_rebuild(v, leaves) for v in template])
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # no numpy bfloat16: float32 holds it exactly
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def save_pytree(tree, directory: str, name: str = "ckpt") -> str:
    """Save ``tree``'s leaves to ``directory/name.npz`` and its manifest to
    ``name.json``; returns the ``.npz`` path."""
    os.makedirs(directory, exist_ok=True)
    arrays, dtypes = {}, {}
    for i, (path, leaf) in enumerate(_leaves_with_paths(tree)):
        key = path or f"leaf{i}"
        dtypes[key] = str(leaf.dtype) if torch.is_tensor(leaf) else str(np.asarray(leaf).dtype)
        arrays[key] = _to_numpy(leaf)
    npz_path = os.path.join(directory, f"{name}.npz")
    np.savez(npz_path, **arrays)
    manifest = {"keys": list(arrays), "dtypes": dtypes,
                "shapes": {k: list(a.shape) for k, a in arrays.items()}}
    with open(os.path.join(directory, f"{name}.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return npz_path


def load_pytree(template, directory: str, name: str = "ckpt"):
    """Load ``directory/name.npz`` into ``template``'s structure: each leaf
    takes its template leaf's dtype and device (a tensor template leaf
    gives a tensor, anything else a numpy array)."""
    with np.load(os.path.join(directory, f"{name}.npz")) as data:
        leaves = []
        for i, (path, like) in enumerate(_leaves_with_paths(template)):
            arr = data[path or f"leaf{i}"]
            if torch.is_tensor(like):
                t = torch.from_numpy(arr.copy())
                leaves.append(t.to(device=like.device, dtype=like.dtype))
            else:
                leaves.append(arr.copy())
    return _rebuild(template, iter(leaves))


def _torch_dtype(name: str | None) -> torch.dtype | None:
    """A manifest dtype name (``float32``, ``torch.bfloat16``) as a torch dtype."""
    if name is None:
        return None
    dtype = getattr(torch, name.removeprefix("torch."), None)
    return dtype if isinstance(dtype, torch.dtype) else None


def _listify(node):
    """Nested dicts from key paths -> the tree: a dict whose keys are all
    digits (``0``..``n-1``) becomes a list."""
    if not isinstance(node, dict):
        return node
    items = {k: _listify(v) for k, v in node.items()}
    if items and all(k.isdigit() for k in items):
        return [items[str(i)] for i in range(len(items))]
    return items


def load_pytree_auto(directory: str, name: str = "ckpt"):
    """Load a checkpoint WITHOUT a template, rebuilding nested dicts and
    lists from the manifest's key paths: an all-digit path segment becomes
    a list index, anything else a dict key. Leaves come back as CPU
    tensors in their saved dtypes (bfloat16 through the float32 the
    ``.npz`` holds, exactly). Trees with NamedTuples need ``load_pytree``'s
    template."""
    with open(os.path.join(directory, f"{name}.json")) as f:
        manifest = json.load(f)
    root: dict = {}
    with np.load(os.path.join(directory, f"{name}.npz")) as data:
        for key in manifest["keys"]:
            t = torch.from_numpy(data[key].copy())
            want = _torch_dtype(manifest.get("dtypes", {}).get(key))
            if want is not None and t.dtype != want:
                t = t.to(want)
            *parents, last = key.split("/")
            node = root
            for seg in parents:
                node = node.setdefault(seg, {})
            node[last] = t
    return _listify(root)


def save_host_arrays(arrays: dict, directory: str, name: str) -> str:
    """Save a flat dict of host numpy arrays verbatim (one ``.npz``): the
    float64 accounting lanes round-trip bitwise."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return path


def load_host_arrays(directory: str, name: str) -> dict:
    """A ``save_host_arrays`` dict back as numpy arrays."""
    with np.load(os.path.join(directory, f"{name}.npz")) as data:
        return {k: data[k].copy() for k in data.files}


def save_fl_state(state_dict: dict, directory: str, round_idx: int) -> str:
    """Save a server-state dict for round ``round_idx``: its trees through
    ``save_pytree`` (``round_{r:05d}.npz``), its int/float/str scalars with
    the round in ``round_{r:05d}_meta.json``."""
    name = f"round_{round_idx:05d}"
    scalars = {k: v for k, v in state_dict.items() if isinstance(v, (int, float, str))}
    trees = {k: v for k, v in state_dict.items() if k not in scalars}
    path = save_pytree(trees, directory, name)
    with open(os.path.join(directory, f"{name}_meta.json"), "w") as f:
        json.dump({"round": round_idx, **scalars}, f)
    return path


def load_fl_state(template_trees: dict, directory: str, round_idx: int | None = None):
    """``(trees, meta)`` of round ``round_idx`` (default: the latest
    ``round_*.npz`` in ``directory``), the trees in ``template_trees``'s
    structure."""
    if round_idx is None:
        rounds = [int(m.group(1)) for fn in os.listdir(directory)
                  if (m := re.match(r"round_(\d+)\.npz$", fn))]
        if not rounds:
            raise FileNotFoundError(f"no FL checkpoints in {directory}")
        round_idx = max(rounds)
    name = f"round_{round_idx:05d}"
    trees = load_pytree(template_trees, directory, name)
    with open(os.path.join(directory, f"{name}_meta.json")) as f:
        meta = json.load(f)
    return trees, meta
