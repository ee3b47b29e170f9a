"""Servable artifact: the frozen output of a federated run that the serving
engine loads — the port of the JAX package's ``serve/artifact.py``.

ACSP-FL's Personalizer phase produces three things worth deploying: the
shared global model, each client's personalized local layers, and the
per-client share structure (FT pick / PMS depth / DLD depth). Training
carries them in ``RoundState``; this module freezes them into an on-disk
artifact (``repro_torch.checkpoint`` npz + a serve manifest) that
``repro_torch.serve.engine`` serves from.

The unifying representation is the **(C, L) share mask**: for every client
and layer, True means "use the shared global layer", False "use my
personalized local layer". All four personalization modes project onto it:

- ``none``  -> all-True rows (no local slab is stored at all);
- ``ft``    -> the Eq. 8 pick, frozen at export time by comparing each
  client's local-model vs global-model loss on its own test shard — an
  all-False row (keep my whole model) or an all-True row (take the global);
- ``pms``/``dld`` -> the prefix mask ``layer_share_mask`` training used.

The on-disk layout is the JAX package's (``servable.npz``, its
``servable.json`` key manifest and ``servable.meta.json``), so
``load_servable`` also reads a directory the JAX package wrote; it goes
through ``repro_torch.weights.servable_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable

import torch

from repro_torch.checkpoint import load_pytree_auto, save_pytree
from repro_torch.core.layersharing import layer_share_mask
from repro_torch.device import resolve_device
from repro_torch.fl.api import FLConfig, RoundState, build_round_step
from repro_torch.models.mlp import mlp_accuracy, mlp_loss

__all__ = ["ServableArtifact", "servable_from_state", "save_servable", "load_servable",
           "fit_servable"]

SERVE_MANIFEST = "servable.meta.json"
SERVE_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ServableArtifact:
    """Everything the serving engine needs, on one device.

    ``local_params`` is None for artifacts without personalization state
    (mode 'none'); ``share_mask`` is always present and fully describes
    each client's composition. ``meta`` carries provenance (mode, rounds
    trained, strategy) for the serve manifest.
    """

    global_params: Any          # layered list, leaves (...)
    local_params: Any           # layered list, leaves (C, ...); or None
    share_mask: torch.Tensor    # (C, L) bool — True: use the global layer
    meta: dict

    @property
    def n_clients(self) -> int:
        return int(self.share_mask.shape[0])

    @property
    def n_layers(self) -> int:
        return int(self.share_mask.shape[1])


def _ft_pick(global_params, local_params, data) -> torch.Tensor:
    """(C,) Eq. 8 pick frozen at export: True -> client keeps its local
    model (its loss on the client's own test shard is <= the global's)."""
    dev = global_params[0]["w"].device
    x = torch.as_tensor(data.x_test, dtype=torch.float32, device=dev)
    y = torch.as_tensor(data.y_test, dtype=torch.int64, device=dev)
    m = torch.as_tensor(data.m_test, dtype=torch.bool, device=dev)
    with torch.no_grad():
        loss_loc = mlp_loss(local_params, x, y, m)
        loss_glob = mlp_loss(global_params, x, y, m)
    return loss_loc <= loss_glob


def servable_from_state(state: RoundState, mode: str, data=None,
                        extra_meta: dict | None = None) -> ServableArtifact:
    """Project a trained ``RoundState`` onto the serve representation, on
    the state's device.

    ``mode`` is the run's personalization mode; ``data`` is required for
    ``ft`` (the pick is frozen against each client's test shard, the
    comparison ``FTPersonalizer`` makes every round).
    """
    n_layers = len(state.global_params)
    c = int(state.select.shape[0])
    dev = state.select.device
    if mode == "none" or state.local_params is None:
        share = torch.ones((c, n_layers), dtype=torch.bool, device=dev)
        local = None
        mode = "none"
    elif mode == "ft":
        if data is None:
            raise ValueError("mode 'ft' needs the dataset to freeze the Eq. 8 pick")
        use_local = _ft_pick(state.global_params, state.local_params, data)
        share = (~use_local)[:, None].expand(c, n_layers).clone()
        local = state.local_params
    elif mode in ("pms", "dld"):
        share = layer_share_mask(n_layers, state.pms)
        local = state.local_params
    else:
        raise ValueError(f"unknown personalization mode {mode!r}")
    meta = {
        "schema_version": SERVE_SCHEMA_VERSION,
        "mode": mode,
        "n_clients": c,
        "n_layers": n_layers,
        "stateful": local is not None,
        "personalized_clients": int((~share.all(dim=1)).sum()),
    }
    meta.update(extra_meta or {})
    return ServableArtifact(global_params=state.global_params, local_params=local,
                            share_mask=share, meta=meta)


def save_servable(artifact: ServableArtifact, directory: str) -> str:
    """Write the artifact: one ``servable.npz`` checkpoint (global params +
    local slabs + share mask) plus ``servable.meta.json``."""
    tree: dict[str, Any] = {"global": artifact.global_params, "share": artifact.share_mask}
    if artifact.local_params is not None:
        tree["local"] = artifact.local_params
    path = save_pytree(tree, directory, "servable")
    with open(os.path.join(directory, SERVE_MANIFEST), "w") as f:
        json.dump(artifact.meta, f, indent=1, default=str)
        f.write("\n")
    return path


def load_servable(directory: str, device=None) -> ServableArtifact:
    """Load an artifact saved by ``save_servable`` — this package's or the
    JAX package's (no template needed) — onto ``device`` (the CUDA card by
    default)."""
    from repro_torch.weights import servable_from_numpy

    dev = resolve_device(device)
    with open(os.path.join(directory, SERVE_MANIFEST)) as f:
        meta = json.load(f)
    tree = load_pytree_auto(directory, "servable")
    return servable_from_numpy(
        ServableArtifact(global_params=tree["global"], local_params=tree.get("local"),
                         share_mask=tree["share"], meta=meta), dev)


def fit_servable(data, cfg: FLConfig, device=None, progress: bool = False,
                 init_fn: Callable | None = None) -> tuple[ServableArtifact, RoundState]:
    """Train ``cfg.rounds`` synchronous rounds on ``device`` (the CUDA card
    by default) and freeze the final state into a servable artifact.

    Drives the same round step ``SyncScheduler`` runs (same key chain,
    same initial state; with ``codec="int8"`` it launches quantize,
    dequantize and masked_aggregate a round on the card), but keeps the
    final ``RoundState`` — the scheduler's ``run`` only returns host-side
    history, and the serving path needs the trained slabs themselves.
    ``init_fn`` maps a key on the device to the initial layered model, as
    in ``run_federated`` (default: ``init_mlp``).
    """
    from repro_torch.fl.sched import _setup_run, check_slice, initial_state

    dev = resolve_device(device)
    check_slice(cfg)
    su = _setup_run(data, cfg, dev, init_fn, mlp_loss, mlp_accuracy, None, None, None)
    state = initial_state(su, data.n_clients)
    step = build_round_step(su.env, su.pipeline, cfg.execution)
    for t in range(cfg.rounds):
        state, out = step(state, t)
        if progress and (t % 10 == 0 or t == cfg.rounds - 1):
            print(f"  round {t:3d}  acc={float(out['acc'].mean()):.4f}")
    artifact = servable_from_state(
        state, cfg.personalization.mode, data=data,
        extra_meta={"rounds": cfg.rounds, "strategy": cfg.strategy,
                    "dataset": getattr(data, "name", "?"), "seed": cfg.seed},
    )
    return artifact, state
