"""Checkpointing of tensor trees and FL server state (numpy ``.npz`` plus a
JSON manifest) — the port of the JAX package's ``checkpoint/``."""

from repro_torch.checkpoint.checkpoint import (
    load_fl_state,
    load_host_arrays,
    load_pytree,
    load_pytree_auto,
    save_fl_state,
    save_host_arrays,
    save_pytree,
)

__all__ = [
    "save_pytree",
    "load_pytree",
    "load_pytree_auto",
    "save_host_arrays",
    "load_host_arrays",
    "save_fl_state",
    "load_fl_state",
]
