"""Deterministic fault injection for the schedulers — the port of the JAX
package's ``fl/faults.py``.

A ``FaultConfig`` compiles, per round, into a ``FaultPlan`` of population
width (C,) lanes: ``crash`` (bool, the client crashes before upload),
``slow`` (float64 multiplier of its simulated duration) and ``corrupt``
(int8 corruption kind: 0 none, 1 NaN, 2 +Inf, 3 scaled by
``corrupt_scale``). The plan is host numpy drawn from numpy
``SeedSequence`` child streams, the JAX package's streams draw for draw, so
both packages compile bitwise the same plan: a pure function of (fault
config, run seed, round index, client id), prefix-stable in the population
size.

The schedulers resolve the plan on the host (selection masks, slowed
durations, retries); only the corruption kinds of the cohort or landing
slots reach the device, where ``apply_corruption`` rewrites the trained
parameters after the trainer and before transmit, so the transmitted
``update_norm`` carries the corruption and the always-on finite guard
rejects it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import CORRUPTION_KINDS, FaultConfig
from repro_torch.tree import tree_map

__all__ = ["CORRUPTION_KINDS", "FAULT_TAG", "FaultPlan", "compile_fault_plan", "apply_corruption"]

# domain separation: fault draws never collide with the other streams of
# the same run seed (the JAX package's tag)
FAULT_TAG = 0xFA017


class FaultPlan(NamedTuple):
    """Per-round fault lanes over the population (host numpy)."""

    crash: np.ndarray    # (C,) bool — crash before upload
    slow: np.ndarray     # (C,) float64 — duration multiplier (>= 1.0)
    corrupt: np.ndarray  # (C,) int8 — CORRUPTION_KINDS index + 1, 0 = none


def _lane_rng(seed: int, fault_seed: int, t: int, child: int) -> np.random.Generator:
    ss = np.random.SeedSequence([FAULT_TAG, int(seed), int(fault_seed), int(t)])
    return np.random.default_rng(ss.spawn(4)[child])


def compile_fault_plan(faults: FaultConfig, seed: int, t: int, n_clients: int) -> FaultPlan:
    """The seeded fault plan of round ``t`` as (C,) lanes: each fault type
    draws from its own spawned child stream, so lane ``i`` depends only on
    ``(faults, seed, t, i)``."""
    c = int(n_clients)
    if faults.dropout_rate > 0.0:
        crash = _lane_rng(seed, faults.fault_seed, t, 0).random(c) < faults.dropout_rate
    else:
        crash = np.zeros((c,), dtype=bool)
    if faults.slow_rate > 0.0:
        slow_hit = _lane_rng(seed, faults.fault_seed, t, 1).random(c) < faults.slow_rate
        slow = np.where(slow_hit, float(faults.slow_factor), 1.0)
    else:
        slow = np.ones((c,), dtype=np.float64)
    if faults.corrupt_rate > 0.0:
        hit = _lane_rng(seed, faults.fault_seed, t, 2).random(c) < faults.corrupt_rate
        # kinds from their own child stream, so lane i's kind stays prefix-stable
        kind = _lane_rng(seed, faults.fault_seed, t, 3).integers(
            1, len(CORRUPTION_KINDS) + 1, size=c)
        corrupt = np.where(hit, kind, 0).astype(np.int8)
    else:
        corrupt = np.zeros((c,), dtype=np.int8)
    return FaultPlan(crash=crash, slow=slow, corrupt=corrupt)


def apply_corruption(trees, kinds: torch.Tensor, scale: float):
    """Rewrite (lanes, ...) parameter trees by the (lanes,) corruption
    kinds: 0 leaves a lane bitwise unchanged, 1 fills it with NaN, 2 with
    +Inf, 3 multiplies it by ``scale`` (one rounding, in the leaf's dtype)."""

    def leaf_fn(x: torch.Tensor) -> torch.Tensor:
        k = kinds.reshape((-1,) + (1,) * (x.ndim - 1))
        y = torch.where(k == 1, torch.full((), float("nan"), dtype=x.dtype, device=x.device), x)
        y = torch.where(k == 2, torch.full((), float("inf"), dtype=x.dtype, device=x.device), y)
        return torch.where(k == 3, x * torch.full((), scale, dtype=x.dtype, device=x.device), y)

    return tree_map(leaf_fn, trees)
