"""Differential privacy for ACSP-FL — the port of the JAX package's
``core/privacy.py`` (paper §5: "additional methods to improve clients'
privacy can be implemented in ACSP-FL such as secure aggregation and
differential privacy based algorithms").

Client-level DP-FedAvg (McMahan et al. 2018):
  1. each selected client's model DELTA (w_i - w_global) is clipped to an
     L2 ball of radius ``clip``;
  2. Gaussian noise N(0, (noise_multiplier * clip)^2 / n_selected) is added
     to the AGGREGATED delta (central DP; per-client noise for local DP).

Trees are the port's nested lists/dicts of tensors, leaves in the JAX
package's order (``repro_torch.tree``); the noise keys are split as the
JAX package splits them and drawn by ``repro_torch.random.normal``. No FL
phase calls this module yet, in either package.
"""

from __future__ import annotations

import math

import torch

from repro_torch import random as prng
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["add_gaussian_noise", "clip_client_updates", "clip_update", "dp_aggregate_deltas",
           "noise_multiplier_for_epsilon"]


def _sq_norm(leaves, dims_from: int) -> torch.Tensor:
    """Sum of squares (float32) over every leaf, over axes ``dims_from`` on."""
    total = None
    for x in leaves:
        x = x.to(torch.float32)
        s = torch.sum(x * x, dim=tuple(range(dims_from, x.ndim))) if x.ndim > dims_from \
            else x * x
        total = s if total is None else total + s
    return total


def clip_update(delta, clip: float):
    """Clip a tree update to L2 norm <= clip. Returns (clipped, norm)."""
    norm = torch.sqrt(_sq_norm(tree_leaves(delta), 0))
    scale = torch.clamp_max(clip / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), delta), norm


def clip_client_updates(client_deltas, clip: float):
    """``clip_update`` for every client of stacked leaves (C, ...): each
    client's norm over its own elements. Returns (clipped, norms (C,))."""
    norms = torch.sqrt(_sq_norm(tree_leaves(client_deltas), 1))
    scale = torch.clamp_max(clip / torch.clamp_min(norms, 1e-12), 1.0)
    return tree_map(lambda x: (x * scale.reshape((-1,) + (1,) * (x.ndim - 1))).to(x.dtype),
                    client_deltas), norms


def add_gaussian_noise(tree, rng: torch.Tensor, sigma: float):
    """Add N(0, sigma^2) noise to every leaf (central-DP aggregate); leaf i
    draws from key i of ``split(rng, n_leaves)``."""
    leaves = tree_leaves(tree)
    rngs = prng.split(rng, len(leaves))
    noised = [(x + sigma * prng.normal(rngs[i], tuple(x.shape)).to(x.dtype))
              for i, x in enumerate(leaves)]
    return tree_unflatten(tree, noised)


def dp_aggregate_deltas(client_deltas, select_mask, clip: float, noise_multiplier: float,
                        rng: torch.Tensor):
    """Client-level central DP-FedAvg on model deltas.

    client_deltas: tree, leaves (C, ...) = w_i - w_global of each client.
    Returns the noised mean delta over SELECTED clients (unweighted mean —
    DP requires bounded per-client sensitivity, so |d_i| weighting is
    dropped, the standard DP-FedAvg trade-off).
    """
    clipped, _ = clip_client_updates(client_deltas, clip)
    m = select_mask.to(torch.float32)
    n_sel = torch.clamp_min(m.sum(), 1.0)

    def mean(x):
        w = m.reshape((-1,) + (1,) * (x.ndim - 1))
        return (x.to(torch.float32) * w).sum(0) / n_sel

    agg = tree_map(mean, clipped)
    sigma = noise_multiplier * clip / n_sel
    return add_gaussian_noise(agg, rng, sigma)


def noise_multiplier_for_epsilon(epsilon: float, delta: float, rounds: int,
                                 sample_rate: float = 1.0) -> float:
    """Crude (moments-accountant-free) Gaussian-mechanism calibration:
    sigma >= sample_rate * sqrt(2 * rounds * ln(1.25/delta)) / epsilon.
    Upper-bounds the true RDP accounting — safe but loose."""
    return sample_rate * math.sqrt(2.0 * rounds * math.log(1.25 / delta)) / epsilon
