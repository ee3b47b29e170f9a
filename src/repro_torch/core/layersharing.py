"""Partial model sharing: K(w, L) and dynamic layer definition (paper §3.4)
— the port of the JAX package's ``core/layersharing.py``.

A *layered model* is a list of per-layer ``{'w','b'}`` dicts; ``K(w, L)``
keeps the first ``n`` layers (the shared global piece). The shared prefix is
expressed as a boolean share mask over the layer axis, so a per-client PMS
(Eq. 9) drives aggregation and accounting without shape changes.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves


def num_layers(params) -> int:
    """Number of layers of a layered model (static)."""
    if not isinstance(params, (list, tuple)):
        raise TypeError("layered model must be a list/tuple of per-layer pytrees")
    return len(params)


def cut_model(params, n_shared: int):
    """K(w, L): split into ``(global piece, local piece)`` at a static cut."""
    m = num_layers(params)
    n = int(n_shared)
    if not 0 <= n <= m:
        raise ValueError(f"n_shared={n} outside [0, {m}]")
    return list(params[:n]), list(params[n:])


def dynamic_layer_definition(accuracy: torch.Tensor, total_layers: int) -> torch.Tensor:
    """DLD (Eq. 9): PMS = total_layers if A^t <= 0.25 else ceil(1 / A^t),
    elementwise, int32 in [1, total_layers]."""
    a = torch.as_tensor(accuracy).to(torch.float32)
    full = torch.full_like(a, float(total_layers))
    inv = torch.div(torch.ones_like(a), torch.clamp_min(a, 1e-6))
    pms = torch.where(a <= 0.25, full, torch.ceil(inv))
    return torch.clamp(pms.to(torch.int32), 1, total_layers)


def layer_share_mask(total_layers: int, pms: torch.Tensor) -> torch.Tensor:
    """Boolean mask over layers, layer j shared iff j < pms: (L,) for a
    scalar ``pms``, (C, L) for a per-client (C,) one."""
    pms = torch.as_tensor(pms)
    layer_idx = torch.arange(total_layers, device=pms.device)
    if pms.ndim == 0:
        return layer_idx < pms
    if pms.ndim == 1:
        return layer_idx[None, :] < pms[:, None]
    raise ValueError(f"pms must be scalar or (C,), got shape {tuple(pms.shape)}")


def shared_param_count(params, pms: int) -> int:
    """Parameters transmitted one-way when sharing the first ``pms`` layers."""
    w_g, _ = cut_model(params, pms)
    return sum(int(x.numel()) for x in tree_leaves(w_g))


def layer_param_sizes(params) -> list[int]:
    """Parameter count of each layer (for analytic TX accounting), as Python
    ints: the sizes are static, so no device round trip is needed."""
    return [sum(int(x.numel()) for x in tree_leaves(layer)) for layer in params]
