"""Personalization (paper §3.4): the fine-tuning choice P(w_l, w_g) (Eq. 8)
and the [w^g, w^l] composition of the layer-sharing variants — the port of
the JAX package's ``core/personalization.py``.

Local parameters are *stacked*: every leaf carries a leading client axis
(C, ...); global leaves are unstacked and broadcast.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def _lane_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


def personalize_ft(local_params, global_params, local_loss, global_loss):
    """Eq. (8): client i keeps w_i^l if L(w_i^l) <= L(w^g), else w^g."""
    use_local = local_loss <= global_loss  # (C,)
    return tree_map(
        lambda lo, gl: torch.where(_lane_mask(use_local, lo), lo, gl.expand_as(lo)),
        local_params,
        global_params,
    )


def compose_model(global_params, local_params, share_mask: torch.Tensor):
    """w_i = [w^g, w_i^l]: for layer j and client i, the global layer where
    ``share_mask[i, j]`` else the client's local layer. ``share_mask`` is
    (C, L) or (L,); ``global_params`` leaves are (...) or stacked (C, ...)."""
    share_mask = torch.as_tensor(share_mask)
    if share_mask.ndim == 1:
        n_lanes = tree_leaves(local_params[0])[0].shape[0]
        share_mask = share_mask[None, :].expand(n_lanes, share_mask.shape[0])
    out = []
    for j in range(len(local_params)):
        m_j = share_mask[:, j]
        out.append(
            tree_map(
                lambda gl, lo, m_j=m_j: torch.where(_lane_mask(m_j, lo), gl.expand_as(lo), lo),
                global_params[j],
                local_params[j],
            )
        )
    return out
