"""Decay function phi (paper Eq. 6): ``phi(S, t) = ceil(|S| * (1 - decay)^t)``
— the port of the JAX package's ``core/decay.py``."""

from __future__ import annotations

import torch


def phi_decay(cohort_size: torch.Tensor | int, t, decay: float) -> torch.Tensor:
    """Number of clients to keep at round ``t`` (Eq. 6): int32
    ``ceil(|S| * (1-decay)^t)`` clipped to ``[0, |S|]``, with the power and
    product in float32 as the JAX package computes them. ``t`` is a Python
    int or an integer tensor on ``cohort_size``'s device (the round's own
    index under a CUDA-graph replay)."""
    size = torch.as_tensor(cohort_size)
    s = size.to(torch.float32)
    base = torch.full((), 1.0 - decay, dtype=torch.float32, device=s.device)
    tt = (t if torch.is_tensor(t) else torch.full((), t, device=s.device)).to(torch.float32)
    kept = torch.ceil(s * torch.pow(base, tt)).to(torch.int32)
    return torch.clamp(kept, min=0).minimum(size.to(torch.int32))
