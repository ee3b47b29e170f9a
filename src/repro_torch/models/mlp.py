"""The paper's model (§4.2): MLP with three hidden layers of 256 units,
SGD + sparse categorical cross-entropy, as a *layered* parameter list
(``[{'w','b'}, ...]``) so the layer-sharing code can index layers — the
port of the JAX package's ``models/mlp.py``.

Every function takes a leading lane axis where the JAX package vmaps: with
``x`` of shape (K, N, F) and parameters either shared (``w`` (F, H), ``b``
(H,)) or per lane (``w`` (K, F, H), ``b`` (K, H)) the results carry the K
axis ((K, N, classes) logits, (K,) loss and accuracy).
"""

from __future__ import annotations

import torch

from repro_torch import random as prng

MLP_HIDDEN = (256, 256, 256)


def init_mlp(key: torch.Tensor, n_features: int, n_classes: int, hidden=MLP_HIDDEN):
    """He-initialized layered MLP params on ``key``'s device: the draws of
    the JAX ``init_mlp`` (``normal`` within 3 ulp, see ``repro_torch.random``)."""
    sizes = (n_features, *hidden, n_classes)
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        key, sub = prng.split(key)
        std = torch.sqrt(torch.tensor(2.0 / fan_in, dtype=torch.float32, device=key.device))
        w = prng.normal(sub, (fan_in, fan_out)) * std
        params.append({"w": w, "b": torch.zeros((fan_out,), dtype=torch.float32, device=key.device)})
    return params


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass -> logits. ReLU between layers, linear head."""
    h = x
    for i, layer in enumerate(params):
        w, b = layer["w"], layer["b"]
        if w.ndim == 3:  # per-lane weights: (K, H) bias broadcasts over rows
            b = b.unsqueeze(-2)
        h = torch.matmul(h, w) + b
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def mlp_loss(params, x, y, mask) -> torch.Tensor:
    """Masked sparse categorical cross-entropy (paper's loss); ``y`` int64."""
    logits = mlp_apply(params, x)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, y.unsqueeze(-1)).squeeze(-1)
    m = mask.to(torch.float32)
    return torch.sum(nll * m, dim=-1) / torch.clamp_min(torch.sum(m, dim=-1), 1.0)


def mlp_accuracy(params, x, y, mask) -> torch.Tensor:
    pred = torch.argmax(mlp_apply(params, x), dim=-1)
    m = mask.to(torch.float32)
    hit = (pred == y).to(torch.float32)
    return torch.sum(hit * m, dim=-1) / torch.clamp_min(torch.sum(m, dim=-1), 1.0)
