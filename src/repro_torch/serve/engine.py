"""Batched personalized inference: one forward, B heterogeneous models — the
port of the JAX package's ``serve/engine.py``.

A serving request is ``(client_id, inputs)``. The engine pairs the shared
global base with that client's personalization state the same way training
does — ``core.personalization.compose_model`` over the per-client share
mask — but across a *batch* of different clients at once: the cohort
gather (``fl.cohort.tree_take``) pulls each requested client's local
layers out of the ``(C, ...)`` slabs into ``(B, ...)`` batch lanes,
``compose_model`` selects global-vs-local per lane and layer, and the
lane form of the forward (``models.mlp.mlp_apply`` with ``(B, F, H)``
weights: one batched matrix product a layer) scores all B personalized
models at once.

Per-lane bit-identity is load-bearing: lane i of the batched forward is
bitwise ``forward_unbatched(client_i, x_i)``, for any batch size and any
mix of personalization modes in the batch. Composition is gather and
select (exact), but a matrix product's reduction order is the library's
choice and may change with the shape of the call. On an H100, every lane
of an unpadded ``(B, 1, F) x (B, F, H)`` har-mlp forward at B = 2 to 30
differs in its last bits (up to 3.4e-7 of max|logit|) from the same
client's ``(1, 1, F) x (1, F, H)`` forward (``chip_smoke.py``
``[classify]`` measures it); oneDNN on the CPU can differ the same way,
and a (1, F) x (F, H) product differs from a batched one. So every forward
goes through ONE lane-shaped call: the batch is cut into blocks of
``LANES`` lanes, a short block is padded with client 0 and zero inputs
(as the JAX package's ``ClassifyProgram`` pads its empty lanes), and each
block runs the same ``(LANES, 1, F) x (LANES, F, H)`` products. A client's
lane then meets the same kernel, the same shapes and its own data whatever
the batch around it, and ``forward_unbatched`` is a block of one request.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.personalization import compose_model
from repro_torch.fl.cohort import tree_take
from repro_torch.models.mlp import mlp_apply
from repro_torch.serve.artifact import ServableArtifact
from repro_torch.tree import tree_map

__all__ = ["LANES", "PersonalizedEngine"]

LANES = 32  # the block every forward is cut into and padded to


@dataclasses.dataclass
class PersonalizedEngine:
    """Serves an artifact: ``forward(client_ids, x)`` -> per-lane outputs,
    on the artifact's device.

    ``apply_fn(lane_params, x) -> out`` is the lane form of the model's
    forward (default: the paper's MLP, ``mlp_apply`` with per-lane
    ``(B, F, H)`` weights and ``(B, N, F)`` inputs). Every forward runs in
    blocks of ``LANES`` lanes (see the module docstring).
    """

    artifact: ServableArtifact
    apply_fn: Callable = mlp_apply

    def __post_init__(self):
        self._global = self.artifact.global_params
        self._local = self.artifact.local_params
        self._share = self.artifact.share_mask.to(torch.bool)
        self.device = self._share.device

    # -- model composition --------------------------------------------------
    def lane_models(self, client_ids):
        """Gather + compose the (B, ...) personalized models for a batch of
        client ids — the serve-side analogue of the trainer's cohort
        gather. Every leaf is a contiguous (B, ...) tensor."""
        ids = torch.as_tensor(client_ids, dtype=torch.int64).to(self.device)
        if self._local is None:
            return tree_map(
                lambda gl: gl.expand((ids.shape[0],) + tuple(gl.shape)).contiguous(),
                self._global)
        local_lanes = tree_take(self._local, ids)              # (B, ...) per leaf
        share_lanes = self._share.index_select(0, ids)         # (B, L)
        return compose_model(self._global, local_lanes, share_lanes)

    # -- entry points --------------------------------------------------------
    def forward(self, client_ids, x) -> torch.Tensor:
        """(B,) client ids + (B, ...) inputs -> (B, ...) outputs for the
        whole heterogeneous batch, in blocks of ``LANES`` lanes."""
        ids = torch.as_tensor(client_ids, dtype=torch.int64).to(self.device).reshape(-1)
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if x.shape[0] != ids.shape[0]:
            raise ValueError(f"{ids.shape[0]} client ids for {x.shape[0]} inputs")
        outs = []
        with torch.no_grad():
            for s in range(0, ids.shape[0], LANES):
                b_ids, b_x = ids[s:s + LANES], x[s:s + LANES]
                n = b_ids.shape[0]
                if n < LANES:  # pad: client 0, zero inputs (dropped below)
                    b_ids = torch.cat([b_ids, b_ids.new_zeros((LANES - n,))])
                    b_x = torch.cat([b_x, b_x.new_zeros((LANES - n,) + tuple(b_x.shape[1:]))])
                out = self.apply_fn(self.lane_models(b_ids), b_x.unsqueeze(1))
                outs.append(out[:n, 0])
        return torch.cat(outs)

    def client_model(self, client_id: int):
        """ONE client's composed model (leaves without the lane axis),
        composed exactly as training's eval does."""
        lane = self.lane_models([int(client_id)])
        return tree_map(lambda leaf: leaf[0], lane)

    def forward_unbatched(self, client_id: int, x_single) -> torch.Tensor:
        """Per-client reference forward: ``client_id``'s model on one input
        row, through the same lane-shaped call as every batch (a block of
        one request)."""
        x_single = torch.as_tensor(x_single, dtype=torch.float32)
        return self.forward([int(client_id)], x_single[None])[0]
