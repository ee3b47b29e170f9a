"""The simulated communication/compute clock of the schedulers (paper
§4.3's overhead metric) — the part of the JAX package's ``core/metrics.py``
the ported slices need, the two-level (edge-server) topology's partition,
hop bytes and round times included. Host-side numpy in float64, as there.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BYTES_PER_PARAM = 4  # float32, as in the paper's Flower/TF setup


@dataclasses.dataclass
class CommModel:
    """Simple channel/compute model for the simulated-time overhead metric."""

    bandwidth_bytes_per_s: float = 12.5e6   # 100 Mbit/s edge uplink
    client_flops_per_s: float = 5e9         # edge-device training throughput
    server_latency_s: float = 0.01

    def client_times(self, tx_bytes_per_client, train_flops_per_client,
                     rx_bytes_per_client=None, delay=None) -> np.ndarray:
        """Per-client completion time (download + train + upload), the async
        event clock's sampling primitive; ``rx_bytes_per_client`` defaults
        to the uplink volume, ``delay`` is an optional multiplicative lane.
        Server latency is not included (it is a per-aggregation cost).
        float64, the JAX package's expression on its numpy inputs."""
        tx = np.asarray(tx_bytes_per_client, np.float64)
        rx = tx if rx_bytes_per_client is None else np.asarray(rx_bytes_per_client, np.float64)
        per_client = ((tx + rx) / self.bandwidth_bytes_per_s
                      + np.asarray(train_flops_per_client, np.float64) / self.client_flops_per_s)
        if delay is not None:
            per_client = per_client * np.asarray(delay, np.float64)
        return per_client

    def round_time(self, tx_bytes_per_client, train_flops_per_client, select_mask,
                   rx_bytes_per_client=None, delay=None) -> np.float32:
        """One synchronous round's time: the slowest selected client plus the
        server latency. The JAX package takes the maximum in jnp, float32
        without x64, so this rounds the float64 client times to float32
        first and returns a float32, bitwise its value."""
        per_client = self.client_times(tx_bytes_per_client, train_flops_per_client,
                                       rx_bytes_per_client, delay=delay).astype(np.float32)
        per_client = np.where(np.asarray(select_mask, bool), per_client, np.float32(0.0))
        return np.max(per_client) + np.float32(self.server_latency_s)

    def round_times(self, tx_bytes, train_flops, select_mask, rx_bytes=None, delay=None):
        """Synchronous round times, (T, C) inputs -> (T,) seconds: the
        slowest selected client's download + training + upload (times its
        optional delay), plus the server latency."""
        tx = np.asarray(tx_bytes, np.float64)
        rx = tx if rx_bytes is None else np.asarray(rx_bytes, np.float64)
        per_client = (
            (tx + rx) / self.bandwidth_bytes_per_s
            + np.asarray(train_flops, np.float64) / self.client_flops_per_s
        )
        if delay is not None:
            per_client = per_client * np.asarray(delay, np.float64)
        per_client = np.where(np.asarray(select_mask, bool), per_client, 0.0)
        return per_client.max(axis=-1) + self.server_latency_s

    def edge_round_times(
        self,
        tx_bytes: np.ndarray,
        train_flops: np.ndarray,
        select_mask: np.ndarray,
        edge_ids: np.ndarray,
        edge_bytes: np.ndarray,
        rx_bytes: np.ndarray | None = None,
        delay: np.ndarray | None = None,
    ) -> np.ndarray:
        """Two-level (edge-server) round time for ``(T, C)`` chunk inputs.

        Each edge e waits for its slowest selected member (client->edge
        leg, same per-client time as the flat model), then forwards its
        partial aggregate — ``edge_bytes (T, E)`` on the edge->server
        hop — so the round completes at
        ``max_e(member_max_e + edge_bytes_e / bandwidth) + server_latency``.
        ``edge_ids (C,)`` is the static client->edge partition. With one
        edge and zero edge bytes this reduces to ``round_times`` exactly.
        """
        tx = np.asarray(tx_bytes, np.float64)
        rx = tx if rx_bytes is None else np.asarray(rx_bytes, np.float64)
        per_client = (
            (tx + rx) / self.bandwidth_bytes_per_s
            + np.asarray(train_flops, np.float64) / self.client_flops_per_s
        )
        if delay is not None:
            per_client = per_client * np.asarray(delay, np.float64)
        per_client = np.where(np.asarray(select_mask, bool), per_client, 0.0)
        ids = np.asarray(edge_ids)
        e_bytes = np.asarray(edge_bytes, np.float64)
        n_edges = e_bytes.shape[-1]
        # per-edge member max: (T, E) via masked max over each id block
        t_edges = np.zeros(per_client.shape[:-1] + (n_edges,), np.float64)
        for e in range(n_edges):
            members = per_client[..., ids == e]
            if members.shape[-1]:
                t_edges[..., e] = members.max(axis=-1)
        t_edges = t_edges + e_bytes / self.bandwidth_bytes_per_s
        return t_edges.max(axis=-1) + self.server_latency_s


def edge_partition(n_clients: int, n_edges: int) -> np.ndarray:
    """(C,) static client->edge assignment: E contiguous client-id blocks
    of ``ceil(C/E)`` (the last block absorbs the remainder). Matches the
    aggregator-side partition (``repro_torch.fl.phases.Aggregator._edges``)."""
    group = -(-n_clients // n_edges)
    return np.minimum(np.arange(n_clients) // group, n_edges - 1)


def edge_hop_bytes(
    selected: np.ndarray,
    pms: np.ndarray,
    layer_sizes: np.ndarray,
    edge_ids: np.ndarray,
    n_edges: int,
) -> np.ndarray:
    """(T, E) edge->server hop bytes for a chunk of rounds.

    Each edge forwards one float32 partial aggregate per layer that at
    least one of its selected members shared this round (layer params x 4
    bytes, + 4 bytes for the layer's weight denominator); layers nobody in
    the group shared cost the edge nothing. ``selected``/``pms`` are the
    ``(T, C)`` history lanes; share masks are the prefix masks
    ``layer j < pms`` (``repro_torch.core.layersharing``'s convention).
    """
    sel = np.asarray(selected, bool)
    p = np.asarray(pms)
    sizes = np.asarray(layer_sizes, np.float64)
    n_layers = sizes.shape[0]
    per_layer_bytes = sizes * BYTES_PER_PARAM + BYTES_PER_PARAM
    share = sel[..., None] & (np.arange(n_layers)[None, None, :] < p[..., None])
    out = np.zeros(sel.shape[:-1] + (n_edges,), np.float64)
    ids = np.asarray(edge_ids)
    for e in range(n_edges):
        forwarded = share[:, ids == e, :].any(axis=1)  # (T, L)
        out[..., e] = forwarded @ per_layer_bytes
    return out
