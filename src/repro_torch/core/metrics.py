"""The simulated communication/compute clock of the schedulers (paper
§4.3's overhead metric) — the part of the JAX package's ``core/metrics.py``
the ported slices need. Host-side numpy in float64, as there.
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
