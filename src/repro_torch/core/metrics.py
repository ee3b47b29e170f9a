"""The simulated communication/compute clock of the synchronous scheduler
(paper §4.3's overhead metric) — the part of the JAX package's
``core/metrics.py`` the ported slice needs. Host-side numpy in float64, as
there.
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
