"""Shape-faithful synthetic stand-ins for the paper's three HAR datasets
(Table 2). Client counts, feature/class dimensionality and per-client sample
ranges match the paper; MotionSense sample counts are scaled down by default
(47k samples x 24 clients is pointless for a CPU correctness run — the
`scale` knob restores full size).

| dataset      | clients | classes | features | samples/client | skew    |
|--------------|---------|---------|----------|----------------|---------|
| UCI-HAR      | 30      | 6       | 561      | 224..327       | ~IID    |
| MotionSense  | 24      | 6       | 7        | 40804..57559   | ~IID    |
| ExtraSensory | 60      | 8       | 277      | 1280..9596     | non-IID |
"""

from __future__ import annotations

from repro_torch.data.synthetic import FederatedDataset, make_federated_classification

DATASETS = {
    "uci-har": dict(
        n_clients=30, n_classes=6, n_features=561,
        samples_per_client_range=(224, 327), dirichlet_alpha=100.0,
        client_shift=0.05,
    ),
    "motionsense": dict(
        n_clients=24, n_classes=6, n_features=7,
        samples_per_client_range=(40804, 57559), dirichlet_alpha=100.0,
        # few features -> harder problem (paper tops out at ~0.70-0.75 here)
        client_shift=0.1, class_sep=1.6,
    ),
    "extrasensory": dict(
        n_clients=60, n_classes=8, n_features=277,
        samples_per_client_range=(1280, 9596), dirichlet_alpha=0.15,  # heavy label skew
        client_shift=0.05, class_sep=2.8,  # classes overlap globally ->
        # a single global model saturates low; personalized heads win (paper Fig. 10c)
    ),
}


def make_har_dataset(
    name: str, seed: int = 0, scale: float = 1.0, n_clients: int | None = None
) -> FederatedDataset:
    """Build one of the paper's three datasets (synthetic stand-in).

    ``scale`` < 1 shrinks per-client sample counts proportionally (CPU runs).
    ``n_clients`` overrides the paper's client count — population scale-up
    for the cohort execution runtime (>= 2000 clients routes through the
    vectorized population generator automatically).
    """
    key = name.lower()
    if key not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    spec = dict(DATASETS[key])
    if n_clients is not None:
        spec["n_clients"] = n_clients
    lo, hi = spec["samples_per_client_range"]
    spec["samples_per_client_range"] = (max(8, int(lo * scale)), max(9, int(hi * scale)))
    return make_federated_classification(seed=seed, name=key, **spec)
