"""Synthetic federated classification data (a copy of the JAX package's
``data/synthetic.py``: numpy only, so both packages build bitwise-equal
datasets from a seed).

Generates per-class Gaussian mixtures with *per-client* covariate shift
(random affine feature transform per client) and label skew (Dirichlet
class proportions). Covariate shift is what makes personalization matter —
a single global model cannot fit every client's transform, reproducing the
paper's non-IID phenomenology (client drift, Tan et al. 2022).

All clients are padded to a common sample count with a validity mask so the
whole dataset is one stacked array program: X (C, N, F), y (C, N),
mask (C, N) — vmap/shard-ready.

Two generator paths share the same distribution family: a per-client loop
(small populations; the seed behaviour, trajectory-stable) and a fully
vectorized whole-population path that kicks in at
``n_clients >= POPULATION_THRESHOLD`` so C=5000+ populations for the
cohort-execution scale benches build in well under a second.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FederatedDataset:
    """Stacked federated dataset (leading axis = clients)."""

    x_train: np.ndarray  # (C, N_tr, F) float32
    y_train: np.ndarray  # (C, N_tr) int32
    m_train: np.ndarray  # (C, N_tr) bool — padding mask
    x_test: np.ndarray   # (C, N_te, F)
    y_test: np.ndarray   # (C, N_te)
    m_test: np.ndarray   # (C, N_te)
    n_classes: int
    name: str = "synthetic"

    @property
    def n_clients(self) -> int:
        return self.x_train.shape[0]

    @property
    def n_features(self) -> int:
        return self.x_train.shape[-1]

    @property
    def n_samples(self) -> np.ndarray:
        """(C,) true (unpadded) train sample counts |d_i|."""
        return self.m_train.sum(axis=1).astype(np.int32)


POPULATION_THRESHOLD = 2000  # vectorized generator path kicks in at this C


def make_federated_classification(
    n_clients: int,
    n_classes: int,
    n_features: int,
    samples_per_client_range: tuple[int, int],
    dirichlet_alpha: float = 100.0,
    client_shift: float = 0.05,
    class_sep: float = 6.0,
    test_fraction: float = 0.25,
    seed: int = 0,
    name: str = "synthetic",
    vectorized: bool | None = None,
) -> FederatedDataset:
    """Build a stacked federated classification dataset.

    Args:
      dirichlet_alpha: label-skew knob. Large (>=100) ~ IID class balance;
        small (~0.5) = heavy non-IID (paper's ExtraSensory regime).
      client_shift: covariate-shift magnitude (per-client affine transform).
      class_sep: distance between class means (controls attainable accuracy).
      vectorized: use the whole-population generator (one batched draw
        instead of a Python loop over clients). Defaults to
        ``n_clients >= POPULATION_THRESHOLD`` — the large-population path
        for cohort-execution scale runs. Same distribution family, but a
        different rng consumption order, so trajectories are not comparable
        across the two paths; small (test/golden) populations keep the
        per-client loop.
    """
    if vectorized is None:
        vectorized = n_clients >= POPULATION_THRESHOLD
    if vectorized:
        return _make_population(
            n_clients, n_classes, n_features, samples_per_client_range,
            dirichlet_alpha, client_shift, class_sep, test_fraction, seed, name,
        )
    rng = np.random.default_rng(seed)
    lo, hi = samples_per_client_range

    # Class prototypes shared by everyone (the "global" structure).
    means = rng.normal(0.0, class_sep / np.sqrt(n_features), (n_classes, n_features))

    counts = rng.integers(lo, hi + 1, size=n_clients)
    n_max = int(counts.max())
    props = rng.dirichlet(np.full(n_classes, dirichlet_alpha), size=n_clients)

    # per-client train/test counts (every client keeps >=1 test sample)
    te_counts = np.maximum(1, (counts * test_fraction).astype(int))
    tr_counts = counts - te_counts
    n_tr = int(tr_counts.max())
    n_te = int(te_counts.max())

    x_tr = np.zeros((n_clients, n_tr, n_features), np.float32)
    y_tr = np.zeros((n_clients, n_tr), np.int32)
    m_tr = np.zeros((n_clients, n_tr), bool)
    x_te = np.zeros((n_clients, n_te, n_features), np.float32)
    y_te = np.zeros((n_clients, n_te), np.int32)
    m_te = np.zeros((n_clients, n_te), bool)

    for i in range(n_clients):
        n_i = int(counts[i])
        labels = rng.choice(n_classes, size=n_i, p=props[i])
        feats = means[labels] + rng.normal(0.0, 1.0, (n_i, n_features))
        # per-client covariate shift: scale + rotation-ish mix + bias
        scale = 1.0 + client_shift * rng.normal(0.0, 1.0, (n_features,))
        bias = client_shift * rng.normal(0.0, 1.0, (n_features,))
        mix = np.eye(n_features) + client_shift * 0.2 * rng.normal(
            0.0, 1.0 / np.sqrt(n_features), (n_features, n_features)
        )
        feats = ((feats * scale) @ mix + bias).astype(np.float32)
        t_i, e_i = int(tr_counts[i]), int(te_counts[i])
        x_tr[i, :t_i], y_tr[i, :t_i], m_tr[i, :t_i] = feats[:t_i], labels[:t_i], True
        x_te[i, :e_i], y_te[i, :e_i], m_te[i, :e_i] = feats[t_i:n_i], labels[t_i:n_i], True

    return FederatedDataset(
        x_train=x_tr, y_train=y_tr, m_train=m_tr,
        x_test=x_te, y_test=y_te, m_test=m_te,
        n_classes=n_classes, name=name,
    )


def _make_population(
    n_clients: int,
    n_classes: int,
    n_features: int,
    samples_per_client_range: tuple[int, int],
    dirichlet_alpha: float,
    client_shift: float,
    class_sep: float,
    test_fraction: float,
    seed: int,
    name: str,
) -> FederatedDataset:
    """Whole-population generator: every per-client quantity is one batched
    draw, so building C=5000+ populations takes a few array ops instead of
    a Python loop over clients (the loop path is ~linear in C with large
    constant factors). Same Gaussian-mixture + covariate-shift family as
    the loop path."""
    rng = np.random.default_rng(seed)
    lo, hi = samples_per_client_range

    means = rng.normal(0.0, class_sep / np.sqrt(n_features), (n_classes, n_features))
    counts = rng.integers(lo, hi + 1, size=n_clients)
    props = rng.dirichlet(np.full(n_classes, dirichlet_alpha), size=n_clients)
    te_counts = np.maximum(1, (counts * test_fraction).astype(int))
    tr_counts = counts - te_counts
    n_tr = int(tr_counts.max())
    n_te = int(te_counts.max())
    n_max = n_tr + n_te

    # labels: inverse-CDF sample against each client's class proportions
    cum = np.cumsum(props, axis=1)                       # (C, K)
    u = rng.random((n_clients, n_max))
    labels = (u[..., None] > cum[:, None, :]).sum(-1).astype(np.int32)
    feats = means[labels] + rng.normal(0.0, 1.0, (n_clients, n_max, n_features))
    # per-client covariate shift: scale + rotation-ish mix + bias, batched
    scale = 1.0 + client_shift * rng.normal(0.0, 1.0, (n_clients, 1, n_features))
    bias = client_shift * rng.normal(0.0, 1.0, (n_clients, 1, n_features))
    mix = np.eye(n_features)[None] + client_shift * 0.2 * rng.normal(
        0.0, 1.0 / np.sqrt(n_features), (n_clients, n_features, n_features)
    )
    feats = (np.einsum("cnf,cfg->cng", feats * scale, mix) + bias).astype(np.float32)

    # split: first tr_counts[i] slots train, next te_counts[i] slots test
    slot = np.arange(n_max)[None, :]
    m_tr_full = slot < tr_counts[:, None]                       # (C, n_max)
    m_te_full = (slot >= tr_counts[:, None]) & (slot < counts[:, None])

    x_tr = np.where(m_tr_full[:, :n_tr, None], feats[:, :n_tr], 0.0).astype(np.float32)
    y_tr = np.where(m_tr_full[:, :n_tr], labels[:, :n_tr], 0).astype(np.int32)
    # test slots start at tr_counts[i]: gather a contiguous (C, n_te) window
    te_idx = np.minimum(tr_counts[:, None] + np.arange(n_te)[None, :], n_max - 1)
    m_te = np.take_along_axis(m_te_full, te_idx, axis=1)
    x_te = np.where(
        m_te[..., None], np.take_along_axis(feats, te_idx[..., None], axis=1), 0.0
    ).astype(np.float32)
    y_te = np.where(m_te, np.take_along_axis(labels, te_idx, axis=1), 0).astype(np.int32)

    return FederatedDataset(
        x_train=x_tr, y_train=y_tr, m_train=m_tr_full[:, :n_tr],
        x_test=x_te, y_test=y_te, m_test=m_te,
        n_classes=n_classes, name=name,
    )
