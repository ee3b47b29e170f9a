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

``ShardedFederatedData`` (``make_sharded_population``) is the lazy
population: O(C) metadata lanes, every client's rows regenerated on demand
from a counter-keyed substream, for the host-resident population plane
(``repro_torch.fl.population``).
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

    def shard(self, idx: np.ndarray):
        """(K, ...) data rows for client ids ``idx`` — one cohort's slabs.

        The common staging interface with ``ShardedFederatedData``: the
        host-population runtime (repro_torch.fl.population) only ever asks for
        cohort-sized row sets, never the whole (C, ...) slab.
        """
        idx = np.asarray(idx)
        return (self.x_train[idx], self.y_train[idx], self.m_train[idx],
                self.x_test[idx], self.y_test[idx], self.m_test[idx])


POPULATION_THRESHOLD = 2000  # vectorized generator path kicks in at this C

# SeedSequence sub-stream tags: the meta pass and the per-client row streams
# draw from disjoint counter-keyed streams of the same master seed
_META_STREAM = 0x6D657461   # "meta"
_CLIENT_STREAM = 0x636C69   # "cli"


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


@dataclasses.dataclass
class ShardedFederatedData:
    """Lazy counter-keyed federated population: O(C) cheap metadata lanes,
    data slabs regenerated per cohort shard.

    The eager generators materialize the full (C, N, F) feature slab —
    ~C * N * F * 4 bytes of host RAM, which at C=10^6 clients x 100 samples
    x 20 features is already ~8 GB and scales linearly from there. This
    variant keeps only the per-client *metadata* (sample counts, Dirichlet
    class proportions — a few hundred bytes per client) and regenerates any
    client's rows on demand from a counter-keyed substream
    ``default_rng(SeedSequence([seed, _CLIENT_STREAM, i]))``, so a cohort's
    ``(K, ...)`` slab costs O(K) memory and the same client always
    regenerates bit-identical rows regardless of which cohorts it appears
    in. ``materialize()`` produces the equivalent eager
    ``FederatedDataset`` (shard-vs-materialize parity is regression-tested).

    Padding widths are derived from the *sample-count range*, not the drawn
    counts, so shapes are static in C and a shard never needs a global max.
    """

    n_classes: int
    seed: int
    client_shift: float
    means: np.ndarray      # (n_classes, F) shared class prototypes
    counts: np.ndarray     # (C,) total samples per client
    props: np.ndarray      # (C, n_classes) Dirichlet class proportions
    tr_counts: np.ndarray  # (C,) train samples per client
    te_counts: np.ndarray  # (C,) test samples per client
    n_tr: int              # train padding width (static given the range)
    n_te: int              # test padding width
    name: str = "synthetic-sharded"

    @property
    def n_clients(self) -> int:
        return int(self.counts.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.means.shape[1])

    @property
    def n_samples(self) -> np.ndarray:
        return self.tr_counts.astype(np.int32)

    def _client_rows(self, i: int):
        """Regenerate client i's (features, labels) from its substream."""
        n_features = self.n_features
        rs = np.random.default_rng(
            np.random.SeedSequence([self.seed, _CLIENT_STREAM, int(i)])
        )
        n_i = int(self.counts[i])
        labels = rs.choice(self.n_classes, size=n_i, p=self.props[i])
        feats = self.means[labels] + rs.normal(0.0, 1.0, (n_i, n_features))
        scale = 1.0 + self.client_shift * rs.normal(0.0, 1.0, (n_features,))
        bias = self.client_shift * rs.normal(0.0, 1.0, (n_features,))
        mix = np.eye(n_features) + self.client_shift * 0.2 * rs.normal(
            0.0, 1.0 / np.sqrt(n_features), (n_features, n_features)
        )
        feats = ((feats * scale) @ mix + bias).astype(np.float32)
        return feats, labels.astype(np.int32)

    def shard(self, idx: np.ndarray):
        """Regenerate the (K, ...) padded data slabs for client ids ``idx``.

        Same 6-tuple layout as ``FederatedDataset.shard``; duplicated ids
        are allowed (each row is generated independently).
        """
        idx = np.asarray(idx)
        k = idx.shape[0]
        n_features = self.n_features
        x_tr = np.zeros((k, self.n_tr, n_features), np.float32)
        y_tr = np.zeros((k, self.n_tr), np.int32)
        m_tr = np.zeros((k, self.n_tr), bool)
        x_te = np.zeros((k, self.n_te, n_features), np.float32)
        y_te = np.zeros((k, self.n_te), np.int32)
        m_te = np.zeros((k, self.n_te), bool)
        for row, i in enumerate(idx):
            feats, labels = self._client_rows(i)
            t_i, e_i = int(self.tr_counts[i]), int(self.te_counts[i])
            n_i = t_i + e_i
            x_tr[row, :t_i], y_tr[row, :t_i], m_tr[row, :t_i] = (
                feats[:t_i], labels[:t_i], True)
            x_te[row, :e_i], y_te[row, :e_i], m_te[row, :e_i] = (
                feats[t_i:n_i], labels[t_i:n_i], True)
        return x_tr, y_tr, m_tr, x_te, y_te, m_te

    def materialize(self) -> FederatedDataset:
        """Eager equivalent: generate every client (parity reference; only
        sensible at small C)."""
        x_tr, y_tr, m_tr, x_te, y_te, m_te = self.shard(np.arange(self.n_clients))
        return FederatedDataset(
            x_train=x_tr, y_train=y_tr, m_train=m_tr,
            x_test=x_te, y_test=y_te, m_test=m_te,
            n_classes=self.n_classes, name=self.name,
        )


def make_sharded_population(
    n_clients: int,
    n_classes: int,
    n_features: int,
    samples_per_client_range: tuple[int, int],
    dirichlet_alpha: float = 100.0,
    client_shift: float = 0.05,
    class_sep: float = 6.0,
    test_fraction: float = 0.25,
    seed: int = 0,
    name: str = "synthetic-sharded",
) -> ShardedFederatedData:
    """Build a lazy sharded population (same distribution family as
    ``make_federated_classification``; its own rng stream layout, so
    trajectories are not comparable to the eager generators).

    The meta pass draws only the O(C)-cheap per-client lanes (counts,
    class proportions) plus the shared class prototypes — a C=10^6
    population constructs in a few hundred MB and well under a second.
    """
    lo, hi = samples_per_client_range
    meta = np.random.default_rng(np.random.SeedSequence([seed, _META_STREAM]))
    means = meta.normal(0.0, class_sep / np.sqrt(n_features), (n_classes, n_features))
    counts = meta.integers(lo, hi + 1, size=n_clients)
    props = meta.dirichlet(np.full(n_classes, dirichlet_alpha), size=n_clients)
    te_counts = np.maximum(1, (counts * test_fraction).astype(int))
    tr_counts = counts - te_counts
    # static padding: exact max over every count the range can produce
    cand = np.arange(lo, hi + 1)
    te_cand = np.maximum(1, (cand * test_fraction).astype(int))
    return ShardedFederatedData(
        n_classes=n_classes, seed=seed, client_shift=client_shift,
        means=means, counts=counts, props=props,
        tr_counts=tr_counts, te_counts=te_counts,
        n_tr=int((cand - te_cand).max()), n_te=int(te_cand.max()),
        name=name,
    )
