"""Two-level (client -> edge -> server) aggregation of the port against the
JAX package's, on the same numpy-made inputs.

Contracts:

- the plain edge reduction (``masked_aggregate_plain`` with ``edge_ids``,
  the CPU side of masked_aggregate's edge mode) is an edge-by-edge loop:
  each edge sums its lanes in ascending order, the partials join in
  ascending edge order, every product and sum rounded once in float32
  (held bitwise to a numpy float32 loop of that order);
- against JAX's ``_weighted_mean`` with ``edge_ids`` (``segment_sum``, then
  a sum over the edges), for all three aggregators, with unsorted cohort
  ids, an edge with no lane, zero-weight rows and all-zero weights: within
  2 ulp of the weighted mean's magnitude scale (the bound the flat
  aggregators are held to); the measured gap is 0 ulp on these inputs;
- ``n_edges <= 1`` is the flat expression, bit for bit;
- ``edge_partition``, ``edge_hop_bytes`` and ``CommModel.edge_round_times``
  exactly the JAX package's;
- E = 3 (and E = 1) trajectories against JAX's ``run_federated`` in the
  legacy threefry stream, sync on the device-resident and the host plane
  and async on the host plane: ``selected``, ``pms``, ``tx_*``,
  ``tx_edge_bytes``, ``round_time`` and the async clock exact,
  ``accuracy_mean`` within 1e-6.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.data import make_federated_classification as jax_make_data  # noqa: E402
from repro.fl import FLConfig as JaxFLConfig  # noqa: E402
from repro.fl import run_federated as jax_run_federated  # noqa: E402
from repro.models.mlp import init_mlp as jax_init_mlp  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.fl import FLConfig, run_federated  # noqa: E402
from repro_torch.kernels.masked_aggregate import masked_aggregate_plain  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

FIXTURE = dict(
    n_clients=8, n_classes=4, n_features=20,
    samples_per_client_range=(60, 90), dirichlet_alpha=50.0,
    client_shift=0.05, class_sep=5.0, seed=1,
)
EXACT = ("selected", "pms", "tx_params", "tx_wire_bytes", "tx_bytes_cum", "round_time",
         "tx_edge_bytes", "sim_clock", "staleness_mean", "in_flight", "rejected_updates")
ULPS = 2  # of the weighted mean's magnitude scale (tests/test_torch_codec_core.py's bound)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cohort(rng, k: int, n_edges: int, pop: int, skip_edge: int | None = 1):
    """Edge ids (K,) of K clients drawn unsorted from ``pop`` clients cut in
    E contiguous groups (the aggregators' partition); no lane in edge
    ``skip_edge``."""
    group = -(-pop // n_edges)
    ids_all = np.minimum(np.arange(pop) // group, n_edges - 1)
    pool = np.nonzero(ids_all != skip_edge)[0]
    cids = rng.permutation(pool)[:k]
    return cids, ids_all[cids].astype(np.int32)


def _layered(rng, k: int):
    sizes = [(7, 5), (5, 4), (4, 3)]
    return [{"w": rng.standard_normal((k,) + s).astype(np.float32) * 0.1,
             "b": rng.standard_normal((k, s[1])).astype(np.float32) * 0.01} for s in sizes]


def _t(tree):
    return [{n: torch.from_numpy(v) for n, v in layer.items()} for layer in tree]


def _j(tree):
    return [{n: jnp.asarray(v) for n, v in layer.items()} for layer in tree]


def _ulps(got, want, x, w) -> float:
    """|got - want| in ulps of the weighted mean's magnitude scale."""
    scale = (np.abs(x.reshape(x.shape[0], -1)) * w[:, None]).sum(0) / max(w.sum(), 1e-12)
    ulp = np.spacing(np.maximum(scale, np.finfo(np.float32).tiny).astype(np.float32))
    return float((np.abs(got.reshape(-1) - want.reshape(-1)) / ulp).max())


def _plain_loop(x, w, ids, n_edges):
    """The edge mode's order in numpy float32: lanes ascending within each
    edge, the partials added in ascending edge order."""
    x = x.reshape(x.shape[0], -1)
    num = np.zeros(x.shape[1], np.float32)
    total = np.float32(0.0)
    for e in range(n_edges):
        part, part_total = np.zeros_like(num), np.float32(0.0)
        for c in np.nonzero(ids == e)[0]:
            part_total = np.float32(part_total + w[c])
            part = (part + (np.float32(w[c]) * x[c]).astype(np.float32)).astype(np.float32)
        total = np.float32(total + part_total)
        num = (num + part).astype(np.float32)
    mean = (num / np.maximum(total, np.float32(1e-12))).astype(np.float32)
    return mean if total > 0 else np.zeros_like(mean)


@pytest.mark.parametrize("n_edges", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_edge_order_is_the_stated_loop(n_edges, seed):
    rng = np.random.default_rng(seed)
    _, ids = _cohort(rng, 9, n_edges, 40)
    x = rng.standard_normal((9, 6, 5)).astype(np.float32)
    w = (rng.random(9) < 0.7) * rng.integers(60, 90, 9).astype(np.float32)
    got = masked_aggregate_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 edge_ids=torch.from_numpy(ids), n_edges=n_edges)
    np.testing.assert_array_equal(got.numpy().reshape(-1), _plain_loop(x, w, ids, n_edges))


@pytest.mark.parametrize("aggregator", ["fedavg", "masked-partial", "staleness-merge"])
@pytest.mark.parametrize("n_edges", [2, 3, 5])
def test_edge_aggregation_matches_jax(aggregator, n_edges):
    """Unsorted cohort ids, an edge with no lane, layer 2 shared by nobody
    (the fallback, or g + 0 in the merge): within ULPS of JAX's
    ``_weighted_mean`` with ``edge_ids``."""
    rng = np.random.default_rng(10 * n_edges + len(aggregator))
    k = 8
    _, ids = _cohort(rng, k, n_edges, 5 * k)
    stacked, prev = _layered(rng, k), [
        {n: v[0] for n, v in layer.items()} for layer in _layered(rng, 1)]
    sel = np.asarray([1, 0, 1, 1, 0, 1, 1, 1], bool)
    n = rng.integers(60, 90, k).astype(np.float32)
    share = np.ones((k, 3), bool)
    share[:, 2] = False
    share[rng.random(k) < 0.4, 1] = False
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    w = sel * n
    if aggregator == "fedavg":
        gj = jagg.fedavg_aggregate(_j(stacked), jnp.asarray(sel), jnp.asarray(n),
                                   edge_ids=jids, n_edges=n_edges)
        gt = tagg.fedavg_aggregate(_t(stacked), torch.from_numpy(sel), torch.from_numpy(n),
                                   edge_ids=tids, n_edges=n_edges)
        rows = [w] * 3
    elif aggregator == "masked-partial":
        gj = jagg.masked_partial_aggregate(_j(stacked), _j(prev), jnp.asarray(sel),
                                           jnp.asarray(n), jnp.asarray(share), edge_ids=jids,
                                           n_edges=n_edges)
        gt = tagg.masked_partial_aggregate(_t(stacked), _t(prev), torch.from_numpy(sel),
                                           torch.from_numpy(n), torch.from_numpy(share),
                                           edge_ids=tids, n_edges=n_edges)
        rows = [w * share[:, j] for j in range(3)]
    else:
        stale = rng.integers(0, 5, k).astype(np.float32)
        wm = (w / np.sqrt(1.0 + stale)).astype(np.float32)
        deltas = [{nm: v - prev[j][nm][None] for nm, v in layer.items()}
                  for j, layer in enumerate(stacked)]
        gj = jagg.staleness_weighted_merge(_j(deltas), _j(prev), jnp.asarray(wm),
                                           jnp.asarray(share), edge_ids=jids, n_edges=n_edges)
        gt = tagg.staleness_weighted_merge(
            _t(stacked), _t(prev), torch.from_numpy(wm), torch.from_numpy(share),
            edge_ids=tids, n_edges=n_edges,
            snapshots=[{nm: torch.from_numpy(np.broadcast_to(v, (k,) + v.shape).copy())
                        for nm, v in layer.items()} for layer in prev])
        rows = [wm * share[:, j] for j in range(3)]
        stacked = deltas
    for j in range(3):
        for name in ("w", "b"):
            got, want = gt[j][name].numpy(), np.asarray(gj[j][name])
            assert _ulps(got, want, stacked[j][name], rows[j]) <= ULPS, (aggregator, j, name)
    for name in ("w", "b"):  # nobody shared layer 2: the previous global, exactly
        if aggregator != "fedavg":
            np.testing.assert_array_equal(gt[2][name].numpy(), prev[2][name])


def test_all_zero_weights_fall_back():
    rng = np.random.default_rng(4)
    _, ids = _cohort(rng, 6, 3, 30, skip_edge=None)
    stacked, prev = _layered(rng, 6), [{n: v[0] for n, v in layer.items()}
                                       for layer in _layered(rng, 1)]
    none = np.zeros(6, bool)
    n = np.full(6, 70.0, np.float32)
    args = dict(edge_ids=torch.from_numpy(ids), n_edges=3)
    ft = tagg.fedavg_aggregate(_t(stacked), torch.from_numpy(none), torch.from_numpy(n), **args)
    mt = tagg.masked_partial_aggregate(_t(stacked), _t(prev), torch.from_numpy(none),
                                       torch.from_numpy(n), torch.ones(3, dtype=torch.bool),
                                       **args)
    for j in range(3):
        for name in ("w", "b"):
            assert not ft[j][name].any()
            np.testing.assert_array_equal(mt[j][name].numpy(), prev[j][name])


@pytest.mark.parametrize("n_edges", [0, 1])
def test_at_most_one_edge_is_flat_bitwise(n_edges):
    rng = np.random.default_rng(5)
    stacked = _layered(rng, 8)
    sel = torch.from_numpy(rng.random(8) < 0.6)
    n = torch.from_numpy(rng.integers(60, 90, 8).astype(np.float32))
    flat = tagg.fedavg_aggregate(_t(stacked), sel, n)
    edged = tagg.fedavg_aggregate(_t(stacked), sel, n, edge_ids=torch.zeros(8, dtype=torch.int32),
                                  n_edges=n_edges)
    for a, b in zip(flat, edged):
        for name in ("w", "b"):
            assert torch.equal(a[name], b[name])


@pytest.mark.parametrize("c,n_edges", [(8, 3), (30, 8), (7, 7), (10, 1)])
def test_edge_accounting_exact(c, n_edges):
    rng = np.random.default_rng(c + n_edges)
    np.testing.assert_array_equal(tmetrics.edge_partition(c, n_edges),
                                  jmetrics.edge_partition(c, n_edges))
    ids = tmetrics.edge_partition(c, n_edges)
    sel = rng.random((4, c)) < 0.5
    pms = rng.integers(1, 5, (4, c))
    sizes = np.asarray([561 * 256 + 256, 256 * 256 + 256, 256 * 256 + 256, 256 * 6 + 6])
    hop_t = tmetrics.edge_hop_bytes(sel, pms, sizes, ids, n_edges)
    hop_j = jmetrics.edge_hop_bytes(sel, pms, sizes, ids, n_edges)
    np.testing.assert_array_equal(hop_t, hop_j)
    wire = rng.random((4, c)) * 1e6
    flops = rng.random((4, c)) * 1e9
    delay = rng.lognormal(0.0, 0.5, c)
    for kw in (dict(), dict(rx_bytes=wire * 2.0, delay=delay)):
        np.testing.assert_array_equal(
            tmetrics.CommModel().edge_round_times(wire, flops, sel, ids, hop_t, **kw),
            jmetrics.CommModel().edge_round_times(wire, flops, sel, ids, hop_j, **kw))


TRAJECTORIES = {
    "sync-device-E3": dict(edge_groups=3, host_population=-1, codec="int8"),
    "sync-host-E3": dict(edge_groups=3, host_population=1, codec="int8"),
    "sync-host-E1": dict(edge_groups=1, host_population=1),
    "async-host-E3": dict(edge_groups=3, host_population=1, scheduler="async", buffer_k=3,
                          max_concurrency=4, codec="int8", personalization="ft",
                          strategy="oort", fraction=0.5, heterogeneity=0.8),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_edge_trajectory_matches_jax(name):
    kw = dict(rounds=5, epochs=1, **TRAJECTORIES[name])
    with jax.threefry_partitionable(False), prng.threefry_partitionable(False):
        r_init, _ = jax.random.split(jax.random.PRNGKey(0))
        g0 = jax.device_get(jax_init_mlp(r_init, FIXTURE["n_features"], FIXTURE["n_classes"]))
        hj = jax_run_federated(jax_make_data(**FIXTURE), JaxFLConfig(**kw))
        ht = run_federated(make_federated_classification(**FIXTURE), FLConfig(**kw),
                           device="cpu", init_fn=lambda key: params_from_numpy(g0, key.device))
    assert ht.tx_edge_bytes.shape == (5, kw["edge_groups"]) and (ht.tx_edge_bytes > 0).any()
    for field in EXACT:
        np.testing.assert_array_equal(getattr(ht, field), np.asarray(getattr(hj, field)),
                                      err_msg=field)
    assert np.abs(ht.accuracy_mean - np.asarray(hj.accuracy_mean)).max() <= 1e-6
