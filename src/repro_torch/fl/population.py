"""Host-resident population plane — the port of the JAX package's
``fl/population.py``: federated populations past the device's slabs.

The device-resident schedulers (``repro_torch.fl.sched``) keep every
``(C, ...)`` per-client slab (data shards, personalized models, EF
residuals, the cheap per-client lanes) on the device. Past a few tens of
thousands of clients that is the population's limit, though a round only
touches its K cohort lanes. This module keeps the population on the host:

- ``PopulationStore`` holds every ``(C, ...)`` per-client array in host
  numpy (the heavy trees optionally ``np.memmap``-backed under
  ``backing_dir``): ``gather(idx) -> (K, ...)`` rows, ``scatter(idx, rows)``
  write-back;
- ``run_host_sync`` / ``run_host_async`` mirror ``SyncScheduler.run`` /
  ``AsyncScheduler.run`` with the store as the source of truth. Each round
  or event stages exactly the cohort's rows (data shard, local models,
  residuals, lanes) through pinned host buffers of ``(K, ...)`` shape,
  allocated once and reused, copied with ``non_blocking=True`` on the
  run's stream; the same phase composition runs on them (one launch of
  each FL kernel a round or event); the cohort's results come back in one
  device-to-host copy and scatter into the store, and the population's
  (evaluation, selection, layer policy, slot refill) in a second one. The
  only persistent device tensors are the global model, the rng key, the
  (C,) sample counts and delay lane and, under async, the M slot
  snapshots: device memory is O(K + model), not O(C). Rounds run eagerly,
  one at a time (``scan_chunk`` is not read here, as in the JAX package).

Bit identity: at the same (data, cfg, pipeline) a host-plane run is
bitwise the device-resident port's. The cohort step replays the device
round's phases and key splits on the staged rows; population evaluation
defaults to one whole-C call on the device-resident path's shapes
(``eval_chunk=0``, the test slabs staged once); ``eval_chunk=n`` streams
it through n-client windows (other GEMM shapes: within 1 ulp). The
schedulers delegate here when ``cfg.execution.resolved_host_population(C)``
is true (``host_population=1``, or C at or above the threshold) or the
dataset has no eager ``x_train`` (``ShardedFederatedData``).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.checkpoint import (
    load_fl_state,
    load_host_arrays,
    load_pytree,
    save_fl_state,
    save_host_arrays,
    save_pytree,
)
from repro_torch.core.aggregation import transmitted_parameters
from repro_torch.core.layersharing import layer_param_sizes, layer_share_mask
from repro_torch.core.metrics import BYTES_PER_PARAM, CommModel
from repro_torch.device import resolve_device
from repro_torch.fl import phases
from repro_torch.fl.api import (
    FLConfig,
    RoundPipeline,
    StackedOuts,
    compute_lanes,
    pipeline_from_config,
)
from repro_torch.fl.sched import (
    _ASYNC_HIST,
    _SYNC_HIST,
    ClientClock,
    _EdgeTopology,
    _host_to,
    _lane,
    _progress_rows,
    _SlotPlane,
    _stacked,
    _sync_fault_inputs,
    append_async_event,
    assign_slots,
    async_history,
    async_slots,
    check_async_aggregator,
    check_slice,
    record_async_event,
    resolve_checkpoint_dir,
    sync_history,
)
from repro_torch.models.mlp import init_mlp, mlp_accuracy, mlp_loss
from repro_torch.obs.profile import phase_timer
from repro_torch.obs.record import format_async_progress, format_sync_progress
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["PopulationStore", "run_host_sync", "run_host_async"]


# ---------------------------------------------------------------------------
# PopulationStore — the host-resident (C, ...) population plane
# ---------------------------------------------------------------------------


class PopulationStore:
    """All per-client server state, host-resident, gathered and scattered
    by rows.

    - ``lanes``: cheap ``(C,)`` vectors (accuracy, loss, selection, share
      depth, participation, update norms), always in RAM;
    - ``trees``: layered trees of ``(C, ...)`` leaves (personalized local
      models, EF residuals), the heavy slabs, optionally ``np.memmap``
      files under ``backing_dir`` (``{name}_{i}.npy``, leaf i in tree
      order), so a population larger than RAM pages from disk.

    ``gather`` copies the requested rows out (safe to mutate; or into
    given buffers, the staging path); ``scatter`` writes rows back in
    place. ``scatter(idx, gather(idx))`` is the identity."""

    def __init__(self, n_clients: int, backing_dir: str | None = None):
        self.n_clients = int(n_clients)
        self.backing_dir = backing_dir
        self.lanes: dict[str, np.ndarray] = {}
        self.trees: dict[str, Any] = {}

    def add_lane(self, name: str, values: np.ndarray) -> None:
        values = np.asarray(values)
        if values.shape[0] != self.n_clients:
            raise ValueError(f"lane {name!r}: leading dim {values.shape[0]} != C={self.n_clients}")
        self.lanes[name] = values

    def add_tree(self, name: str, template, init: str) -> None:
        """A tree of ``(C, ...)`` leaves shaped by the per-client
        ``template``: ``init='broadcast'`` fills every row with the template
        leaf (the server's w(0) broadcast), anything else zero-fills (EF
        residuals)."""
        leaves = []
        for i, leaf in enumerate(tree_leaves(template)):
            leaf = np.asarray(leaf)
            shape = (self.n_clients,) + leaf.shape
            if self.backing_dir is None:
                arr = np.empty(shape, leaf.dtype)
            else:
                os.makedirs(self.backing_dir, exist_ok=True)
                arr = np.lib.format.open_memmap(os.path.join(self.backing_dir, f"{name}_{i}.npy"),
                                                mode="w+", dtype=leaf.dtype, shape=shape)
            arr[...] = leaf[None] if init == "broadcast" else 0
            leaves.append(arr)
        self.trees[name] = tree_unflatten(template, leaves)

    @classmethod
    def build(cls, n_clients: int, lanes: dict[str, np.ndarray], g0=None, stateful: bool = False,
              lossy: bool = False, backing_dir: str | None = None) -> "PopulationStore":
        """The server's population plane: the scheduler lanes plus the
        heavy slabs the features need (local models when ``stateful``, EF
        residuals when ``lossy``), shaped like the global model ``g0``."""
        store = cls(n_clients, backing_dir=backing_dir)
        for name, values in lanes.items():
            store.add_lane(name, values)
        if g0 is not None and (stateful or lossy):
            g_np = tree_map(lambda t: t.detach().cpu().numpy() if torch.is_tensor(t)
                            else np.asarray(t), g0)
            if stateful:
                store.add_tree("local", g_np, init="broadcast")
            if lossy:
                store.add_tree("residual", g_np, init="zeros")
        return store

    def gather(self, idx: np.ndarray, names, out: dict | None = None) -> dict:
        """``{name: (K, ...) rows}`` of clients ``idx`` (duplicates allowed),
        lane rows and tree rows alike, as new contiguous arrays or, with
        ``out`` (the same structure of ``(K, ...)`` arrays), written into
        those."""
        idx = np.asarray(idx)
        result: dict[str, Any] = {}
        for name in names:
            if name in self.lanes:
                src = self.lanes[name]
            elif name in self.trees:
                src = self.trees[name]
            else:
                raise KeyError(name)
            if out is None:
                result[name] = tree_map(lambda leaf: np.ascontiguousarray(leaf[idx]), src)
            else:
                tree_map(lambda leaf, dst: np.take(leaf, idx, axis=0, out=dst), src, out[name])
                result[name] = out[name]
        return result

    def scatter(self, idx: np.ndarray, values: dict) -> None:
        """Write ``(K, ...)`` rows back at clients ``idx``."""
        idx = np.asarray(idx)
        for name, val in values.items():
            if name in self.lanes:
                self.lanes[name][idx] = np.asarray(val)
            elif name in self.trees:
                tree_map(lambda leaf, rows: leaf.__setitem__(idx, np.asarray(rows)),
                         self.trees[name], val)
            else:
                raise KeyError(name)

    def flush(self) -> None:
        """Flush memmap-backed slabs to disk (nothing for RAM)."""
        for tree in self.trees.values():
            for leaf in tree_leaves(tree):
                if isinstance(leaf, np.memmap):
                    leaf.flush()

    def nbytes(self) -> int:
        return (sum(a.nbytes for a in self.lanes.values())
                + sum(leaf.nbytes for tree in self.trees.values() for leaf in tree_leaves(tree)))


# ---------------------------------------------------------------------------
# staging: pinned host buffers -> device buffers, allocated once
# ---------------------------------------------------------------------------


class _Staging:
    """One pinned host buffer and one device buffer per staged key and
    shape, allocated at first use and reused every round (on the CPU
    plain tensors). ``put`` copies a host buffer to its device buffer with
    ``non_blocking=True`` on the current stream; a host buffer is rewritten
    only after its last copy has finished (a CUDA event), so windows of
    one round may reuse it. ``bytes`` counts what was copied since the last
    ``reset``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._host: dict = {}
        self._dev: dict = {}
        self._done: dict = {}
        self.bytes = 0

    def reset(self) -> None:
        self.bytes = 0

    def host(self, key, shape, dtype) -> np.ndarray:
        """The host buffer of ``key`` at ``shape`` (writable as numpy)."""
        k = (key, tuple(shape))
        buf = self._host.get(k)
        if buf is None:
            like = torch.from_numpy(np.empty((0,), dtype))
            buf = self._host[k] = torch.empty(tuple(shape), dtype=like.dtype,
                                               pin_memory=self.cuda)
        done = self._done.get(k)
        if done is not None:
            done.synchronize()  # its previous copy has left the buffer
        return buf.numpy()

    def put(self, key, shape) -> torch.Tensor:
        """The device buffer of ``key``, loaded from its host buffer."""
        k = (key, tuple(shape))
        h = self._host[k]
        d = self._dev.get(k)
        if d is None:
            d = self._dev[k] = torch.empty(h.shape, dtype=h.dtype, device=self.device)
        d.copy_(h, non_blocking=True)
        if self.cuda:
            ev = self._done.get(k) or torch.cuda.Event()
            ev.record()
            self._done[k] = ev
        self.bytes += h.numel() * h.element_size()
        return d

    def stage(self, key, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the device, through ``key``'s buffers."""
        arr = np.asarray(arr)
        np.copyto(self.host(key, arr.shape, arr.dtype), arr)
        return self.put(key, arr.shape)

    def rows(self, store: PopulationStore, idx: np.ndarray, names) -> dict:
        """The store's rows ``idx`` of ``names`` (lanes or trees) on the
        device: gathered straight into the pinned buffers, then copied."""
        k = len(idx)
        srcs = {name: store.lanes[name] if name in store.lanes else store.trees[name]
                for name in names}
        out = {name: tree_unflatten(src, [self.host((name, i), (k,) + leaf.shape[1:], leaf.dtype)
                                          for i, leaf in enumerate(tree_leaves(src))])
               for name, src in srcs.items()}
        store.gather(idx, names, out=out)
        return {name: tree_unflatten(src, [self.put((name, i), buf.shape)
                                           for i, buf in enumerate(tree_leaves(out[name]))])
                for name, src in srcs.items()}

    def data(self, data, idx: np.ndarray, key: str = "data") -> tuple:
        """The data shard of clients ``idx`` on the device (labels as int64)."""
        parts = data.shard(np.asarray(idx))
        staged = [self.stage((key, i), a) for i, a in enumerate(parts)]
        staged[1], staged[4] = staged[1].to(torch.int64), staged[4].to(torch.int64)
        return tuple(staged)


# ---------------------------------------------------------------------------
# shared host-runner setup and the device steps
# ---------------------------------------------------------------------------


def _delay_lane(n_clients: int, seed: int, device) -> torch.Tensor:
    """Oort's per-client analytic delay lane, ``uniform(PRNGKey(seed + 99),
    (C,), 0.5, 2.0)``: the bits ``api.build_env`` draws (the JAX package's
    in either threefry stream), kept on the device."""
    return prng.uniform(prng.PRNGKey(seed + 99, device=device), (n_clients,), minval=0.5,
                        maxval=2.0)


class _HostSetup:
    """What both host runners need before their first event: the pipeline,
    the clock, the initial model (the device-resident run's key split and
    init), and the (C,) sample counts and delay lane on the device."""

    def __init__(self, data, cfg: FLConfig, device: torch.device, init_fn, loss_fn, acc_fn,
                 comm, pipeline, client_delay):
        self.device = device
        self.pipeline = pipeline or pipeline_from_config(cfg)
        self.comm = comm or CommModel()
        r_init, self.r_loop = prng.split(prng.PRNGKey(cfg.seed, device=device))
        if init_fn is None:
            init_fn = lambda r: init_mlp(r, data.n_features, data.n_classes)  # noqa: E731
        self.g0 = init_fn(r_init)
        self.n_layers = len(self.g0)
        self.pms0 = cfg.pms_layers if cfg.personalization.mode == "pms" else self.n_layers
        self.clock = ClientClock.build(self.g0, self.pipeline.transmit.codec, data, cfg,
                                       self.comm, client_delay)
        self.loss_fn, self.acc_fn = loss_fn, acc_fn
        self.n_clients = data.n_clients
        self.n_samples = torch.as_tensor(np.asarray(data.n_samples), dtype=torch.float32,
                                         device=device)
        self.delay = _delay_lane(data.n_clients, cfg.seed, device)
        self.stateful = self.pipeline.personalizer.stateful
        self.lossy = self.pipeline.transmit.lossy

    def default_lanes(self) -> dict[str, np.ndarray]:
        c = self.n_clients
        return {"accuracy": np.zeros((c,), np.float32), "loss": np.zeros((c,), np.float32),
                "update_norm": np.zeros((c,), np.float32),
                "participation": np.zeros((c,), np.int32)}

    def store(self, lanes: dict, backing_dir: str | None) -> PopulationStore:
        return PopulationStore.build(self.n_clients, lanes, g0=self.g0, stateful=self.stateful,
                                     lossy=self.lossy, backing_dir=backing_dir)

    def t(self, t: int) -> torch.Tensor:
        """The round index as an int32 0-d device tensor (a fill)."""
        return torch.full((), t, dtype=torch.int32, device=self.device)

    def keys(self, rng: torch.Tensor):
        """The round's key split: ``(rng, r_fit, r_sel, r_codec)``, the
        codec's key only with a lossy codec (3 or 4 keys, as the device
        round step splits)."""
        keys = prng.split(rng, 4 if self.lossy else 3)
        return keys[0], keys[1], keys[2], keys[3] if self.lossy else None

    def lane_env(self, data_k, cids: torch.Tensor) -> phases.RoundEnv:
        """The compute phases' environment on staged lanes of clients ``cids``."""
        x_tr, y_tr, m_tr, x_te, y_te, m_te = data_k
        return phases.RoundEnv(
            x_tr=x_tr, y_tr=y_tr, m_tr=m_tr, x_te=x_te, y_te=y_te, m_te=m_te,
            n_samples=self.n_samples.index_select(0, cids),
            delay=self.delay.index_select(0, cids), n_clients=int(cids.shape[0]),
            loss_fn=self.loss_fn, acc_fn=self.acc_fn, population=self.n_clients)

    def population_env(self) -> phases.RoundEnv:
        """Selection's and the layer policy's environment: the (C,) lanes,
        no data slabs (selection reads only the cheap lanes)."""
        return phases.RoundEnv(
            x_tr=None, y_tr=None, m_tr=None, x_te=None, y_te=None, m_te=None,
            n_samples=self.n_samples, delay=self.delay, n_clients=self.n_clients,
            loss_fn=None, acc_fn=None, population=self.n_clients)

    def evaluate(self, g, local, pms: torch.Tensor, x_te, y_te, m_te):
        """The distributed evaluator's accuracy and loss of ``pms.shape[0]``
        clients: each scores its eval model (global, local rows, share
        depths) on its test shard."""
        n = int(pms.shape[0])
        env = phases.RoundEnv(
            x_tr=None, y_tr=None, m_tr=None, x_te=x_te, y_te=y_te, m_te=m_te,
            n_samples=None, delay=None, n_clients=n, loss_fn=self.loss_fn, acc_fn=self.acc_fn,
            population=self.n_clients)
        ctx = phases.RoundContext(new_global=g, new_local=local,
                                  share=layer_share_mask(self.n_layers, pms))
        model = self.pipeline.personalizer.eval_model(ctx, env)
        return self.acc_fn(model, x_te, y_te, m_te), self.loss_fn(model, x_te, y_te, m_te)

    def select(self, t, r_sel, g, pms, executed, accuracy, loss, update_norm, participation):
        """Selection and the layer policy over the population's lanes, the
        device round step's expressions: ``(pctx, share, wire_paid)``."""
        share = layer_share_mask(self.n_layers, pms)
        wire_prospective, wire_paid = self.pipeline.transmit.wire_costs(g, share, executed)
        env = self.population_env()
        pctx = phases.RoundContext(
            t=t, select=executed, pms=pms, share=share, participation=participation,
            accuracy=accuracy, loss=loss, wire_bytes=wire_prospective, wire_paid=wire_paid,
            update_norm=update_norm, rng_sel=r_sel)
        pctx = self.pipeline.selector.select(pctx, env)
        pctx = pctx._replace(next_pms=self.pipeline.layer_policy.next_pms(pctx, env,
                                                                          self.n_layers))
        return pctx, share, wire_paid


def _population_plane_manifest(cfg: FLConfig, store: PopulationStore) -> dict:
    return {"host_population": True, "edge_groups": int(cfg.execution.edge_groups),
            "store_backing": None if store.backing_dir is None else f"memmap:{store.backing_dir}"}


def _eval_windows(c: int, eval_chunk: int) -> list[tuple[int, int]]:
    chunk = eval_chunk or c
    return [(lo, min(lo + chunk, c)) for lo in range(0, c, chunk)]


def _evaluate_population(su: _HostSetup, store: PopulationStore, data, staging: _Staging,
                         g, pms_lane: np.ndarray, eval_chunk: int, cache: dict):
    """Population evaluation: ``(accuracy, loss)`` (C,) on the device.
    ``eval_chunk=0`` is one whole-C call (the test slabs staged once and
    kept, the local models uploaded), bitwise the device-resident
    evaluator; else ``eval_chunk``-client windows, each window's rows
    staged (a lazy dataset regenerates them)."""
    c, dev = su.n_clients, su.device
    if eval_chunk == 0:
        slabs = cache.get("test")
        if slabs is None:
            _, _, _, x_te, y_te, m_te = data.shard(np.arange(c))
            slabs = cache["test"] = (_host_to(x_te, dev), _host_to(y_te, dev).to(torch.int64),
                                     _host_to(m_te, dev))
        local = (tree_map(lambda leaf: _host_to(leaf, dev), store.trees["local"])
                 if su.stateful else None)
        return su.evaluate(g, local, _host_to(pms_lane, dev), *slabs)
    accs, losses = [], []
    for lo, hi in _eval_windows(c, eval_chunk):
        rows = np.arange(lo, hi)
        local = (staging.rows(store, rows, ["local"])["local"] if su.stateful else None)
        _, _, _, x_te, y_te, m_te = staging.data(data, rows, key="eval")
        acc, loss = su.evaluate(g, local, staging.stage("eval_pms", pms_lane[lo:hi]),
                                x_te, y_te, m_te)
        accs.append(acc)
        losses.append(loss)
    return torch.cat(accs), torch.cat(losses)


def _restore_rows(dst, src):
    """Copy a loaded leaf into a live store leaf in place (a memmap leaf
    stays a memmap: the rows page to its file on ``flush``)."""
    dst[...] = np.asarray(src)
    return dst


def _save_store(store: PopulationStore, ckpt_dir: str, r: int, extra: dict) -> None:
    """The store's trees (memmap leaves flushed first) and every lane, with
    ``extra`` host arrays beside the lanes."""
    store.flush()
    if store.trees:
        save_pytree(store.trees, ckpt_dir, f"store_{r:05d}")
    save_host_arrays({**{f"lane_{k}": v for k, v in store.lanes.items()}, **extra}, ckpt_dir,
                     f"hist_{r:05d}")


def _load_store(store: PopulationStore, resume_from: str, r: int) -> dict:
    """Restore the store's trees row for row in place and its lanes
    verbatim; returns the snapshot's host arrays."""
    if store.trees:
        loaded = load_pytree(store.trees, resume_from, f"store_{r:05d}")
        tree_map(_restore_rows, store.trees, loaded)
    host = load_host_arrays(resume_from, f"hist_{r:05d}")
    for name in store.lanes:
        store.lanes[name][...] = host[f"lane_{name}"]
    store.flush()
    return host


def _tree_rows(template, host: dict, prefix: str, rows=None):
    """A tree shaped like ``template`` from the fetched leaves
    ``host[f"{prefix}/{i}"][0]`` (optionally only ``rows``)."""
    leaves = [host[f"{prefix}/{i}"][0] for i in range(len(tree_leaves(template)))]
    if rows is not None:
        leaves = [leaf[rows] for leaf in leaves]
    return tree_unflatten(template, leaves)


def _fetch_rows(out: dict, prefix: str, tree, idx: torch.Tensor | None = None) -> None:
    """Add a tree's leaves (rows ``idx`` of them) to a fetch under
    ``prefix/i``."""
    for i, leaf in enumerate(tree_leaves(tree)):
        out[f"{prefix}/{i}"] = leaf if idx is None else leaf.index_select(0, idx)


# ---------------------------------------------------------------------------
# host-plane synchronous runner (mirrors SyncScheduler.run)
# ---------------------------------------------------------------------------


def run_host_sync(data, cfg: FLConfig, device=None, init_fn: Callable | None = None,
                  loss_fn: Callable = mlp_loss, acc_fn: Callable = mlp_accuracy,
                  comm: CommModel | None = None, progress: bool = False,
                  pipeline: RoundPipeline | None = None, client_delay: np.ndarray | None = None,
                  recorder=None, backing_dir: str | None = None, stats: dict | None = None,
                  checkpoint_every: int = 0, checkpoint_dir: str | None = None,
                  resume_from: str | None = None):
    """The synchronous barrier loop with a host-resident population plane,
    on ``device`` (the CUDA card by default).

    A round resolves the cohort from the host selection lane, stages its
    rows (store and data shard) through the pinned buffers, runs the
    cohort step (personalize, train, transmit, guard, aggregate: the
    device round's compute phases on K lanes), fetches the cohort's results
    in one copy and scatters them, evaluates the population (thinned by
    ``eval_every``; ``eval_chunk`` windows), selects and sets the next
    depths over the (C,) lanes, and fetches those in a second copy. The
    history and accounting are ``SyncScheduler.run``'s, bit for bit; edge
    groups account their hop. ``stats`` (a dict) collects per round
    ``round_ms``, ``host_gather_ms`` (the store's and the data's rows into
    the staging buffers) and ``staged_bytes`` (host-to-device bytes of the
    cohort's rows), and the store's host bytes (``store_bytes``). Faults,
    checkpoints (the model, the rng, every store lane and tree, memmap
    leaves restored in place) and the recorder as ``SyncScheduler.run``'s;
    a resumed run is bitwise the uninterrupted one."""
    check_slice(cfg)
    dev = resolve_device(device)
    su = _HostSetup(data, cfg, dev, init_fn, loss_fn, acc_fn, comm, pipeline, client_delay)
    comm, clock = su.comm, su.clock
    faults = cfg.faults
    faulty = faults.enabled
    max_norm = float(faults.max_update_norm) if faulty else 0.0
    corrupt_scale = float(faults.corrupt_scale) if faulty else 0.0
    ckpt_dir = resolve_checkpoint_dir(checkpoint_every, checkpoint_dir, resume_from)
    c = data.n_clients
    k = cfg.execution.resolved_cohort(c)
    eval_every, eval_chunk = cfg.execution.eval_every, cfg.execution.eval_chunk
    edges = _EdgeTopology.build(cfg, c, clock)
    delay = None if clock.uniform else clock.delay

    lanes = su.default_lanes()
    lanes["select"] = np.ones((c,), bool)
    lanes["pms"] = np.full((c,), su.pms0, np.int32)
    store = su.store(lanes, backing_dir)
    tree_names = [n for n in ("local", "residual") if n in store.trees]
    staging, eval_cache = _Staging(dev), {}
    g, rng = su.g0, su.r_loop

    if recorder is not None:
        recorder.open_run(mode="sync", cfg=cfg, data=data, comm=comm, clock=clock, lanes=k,
                          device=dev, population_plane=_population_plane_manifest(cfg, store))
    prof = recorder.profiler if recorder is not None else None
    emit = recorder.log if recorder is not None else print
    keys = _SYNC_HIST + (("tx_edge_bytes",) if edges else ())
    hist: dict[str, list] = {key: [] for key in keys}
    start = 0
    if resume_from is not None:
        trees, meta = load_fl_state({"g": g, "rng": rng}, resume_from)
        g, rng, start = trees["g"], trees["rng"], int(meta["round"])
        host = _load_store(store, resume_from, start)
        hist = {key: [host[key]] for key in keys}
    for t in range(start, cfg.rounds):
        t_round0 = time.perf_counter()
        if prof is not None:
            prof.begin_chunk(t, 1)
        # --- the cohort from the host lanes (cohort_indices' order) ---
        select = store.lanes["select"]
        if faulty:
            # crashed and late clients leave the selection first; a round
            # whose every selected client died runs fault-free
            sel_pre = select.copy()
            plan, alive_np, dur_t = _sync_fault_inputs(faults, cfg.seed, t, clock,
                                                       store.lanes["pms"])
            if not (sel_pre & alive_np).any():
                alive_np = np.ones_like(alive_np)
            select = select & alive_np
        idx = np.argsort(~select, kind="stable")[:k]
        cmask = select[idx]
        executed = np.zeros((c,), bool)
        executed[idx] = cmask
        store.lanes["participation"][idx] += cmask
        # --- stage the cohort's rows ---
        t_gather0 = time.perf_counter()
        staging.reset()
        rows = staging.rows(store, idx, ["pms", "participation", "update_norm", *tree_names])
        data_k = staging.data(data, idx)
        idx_d, cmask_d = staging.stage("idx", idx), staging.stage("cmask", cmask)
        corrupt_d = (staging.stage("corrupt", plan.corrupt[idx].astype(np.int32))
                     if faulty else None)
        staged_bytes = float(staging.bytes)
        gather_ms = (time.perf_counter() - t_gather0) * 1e3
        with phase_timer(prof, "dispatch"):
            with torch.no_grad():
                rng, r_fit, r_sel, r_codec = su.keys(rng)
                pms_k = rows["pms"]
                cctx = phases.RoundContext(
                    t=su.t(t), global_params=g, local_params=rows.get("local"), select=cmask_d,
                    pms=pms_k, share=layer_share_mask(su.n_layers, pms_k),
                    residual=rows.get("residual"), participation=rows["participation"],
                    cohort_idx=idx_d, cohort_mask=cmask_d, rng_fit=r_fit, rng_codec=r_codec,
                    rng_sel=r_sel)
                kinds = (None if corrupt_d is None
                         else torch.where(cmask_d, corrupt_d, torch.zeros_like(corrupt_d)))
                cctx, n_rejected = compute_lanes(su.pipeline, cctx, su.lane_env(data_k, idx_d),
                                                 rows["update_norm"], kinds, max_norm,
                                                 corrupt_scale)
                g = cctx.new_global
                back = {"update_norm": cctx.update_norm, "rejected": n_rejected}
                if su.stateful:
                    _fetch_rows(back, "local", cctx.new_local)
                if su.lossy:
                    _fetch_rows(back, "residual", cctx.residual)
                back = StackedOuts([back])
        with phase_timer(prof, "device_get"):
            back = back.numpy()  # the cohort's results: one device-to-host copy
            store.scatter(idx, {name: _tree_rows(store.trees[name], back, name)
                                for name in tree_names})
            store.lanes["update_norm"][idx] = back["update_norm"][0]
        # --- population evaluation (thinned), selection, next depths ---
        pms_row = store.lanes["pms"].copy()  # this round's depths, the history's
        with phase_timer(prof, "dispatch"):
            with torch.no_grad():
                fresh = t % eval_every == 0
                if fresh:
                    acc_d, loss_d = _evaluate_population(su, store, data, staging, g, pms_row,
                                                         eval_chunk, eval_cache)
                else:
                    acc_d = staging.stage("accuracy", store.lanes["accuracy"])
                    loss_d = staging.stage("loss", store.lanes["loss"])
                executed_d = staging.stage("executed", executed)
                pctx, share, wire_paid = su.select(
                    su.t(t), r_sel, g, staging.stage("pms_c", pms_row), executed_d, acc_d, loss_d,
                    staging.stage("update_norm_c", store.lanes["update_norm"]),
                    staging.stage("participation_c", store.lanes["participation"]))
                pop = {"next_select": pctx.next_select, "next_pms": pctx.next_pms,
                       "wire": wire_paid,
                       "tx": transmitted_parameters(executed_d, share, layer_param_sizes(g))}
                if fresh:
                    pop.update(accuracy=acc_d, loss=loss_d)
                pop = StackedOuts([pop])
        with phase_timer(prof, "device_get"):
            pop = {key: v[0] for key, v in pop.numpy().items()}  # the second copy
        if fresh:
            store.lanes["accuracy"][:] = pop["accuracy"]
            store.lanes["loss"][:] = pop["loss"]
        store.lanes["select"] = pop["next_select"].copy()
        store.lanes["pms"] = pop["next_pms"].astype(np.int32)
        if prof is not None:
            prof.end_chunk()
        # --- the simulated clock (SyncScheduler's accounting) ---
        wire_row = pop["wire"].astype(np.float64)[None]
        sel, pms = executed[None], pms_row[None]
        n_dropped = None
        if faulty:
            # the server waits on everyone it dispatched, up to the deadline
            wait = dur_t[sel_pre]
            rt = float(wait.max()) if wait.size else 0.0
            if faults.deadline_s > 0.0:
                rt = min(rt, faults.deadline_s)
            rt = np.asarray([rt + comm.server_latency_s], np.float64)
            n_dropped = int((sel_pre & ~alive_np).sum())
        elif edges:
            e_bytes = edges.hop_bytes(sel, pms)
            hist["tx_edge_bytes"].append(e_bytes)
            rt = edges.round_times(comm, clock, wire_row, sel, pms, e_bytes, delay)
        else:
            rt = comm.round_times(wire_row, clock.round_flops(pms), sel,
                                  rx_bytes=clock.shared_params(pms) * float(BYTES_PER_PARAM),
                                  delay=delay)
        acc_row = store.lanes["accuracy"].copy()
        tx = np.asarray([pop["tx"]], np.float64)
        rejected = back["rejected"].astype(np.int64)
        hist["round_time"].append(rt)
        hist["acc"].append(acc_row[None])
        hist["selected"].append(sel)
        hist["pms"].append(pms)
        hist["wire"].append(wire_row.sum(axis=1))
        hist["tx_params"].append(tx)
        hist["rejected"].append(rejected)
        if recorder is not None:
            with phase_timer(prof, "record"):
                recorder.on_sync_chunk(
                    t0=t, acc=acc_row[None], sel=sel, pms=pms, wire=wire_row, tx=tx, times=rt,
                    update_norm=store.lanes["update_norm"][None], lanes=k,
                    host_gather_ms=[gather_ms], staged_bytes=[staged_bytes], rejected=rejected,
                    dropped=None if n_dropped is None else np.asarray([n_dropped], np.int64))
        round_s = time.perf_counter() - t_round0
        hist["wall"].append(np.asarray([round_s]))
        if stats is not None:
            stats.setdefault("round_ms", []).append(round_s * 1e3)
            stats.setdefault("host_gather_ms", []).append(gather_ms)
            stats.setdefault("staged_bytes", []).append(staged_bytes)
        if progress:
            for _ in _progress_rows(t, 1, 1, cfg.rounds):
                emit(format_sync_progress(t, float(acc_row.mean()), int(executed.sum())))
        r = t + 1
        if ckpt_dir and checkpoint_every and r % checkpoint_every == 0:
            save_fl_state({"g": g, "rng": rng}, ckpt_dir, r)
            _save_store(store, ckpt_dir, r, {key: np.concatenate(v) for key, v in hist.items()})

    store.flush()
    if stats is not None:
        stats["store_bytes"] = store.nbytes()
    history = sync_history(hist, k)
    if recorder is not None:
        recorder.close(history)
    return history


# ---------------------------------------------------------------------------
# host-plane async runner (mirrors AsyncScheduler.run)
# ---------------------------------------------------------------------------


def run_host_async(data, cfg: FLConfig, device=None, init_fn: Callable | None = None,
                   loss_fn: Callable = mlp_loss, acc_fn: Callable = mlp_accuracy,
                   comm: CommModel | None = None, progress: bool = False,
                   pipeline: RoundPipeline | None = None, client_delay: np.ndarray | None = None,
                   recorder=None, backing_dir: str | None = None, stats: dict | None = None,
                   checkpoint_every: int = 0, checkpoint_dir: str | None = None,
                   resume_from: str | None = None):
    """FedBuff-style buffered execution with a host-resident population
    plane, on ``device`` (the CUDA card by default): each event stages the
    M dispatch slots' rows (the slot snapshots stay on the device), runs
    the async step's compute phases on them (the staleness merge: one
    launch of masked_aggregate's kernel), fetches the landers' results in
    one copy and scatters only those (the other lanes recompute the same
    rows next event, as on the device path), then evaluates, selects and
    refills the freed slots over the (C,) lanes. The event queue, faults,
    history, checkpoints and recorder are ``AsyncScheduler.run``'s; the
    history is bitwise the device-resident run's. ``stats`` as
    ``run_host_sync``'s, a row an event."""
    check_slice(cfg)
    dev = resolve_device(device)
    su = _HostSetup(data, cfg, dev, init_fn, loss_fn, acc_fn, comm, pipeline, client_delay)
    comm, clock = su.comm, su.clock
    check_async_aggregator(su.pipeline)
    faults = cfg.faults
    faulty = faults.enabled
    max_norm = float(faults.max_update_norm) if faulty else 0.0
    corrupt_scale = float(faults.corrupt_scale) if faulty else 0.0
    ckpt_dir = resolve_checkpoint_dir(checkpoint_every, checkpoint_dir, resume_from)
    c = data.n_clients
    m = async_slots(cfg, c)
    eval_every, eval_chunk = cfg.execution.eval_every, cfg.execution.eval_chunk
    edges = _EdgeTopology.build(cfg, c, clock)
    buffer_k = cfg.scheduler.buffer_k or max(1, c // 2)

    lanes = su.default_lanes()
    lanes["client_pms"] = np.full((c,), su.pms0, np.int32)
    store = su.store(lanes, backing_dir)
    tree_names = [n for n in ("local", "residual") if n in store.trees]
    staging, eval_cache = _Staging(dev), {}
    g, rng = su.g0, su.r_loop
    slot_params = tree_map(lambda gl: gl.expand((m,) + tuple(gl.shape)).clone(), su.g0)
    slot_pms = np.full((m,), su.pms0, np.int32)

    if recorder is not None:
        recorder.open_run(mode="async", cfg=cfg, data=data, comm=comm, clock=clock, lanes=m,
                          buffer_k=buffer_k, device=dev,
                          population_plane=_population_plane_manifest(cfg, store))
    prof = recorder.profiler if recorder is not None else None
    emit = recorder.log if recorder is not None else print

    # --- the host event queue over the M slots (client_pms is the store's lane) ---
    plane = _SlotPlane.start(cfg, clock, comm, store.lanes["client_pms"], m)
    if recorder is not None:
        recorder.on_async_dispatch(plane.slot_client, 0.0, plane.client_pms)
    keys = _ASYNC_HIST + (("tx_edge_bytes",) if edges else ())
    hist: dict[str, list] = {key: [] for key in keys}
    sim_clock, version, t = 0.0, 0, 0
    if resume_from is not None:
        trees, meta = load_fl_state({"g": g, "rng": rng, "slot_params": slot_params},
                                    resume_from)
        g, rng, slot_params = trees["g"], trees["rng"], trees["slot_params"]
        t, sim_clock, version = int(meta["round"]), float(meta["sim_clock"]), int(meta["version"])
        host = _load_store(store, resume_from, t)
        plane.restore(host)
        slot_pms[...] = host["slot_pms"]
        hist = {key: list(host[key]) for key in keys}
    while t < cfg.rounds:
        if not plane.active.any():
            break  # every slot's retries ran out: end with the history so far
        t_round0 = time.perf_counter()
        ev = plane.land(buffer_k, version)
        if ev is None:
            continue  # a pure-retry event: no aggregation
        if prof is not None:
            prof.begin_chunk(t, 1)
        # --- stage the slots' rows (a duplicate id in an inactive slot is a
        # row read; only landing rows write back) ---
        t_gather0 = time.perf_counter()
        staging.reset()
        store.lanes["participation"][ev.landed_clients] += 1
        cids = plane.slot_client
        rows = staging.rows(store, cids, ["participation", "update_norm", *tree_names])
        data_m = staging.data(data, cids)
        cids_d = staging.stage("cids", cids.astype(np.int64))
        land_d = staging.stage("land", ev.land)
        landers_d = staging.stage("landers", ev.landers.astype(np.int64))
        staleness_d = staging.stage("staleness", ev.staleness)
        slot_pms_d = staging.stage("slot_pms", slot_pms)
        corrupt_d = staging.stage("corrupt", plane.slot_kind) if faulty else None
        staged_bytes = float(staging.bytes)
        gather_ms = (time.perf_counter() - t_gather0) * 1e3
        with phase_timer(prof, "dispatch"):
            with torch.no_grad():
                rng, r_fit, r_sel, r_codec = su.keys(rng)
                share_m = layer_share_mask(su.n_layers, slot_pms_d)
                cctx = phases.RoundContext(
                    t=su.t(t), global_params=g, local_params=rows.get("local"), select=land_d,
                    pms=slot_pms_d, share=share_m, residual=rows.get("residual"),
                    participation=rows["participation"], cohort_idx=cids_d, cohort_mask=land_d,
                    dispatch_params=slot_params, staleness=staleness_d, rng_fit=r_fit,
                    rng_codec=r_codec, rng_sel=r_sel)
                kinds = (None if corrupt_d is None
                         else torch.where(land_d, corrupt_d, torch.zeros_like(corrupt_d)))
                cctx, n_rejected = compute_lanes(su.pipeline, cctx, su.lane_env(data_m, cids_d),
                                                 rows["update_norm"], kinds, max_norm,
                                                 corrupt_scale)
                g = cctx.new_global
                land_f = land_d.to(torch.float32)
                n_land = torch.clamp_min(torch.sum(land_f), 1.0)
                merge_w = (cctx.merge_weight if cctx.merge_weight is not None
                           else torch.ones_like(land_f))
                back = {
                    "update_norm": cctx.update_norm.index_select(0, landers_d),
                    "wire": cctx.wire_paid.index_select(0, landers_d),
                    "tx_params": transmitted_parameters(land_d, share_m, layer_param_sizes(g)),
                    "staleness_mean": torch.sum(land_f * staleness_d.to(torch.float32)) / n_land,
                    "merge_discount_mean": torch.sum(land_f * merge_w) / n_land,
                    "rejected": n_rejected,
                }
                if su.stateful:
                    _fetch_rows(back, "local", cctx.new_local, landers_d)
                if su.lossy:
                    _fetch_rows(back, "residual", cctx.residual, landers_d)
                back = StackedOuts([back])
        with phase_timer(prof, "device_get"):
            back = back.numpy()  # the landers' results: one device-to-host copy
            store.scatter(ev.landed_clients, {name: _tree_rows(store.trees[name], back, name)
                                              for name in tree_names})
            store.lanes["update_norm"][ev.landed_clients] = back["update_norm"][0]
        land_c = np.zeros((c,), bool)
        land_c[ev.landed_clients] = True
        wire_paid_c = np.zeros((c,), np.float32)
        wire_paid_c[ev.landed_clients] = back["wire"][0]
        pms_pre = store.lanes["client_pms"].copy()  # this event's depths, the history's
        # --- population evaluation (thinned), selection, slot refill ---
        with phase_timer(prof, "dispatch"):
            with torch.no_grad():
                fresh = t % eval_every == 0
                if fresh:
                    acc_d, loss_d = _evaluate_population(su, store, data, staging, g, pms_pre,
                                                         eval_chunk, eval_cache)
                else:
                    acc_d = staging.stage("accuracy", store.lanes["accuracy"])
                    loss_d = staging.stage("loss", store.lanes["loss"])
                pctx, _, _ = su.select(
                    su.t(t), r_sel, g, staging.stage("pms_c", pms_pre),
                    staging.stage("land_c", land_c), acc_d, loss_d,
                    staging.stage("update_norm_c", store.lanes["update_norm"]),
                    staging.stage("participation_c", store.lanes["participation"]))
                dispatched, new_slot_client, new_slot_pms, disp_pms = assign_slots(
                    pctx.next_select, pctx.next_pms, staging.stage("idle_now", ev.idle_now),
                    land_d, staging.stage("active", plane.active),
                    staging.stage("force", np.asarray(ev.force)), cids_d, slot_pms_d)
                slot_params = tree_map(
                    lambda s_, gl: torch.where(_lane(dispatched, s_), gl.expand_as(s_), s_),
                    slot_params, g)
                pop = {"dispatched": dispatched, "slot_client": new_slot_client,
                       "slot_pms": new_slot_pms, "disp_pms": disp_pms}
                if fresh:
                    pop.update(accuracy=acc_d, loss=loss_d)
                pop = StackedOuts([pop])
        with phase_timer(prof, "device_get"):
            pop = {key: v[0] for key, v in pop.numpy().items()}  # the second copy
        if fresh:
            store.lanes["accuracy"][:] = pop["accuracy"]
            store.lanes["loss"][:] = pop["loss"]
        if prof is not None:
            prof.end_chunk()
        dispatched = pop["dispatched"]
        new_slot_client = pop["slot_client"].astype(np.int32)
        slot_pms = pop["slot_pms"].astype(np.int32)
        plane.client_pms[new_slot_client[dispatched]] = pop["disp_pms"][dispatched]
        plane.dispatch(ev, dispatched, new_slot_client, version)

        out = {"acc": store.lanes["accuracy"].copy(), "selected": land_c,
               "tx_params": back["tx_params"][0], "pms": pms_pre,
               "wire_per_client": wire_paid_c, "update_norm": store.lanes["update_norm"],
               "staleness_mean": back["staleness_mean"][0],
               "merge_discount_mean": back["merge_discount_mean"][0],
               "rejected": back["rejected"][0], "dispatched": dispatched}
        append_async_event(hist, out, ev, sim_clock, plane, edges)
        record_async_event(recorder, prof, plane, ev, t, hist, out, faulty)
        round_s = time.perf_counter() - t_round0
        hist["wall"].append(round_s)
        if stats is not None:
            stats.setdefault("round_ms", []).append(round_s * 1e3)
            stats.setdefault("host_gather_ms", []).append(gather_ms)
            stats.setdefault("staged_bytes", []).append(staged_bytes)
        sim_clock = ev.new_clock
        version += 1
        if progress and (t % 10 == 0 or t == cfg.rounds - 1):
            emit(format_async_progress(t, float(out["acc"].mean()), int(ev.land.sum()),
                                       ev.new_clock, hist["staleness"][-1]))
        t += 1
        if ckpt_dir and checkpoint_every and t % checkpoint_every == 0:
            save_fl_state({"g": g, "rng": rng, "slot_params": slot_params,
                           "sim_clock": float(sim_clock), "version": int(version)}, ckpt_dir, t)
            _save_store(store, ckpt_dir, t, {**plane.snapshot(), "slot_pms": slot_pms,
                                             **{key: _stacked(key, v) for key, v in hist.items()}})

    store.flush()
    if stats is not None:
        stats["store_bytes"] = store.nbytes()
    history = async_history(hist)
    if recorder is not None:
        recorder.close(history)
    return history
