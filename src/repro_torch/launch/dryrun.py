"""The dry run of the port — the port of the JAX package's
``launch/dryrun.py``: one rank's step of every (architecture x input shape x
mesh) at the production shapes, with no allocation, and what it costs.

The JAX package lowers and compiles each step with ``ShapeDtypeStruct``
inputs and reads XLA's ``memory_analysis``, ``cost_analysis`` and the HLO's
collectives (``launch/hlo_analysis.py``). The port has no compiler: it
builds the step's arguments and runs the step itself on ``FakeTensor``s,
which carry a shape, a dtype and a device and no memory, as one rank of the
mesh over a fake process group of the mesh's size (``launch.mesh
.fake_world``: 256 ranks, or 512 with ``--multi-pod``), and counts it
(``launch/cost_analysis.py``). The kernels' wrappers take their fake
branch: the launch's outputs and temporaries with its shapes, and the
launch, its flops and bytes reported to the counter; their own launch
counters, which count real launches, do not move (``flash_attention_plain``
would hold S x T scores). Nothing runs on a card and nothing is allocated, so the
dry run needs no card; ``resolve_device`` is never asked.

The fake tensors live on the CPU device, on every host, and every branch
that picks the card's path (the kernels' wrappers, ``launch/tp.py``'s
float32-output product) takes a fake tensor for the card's: a CPU-only
torch aborts in autograd on fake CUDA tensors, and one device for every
host makes the numbers the same here and on the card.

Per (arch, shape, mesh) the result has the JAX package's keys:

- ``memory``: ``argument_bytes`` — the storage this rank holds for the
  step's arguments: its parameters, AdamW moments and step (train), the
  batch (the port hands every rank the global batch) and the cache, by
  part as ``params_bytes``, ``opt_bytes``, ``batch_bytes`` and
  ``cache_bytes``; ``output_bytes`` — the storage of the step's result
  that is no argument's; ``peak_bytes``, the most live storage through
  the step (init's transients left out, as XLA's ``memory_analysis`` sees
  only the compiled step); ``temp_bytes`` — ``peak_bytes`` less
  ``argument_bytes``; and ``jax_layout_argument_bytes`` (by part as
  ``jax_layout_<part>_bytes``), the same arguments in the JAX package's
  layout (``sharding.tree_pspecs``, ``batch_spec``, ``cache_pspecs`` of
  the whole trees), which the port does not hold: it keeps norms, the
  float32 router, a shared kv head and the cache's ``kv_pos`` whole over
  ``model`` and the batch whole over the data axes;
- ``flops_per_device``, ``bytes_per_device`` (eager PyTorch fuses nothing:
  larger than XLA's count), ``collective_bytes_per_device`` and
  ``collectives`` by kind;
- the roofline terms at the H100 SXM's data-sheet figures
  (``launch.mesh.HW``: not measurements) and ``bottleneck``.
  ``t_collective`` moves the bytes of a group within one host of 8 over
  NVLink and those of a group that spans hosts over the network
  (``link_bytes`` splits them);

and the port's own: ``launches`` and ``kernel_flops`` by kernel,
``attention_flops`` (the attention kernels' products, which skip invisible
key tiles where JAX's ``chunked_attention`` computes every tile), ``fits``
(peak within the card's 80 GB), the ``device`` the figures are for, and
``layout``. The layout is the port's: ZeRO over the data axes x tensor
parallelism over ``model`` (``init_params(zero=True)``, JAX's
``tree_pspecs``) for every shape, the caches at the rank's rows, kv heads
and d_inner. ``--seq-parallel`` opens the mesh context with
``seq_parallel``: a train step of a decoder whose sequence the ``model``
axis divides then runs JAX's sequence-parallel layout (the residual stream
between blocks split over ``model``, ``launch/tp.py``), which the result's
``layout`` names; a prefill, a decode and whisper are traced as without it,
as JAX applies it in training only. ``recompute_collectives`` (by kind)
are the bytes of ``collectives`` that ``torch.utils.checkpoint``'s
recompute runs again, the stream's gathers among them, and ``wire_bytes``
(by kind) what a ring sends from the rank.

Usage (no card needed):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 2,2     # four cards
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --shape train_4k --fl-shared 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k --mesh 16,16 --mesh 2,2 \\
      --mesh 1,4 [--seq-parallel]; ... --table --seq-parallel   # with and without SP

Results go to ``build/dryrun`` (not committed) unless ``--out`` says
otherwise, one JSON a combination.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import types

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config, get_shape, list_archs
from repro_torch.launch import context as ctxmod
from repro_torch.launch.cost_analysis import analyze, storage_bytes
from repro_torch.launch.mesh import HW, data_axes, fake_world, make_rank_mesh
from repro_torch.launch.sharding import batch_spec, cache_pspecs, tree_pspecs
from repro_torch.models.api import get_model, make_batch_specs, param_tree
from repro_torch.models.transformer import stream_len
from repro_torch.optim import adamw

__all__ = ["SLIDING_WINDOW", "build_lowerable", "main", "mesh_axes", "run_one"]

SLIDING_WINDOW = 8192
DEVICE = "cpu"  # the fake tensors' device (module docstring)
OUT_DIR = os.path.join("build", "dryrun")
PRODUCTION = {False: (16, 16), True: (2, 16, 16)}

def mesh_axes(shape) -> tuple[str, ...]:
    """The axis names of a mesh of ``shape``: (data, model), or (pod,
    data, model) for three entries."""
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def window_for(cfg, shape) -> int:
    """JAX's rule: long_500k runs the attention-only archs on an 8,192-key
    ring; jamba's attention layers keep the whole cache (the hybrid is
    sub-quadratic overall)."""
    if shape.needs_subquadratic and cfg.attn_type != "none":
        return 0 if cfg.ssm else SLIDING_WINDOW
    return 0


def _batch_tensors(cfg, kind: str, batch: int, seq: int) -> dict:
    return {k: torch.zeros(s, dtype=d, device=DEVICE)
            for k, (s, d) in make_batch_specs(cfg, kind, batch, seq).items()}


def _spec_bytes(shape, itemsize: int, spec, mesh) -> int:
    """A leaf's bytes a device under ``spec`` (one entry a dim: an axis
    name, a tuple of names or None), as JAX shards it."""
    n = itemsize
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        n *= -(-dim // math.prod(mesh.shape[a] for a in axes))
    return n


def _tree_bytes(tree, specs, mesh) -> int:
    """Every tensor leaf of ``tree`` at its spec in ``specs`` (the same
    nesting), whole without a mesh."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v, sp, mesh) for v, sp in zip(tree, specs))
    if mesh is None:
        return tree.numel() * tree.element_size()
    return _spec_bytes(tuple(tree.shape), tree.element_size(), specs, mesh)


def layout_bytes(cfg, shape, window: int, mesh, dp) -> dict:
    """The arguments' bytes a device in JAX's layout (``tree_pspecs`` of
    the whole parameters, AdamW's two float32 moments and its int32 step
    for a train step, ``batch_spec`` of the batch, ``cache_pspecs`` of the
    whole cache and its int32 ``pos``), read off the port's whole trees,
    which are built here on fake tensors with no mesh."""
    bundle = get_model(cfg)
    with FakeTensorMode():
        # the rules read a leaf's path: "blocks/0/mixer/wq", as JAX's tree spells it
        whole = param_tree(bundle.init(torch.Generator()))
        params = {k.replace(".", "/"): p for k, p in whole.items()}
        specs = tree_pspecs(params, mesh, dp) if mesh is not None else params
        out = {"params": _tree_bytes(params, specs, mesh)}
        kind = shape.kind
        if kind == "train":
            moments = {k: p.to(torch.float32) for k, p in params.items()}
            out["opt"] = 2 * _tree_bytes(moments, specs, mesh) + 4
        if kind == "decode":
            data = {"tokens": torch.zeros((shape.global_batch, 1), dtype=torch.int32)}
        else:
            data = _batch_tensors(cfg, kind, shape.global_batch, shape.seq_len)
        out["batch"] = sum(_tree_bytes(t, batch_spec(k, tuple(t.shape), mesh, dp)
                                       if mesh is not None else None, mesh)
                           for k, t in data.items())
        if kind == "decode":
            cache = {k: torch.zeros((), dtype=torch.int32) if isinstance(v, int) else v
                     for k, v in bundle.init_cache(shape.global_batch, shape.seq_len, window,
                                                   DEVICE).items()}  # JAX's int32 pos
            out["cache"] = _tree_bytes(cache, cache_pspecs(cache, mesh, dp)
                                       if mesh is not None else cache, mesh)
    return out


def _cut(shape, batch: int | None, seq: int | None):
    """``shape`` at another global batch or sequence length."""
    return dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                               seq_len=seq or shape.seq_len)


def build_lowerable(arch: str, shape_name: str, mesh, multi_pod: bool,
                    fl_shared: int | None = None, *, cfg=None, batch: int | None = None,
                    seq: int | None = None, zero: bool | None = None):
    """Returns (fn, held, meta): ``fn()`` runs one step of ``arch`` at
    ``shape_name`` on this rank, ``held`` holds its arguments' tensors
    ({"params", "opt", "batch", "cache"}), ``meta`` the JAX package's. Call
    it under a ``FakeTensorMode`` and, with a ``mesh`` (a ``RankMesh``),
    inside its ``mesh_context``. ``cfg``, ``batch`` and ``seq`` cut the
    configuration and the shape (the card's real runs); ``zero`` (default:
    under a mesh) builds the model of 2-D blocks, False its
    tensor-parallel blocks alone (the port's serving layout)."""
    cfg = cfg or get_config(arch)
    shape = _cut(get_shape(shape_name), batch, seq)
    dp = data_axes(multi_pod)
    window = window_for(cfg, shape)
    bundle = get_model(cfg)
    meta = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "window": window,
            "params": cfg.param_count(), "active_params": cfg.active_param_count(),
            "global_batch": shape.global_batch, "seq_len": shape.seq_len,
            "n_layers": cfg.n_layers}
    if fl_shared is not None:
        from repro_torch.fl.cross_silo import build_fl_dryrun

        return build_fl_dryrun(cfg, bundle, shape, mesh, dp, fl_shared, meta)

    zero = (mesh is not None) if zero is None else zero
    model = bundle.init(torch.Generator(), zero=zero)
    params = list(model.parameters())
    if shape.kind == "train":
        opt = adamw(3e-4)
        opt_state = opt.init(param_tree(model))
        data = _batch_tensors(cfg, "train", shape.global_batch, shape.seq_len)
        step = bundle.make_train_step(opt, window=window)
        held = {"params": params, "opt": opt_state, "batch": data}
        return (lambda: step(model, opt_state, data)[2]), held, meta
    if shape.kind == "prefill":
        data = _batch_tensors(cfg, "prefill", shape.global_batch, shape.seq_len)
        step = bundle.make_prefill_step(window=window)
        return (lambda: step(model, data)), {"params": params, "batch": data}, meta
    cache = bundle.init_cache(shape.global_batch, shape.seq_len, window, DEVICE)
    token = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device=DEVICE)
    step = bundle.make_decode_step(window=window)
    held = {"params": params, "batch": {"tokens": token}, "cache": cache}
    return (lambda: step(model, cache, token)), held, meta


def _resolve_mesh(mesh, multi_pod: bool):
    """The mesh shape asked for: None -> the production mesh, () -> no
    mesh (one card), else the shape given."""
    if mesh is None:
        return PRODUCTION[multi_pod]
    return tuple(int(n) for n in mesh)


def run_one(arch: str, shape_name: str, multi_pod: bool = False, fl_shared: int | None = None,
            verbose: bool = True, seq_parallel: bool = False, mesh=None, *, cfg=None,
            batch: int | None = None, seq: int | None = None, zero: bool | None = None) -> dict:
    """One (arch, shape, mesh)'s dry run on rank 0 (module docstring);
    returns its result. ``mesh`` is a shape over (data, model)
    or (pod, data, model) — None for the production mesh of ``multi_pod``,
    () for one card with no mesh. ``cfg``, ``batch``, ``seq`` and ``zero``
    as in ``build_lowerable``. Must run where no process group is open
    (``fake_world`` opens its own)."""
    shape_m = _resolve_mesh(mesh, multi_pod)
    multi_pod = len(shape_m) == 3
    dp = data_axes(multi_pod)
    n_chips = math.prod(shape_m) if shape_m else 1
    jax_layout = {}  # the model-only layout of a silo has no JAX counterpart here
    if fl_shared is None:
        shape, cfg_ = _cut(get_shape(shape_name), batch, seq), cfg or get_config(arch)
        stub = types.SimpleNamespace(shape=dict(zip(mesh_axes(shape_m), shape_m)))
        jax_layout = layout_bytes(cfg_, shape, window_for(cfg_, shape), stub if shape_m else None,
                                  dp)
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        rank_mesh = None
        if shape_m:
            stack.enter_context(fake_world(n_chips, 0))
            rank_mesh = make_rank_mesh(shape_m, mesh_axes(shape_m), device=DEVICE)
            stack.callback(rank_mesh.close)
            stack.enter_context(ctxmod.mesh_context(
                rank_mesh, dp_axes=dp, moe_ep=(fl_shared is None), seq_parallel=seq_parallel))
        stack.enter_context(FakeTensorMode())
        fn, held, meta = build_lowerable(arch, shape_name, rank_mesh, multi_pod, fl_shared,
                                         cfg=cfg, batch=batch, seq=seq, zero=zero)
        data = held.get("batch", held.get("silo_batch", {}))
        split = ("labels" in data and not (cfg or get_config(arch)).encoder_decoder
                 and ctxmod.seq_split(stream_len(cfg or get_config(arch), data)))
        t_build = time.time() - t0
        terms, _ = analyze(fn, held=held)
        t_step = time.time() - t0 - t_build
        held_bytes = {k: storage_bytes(v) for k, v in held.items()}
    attn = sum(v for k, v in terms["kernel_flops"].items() if k.startswith("flash_attention"))
    link = terms["link_bytes"]
    peak = terms["peak_bytes"]
    result = {
        **meta,
        "fl_shared": fl_shared,
        "seq_parallel": seq_parallel,
        "n_chips": n_chips,
        "mesh": dict(zip(mesh_axes(shape_m), shape_m)) if shape_m else {},
        "rank": 0,
        "lower_s": round(t_build, 1),    # building the rank's fake arguments
        "compile_s": round(t_step, 1),   # tracing the step
        "flops_per_device": terms["flops"],
        "bytes_per_device": terms["bytes"],
        "collective_bytes_per_device": terms["collective_bytes"],
        "collectives": terms["collectives"],
        "collective_count": terms["collective_count"],
        "xla_flat_flops": None,          # no XLA: nothing is counted once per loop
        "xla_flat_bytes": None,
        "flat_collective_bytes": terms["collective_bytes"],
        "memory": {
            "argument_bytes": terms["argument_bytes"],
            "output_bytes": terms["output_bytes"],
            "temp_bytes": peak - terms["argument_bytes"],
            "generated_code_bytes": None,
            "peak_bytes": peak,
            **{f"{k}_bytes": v for k, v in held_bytes.items()},
            "jax_layout_argument_bytes": sum(jax_layout.values()) if jax_layout else None,
            **{f"jax_layout_{k}_bytes": v for k, v in jax_layout.items()},
        },
        "launches": terms["launches"],
        "kernel_flops": terms["kernel_flops"],
        "attention_flops": attn,
        "row_recompute_flops": terms["row_recompute_flops"],
        "recompute_collectives": terms["recompute_collectives"],
        "wire_bytes": terms["wire_bytes"],
        "t_compute": terms["flops"] / HW["peak_flops_bf16"],
        "t_memory": terms["bytes"] / HW["hbm_bw"],
        "link_bytes": link,
        "t_collective": (link.get("nvlink", 0.0) / HW["link_bw"]
                         + link.get("network", 0.0) / HW["network_bw"]),
        "fits": peak <= HW["hbm_bytes"],
        "device": HW["device"],
        "figures": f"data sheet ({HW['source']}), not measurements",
        "layout": ("ZeRO over the data axes x TP over model" if (zero is not False and shape_m)
                   else "TP over model" if shape_m else "one card")
                  + ("" if not seq_parallel else "; sequence-parallel: the residual stream split "
                     "over model" if split else "; seq_parallel asked, not applied (JAX applies "
                     "it to a decoder's train step on a model axis over 1 that divides the "
                     "sequence)"),
    }
    terms_t = {k: result[k] for k in ("t_compute", "t_memory", "t_collective")}
    result["bottleneck"] = max(terms_t, key=terms_t.get)
    if verbose:
        print(summary_line(result))
    return result


def summary_line(r: dict) -> str:
    """One line of a result: GiB a rank, fits, collective MB by kind, the
    roofline terms."""
    gib = r["memory"]["peak_bytes"] / 2 ** 30
    mesh = "x".join(str(n) for n in r["mesh"].values()) or "1"
    coll = " ".join(f"{k}={v / 1e6:.1f}MB" for k, v in sorted(r["collectives"].items()))
    return (f"[dryrun] {r['arch']} {r['shape']} mesh {mesh} rank {r['rank']}"
            + (f" fl_shared={r['fl_shared']}" if r["fl_shared"] is not None else "")
            + f": {gib:.2f} GiB a rank ({'fits' if r['fits'] else 'does not fit'} in 80 GB), "
            f"args {r['memory']['argument_bytes'] / 2 ** 30:.2f} GiB, flops/dev "
            f"{r['flops_per_device']:.3e}, collectives {r['collective_bytes_per_device'] / 1e6:.1f}"
            f" MB {coll}; roofline compute {r['t_compute'] * 1e3:.2f} ms memory "
            f"{r['t_memory'] * 1e3:.2f} ms collective {r['t_collective'] * 1e3:.2f} ms -> "
            f"{r['bottleneck']}; launches {json.dumps(r['launches'])} ({r['device']}, "
            f"data-sheet figures)")


def tables(out_dir: str, fl_shared: int | None = None) -> str:
    """Two markdown tables of the results under ``out_dir`` (``--table``):
    the peak GiB a rank and the collective MB a rank, arch by shape, each
    cell the meshes' values in the order 16 x 16, (4, 1), (2, 2), (1, 4)
    ("—" where no result; a peak past the card's 80 GB marked ✗)."""
    meshes = [PRODUCTION[False], (4, 1), (2, 2), (1, 4)]
    shapes = list(SHAPES)
    found = {}
    for a in list_archs():
        for sh in shapes:
            for m in meshes:
                path = os.path.join(out_dir, _tag(a, sh, m, fl_shared, False) + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        found[a, sh, m] = json.load(f)

    def cell(a, sh, value) -> str:
        return " / ".join(value(found[a, sh, m]) if (a, sh, m) in found else "—" for m in meshes)

    def gib(r) -> str:
        return f"{r['memory']['peak_bytes'] / 2**30:.1f}" + ("" if r["fits"] else " ✗")

    def coll(r) -> str:
        return f"{r['collective_bytes_per_device'] / 1e6:,.0f}"

    head = "| arch | " + " | ".join(shapes) + " |\n|" + " --- |" * (len(shapes) + 1)
    out = []
    for title, value in (("peak GiB a rank", gib), ("collective MB a rank", coll)):
        rows = [f"| {a} | " + " | ".join(cell(a, sh, value) for sh in shapes) + " |"
                for a in list_archs()]
        out.append(f"{title} (16 x 16 / 4 x 1 / 2 x 2 / 1 x 4):\n\n{head}\n" + "\n".join(rows))
    return "\n\n".join(out)


def sp_tables(out_dir: str) -> str:
    """Two markdown tables of the train_4k results under ``out_dir`` with
    and without ``--seq-parallel`` (``--table --seq-parallel``): peak GiB a
    rank, and collective MB a rank with its all-reduce MB, arch by mesh
    (16 x 16, 2 x 2, 1 x 4), each cell "without / with" ("—" where no
    result; ✗ past the card's 80 GB)."""
    meshes = [PRODUCTION[False], (2, 2), (1, 4)]
    found = {}
    for a in list_archs():
        for m in meshes:
            for sp in (False, True):
                path = os.path.join(out_dir, _tag(a, "train_4k", m, None, sp) + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        found[a, m, sp] = json.load(f)

    def cell(a, m, value) -> str:
        return " / ".join(value(found[a, m, sp]) if (a, m, sp) in found else "—"
                          for sp in (False, True))

    def gib(r) -> str:
        return f"{r['memory']['peak_bytes'] / 2**30:.1f}" + ("" if r["fits"] else " ✗")

    def coll(r) -> str:
        return (f"{r['collective_bytes_per_device'] / 1e6:,.0f} "
                f"({r['collectives'].get('all-reduce', 0.0) / 1e6:,.0f})")

    names = ["16 x 16", "2 x 2", "1 x 4"]
    head = "| arch | " + " | ".join(names) + " |\n|" + " --- |" * (len(names) + 1)
    out = []
    for title, value in (("train_4k peak GiB a rank, without / with seq_parallel", gib),
                         ("train_4k collective MB a rank (of which all-reduce), without / with "
                          "seq_parallel", coll)):
        rows = [f"| {a} | " + " | ".join(cell(a, m, value) for m in meshes) + " |"
                for a in list_archs()]
        out.append(f"{title}:\n\n{head}\n" + "\n".join(rows))
    return "\n\n".join(out)


def _tag(arch, shape, mesh_shape, fl_shared, seq_parallel) -> str:
    m = ("2pod" if mesh_shape == PRODUCTION[True] else "1pod" if mesh_shape == PRODUCTION[False]
         else "mesh" + "x".join(map(str, mesh_shape)) if mesh_shape else "1card")
    return (f"{arch}_{shape}_{m}" + (f"_fl{fl_shared}" if fl_shared is not None else "")
            + ("_sp" if seq_parallel else ""))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fl-shared", type=int, default=None,
                    help="cross-silo FL round step sharing the first N stack periods")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="the sequence-parallel layout in a train step (JAX's seq_parallel)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--mesh", action="append", default=None,
                    help="a mesh shape such as 2,2 (data,model), instead of the production "
                         "mesh; repeatable; 1 alone = one card, no mesh")
    ap.add_argument("--table", action="store_true",
                    help="print the markdown tables of the results under --out, and stop "
                         "(with --seq-parallel: train_4k with and without it)")
    args = ap.parse_args(argv)
    if args.table:
        print(sp_tables(args.out) if args.seq_parallel else tables(args.out, args.fl_shared))
        return

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    if args.mesh:
        meshes = [() if m.strip() == "1" else tuple(int(x) for x in m.split(","))
                  for m in args.mesh]
    else:
        meshes = [PRODUCTION[mp] for mp in
                  ([False, True] if (args.all or args.both_meshes) else [args.multi_pod])]
    failures, combos = [], [(a, s, m) for m in meshes for a in archs for s in shapes]
    for a, s, m in combos:
        tag = _tag(a, s, m, args.fl_shared, args.seq_parallel)
        out_path = os.path.join(args.out, tag + ".json")
        if os.path.exists(out_path):
            print(f"skip {tag} (exists)")
            continue
        try:
            res = run_one(a, s, fl_shared=args.fl_shared, seq_parallel=args.seq_parallel, mesh=m)
            with open(out_path, "w") as f:
                json.dump(res, f, indent=1)
        except Exception as e:  # noqa: BLE001 — one failed combination fails the run at its end
            traceback.print_exc()
            failures.append((tag, str(e)))
            with open(os.path.join(args.out, tag + ".FAILED"), "w") as f:
                f.write(traceback.format_exc())
    if failures:
        print(f"\n{len(failures)} FAILURES:", file=sys.stderr)
        for t, e in failures:
            print(" ", t, e[:200], file=sys.stderr)
        raise SystemExit(1)
    print(f"\nall {len(combos)} combos passed")


if __name__ == "__main__":
    main()
