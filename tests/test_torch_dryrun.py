"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

The reference: one ``tests/_subproc.run_forced(code, 4)`` call runs
``repro.launch.dryrun.run_one`` (``build_lowerable``, XLA's
``memory_analysis`` and ``hlo_analysis.analyze``) on a (2, 2) mesh of host
devices for the reduced granite-3-8b (GQA), falcon-mamba-7b (Mamba) and
deepseek-moe-16b (MoE) at train, prefill and decode shapes cut to a global
batch of 8 x 256 tokens, and granite's train step again under
``seq_parallel=True``: it patches ``get_config``, ``get_shape`` and
``make_production_mesh`` inside that subprocess only. The port traces the
same on fake tensors over a fake world of 4, rank 0.

Asserted:

- the arguments' bytes a rank holds are JAX's ``argument_size_in_bytes``
  exactly once the layout differences are taken off, each computed from
  the config: the port keeps the norms and an MoE layer's float32 router
  whole over ``model`` (JAX splits them), with a train step's two float32
  moments of each, hands every rank the global batch (JAX its share over
  ``data``), keeps a decode cache's ``kv_pos`` whole over ``model`` and
  holds its ``pos`` as a Python int (JAX's is an int32); and the same
  arguments in JAX's layout (``jax_layout_argument_bytes``, the ported
  ``tree_pspecs``, ``batch_spec``, ``cache_pspecs``) are JAX's exactly;
- the product flops outside attention agree within 2%, attention reported
  apart (the port's kernels skip the tiles no query sees; JAX's
  ``chunked_attention`` computes every tile). Two differences of layout
  are added back, each computed from the config: a tensor-parallel
  prefill's head runs at the last position only (JAX's at every position),
  and under ``torch.utils.checkpoint`` each block's last row product runs
  again in the recompute (a custom autograd Function runs its whole
  forward there; XLA's remat drops a product whose output the backward
  does not read);
- the 256-rank production mesh traces all four shapes of the reduced
  granite on rank 0 (and a 512-rank two-pod mesh one), with the JAX
  package's result keys;
- ``--fl-shared`` gives a result through the CLI;
- under ``seq_parallel`` granite's train step holds JAX's arguments and
  product flops as above, its peak falls below the port's own trace
  without it, with the same products and launches, and its stream's
  all-reduces give way to reduce-scatters and all-gathers, which the
  checkpoint's recompute runs again; a prefill, a decode, whisper, a
  (d, 1) mesh and a sequence the ``model`` axis does not divide trace the
  same step with or without the flag.
"""

from __future__ import annotations

import dataclasses
import json
import math

import pytest

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import main, run_one
from repro_torch.models.api import make_batch_specs
from repro_torch.models.transformer import layer_specs

ARCHS = ("granite-3-8b", "falcon-mamba-7b", "deepseek-moe-16b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
B, S, MESH = 8, 256, (2, 2)
FLOPS_REL = 0.02
JAX_KEYS = {"arch", "shape", "multi_pod", "window", "params", "active_params", "fl_shared",
            "seq_parallel", "n_chips", "lower_s", "compile_s", "flops_per_device",
            "bytes_per_device", "collective_bytes_per_device", "collectives", "xla_flat_flops",
            "xla_flat_bytes", "flat_collective_bytes", "memory", "t_compute", "t_memory",
            "t_collective", "bottleneck"}

_JAX_CODE = """
import os
os.environ["JAX_CACHE_DIR"] = {cache!r}
import dataclasses, json
import repro.launch.dryrun as D
import jax
from jax.sharding import AxisType
from repro.configs import get_config, get_shape

D.get_config = lambda a: get_config(a).reduced()
D.get_shape = lambda n: dataclasses.replace(get_shape(n), global_batch={b}, seq_len={s})
mesh = jax.make_mesh({mesh}, ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(AxisType.Auto,) * 2)
D.make_production_mesh = lambda multi_pod=False: mesh
out = {{}}
for arch, shape, sp in [(a, s, False) for a in {archs!r} for s in {shapes!r}] + [
        ("granite-3-8b", "train_4k", True)]:
    r = D.run_one(arch, shape, verbose=False, seq_parallel=sp)
    out[arch + " " + shape + (" seq_parallel" if sp else "")] = {{
        "argument_bytes": r["memory"]["argument_bytes"], "flops": r["flops_per_device"]}}
with open({out!r}, "w") as f:
    json.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    pytest.importorskip("jax")
    from _subproc import run_forced

    base = tmp_path_factory.mktemp("dryrun")
    out = base / "jax.json"
    code = _JAX_CODE.format(cache=str(base / "cache"), b=B, s=S, mesh=MESH, archs=ARCHS,
                            shapes=SHAPES, out=str(out))
    assert "OK" in run_forced(code, 4, timeout=600)
    return json.loads(out.read_text())


SP_CASE = "granite-3-8b train_4k seq_parallel"
CASES = [*(f"{a} {s}" for a in ARCHS for s in SHAPES), SP_CASE]


def _port(arch, shape, seq_parallel=False, mesh=MESH, seq=S):
    return run_one(arch, shape, mesh=mesh, cfg=get_config(arch).reduced(), batch=B, seq=seq,
                   verbose=False, seq_parallel=seq_parallel)


@pytest.fixture(scope="module")
def port_results():
    out = {f"{a} {s}": _port(a, s) for a in ARCHS for s in SHAPES}
    out[SP_CASE] = _port("granite-3-8b", "train_4k", seq_parallel=True)
    return out


def _jax_attention_flops(cfg, shape: str) -> float:
    """``chunked_attention``'s products a device: every (query, key) pair of
    its 1,024-key chunks, q.k and p.v, over the rank's batch and heads; a
    train step runs them forward twice (remat) and its backward's four."""
    chunk = min(1024, S)
    t = -(-S // chunk) * chunk
    layers = sum(spec.kind == "attn" for spec in layer_specs(cfg))
    once = 2.0 * (B // MESH[0]) * (cfg.n_heads // MESH[1]) * S * t * 2 * cfg.head_dim_ * layers
    return once * {"train_4k": 4, "prefill_32k": 1, "decode_32k": 0}[shape]


def _layout_flops(cfg, shape: str) -> float:
    """The port's products less JAX's by the two layout differences: a
    tensor-parallel prefill's head at the last position only (negative),
    and each block's last row product again in a train step's recompute
    (the dense FFN's ``wd``, the shared experts' after an MoE, a Mamba
    block's ``out_proj``), each over the rank's rows and its block of the
    contraction."""
    rows, n_mp, d = B // MESH[0] * S, MESH[1], cfg.d_model
    if shape == "prefill_32k":
        return -2.0 * (B // MESH[0]) * (S - 1) * d * cfg.vocab_padded / n_mp
    if shape != "train_4k":
        return 0.0
    total = 0.0
    for spec in layer_specs(cfg):
        if spec.moe:
            width = cfg.n_shared_experts * cfg.d_ff_expert
        elif spec.kind == "mamba" and not cfg.d_ff:
            width = cfg.d_inner
        else:
            width = cfg.d_ff
        total += 2.0 * rows * (width // n_mp) * d
    return total


def _held_less_jax(cfg, shape: str) -> int:
    """The bytes a rank holds less JAX's argument bytes, by the layout
    differences (module docstring)."""
    n_dp, n_mp = MESH
    specs = layer_specs(cfg)
    off_model = 1 - 1 / n_mp
    norms = 1 + sum(1 if (spec.kind == "mamba" and not cfg.d_ff) else 2 for spec in specs)
    norm_el = norms * cfg.d_model * off_model
    routers = sum(bool(spec.moe) for spec in specs)
    router_el = routers * cfg.d_model * cfg.n_experts / n_dp * off_model
    out = norm_el * (2 if cfg.dtype == "bfloat16" else 4) + router_el * 4
    kind = shape.split("_")[0]
    if kind == "train":
        out += 2 * 4 * (norm_el + router_el)
    if kind == "decode":
        batch = B * 4
        out += sum(spec.kind == "attn" for spec in specs) * S * 4 * off_model - 4
    else:
        batch = sum(math.prod(s) * d.itemsize
                    for s, d in make_batch_specs(cfg, kind, B, S).values())
    return int(out + batch * (1 - 1 / n_dp))


@pytest.mark.parametrize("case", CASES)
def test_argument_bytes_equal_jax(jax_results, port_results, case):
    arch, shape = case.split()[:2]
    mem, want = port_results[case]["memory"], jax_results[case]["argument_bytes"]
    assert mem["argument_bytes"] - _held_less_jax(get_config(arch).reduced(), shape) == want
    assert mem["jax_layout_argument_bytes"] == want
    assert mem["argument_bytes"] + mem["temp_bytes"] == mem["peak_bytes"]


@pytest.mark.parametrize("case", CASES)
def test_product_flops_outside_attention_agree(jax_results, port_results, case):
    arch, shape = case.split()[:2]
    cfg, r = get_config(arch).reduced(), port_results[case]
    port = r["flops_per_device"] - r["attention_flops"] - _layout_flops(cfg, shape)
    want = jax_results[case]["flops"] - _jax_attention_flops(cfg, shape)
    assert abs(port - want) <= FLOPS_REL * want, (case, port, want)
    if shape == "train_4k":  # the recompute the port spends beyond XLA's, measured
        assert r["row_recompute_flops"] >= _layout_flops(cfg, shape)
    jax_attention = _jax_attention_flops(cfg, shape)
    assert r["attention_flops"] <= jax_attention
    assert (r["attention_flops"] > 0) == (jax_attention > 0)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_production_mesh_traces_every_shape(shape):
    """The reduced granite at the production shapes on 16 x 16, rank 0:
    the JAX package's keys, 256 chips, collectives, and its kernels
    launched as the path runs them."""
    cfg = get_config("granite-3-8b").reduced()
    r = run_one("granite-3-8b", shape, cfg=cfg, verbose=False)
    assert JAX_KEYS <= set(r) and r["n_chips"] == 256 and r["mesh"] == {"data": 16, "model": 16}
    assert r["window"] == (8192 if shape == "long_500k" else 0)
    assert r["collective_bytes_per_device"] > 0 and r["fits"]
    assert set(r["link_bytes"]) == {"network"}  # 16 ranks a group: more than a host of 8
    assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0
    launches = {"train_4k": {"flash_attention": 4, "flash_attention_bwd": 2},
                "prefill_32k": {"flash_attention": 2}}.get(shape, {})
    assert r["launches"] == launches
    assert r["bottleneck"] in ("t_compute", "t_memory", "t_collective")


def test_two_pod_mesh_and_seq_parallel_are_recorded():
    """On the two-pod mesh the flag is recorded: not applied to a prefill
    (JAX applies it in training only), applied to a train step."""
    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(), n_layers=1)
    r = run_one("granite-3-8b", "prefill_32k", multi_pod=True, seq_parallel=True, cfg=cfg,
                batch=64, seq=128, verbose=False)
    assert r["n_chips"] == 512 and r["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert r["seq_parallel"] and "not applied" in r["layout"]
    r = run_one("granite-3-8b", "train_4k", multi_pod=True, seq_parallel=True, cfg=cfg,
                batch=64, seq=128, verbose=False)
    assert r["seq_parallel"] and "sequence-parallel" in r["layout"]
    assert "not applied" not in r["layout"] and r["collectives"]["reduce-scatter"] > 0


def test_seq_parallel_lowers_the_peak_and_swaps_the_all_reduces(port_results):
    """granite's train step on (2, 2) under ``seq_parallel`` against the
    port's trace without it: a lower peak (each block's checkpointed input
    is a rank's S/n tokens), the same products and launches, fewer
    all-reduce bytes and more reduce-scatter and all-gather bytes, and the
    recompute runs the stream's gathers and reduce-scatters again."""
    tp, sp = port_results["granite-3-8b train_4k"], port_results[SP_CASE]
    assert "sequence-parallel" in sp["layout"] and "sequence" not in tp["layout"]
    assert sp["memory"]["peak_bytes"] < tp["memory"]["peak_bytes"]
    assert sp["memory"]["argument_bytes"] == tp["memory"]["argument_bytes"]
    assert sp["flops_per_device"] == tp["flops_per_device"] and sp["launches"] == tp["launches"]
    assert sp["collectives"]["all-reduce"] < tp["collectives"]["all-reduce"] / 4
    for kind in ("reduce-scatter", "all-gather"):
        assert sp["collectives"][kind] > tp["collectives"][kind], kind
        assert sp["recompute_collectives"][kind] > tp["recompute_collectives"].get(kind, 0), kind
    assert tp["recompute_collectives"]["all-reduce"] > 0
    assert "all-reduce" not in sp["recompute_collectives"]


_UNCHANGED = {  # case -> (arch, shape, mesh, seq)
    "granite prefill": ("granite-3-8b", "prefill_32k", MESH, S),
    "granite decode": ("granite-3-8b", "decode_32k", MESH, S),
    "whisper train": ("whisper-tiny", "train_4k", MESH, S),
    "granite train on (4, 1)": ("granite-3-8b", "train_4k", (4, 1), S),
    "granite train, S = 255": ("granite-3-8b", "train_4k", MESH, 255),
}
_TIMES = ("lower_s", "compile_s", "seq_parallel", "layout")


@pytest.mark.parametrize("case", _UNCHANGED)
def test_seq_parallel_leaves_other_steps_unchanged(case):
    """Where JAX does not apply the layout (a prefill, a decode, whisper, a
    (d, 1) mesh, a sequence the ``model`` axis does not divide), the flag
    traces the same step: every figure of the result equal."""
    arch, shape, mesh, seq = _UNCHANGED[case]
    off, on = (_port(arch, shape, sp, mesh, seq) for sp in (False, True))
    assert on["seq_parallel"] and "not applied" in on["layout"]
    assert {k: v for k, v in on.items() if k not in _TIMES} == {
        k: v for k, v in off.items() if k not in _TIMES}


def test_cli_fl_shared_writes_its_result(tmp_path, capsys, monkeypatch):
    """``--fl-shared`` through ``main`` (the reduced configs patched in): one
    JSON a combination under ``--out``, the round's Eq. 1 mean one partial
    and one combine launch of each dtype."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a).reduced())
    main(["--arch", "granite-3-8b", "--shape", "train_4k", "--fl-shared", "1", "--mesh", "4,1",
          "--out", str(tmp_path)])
    (path,) = tmp_path.glob("*.json")
    assert path.name == "granite-3-8b_train_4k_mesh4x1_fl1.json"
    r = json.loads(path.read_text())
    assert JAX_KEYS <= set(r) and r["mode"] == "fl_round" and r["n_silos"] == 4
    assert r["local_batch"] == 64 and r["launches"]["masked_aggregate_partial"] == 1
    assert r["collectives"]["all-reduce"] > 0 and set(r["link_bytes"]) == {"nvlink"}
    assert "all 1 combos passed" in capsys.readouterr().out
