"""Cross-silo FL of LMs in the port (``repro_torch.fl.cross_silo``,
``examples/cross_silo_llm_torch.py``) against the JAX package's
``fl/cross_silo.py`` and ``examples/cross_silo_llm.py`` on the CPU, on the
same numpy-seeded inputs; JAX's stacked silo trees are carried in and out
by ``weights.silo_params_from_numpy``.

Contracts:

- the silo mean (``_agg_over_silo``, ``partial_aggregate_silo_params``):
  fp32 and int8/int4 bitwise JAX's, the int formats against JAX's float32
  mean rounded to the leaf's dtype (the port keeps every parameter's
  dtype; JAX returns float32 there, ROADMAP.md queue 3); bf16 bitwise
  (measured 0 ulp: XLA rounds the bf16 reduce after every add on the CPU,
  and so does the port); all-zero weights give +0 in both (JAX's sum
  starts from +0 and divides by 1e-9; the kernel writes its zero
  fallback), bitwise too.
  The cut on six reduced configs that cover every kind of it (no prologue,
  a prologue, ``vision_proj``, a period of 8, a Mamba stack, whisper's
  encoder), at shared_periods 0, 1 and past the stack.
- the int blocks of a stack entry run across the period boundary as JAX's
  do (tiny-llm: d_model 64, so every norm of 2 periods is one 128-element
  block), bitwise; quantizing each layer on its own would not be.
- error feedback over 3 periods, deterministic and stochastic rounding
  (the keys in JAX's leaf order): parameters and residuals bitwise.
- three rounds of ``make_fl_round_step`` / ``make_quantized_fl_round_step``
  against the jitted JAX rounds (plain AdamW at lr 3e-4), float32 configs:
  losses within ``F32_REL`` (measured 1.5e-7 relative); every parameter
  within one lr, and at most ``SCAN_SHARE`` of them beyond ``STEP_ABS``
  (``tests/_torch_train.py``'s rule behind a scan, here for every arch:
  without the CLI's clip and warm-up the first AdamW steps move an element
  by ``lr * g / (|g| + eps)``, so where a gradient element cancels to near
  zero in one step a rounding-level difference moves it by a fraction of
  lr, while its RMS gradient over the three steps is not near zero and
  the near-zero rule does not name it; measured: 6 of 542,400 on tiny-llm,
  at 1.5-22% of their leaf's RMS maximum, within 0.058 lr; 54-105 of 3.3 M
  on falcon-mamba). A shared leaf of an int wire may also be one
  quantization step (``max|leaf| / 127``) apart where a silo's rounding
  flipped (measured: up to 0.66 of one on falcon-mamba, none on
  tiny-llm). The int plain modes run on float32 configs only: in bf16 JAX
  promotes the shared leaves to float32 after round 1 and trains another
  model. bf16 (tiny-llm, fp32 and EF wires):
  losses within ``BF16_REL`` (measured 1.5e-5 relative); every element
  within three learning rates plus one bf16 ulp of the leaf's largest
  value (what three AdamW steps and a rounding can move it; measured at
  most 0.84 of that), and each leaf's mean difference from JAX at most a
  tenth of JAX's mean movement from the start (measured at most 0.052;
  a port that skipped its update would be at 1, and a leaf that JAX's
  rounds leave unmoved, as bf16 norms, must stay so).
- ``tests/test_cross_silo.py``'s eight cases, on the port.
- the example's batches bitwise JAX's; its ledger line JAX's numbers.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with
import jax.numpy as jnp  # noqa: E402

from _torch_train import BF16_REL, F32_REL, LR, SCAN_SHARE, STEP_ABS  # noqa: E402
from _torch_train import one_torch_thread  # noqa: E402,F401
from repro import optim as jax_optim  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.fl import cross_silo as J  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.fl import cross_silo as T  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.transformer import layer_plan  # noqa: E402
from repro_torch.weights import silo_params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="tiny-llm", family="dense", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=256, head_dim=16)
N_SILOS = 3
WEIGHTS = [1.0, 2.0, 1.0]
REDUCED = ["tiny-llm", "deepseek-moe-16b", "qwen2-vl-2b", "jamba-v0.1-52b", "falcon-mamba-7b",
           "whisper-tiny"]


def cfgs(arch: str, dtype: str | None = None):
    """(the JAX config, the port's config), equal field for field."""
    if arch == "tiny-llm":
        jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    else:
        jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if dtype:
        jcfg, cfg = dataclasses.replace(jcfg, dtype=dtype), dataclasses.replace(cfg, dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bit patterns (float32 or bf16) as integers."""
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)).numpy()


def random_silos(jcfg, seed: int, n_silos: int = N_SILOS):
    """A JAX stacked silo tree of ``jcfg``'s shapes and dtypes, every silo's
    values its own (numpy normals), with no JAX init compiled."""
    shapes = jax.eval_shape(jax_get_model(jcfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(
        (n_silos,) + s.shape).astype(np.float32) * 0.05).astype(s.dtype), shapes)


def carried(cfg, tree) -> dict:
    """A JAX stacked silo tree as the port's (S, ...) tensors by name."""
    return silo_params_from_numpy(cfg, jax.device_get(tree), device="cpu").params


def assert_bitwise_in_leaf_dtype(got: dict, want: dict):
    """Every name's tensor bitwise JAX's, JAX's cast to the port's dtype
    first (JAX's int wire returns float32 where the port keeps the leaf's
    dtype)."""
    assert list(got) == list(want)
    for name, g in got.items():
        w = want[name].to(g.dtype)
        assert g.shape == w.shape, name
        assert (_bits(g) == _bits(w)).all(), name


# ---------------------------------------------------------------------------
# the silo mean
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", [[1.0, 2.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                         ids=["121", "100", "000"])
@pytest.mark.parametrize("agg", ["fp32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["float32", "bfloat16"])
def test_agg_over_silo_matches_jax(dtype, agg, weights):
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((N_SILOS, 5, 700)).astype(np.float32)).astype(dtype)
    want = J._agg_over_silo(x, jnp.asarray(weights, jnp.float32), agg)
    got = T._agg_over_silo(_t(x), torch.tensor(weights), agg)
    assert got.shape == tuple(x.shape) and got.dtype == _t(x).dtype
    assert (_bits(got) == _bits(_t(want).to(got.dtype))).all()
    if not sum(weights):  # JAX's 0 / 1e-9 and the kernel's zero fallback: +0 both
        assert not _bits(got).any()


def test_agg_mode_is_the_env_lever(monkeypatch):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 40)).astype(np.float32))
    w = torch.tensor(WEIGHTS)
    monkeypatch.delenv("REPRO_FL_AGG_DTYPE", raising=False)
    assert T._agg_mode() == "fp32"
    monkeypatch.setenv("REPRO_FL_AGG_DTYPE", "int8")
    assert torch.equal(T._agg_over_silo(x, w), T._agg_over_silo(x, w, "int8"))
    assert not torch.equal(T._agg_over_silo(x, w), T._agg_over_silo(x, w, "fp32"))


def _n_periods(cfg) -> int:
    return 0 if cfg.encoder_decoder else layer_plan(cfg)[2]


@pytest.mark.parametrize("arch", REDUCED)
def test_partial_aggregate_fp32_matches_jax_on_every_cut(arch):
    """The fp32 silo mean bitwise JAX's on every reduced kind of cut, at
    shared_periods 0, 1 and past the stack; the shared names equal across
    silos, the others untouched."""
    jcfg, cfg = cfgs(arch)
    silo = random_silos(jcfg, seed=3)
    w = jnp.asarray(WEIGHTS)
    for sp in (0, 1, _n_periods(cfg) + 1):
        want = carried(cfg, J.partial_aggregate_silo_params(silo, w, sp, "fp32"))
        port = silo_params_from_numpy(cfg, jax.device_get(silo), device="cpu")
        before = {n: p.clone() for n, p in port.params.items()}
        T.partial_aggregate_silo_params(port, torch.tensor(WEIGHTS), sp, "fp32")
        assert_bitwise_in_leaf_dtype(port.params, want)
        shared = {n for g in T.shared_groups(cfg, port.params, sp) for n in g}
        for n, p in port.params.items():
            if n in shared:
                assert all(torch.equal(p[s], p[0]) for s in range(1, N_SILOS)), n
            else:
                assert torch.equal(p, before[n]), n
        if cfg.encoder_decoder:  # embed + every encoder leaf; enc_pos, enc_norm stay per silo
            assert shared == {"embed"} | {n for n in port.params if n.startswith("encoder.")}
        else:
            n_pro, p, n_periods = layer_plan(cfg)
            layers = set(range(n_pro + p * min(sp, n_periods)))
            assert shared == ({"embed", "vision_proj"} & set(port.params)) | {
                n for n in port.params
                if n.startswith("blocks.") and int(n.split(".")[1]) in layers}


@pytest.mark.parametrize("agg", ["int8", "int4"])
def test_int_wire_blocks_run_across_the_period_boundary(agg):
    """tiny-llm's int wire bitwise JAX's (cast to bf16, the leaf dtype) at
    every cut; JAX quantizes a stack entry's (S, sp, ...) slice as one row a
    silo, so its 128-element norm blocks span two layers here. A control
    quantizing each layer alone misses JAX's bits."""
    jcfg, cfg = cfgs("tiny-llm")
    silo = random_silos(jcfg, seed=5)
    w = jnp.asarray(WEIGHTS)
    for sp in (0, 1, 2, 5):
        want = carried(cfg, J.partial_aggregate_silo_params(silo, w, sp, agg))
        port = silo_params_from_numpy(cfg, jax.device_get(silo), device="cpu")
        T.partial_aggregate_silo_params(port, torch.tensor(WEIGHTS), sp, agg)
        assert all(p.dtype == torch.bfloat16 for p in port.params.values())
        assert_bitwise_in_leaf_dtype(port.params, want)
        if sp == 2:
            base = silo_params_from_numpy(cfg, jax.device_get(silo), device="cpu").params
            per_layer = T._int_means([base["blocks.0.norm1"].reshape(N_SILOS, -1)],
                                     torch.tensor(WEIGHTS), int(agg[3:]))[0]
            assert not torch.equal(per_layer.to(torch.bfloat16), want["blocks.0.norm1"][0].to(
                torch.bfloat16))


def test_int_wire_returns_float32_in_jax_and_the_leaf_dtype_in_the_port():
    """The reference behaviour of ROADMAP.md queue 3: on tiny-llm (bf16, 3
    silos, weights [1, 2, 1]) JAX's int8/int4 wire returns float32 for
    ``embed`` and every stack leaf (personal periods too, by
    ``concatenate``'s promotion), while ``final_norm`` and ``head`` stay
    bf16 and the fp32, bf16 and EF wires keep bf16; the port keeps every
    leaf's dtype."""
    jcfg, cfg = cfgs("tiny-llm")
    silo = random_silos(jcfg, seed=9)
    w = jnp.asarray(WEIGHTS)
    for agg in ("int8", "int4"):
        out = J.partial_aggregate_silo_params(silo, w, 2, agg)
        assert out["embed"].dtype == jnp.float32
        assert all(leaf.dtype == jnp.float32 for leaf in jax.tree.leaves(out["stack"]))
        assert out["final_norm"].dtype == out["head"].dtype == jnp.bfloat16
        port = silo_params_from_numpy(cfg, jax.device_get(silo), device="cpu")
        T.partial_aggregate_silo_params(port, torch.tensor(WEIGHTS), 2, agg)
        assert {p.dtype for p in port.params.values()} == {torch.bfloat16}
    for agg in ("fp32", "bf16"):
        out = J.partial_aggregate_silo_params(silo, w, 2, agg)
        assert {leaf.dtype for leaf in jax.tree.leaves(out)} == {jnp.dtype(jnp.bfloat16)}
    out, _ = J.partial_aggregate_silo_params_ef(silo, J.init_ef_residual(silo), w, 2)
    assert {leaf.dtype for leaf in jax.tree.leaves(out)} == {jnp.dtype(jnp.bfloat16)}


@pytest.mark.parametrize("stochastic", [False, True], ids=["nearest", "stochastic"])
@pytest.mark.parametrize("arch", ["tiny-llm", "deepseek-moe-16b", "qwen2-vl-2b", "whisper-tiny"])
def test_ef_aggregate_over_three_periods_bitwise(arch, stochastic):
    """Three periods of ``partial_aggregate_silo_params_ef``, the residual
    carried and the parameters moved between periods: parameters and
    residuals bitwise JAX's, the keys folded in JAX's leaf order (embed,
    vision_proj, the prologue or whisper's encoder, then the stack
    entries)."""
    jcfg, cfg = cfgs(arch)
    jsilo = random_silos(jcfg, seed=11)
    port = silo_params_from_numpy(cfg, jax.device_get(jsilo), device="cpu")
    jres, tres = J.init_ef_residual(jsilo), T.init_ef_residual(port)
    w = jnp.asarray(WEIGHTS)
    for period in range(3):
        if period:  # a local step's worth of movement, the same in both
            step = random_silos(jcfg, seed=100 + period)
            jsilo = jax.tree.map(lambda a, d: (a + d * 0.1).astype(a.dtype), jsilo, step)
            for n, p in carried(cfg, jsilo).items():
                port.params[n].copy_(p)
        key = jax.random.fold_in(jax.random.PRNGKey(4), period)
        jsilo, jres = J.partial_aggregate_silo_params_ef(jsilo, jres, w, 2, bits=8, rng=key,
                                                         stochastic=stochastic)
        port, tres = T.partial_aggregate_silo_params_ef(
            port, tres, torch.tensor(WEIGHTS), 2, bits=8,
            rng=prng.fold_in(prng.PRNGKey(4), period), stochastic=stochastic)
        assert_bitwise_in_leaf_dtype(port.params, carried(cfg, jsilo))
        assert_bitwise_in_leaf_dtype(tres, carried(cfg, jres))


# ---------------------------------------------------------------------------
# three rounds against the jitted JAX rounds
# ---------------------------------------------------------------------------


def _rounds(arch: str, dtype: str, wire: str, rounds: int = 3, shared: int = 2):
    """``rounds`` rounds of JAX's jitted round step and the port's from the
    same weights on the same batches: (the config, the losses as (JAX,
    port) pairs, the port's parameters, JAX's carried by name, the shared
    names, the starting weights carried by name)."""
    jcfg, cfg = cfgs(arch, dtype)
    jb, tb = jax_get_model(jcfg), get_model(cfg)
    base = jb.init(jax.random.PRNGKey(0))
    jsilo = jax.tree.map(lambda l: jnp.broadcast_to(l, (N_SILOS,) + l.shape).copy(), base)
    jopt, topt = jax_optim.adamw(LR), optim.adamw(LR)
    jstate = jax.vmap(jopt.init)(jsilo)
    port = silo_params_from_numpy(cfg, jax.device_get(jsilo), device="cpu")
    start = {n: p.clone() for n, p in port.params.items()}
    tstate = T.init_silo_opt(topt, port)
    w, tw = jnp.asarray(WEIGHTS), torch.tensor(WEIGHTS)
    ef = wire == "int8+ef"
    if ef:
        jstep = jax.jit(J.make_quantized_fl_round_step(jcfg, jb, jopt, shared, bits=8,
                                                       error_feedback=True))
        tstep = T.make_quantized_fl_round_step(cfg, tb, topt, shared, bits=8, error_feedback=True)
        jres, tres = J.init_ef_residual(jsilo), T.init_ef_residual(port)
    else:
        jstep = jax.jit(J.make_fl_round_step(jcfg, jb, jopt, shared, agg=wire))
        tstep = T.make_fl_round_step(cfg, tb, topt, shared, agg=wire)
    rng = jax.random.PRNGKey(1)
    losses = []
    for _ in range(rounds):
        rng, sub = jax.random.split(rng)
        toks = jax.random.randint(sub, (N_SILOS, 2, 33), 0, cfg.vocab_size)
        batch = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
        tbatch = {k: _t(v) for k, v in batch.items()}
        if ef:
            jsilo, jstate, jres, jloss = jstep(jsilo, jstate, jres, batch, w)
            port, tstate, tres, tloss = tstep(port, tstate, tres, tbatch, tw)
        else:
            jsilo, jstate, jloss = jstep(jsilo, jstate, batch, w)
            port, tstate, tloss = tstep(port, tstate, tbatch, tw)
        assert tloss.shape == () and tloss.dtype == torch.float32 and not tloss.requires_grad
        losses.append((float(jloss), float(tloss)))
    shared_names = {n for g in T.shared_groups(cfg, port.params, shared) for n in g}
    return cfg, losses, port.params, carried(cfg, jsilo), shared_names, start


ROUND_CASES = [("tiny-llm", "float32", w) for w in ("fp32", "int8", "int8+ef")] + [
    ("falcon-mamba-7b", "float32", w) for w in ("fp32", "int8", "int8+ef")]


@pytest.mark.parametrize("arch,dtype,wire", ROUND_CASES)
def test_three_rounds_match_jax_float32(arch, dtype, wire):
    cfg, losses, got, want, shared, _ = _rounds(arch, dtype, wire)
    for jl, tl in losses:
        assert abs(tl - jl) <= F32_REL * abs(jl), losses
    n_over = n_total = 0
    for name, p in got.items():
        d = (p.double() - want[name].double()).abs()
        step = float(want[name].abs().max()) / 127 if wire != "fp32" and name in shared else 0.0
        assert float(d.max()) <= LR + step, (name, float(d.max()))
        n_over += int((d > STEP_ABS).sum())
        n_total += d.numel()
    assert n_over <= SCAN_SHARE * n_total, (n_over, n_total)


@pytest.mark.parametrize("wire", ["fp32", "int8+ef"])
def test_three_rounds_match_jax_bf16(wire):
    cfg, losses, got, want, _, start = _rounds("tiny-llm", "bfloat16", wire)
    for jl, tl in losses:
        assert abs(tl - jl) <= BF16_REL * abs(jl), losses
    for name, p in got.items():
        assert p.dtype == torch.bfloat16, name
        top = float(want[name].float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0
        d = (p.double() - want[name].double()).abs()
        assert float(d.max()) <= 3 * LR + ulp, (name, float(d.max()))
        moved = float((want[name].double() - start[name].double()).abs().mean())
        assert float(d.mean()) <= 0.1 * moved, (name, float(d.mean()), moved)


# ---------------------------------------------------------------------------
# tests/test_cross_silo.py's eight cases, on the port
# ---------------------------------------------------------------------------


def _tiny_silo(n_silos: int = N_SILOS):
    _, cfg = cfgs("tiny-llm")
    bundle = get_model(cfg)
    base = bundle.init(torch.Generator().manual_seed(0))
    return cfg, bundle, T.silo_params_from_model(base, n_silos)


def _tiny_batch(seed: int = 1):
    toks = prng.randint(prng.PRNGKey(seed), (N_SILOS, 2, 33), 0, 256)
    return {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}


@pytest.fixture(scope="module")
def round_out():
    cfg, bundle, silo = _tiny_silo()
    before = {n: p.clone() for n, p in silo.params.items()}
    opt = optim.adamw(1e-2)
    step = T.make_fl_round_step(cfg, bundle, opt, shared_periods=2)
    silo, _, loss = step(silo, T.init_silo_opt(opt, silo), _tiny_batch(), torch.tensor(WEIGHTS))
    return before, silo, float(loss)


def test_loss_finite(round_out):
    assert np.isfinite(round_out[2])


def test_shared_periods_identical_across_silos(round_out):
    _, silo, _ = round_out
    for n, p in silo.params.items():
        if n.startswith(("blocks.0.", "blocks.1.")):  # periods 0-1 shared
            for i in range(1, N_SILOS):
                assert torch.equal(p[i], p[0]), n


def test_personal_periods_diverge(round_out):
    _, silo, _ = round_out
    assert any(not torch.equal(p[0], p[1]) for n, p in silo.params.items()
               if n.startswith(("blocks.2.", "blocks.3.")))


def test_embed_always_shared(round_out):
    before, silo, _ = round_out
    emb = silo.params["embed"]
    assert not torch.equal(emb, before["embed"])
    for i in range(1, N_SILOS):
        assert torch.equal(emb[i], emb[0])


def test_head_personalized(round_out):
    _, silo, _ = round_out
    assert not torch.equal(silo.params["head"][0], silo.params["head"][1])


def test_silo_models_are_views_of_the_stacked_params(round_out):
    _, silo, _ = round_out
    for s, model in enumerate(silo.models):
        for n, p in model.named_parameters():
            assert p.data_ptr() == silo.params[n][s].data_ptr(), n


def test_ef_aggregate_shared_identical_and_residual_scoped():
    cfg, _, silo = _tiny_silo()
    silo, res = T.partial_aggregate_silo_params_ef(silo, T.init_ef_residual(silo),
                                                   torch.tensor(WEIGHTS), shared_periods=2)
    emb = silo.params["embed"]
    for i in range(1, N_SILOS):
        assert torch.equal(emb[i], emb[0])
    # residual lives on the shared prefix, never on the personalized head
    assert float(res["embed"].abs().max()) > 0.0
    assert float(res["head"].abs().max()) == 0.0
    shared = {n for g in T.shared_groups(cfg, silo.params, 2) for n in g}
    assert all(not res[n].any() for n in res if n not in shared)


def test_ef_residual_cancels_quantization_bias_across_periods():
    """Across many periods the EF-quantized running average converges to
    the fp32 mean while plain quantization keeps its per-period bias."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 8, 33)).astype(np.float32)
                         * 0.1)
    w = torch.ones((4,))
    ref = T._agg_over_silo(x, w, agg="fp32")[0]
    phase = T._quantize_phase(8)
    e = torch.zeros_like(x)
    acc_ef = torch.zeros_like(ref)
    periods = 40
    for t in range(periods):
        (dec,), (e,) = phase.silo_transmit([x], [e], [prng.fold_in(prng.PRNGKey(0), t)])
        acc_ef += T._agg_over_silo(dec, w, agg="fp32")[0]
    err_ef = float((acc_ef / periods - ref).abs().max())
    err_plain = float((T._agg_over_silo(x, w, agg="int8")[0] - ref).abs().max())
    assert err_ef < 0.2 * err_plain
    # residual stays bounded by one quantization step per element
    step = float(x.abs().max()) / 127.0
    assert float(e.abs().max()) <= 2 * step


def test_ef_quantized_round_step_runs():
    cfg, bundle, silo = _tiny_silo()
    opt = optim.adamw(1e-2)
    step = T.make_quantized_fl_round_step(cfg, bundle, opt, shared_periods=2, bits=8,
                                          error_feedback=True)
    silo, _, new_res, loss = step(silo, T.init_silo_opt(opt, silo), T.init_ef_residual(silo),
                                  _tiny_batch(), torch.tensor(WEIGHTS))
    assert np.isfinite(float(loss))
    emb = silo.params["embed"]
    for i in range(1, N_SILOS):
        assert torch.equal(emb[i], emb[0])
    assert list(new_res) == list(silo.params)
    assert all(new_res[n].shape == p.shape and new_res[n].dtype == p.dtype
               for n, p in silo.params.items())


def test_zero_weight_silo_excluded():
    cfg, _, one = _tiny_silo(1)
    silo = T.SiloParams(cfg, {n: torch.cat([p, p * 0 + 5.0]) for n, p in one.params.items()})
    T.partial_aggregate_silo_params(silo, torch.tensor([1.0, 0.0]), shared_periods=cfg.n_layers)
    # silo 1 has weight 0 -> shared layers equal silo 0's values everywhere
    for n, p in silo.params.items():
        if n.startswith("blocks."):
            assert torch.equal(p[1], p[0]), n


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name.replace("/", "_"), ROOT / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("small", [True, False], ids=["small", "100m"])
def test_example_silo_batches_bitwise_jax(small, step):
    jex, tex = _load("examples/cross_silo_llm.py"), _load("examples/cross_silo_llm_torch.py")
    vocab = jex.make_cfg(small).vocab_padded
    assert dataclasses.asdict(jex.make_cfg(small)) == dataclasses.asdict(tex.make_cfg(small))
    want = jex.silo_batches(jax.random.PRNGKey(0), 4, 2, 128, vocab, step)
    got = tex.silo_batches(prng.PRNGKey(0), 4, 2, 128, vocab, step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_example_main_runs_two_rounds_with_jax_ledger(capsys):
    """The port's example at ``--small`` for 2 rounds on the CPU: finite,
    falling losses, and the ledger lines the JAX example prints for the
    same flags (its counts from the JAX model's shapes)."""
    jex, tex = _load("examples/cross_silo_llm.py"), _load("examples/cross_silo_llm_torch.py")
    losses = tex.main(["--small", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(losses) == 2 and np.isfinite(losses).all()
    cfg = jex.make_cfg(True)
    base = jax.eval_shape(jax_get_model(cfg).init, jax.random.PRNGKey(0))
    n_params = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(base))
    per_period = sum(sum(int(np.prod(leaf.shape[1:])) for leaf in jax.tree.leaves(tree))
                     for tree in base["stack"])
    n_periods = jax.tree.leaves(base["stack"][0])[0].shape[0]
    shared = cfg.n_layers // 2
    shared_params = int(np.prod(base["embed"].shape)) + min(shared, n_periods) * per_period
    assert out[0] == (f"model {cfg.name}: {n_params/1e6:.1f}M params, 4 silos, sharing "
                      f"{shared}/{cfg.n_layers} layer periods")
    assert out[1] == (f"aggregated/round: {shared_params/1e6:.1f}M of {n_params/1e6:.1f}M params "
                      f"({shared_params/n_params:.0%}) -> comm reduction "
                      f"{1-shared_params/n_params:.0%} vs full FedAvg")
    small = tex.make_cfg(True)
    model = get_model(small).init(torch.Generator().manual_seed(0))
    assert tex.comm_ledger(small, model, shared) == (shared_params, n_params)
