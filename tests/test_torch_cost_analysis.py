"""The port's cost counter (``repro_torch.launch.cost_analysis``) and the
kernel wrappers' dry-run branches, on the CPU with no jax.

The counter mirrors ``tests/test_hlo_analysis.py``: one product's flops
exact, a reduced model's layers counted once each (3 layers = 3 x one
layer's products), bytes positive and bounded, no collectives without a
mesh, and the peak of a known allocation sequence exact. Each kernel
wrapper given fake tensors returns what its plain version returns on real
CPU tensors of the same shapes (shape, dtype, device) and reports one
launch to the counter, in every mode, leaving its own launch count (real
launches only) as it was.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.masked_aggregate import ops as ma
from repro_torch.kernels.quantize import ops as qo
from repro_torch.kernels.ssm_scan import ops as ss
from repro_torch.launch.cost_analysis import CostCounter, analyze
from repro_torch.models.api import get_model


def test_one_matmul_flops_exact():
    with FakeTensorMode():
        a, b = torch.empty((64, 128)), torch.empty((128, 32))
        terms, out = analyze(lambda: a @ b)
    assert terms["flops"] == 2 * 64 * 128 * 32
    assert tuple(out.shape) == (64, 32)
    assert terms["launches"] == {} and terms["kernel_flops"] == {}


def _prefill_flops(n_layers: int) -> float:
    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(), n_layers=n_layers)
    bundle = get_model(cfg)
    with FakeTensorMode():
        model = bundle.init(torch.Generator())
        tokens = torch.zeros((2, 64), dtype=torch.int32)
        step = bundle.make_prefill_step()
        terms, _ = analyze(lambda: step(model, {"tokens": tokens}))
    return terms["flops"] - sum(terms["kernel_flops"].values()), cfg


def test_layers_counted_once_each():
    """A 3-layer reduced granite's products are the head's plus 3 times one
    layer's: q, k, v, o and the SwiGLU's three, 2*M*N*K each."""
    f1, cfg = _prefill_flops(1)
    f3, _ = _prefill_flops(3)
    t, d = 2 * 64, cfg.d_model
    q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    layer = 2 * t * d * (2 * q + 2 * kv) + 3 * 2 * t * d * cfg.d_ff
    head = 2 * t * d * cfg.vocab_padded
    assert f1 == head + layer
    assert f3 == head + 3 * layer


def test_bytes_positive_and_bounded():
    n = 256
    with FakeTensorMode():
        x = torch.empty((n, n))
        terms, _ = analyze(lambda: torch.relu(x @ x) @ x)
    assert 3 * n * n * 4 <= terms["bytes"] <= 100 * n * n * 4


def test_no_collectives_without_a_mesh():
    cfg = get_config("granite-3-8b").reduced()
    bundle = get_model(cfg)
    from repro_torch.models.api import param_tree
    from repro_torch.optim import adamw

    with FakeTensorMode():
        model = bundle.init(torch.Generator())
        opt = adamw(3e-4)
        state = opt.init(param_tree(model))
        batch = {k: torch.zeros((2, 32), dtype=torch.int32) for k in ("tokens", "labels")}
        step = bundle.make_train_step(opt)
        terms, _ = analyze(lambda: step(model, state, batch), held=list(model.parameters()))
    assert terms["collective_bytes"] == 0 and terms["collectives"] == {}
    # remat: an attention layer's forward kernel twice, its backward once
    assert terms["launches"] == {"flash_attention": 2 * cfg.n_layers,
                                 "flash_attention_bwd": cfg.n_layers}


def test_known_allocation_sequence_peak_exact():
    """Arguments of 1,000 B live from the start; 4,000 B and 2,000 B made,
    the first freed, then 3,000 B: the peak is 7,000 B, the result's 3,000
    B its output."""
    with FakeTensorMode():
        arg = torch.empty((250,))

        def step():
            a = torch.empty((1000,))
            b = torch.empty((500,))
            a.add_(1.0)
            del a
            c = torch.empty((750,))
            b.add_(1.0)
            return c

        terms, _ = analyze(step, held=arg)
    assert terms["argument_bytes"] == 1000
    assert terms["peak_bytes"] == 1000 + 4000 + 2000
    assert terms["output_bytes"] == 3000


# ---------------------------------------------------------------------------
# the kernels' fake branches against their plain versions
# ---------------------------------------------------------------------------


def _cases():
    """(name, counter, a function of a tensor factory that calls the
    wrapper) for every mode; the factory makes real CPU tensors or fake
    ones."""
    def attention(dtype, lse, pos=False, dims=(64, 64), t_len=None):
        def run(make):
            s, t = 48, t_len or 48
            q = make((2, s, 4, dims[0]), dtype)
            k, v = make((2, t, 2, dims[0]), dtype), make((2, t, 2, dims[1]), dtype)
            kw = {}
            if pos:
                kw = {"q_pos": make((s,), torch.int32, arange=True),
                      "k_pos": make((t,), torch.int32, arange=True)}
            if lse:
                return fa._attention(q, k, v, True, 16, True, **kw)
            return fa.flash_attention(q, k, v, causal=t_len is None, **kw)
        return run

    def attention_bwd(dtype, pos=False):
        def run(make):
            q, k, v = make((1, 40, 4, 64), dtype), make((1, 40, 2, 64), dtype), \
                make((1, 40, 2, 64), dtype)
            out, lse = make((1, 40, 4, 64), dtype), make((1, 4, 40), torch.float32)
            kw = ({"q_pos": make((40,), torch.int32, arange=True),
                   "k_pos": make((40,), torch.int32, arange=True)} if pos else {})
            return fa.flash_attention_bwd(q, k, v, out, lse, make((1, 40, 4, 64), dtype), **kw)
        return run

    def scan(dtype, chunk_states, h0):
        def run(make):
            x = make((2, 150, 32), dtype)
            a, d = make((32, 8), torch.float32, neg=True), make((32,), torch.float32)
            bm = make((2, 150, 8), dtype)
            start = make((2, 32, 8), torch.float32) if h0 else None
            return ss.ssm_scan(x, a, bm, bm, x, d, chunk_states=chunk_states, h0=start)
        return run

    def scan_bwd(dtype, gh):
        def run(make):
            x = make((2, 150, 32), dtype)
            a, d = make((32, 8), torch.float32, neg=True), make((32,), torch.float32)
            bm = make((2, 150, 8), dtype)
            hs = make((2, 2, 32, 8), torch.float32)
            return ss.ssm_scan_bwd(x, a, bm, bm, x, d, hs, make((2, 150, 32), torch.float32),
                                   make((2, 32, 8), torch.float32) if gh else None)
        return run

    def quantize(bits, noise):
        def run(make):
            xs = [make((3, 1000), torch.float32), make((700,), torch.float32)]
            us = [make(tuple(x.shape), torch.float32, uniform=True) for x in xs] if noise else None
            return qo.quantize_leaves(xs, us, bits=bits)
        return run

    def dequantize(make):
        return qo.dequantize_leaves([
            (make((3, 1000), torch.int8), make((3, 2), torch.float32)),
            (make((700,), torch.int8), make((2,), torch.float32))])

    def aggregate(kind):
        def run(make):
            xs = [make((4, 10, 3), torch.float32), make((4, 7), torch.float32)]
            w = make((2, 4), torch.float32, uniform=True)
            if kind == "fallback":
                return ma.masked_aggregate_leaves(xs, w, rows=[0, 1],
                                                  fallbacks=[None, make((7,), torch.float32)])
            if kind == "snapshot":
                return ma.masked_aggregate_leaves(xs, w, snapshots=[make(tuple(x.shape),
                                                                         torch.float32)
                                                                    for x in xs])
            if kind == "base":
                return ma.masked_aggregate_leaves(xs, w, bases=[make((10, 3), torch.float32),
                                                                make((7,), torch.float32)])
            if kind == "one":
                return ma.masked_aggregate(make((4, 9), torch.bfloat16),
                                           make((4,), torch.float32, uniform=True))
            if kind == "partial":
                return ma.masked_aggregate_partial(xs, w, rows=[0, 1], slot=1, n_slots=3)
            buf = make((2, ma.partial_layout([30, 7], 2)[2]), torch.float32)
            return ma.masked_aggregate_combine(buf, [(10, 3), (7,)], rows=[0, 1],
                                               dtype=torch.bfloat16)
        return run

    bf, f32 = torch.bfloat16, torch.float32
    out = []
    for dt in (bf, f32):
        n = str(dt)[6:]
        out += [(f"flash_attention {n}", fa.flash_attention, attention(dt, False)),
                (f"flash_attention {n} lse", fa.flash_attention, attention(dt, True)),
                (f"flash_attention {n} positions", fa.flash_attention, attention(dt, False, True)),
                (f"flash_attention {n} non-causal T!=S", fa.flash_attention,
                 attention(dt, False, t_len=30)),
                (f"flash_attention_bwd {n}", fa.flash_attention_bwd, attention_bwd(dt)),
                (f"flash_attention_bwd {n} positions", fa.flash_attention_bwd,
                 attention_bwd(dt, True))]
        out += [(f"ssm_scan {n} chunks={c} h0={h}", ss.ssm_scan, scan(dt, c, h))
                for c in (False, True) for h in (False, True)]
        out += [(f"ssm_scan_bwd {n} gh={g}", ss.ssm_scan_bwd, scan_bwd(dt, g))
                for g in (False, True)]
    out += [("flash_attention (192, 128)", fa.flash_attention,
             attention(bf, False, dims=(192, 128)))]
    out += [(f"quantize int{b} noise={u}", qo.quantize_leaves, quantize(b, u))
            for b in (8, 4) for u in (False, True)]
    out += [("dequantize", qo.dequantize_leaves, dequantize)]
    out += [(f"masked_aggregate {k}", ma.masked_aggregate_leaves, aggregate(k))
            for k in ("fallback", "snapshot", "base", "one")]
    out += [("masked_aggregate partial", ma.masked_aggregate_partial, aggregate("partial")),
            ("masked_aggregate combine", ma.masked_aggregate_combine, aggregate("combine"))]
    return out


CASES = _cases()


def _real(shape, dtype, arange=False, neg=False, uniform=False):
    g = torch.Generator().manual_seed(sum(shape) + len(shape))
    if arange:
        return torch.arange(shape[0], dtype=dtype)
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    t = torch.rand(shape, generator=g) if uniform else torch.randn(shape, generator=g)
    return (-t.abs() if neg else t).to(dtype)


def _leaves(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)] if isinstance(out, (list, tuple)) else []


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_fake_branch_outputs_match_the_plain_version(name):
    """The wrapper on fake tensors returns the plain version's outputs'
    shapes, dtypes and device and reports one launch to the counter; its
    own launch count, which counts only real launches, does not move."""
    _, fn, run = next(c for c in CASES if c[0] == name)
    want = _leaves(run(_real))
    before = fn.launches
    with FakeTensorMode() as mode:
        with CostCounter() as counter:
            got = _leaves(run(lambda shape, dtype, **_: torch.empty(shape, dtype=dtype)))
        assert all(mode.is_our_fake(t) for t in got)
    assert fn.launches == before
    assert sum(counter.launches.values()) == 1, dict(counter.launches)
    assert [(tuple(t.shape), t.dtype, t.device) for t in got] == \
        [(tuple(t.shape), t.dtype, t.device) for t in want]


def test_prefill_conv_cache_keeps_no_activation_alive():
    """A Mamba prefill's conv cache (B, d_conv - 1, d_inner) holds a storage
    of its own size: as a view it kept the layer's whole (B, S + 3, d_inner)
    conv input alive, one a layer until the prefill ended (the dry run's
    finding at falcon-mamba-7b's 32,768 tokens: 57.8 GiB against 25.8)."""
    cfg = get_config("falcon-mamba-7b").reduced()
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 40), dtype=torch.int32)
    _, cache = bundle.make_prefill_step()(model, {"tokens": tokens})
    for layer in cache["layers"]:
        conv = layer["conv"]
        assert conv.untyped_storage().nbytes() == conv.numel() * conv.element_size()
