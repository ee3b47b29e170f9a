"""The gradients of the port's two training kernels on the CPU, against the
JAX package's, on the same numpy inputs.

- flash_attention: ``flash_attention_backward_plain`` (what
  ``flash_attention_bwd`` runs on CPU tensors) against ``jax.vjp`` of the
  JAX model's ``chunked_attention``, causal, windowed, non-causal at T != S,
  G in {1, 2, 4} and MLA's reduced (48, 32), in float32: dQ, dK, dV within
  1e-5 of their max. The lse it takes comes from ``flash_attention_plain``
  (``return_lse``), itself checked against the rows' logsumexp in float64;
  ``FlashAttentionFn`` (autograd) gives the plain backward's gradients and
  the forward's output exactly. With position vectors (M-RoPE's t stream:
  an image's tokens sharing one position, ties and jumps, T != S with the
  empty slots' -1, causal, windowed and non-causal) the plain forward and
  backward against ``chunked_attention`` over those positions and its
  ``jax.vjp``, within 1e-5 of max in float32; positions ``arange`` give the
  index mask's bits, forward and backward, in float32 and bf16.
- ssm_scan: the port's ``models.ssm_vjp.selective_scan`` (the scan with its
  chunk start states, then ``ssm_scan_bwd``; plain versions here) against
  ``jax.vjp`` of the JAX package's ``models.ssm_vjp.selective_scan`` at S =
  100, 128 and 300 (under, at and over one 128-step chunk, ragged), with
  and without a final-state cotangent, float32: y and all six gradients
  within 1e-5 of their max; the chunk start states equal JAX's ``_fwd``
  residuals within 1e-5 of max. With bf16 streams the gradients come back
  in bf16, as JAX's ``astype`` VJPs round them.
- the two backward contracts (``contract.bwd_check``) accept the plain
  backward and reject their controls, in float32 and bf16 (flash_attention
  at G = 2 and 16, with the bf16-only control of dS rounded before D is
  subtracted); the bf16 plain backward rounds P and dS where the wgmma
  kernel does, against those formulas written out in float64; the float32
  plain backward is bitwise what it was before the rounding points.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.models import ssm_vjp as jax_ssm_vjp  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_bwd,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention import contract as fa_contract  # noqa: E402
from repro_torch.kernels.ssm_scan import contract as ssm_contract  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd, ssm_scan_plain  # noqa: E402
from repro_torch.models.ssm_vjp import selective_scan  # noqa: E402
from _torch_train import one_torch_thread  # noqa: E402,F401 (fixture)

REL = 1e-5


def _close(got, want, what=""):
    got = got.detach().to(torch.float64).numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap, scale = np.abs(got - want).max(), np.abs(want).max()
    assert gap <= REL * scale, (what, gap / scale)


def _attention_case(case, seed=0):
    b, s, t, h, hkv, dq, dv = case
    rng = np.random.default_rng(seed + s + t + dq)
    draw = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return draw(b, s, h, dq), draw(b, t, hkv, dq), draw(b, t, hkv, dv), draw(b, s, h, dv)


_ATTN_CASES = [
    # (b, s, t, h, hkv, dq, dv, causal, window)
    (2, 70, 70, 4, 4, 64, 64, True, 0),      # G = 1
    (1, 150, 150, 4, 2, 64, 64, True, 0),    # G = 2, a ragged 64-key tile
    (1, 150, 150, 8, 2, 64, 64, True, 40),   # G = 4, a window
    (2, 33, 90, 4, 2, 64, 64, False, 0),     # non-causal, T != S (S < T)
    (1, 90, 40, 4, 1, 64, 64, False, 0),     # non-causal, S > T, G = 4
    (1, 1, 70, 2, 2, 64, 64, False, 0),      # a decode step's single query
    (2, 64, 64, 4, 4, 48, 32, True, 0),      # MLA's reduced (48, 32)
    (1, 100, 100, 4, 4, 48, 32, True, 16),
]


@pytest.mark.parametrize("case", _ATTN_CASES, ids=str)
def test_attention_backward_plain_matches_jax_vjp(case):
    causal, window = case[7:]
    q, k, v, dout = _attention_case(case[:7])
    s, t, dq = q.shape[1], k.shape[1], q.shape[-1]

    def ref(q, k, v):
        return chunked_attention(q, k, v, jnp.arange(s), jnp.arange(t), causal=causal,
                                 window=window, chunk=64, scale=1.0 / np.sqrt(dq))

    want_out, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = flash_attention_plain(tq, tk, tv, causal, window, return_lse=True)
    _close(out, want_out, "out")
    got = flash_attention_backward_plain(tq, tk, tv, out, lse, tdo, causal, window)
    assert [g.dtype for g in got] == [torch.float32] * 3
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)
    # the wrapper on CPU tensors is the plain backward
    assert all(torch.equal(a, b) for a, b in zip(
        got, flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, window)))


def _position_case(kind: str, s: int, t: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(q_pos (S,), k_pos (T,)) int32: ``image`` (a quarter of the tokens an
    image at t = 0, then text from t = 6; q_pos = k_pos), ``ties`` (a walk
    with steps 0, 1 or 2; q_pos = k_pos), ``cache`` (T keys walking with
    ties, a tenth of them empty slots at -1, and S sorted queries at keys'
    positions, so every query sees a key)."""
    rng = np.random.default_rng(seed)
    if kind == "image":
        nv = s // 4
        pos = np.concatenate([np.zeros(nv), 6 + np.arange(s - nv)]).astype(np.int32)
        return pos, pos
    walk = np.cumsum(rng.integers(0, 3, t)).astype(np.int32)
    if kind == "ties":
        return walk, walk
    walk[rng.random(t) < 0.1] = -1
    return np.sort(rng.choice(walk[walk >= 0], s)).astype(np.int32), walk


_POS_CASES = [
    # (b, s, t, h, hkv, dq, dv, causal, window, positions)
    (2, 80, 80, 4, 2, 64, 64, True, 0, "image"),
    (1, 150, 150, 4, 1, 64, 64, True, 12, "ties"),
    (1, 40, 130, 4, 2, 64, 64, True, 0, "cache"),
    (1, 40, 130, 2, 2, 48, 32, False, 0, "cache"),
]


@pytest.mark.parametrize("case", _POS_CASES, ids=str)
def test_attention_positions_plain_matches_jax_vjp(case):
    """The position mask: ``flash_attention_plain`` and its backward against
    ``chunked_attention`` over the same q and kv positions, and its
    ``jax.vjp``, in float32 within 1e-5 of max."""
    causal, window, kind = case[7:]
    q, k, v, dout = _attention_case(case[:7])
    s, t, dq = q.shape[1], k.shape[1], q.shape[-1]
    q_pos, k_pos = _position_case(kind, s, t, seed=s + t)

    def ref(q, k, v):
        return chunked_attention(q, k, v, jnp.asarray(q_pos), jnp.asarray(k_pos), causal=causal,
                                 window=window, chunk=64, scale=1.0 / np.sqrt(dq))

    want_out, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    mask = dict(q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos))
    out, lse = flash_attention_plain(tq, tk, tv, causal, window, return_lse=True, **mask)
    _close(out, want_out, "out")
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, window, **mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)
    # autograd through FlashAttentionFn keeps the positions for the backward
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    fn_out = flash_attention(*leaves, causal=causal, window=window, **mask)
    assert torch.equal(fn_out.detach(), out)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(fn_out, leaves, tdo), got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_arange_positions_are_the_index_mask_bitwise(dtype):
    """q_pos = k_pos = arange(S) masks as the index rule does: the plain
    forward, its lse and the plain backward bit for bit, causal with and
    without a window."""
    q, k, v, dout = (torch.from_numpy(a).to(dtype)
                     for a in _attention_case((1, 150, 150, 4, 2, 64, 64)))
    ar = torch.arange(150, dtype=torch.int32)
    for window in (0, 40):
        out, lse = flash_attention_plain(q, k, v, True, window, return_lse=True)
        out_a, lse_a = flash_attention_plain(q, k, v, True, window, return_lse=True, q_pos=ar,
                                             k_pos=ar)
        assert torch.equal(out, out_a) and torch.equal(lse, lse_a)
        grads = flash_attention_bwd(q, k, v, out, lse, dout, True, window)
        grads_a = flash_attention_bwd(q, k, v, out, lse, dout, True, window, q_pos=ar, k_pos=ar)
        assert all(torch.equal(x, y) for x, y in zip(grads, grads_a))


@pytest.mark.parametrize("case", _ATTN_CASES[:4], ids=str)
def test_forward_lse_is_the_rows_logsumexp(case):
    causal, window = case[7:]
    q, k, v, _ = (torch.from_numpy(a) for a in _attention_case(case[:7]))
    _, lse = flash_attention_plain(q, k, v, causal, window, return_lse=True)
    s, t, g = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    sc = torch.einsum("bshd,bthd->bhst", q.double(), k.double().repeat_interleave(g, 2))
    sc = sc / np.sqrt(q.shape[-1])
    rows, keys = torch.arange(s)[:, None], torch.arange(t)[None]
    vis = torch.ones((s, t), dtype=torch.bool)
    if causal:
        vis &= keys <= rows
    if window:
        vis &= keys > rows - window
    want = torch.logsumexp(sc.masked_fill(~vis, -torch.inf), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert float((lse.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_fn_gives_the_plain_backward(dtype):
    """Where q, k, v need gradients, ``flash_attention`` runs
    ``FlashAttentionFn``: the same output as without them, and the plain
    backward's gradients in the inputs' dtype."""
    q, k, v, dout = (torch.from_numpy(a).to(dtype)
                     for a in _attention_case((2, 40, 40, 4, 2, 64, 64)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal=True, window=16)
    grads = torch.autograd.grad(out, leaves, dout)
    want_out, lse = flash_attention_plain(q, k, v, True, 16, return_lse=True)
    assert torch.equal(out.detach(), want_out) and torch.equal(flash_attention(q, k, v, True, 16),
                                                               want_out)
    want = flash_attention_backward_plain(q, k, v, want_out, lse, dout, True, 16)
    assert all(g.dtype == dtype and torch.equal(g, w) for g, w in zip(grads, want))


@pytest.mark.parametrize("case", [(2, 96, 96, 4, 2, 64, 64), (1, 96, 96, 16, 1, 64, 64)],
                         ids=["G2", "G16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_attention_bwd_contract_accepts_plain32_and_rejects_controls(dtype, causal, window, case):
    """The plain backward in q's dtype (bf16: P and dS rounded where the
    wgmma kernel rounds them) meets ``bwd_check``; every control fails it:
    D left out, P off by 2^-10 (2^-6 in bf16) and, in bf16, dS rounded
    before D is subtracted."""
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in _attention_case(case))
    out, lse = flash_attention_plain(q, k, v, causal, window, return_lse=True)
    ref = fa_contract.bwd_references(q, k, v, out, lse, dout, causal, window)
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal, window)  # plain, in q's dtype
    assert fa_contract.bwd_check(got, ref)["ok"]
    controls = fa_contract.bwd_controls(q, k, v, out, lse, dout, causal, window)
    assert len(controls) == (3 if dtype == torch.bfloat16 else 2)
    for name, bad in controls.items():
        assert not fa_contract.bwd_check(bad, ref)["ok"], name


def _rounded_backward64(q, k, v, out, lse, dout, causal, window):
    """The bf16 kernel's formulas written out in float64 over einsums: P
    rounded to bf16 before dV, dS (from the unrounded P) before dK and dQ."""
    f = lambda x: torch.from_numpy(np.asarray(x.float().numpy(), np.float64))  # noqa: E731
    q, k, v, out, dout, lse = f(q), f(k), f(v), f(out), f(dout), f(lse)
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s, t = q.shape[1], k.shape[1]
    scale = 1.0 / np.sqrt(q.shape[-1])
    rows, keys = torch.arange(s)[:, None], torch.arange(t)[None]
    vis = torch.ones((s, t), dtype=torch.bool)
    if causal:
        vis &= keys <= rows
    if window:
        vis &= keys > rows - window
    sc = torch.einsum("bshd,bthd->bhst", q, k) * scale
    p = torch.where(vis, torch.exp(sc - lse[..., None]), 0.0)
    dp = torch.einsum("bshd,bthd->bhst", dout, v)
    dd = torch.einsum("bshd,bshd->bhs", dout, out)
    ds = p * (dp - dd[..., None])
    rnd = lambda x: x.float().to(torch.bfloat16).double()  # noqa: E731
    dq = torch.einsum("bhst,bthd->bshd", rnd(ds), k) * scale
    dk = torch.einsum("bhst,bshd->bthd", rnd(ds), q) * scale
    dv = torch.einsum("bhst,bshd->bthd", rnd(p), dout)
    b, hkv = q.shape[0], k.shape[2] // g
    fold = lambda x: x.reshape(b, t, hkv, g, x.shape[-1]).sum(3)  # noqa: E731
    return dq, fold(dk), fold(dv)


def test_bf16_plain_backward_rounds_p_and_ds():
    """For bf16 inputs the plain backward rounds P to bf16 before dV and dS
    before dK and dQ, and nothing else: in float64 it equals those formulas
    written out by hand (within float64 summation order), and it differs
    from the unrounded backward by more than that."""
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in _attention_case((2, 50, 50, 4, 2, 64, 64)))
    out, lse = flash_attention_plain(q, k, v, True, 20, return_lse=True)
    got = flash_attention_backward_plain(q, k, v, out, lse, dout, True, 20,
                                         acc_dtype=torch.float64, dtype=torch.float64)
    want = _rounded_backward64(q, k, v, out, lse, dout, True, 20)
    unrounded = flash_attention_backward_plain(q, k, v, out, lse, dout, True, 20,
                                               acc_dtype=torch.float64, dtype=torch.float64,
                                               rounding=False)
    for name, g, w, u in zip(("dq", "dk", "dv"), got, want, unrounded):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-12 * scale, name
        assert float((u - w).abs().max()) > 1e-5 * scale, name


def _plain_backward_before_rounding_points(q, k, v, out, lse, dout, causal, window):
    """``flash_attention_backward_plain`` in float32 as it stood before the
    bf16 rounding points were added: the float32 path must keep its bits."""
    b, s, h, dqk = q.shape
    t, hkv, dv_dim = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    scale = 1.0 / np.sqrt(dqk)
    rows, keys = torch.arange(s)[:, None], torch.arange(t)[None, :]
    vis = torch.ones((s, t), dtype=torch.bool)
    if causal:
        vis = vis & (keys <= rows)
    if window:
        vis = vis & (keys > rows - window)
    grads = ([], [], [])
    for i in range(b):
        def heads(x, d):
            return x[i].to(torch.float32).reshape(s, hkv, g, d).permute(1, 2, 0, 3)

        def kv(x):
            return x[i].to(torch.float32).permute(1, 0, 2)[:, None]

        qi, oi, doi = heads(q, dqk), heads(out, dv_dim), heads(dout, dv_dim)
        ki, vi = kv(k), kv(v)
        li = lse[i].to(torch.float32).reshape(hkv, g, s)[..., None]
        sc = torch.matmul(qi, ki.transpose(-1, -2)) * scale
        p = torch.exp(torch.where(vis, sc - li, -torch.inf))
        ds = p * (torch.matmul(doi, vi.transpose(-1, -2)) - (doi * oi).sum(-1, keepdim=True))
        grads[0].append((torch.matmul(ds, ki) * scale).permute(2, 0, 1, 3).reshape(s, h, dqk))
        grads[1].append((torch.matmul(ds.transpose(-1, -2), qi).sum(1) * scale).transpose(0, 1))
        grads[2].append(torch.matmul(p.transpose(-1, -2), doi).sum(1).transpose(0, 1))
    return tuple(torch.stack(gr) for gr in grads)


@pytest.mark.parametrize("case", _ATTN_CASES[:3] + _ATTN_CASES[6:7], ids=str)
def test_float32_plain_backward_is_unchanged(case):
    causal, window = case[7:]
    q, k, v, dout = (torch.from_numpy(a) for a in _attention_case(case[:7]))
    out, lse = flash_attention_plain(q, k, v, causal, window, return_lse=True)
    got = flash_attention_backward_plain(q, k, v, out, lse, dout, causal, window)
    want = _plain_backward_before_rounding_points(q, k, v, out, lse, dout, causal, window)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _scan_case(b, s, di, ds, seed=0):
    rng = np.random.default_rng(seed + s)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    dt = f32(np.log1p(np.exp(rng.standard_normal((b, s, di)) * 0.5 - 2)))
    a = f32(-np.exp(rng.standard_normal((di, ds))))
    bm, cm = f32(rng.standard_normal((b, s, ds))), f32(rng.standard_normal((b, s, ds)))
    x, d = f32(rng.standard_normal((b, s, di))), f32(rng.standard_normal((di,)))
    gy, gh = f32(rng.standard_normal((b, s, di))), f32(rng.standard_normal((b, di, ds)))
    return (dt, a, bm, cm, x, d), gy, gh


@pytest.mark.parametrize("with_gh", [True, False])
@pytest.mark.parametrize("s", [100, 128, 300])
def test_selective_scan_grads_match_jax_vjp(s, with_gh):
    args, gy, gh = _scan_case(2, s, 24, 8)
    gh = gh if with_gh else np.zeros_like(gh)
    (want_y, want_h), vjp = jax.vjp(jax_ssm_vjp.selective_scan, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = selective_scan(*leaves)
    _close(y, want_y, "y")
    _close(h, want_h, "h")
    got = torch.autograd.grad((y, h) if with_gh else y, leaves,
                              (torch.from_numpy(gy), torch.from_numpy(gh)) if with_gh
                              else torch.from_numpy(gy))
    for name, g, w in zip(ssm_contract.BWD_NAMES, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("s", [100, 300])
def test_chunk_states_are_jax_fwd_residuals(s):
    args, _, _ = _scan_case(2, s, 16, 8)
    _, res = jax_ssm_vjp._fwd(*(jnp.asarray(a) for a in args))
    y, h, hs = ssm_scan_plain(*(torch.from_numpy(a) for a in args), chunk_states=True)
    assert hs.shape == (-(-s // 128), 2, 16, 8) and not hs[0].any()
    _close(hs, res[-1], "h_starts")
    y2, h2, hs2 = ssm_scan(*(torch.from_numpy(a) for a in args), chunk_states=True)
    assert torch.equal(y, y2) and torch.equal(h, h2) and torch.equal(hs, hs2)


def test_selective_scan_bf16_streams_round_their_cotangents():
    """bf16 streams (the model's ``_scan_dt``): the gradients of dt, B, C, x
    come back in bf16 (JAX's astype VJP), those of A and D in float32; each
    is the float32 backward rounded once."""
    args, gy, _ = _scan_case(1, 150, 16, 8)
    streams = [torch.from_numpy(args[i]).to(torch.bfloat16) for i in (0, 2, 3, 4)]
    a, d = torch.from_numpy(args[1]), torch.from_numpy(args[5])
    leaves = [t.clone().requires_grad_() for t in (streams[0], a, streams[1], streams[2],
                                                   streams[3], d)]
    y, _ = selective_scan(*leaves, y_dtype=torch.bfloat16)
    gyb = torch.from_numpy(gy).to(torch.bfloat16)
    got = torch.autograd.grad(y, leaves, gyb)
    assert [g.dtype for g in got] == [t.dtype for t in leaves]
    plain = [t.detach() for t in leaves]
    _, _, hs = ssm_scan_plain(*plain, chunk_states=True)
    want = ssm_scan_bwd(*plain, hs, gyb.float())
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16], ids=str)
def test_scan_bwd_contract_accepts_plain32_and_rejects_controls(stream):
    args, gy, _ = _scan_case(2, 300, 16, 8)
    t = [torch.from_numpy(a) for a in args]
    t[0], t[2], t[3], t[4] = (t[i].to(stream) for i in (0, 2, 3, 4))
    _, _, hs = ssm_scan_plain(*t, chunk_states=True)
    gy = torch.from_numpy(gy)
    plain32, ref64 = ssm_contract.bwd_references(*t, hs, gy)
    got = ssm_scan_bwd(*t, hs, gy)  # the plain backward in the streams' dtype
    assert ssm_contract.bwd_check(got, plain32, ref64)["ok"]
    for name, bad in ssm_contract.bwd_controls(*t, hs, gy).items():
        assert not ssm_contract.bwd_check(bad, plain32, ref64)["ok"], name
