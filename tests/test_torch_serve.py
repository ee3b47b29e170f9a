"""The port's serving path against the JAX package's: sampling, prompts, and
the continuous-batching decode loop.

- ``random.randint`` is bitwise equal to ``jax.random.randint`` and
  ``random.categorical`` gives jax's indices, in both threefry streams;
  ``make_concrete_batch`` draws the JAX CLI's prompts.
- ``DecodeProgram`` under ``ContinuousBatcher`` and ``greedy_decode`` give
  the same tokens per request, ``tokens_out`` and ``prefill_calls`` as the
  JAX ones, for both archs (reduced float32 configs, the JAX weights
  carried over). A greedy token may differ only where the reference's
  top-2 logit margin at that step is below the logits tolerance of
  ``tests/test_torch_lm.py`` (1e-5 of max|logits|, 2^-8 after a Mamba
  scan); the comparison then stops at that step.
- ``serve`` runs every served arch's reduced config on the CPU (qwen2-vl-2b
  and whisper-tiny in waves: ``tests/test_torch_dense_zoo.py`` and
  ``tests/test_torch_whisper.py`` hold their waves to the JAX launcher's).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro.models.api import make_concrete_batch as jax_make_concrete_batch  # noqa: E402
from repro.serve import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serve import DecodeProgram as JaxDecodeProgram  # noqa: E402
from repro.serve import ServeRequest as JaxRequest  # noqa: E402
from repro.serve import greedy_decode as jax_greedy_decode  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.api import get_model, make_concrete_batch  # noqa: E402
from repro_torch.serve import ContinuousBatcher, DecodeProgram, ServeRequest, greedy_decode  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

ARCHS = ["falcon-mamba-7b", "granite-3-8b"]
MOE_ARCHS = ["deepseek-moe-16b", "moonshot-v1-16b-a3b", "deepseek-v2-lite-16b"]
ZOO_ARCHS = ARCHS + MOE_ARCHS + ["chatglm3-6b", "stablelm-12b", "jamba-v0.1-52b"]  # token-only
WAVE_ARCHS = ["qwen2-vl-2b", "whisper-tiny"]  # a prefill batch beyond tokens: served in waves
MODES = pytest.mark.parametrize("partitionable", [True, False], ids=["partitionable", "legacy"])
LOGITS_REL = {"granite-3-8b": 1e-5, "falcon-mamba-7b": 2.0 ** -8}  # test_torch_lm.py's contracts


@contextlib.contextmanager
def both(partitionable):
    with jax.threefry_partitionable(partitionable), prng.threefry_partitionable(partitionable):
        yield


# ---------------------------------------------------------------------------
# sampling and prompts
# ---------------------------------------------------------------------------


@MODES
@pytest.mark.parametrize("seed", [0, 2**31 - 1])
@pytest.mark.parametrize("bounds", [(0, 65024), (0, 49155), (-5, 7), (0, 2**31 - 1), (3, 3)],
                         ids=str)
def test_randint_bitwise(bounds, seed, partitionable):
    lo, hi = bounds
    with both(partitionable):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (5, 37), lo, hi))
        got = prng.randint(prng.PRNGKey(seed), (5, 37), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@MODES
@pytest.mark.parametrize("seed", [0, 42])
def test_categorical_matches_jax(seed, partitionable):
    """Same indices; the gumbel draws are within a few float32 ulp of jax's
    (``tests/test_torch_random.py``), far below these logits' top-2 gaps."""
    logits = np.random.default_rng(seed).standard_normal((4, 300)).astype(np.float32) * 3
    with both(partitionable):
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed), jnp.asarray(logits)))
        got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


@MODES
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_make_concrete_batch_draws_the_jax_prompts(arch, partitionable):
    with both(partitionable):
        want = jax_make_concrete_batch(jax_get_config(arch), "prefill", 8, 64, jax.random.PRNGKey(1))
        got = make_concrete_batch(get_config(arch), "prefill", 8, 64, prng.PRNGKey(1))
    assert set(got) == set(want) == {"tokens"}
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


# ---------------------------------------------------------------------------
# the decode loop
# ---------------------------------------------------------------------------


class _Recorded:
    """A step function that keeps each call's (B, V) logits as numpy."""

    def __init__(self, fn):
        self.fn, self.logits = fn, []

    def __call__(self, *args):
        logits, cache = self.fn(*args)
        self.logits.append(np.asarray(logits.numpy() if isinstance(logits, torch.Tensor)
                                      else logits, np.float32))
        return logits, cache


def _first_flip(jrec, trec, rel):
    """Index of the first call whose greedy tokens differ, or None. A flip
    must be a near tie of the reference: its top-2 margin below ``rel`` of
    max|logits|."""
    for i, (jl, tl) in enumerate(zip(jrec.logits, trec.logits)):
        lanes = np.nonzero(jl.argmax(-1) != tl.argmax(-1))[0]
        if lanes.size:
            top2 = np.sort(jl[lanes], axis=-1)[:, -2:]
            margin = (top2[:, 1] - top2[:, 0]).max()
            assert margin < rel * np.abs(jl).max(), (i, lanes, margin)
            return i
    return None


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(arch, cfg pair, JAX params, JAX jitted steps, the port's model)."""
    arch = request.param
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, jax.device_get(params), device="cpu")
    return (arch, jcfg, cfg, params, jax.jit(bundle.make_prefill_step()),
            jax.jit(bundle.make_decode_step()), model)


def _run_both(served, *, requests, batch, prompt_len, max_new, eos_id, temperature=0.0):
    arch, jcfg, cfg, params, jprefill, jdecode, model = served
    prompts = np.asarray(jax_make_concrete_batch(jcfg, "prefill", requests, prompt_len,
                                                 jax.random.PRNGKey(1))["tokens"])
    jp, jd = _Recorded(jprefill), _Recorded(jdecode)
    jprog = JaxDecodeProgram(jp, jd, params, batch, prompt_len, eos_id=eos_id,
                             temperature=temperature, rng=jax.random.PRNGKey(2))
    jres = JaxBatcher(jprog, batch).run(
        [JaxRequest(rid=i, client_id=i, inputs=prompts[i], steps=max_new) for i in range(requests)])
    bundle = get_model(cfg)
    tp, td = _Recorded(bundle.make_prefill_step()), _Recorded(bundle.make_decode_step())
    tprog = DecodeProgram(tp, td, model, batch, prompt_len, eos_id=eos_id,
                          temperature=temperature, rng=prng.PRNGKey(2))
    tres = ContinuousBatcher(tprog, batch).run(
        [ServeRequest(rid=i, client_id=i, inputs=prompts[i], steps=max_new) for i in range(requests)])
    return (jprog, jres, jp, jd), (tprog, tres, tp, td)


def _assert_same_serving(served, jrun, trun):
    (jprog, jres, jp, jd), (tprog, tres, tp, td) = jrun, trun
    rel = LOGITS_REL[served[0]]
    # prefill and decode calls interleave in the same order in both runs
    flip = _first_flip(jp, tp, rel)
    flip_d = _first_flip(jd, td, rel)
    if flip is not None or flip_d is not None:
        return  # a justified near-tie flip: the runs legitimately part here
    by_rid = lambda rs: {r.rid: (list(r.output), r.steps) for r in rs}  # noqa: E731
    assert by_rid(tres) == by_rid(jres)
    assert tprog.tokens_out == jprog.tokens_out
    assert tprog.prefill_calls == jprog.prefill_calls


def test_decode_program_matches_jax(served):
    jrun, trun = _run_both(served, requests=5, batch=2, prompt_len=16, max_new=6,
                           eos_id=served[1].eos_token_id)
    assert trun[0].prefill_calls >= 3  # 5 requests on 2 lanes: backfills re-prefill
    _assert_same_serving(served, jrun, trun)


def test_decode_program_with_early_eos_matches_jax(served):
    """EOS set to the token the reference's first lane emits third: that lane
    retires early and the survivors re-prefill with the backfill."""
    jrun, _ = _run_both(served, requests=3, batch=2, prompt_len=16, max_new=6, eos_id=-1)
    eos = int(sorted(jrun[1], key=lambda r: r.rid)[0].output[2])
    jrun, trun = _run_both(served, requests=3, batch=2, prompt_len=16, max_new=6, eos_id=eos)
    assert min(len(r.output) for r in trun[1]) < 6
    _assert_same_serving(served, jrun, trun)


def test_decode_program_with_temperature_matches_jax(served):
    jrun, trun = _run_both(served, requests=3, batch=2, prompt_len=16, max_new=5,
                           eos_id=served[1].eos_token_id, temperature=0.7)
    _assert_same_serving(served, jrun, trun)


def test_greedy_decode_matches_jax(served):
    arch, jcfg, cfg, params, jprefill, jdecode, model = served
    toks = np.array(jax_make_concrete_batch(jcfg, "prefill", 3, 16, jax.random.PRNGKey(3))["tokens"])
    jp, jd = _Recorded(jprefill), _Recorded(jdecode)
    jseqs, jn = jax_greedy_decode(jp, jd, params, {"tokens": jnp.asarray(toks)}, 6, eos_id=1)
    bundle = get_model(cfg)
    tp, td = _Recorded(bundle.make_prefill_step()), _Recorded(bundle.make_decode_step())
    tseqs, tn = greedy_decode(tp, td, model, {"tokens": torch.from_numpy(toks)}, 6, eos_id=1)
    if _first_flip(jp, tp, LOGITS_REL[arch]) is None and _first_flip(jd, td, LOGITS_REL[arch]) is None:
        assert tseqs == jseqs
        np.testing.assert_array_equal(tn, jn)


# ---------------------------------------------------------------------------
# the CLI body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO_ARCHS + WAVE_ARCHS)
def test_serve_on_the_cpu(arch):
    cfg = get_config(arch).reduced()
    stats = serve(cfg, requests=3, batch=2, prompt_len=8, max_new=4, seed=0, device="cpu")
    assert stats["n_requests"] == 3 and stats["timer"] == "host" and stats["logits_finite"]
    assert stats["tokens"] == sum(stats["lens"]) and all(1 <= n <= 4 for n in stats["lens"])
    assert len(stats["prefill_ms"]) == stats["prefill_calls"] >= 2
    assert all(len(o) == n for o, n in zip(stats["outputs"], stats["lens"]))


def test_serve_cli_runs_the_reduced_config(capsys):
    stats = serve_main(["--arch", "granite-3-8b", "--requests", "2", "--batch", "2",
                        "--prompt-len", "8", "--max-new", "3", "--device", "cpu"])
    assert stats["n_requests"] == 2
    assert "served 2 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_takes_the_moe_family(arch, capsys):
    stats = serve_main(["--arch", arch, "--requests", "2", "--batch", "2", "--prompt-len", "8",
                        "--max-new", "2", "--device", "cpu"])
    assert stats["n_requests"] == 2 and stats["logits_finite"]
    assert "served 2 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["chatglm3-6b", "stablelm-12b"] + WAVE_ARCHS)
def test_serve_cli_takes_the_dense_zoo(arch, capsys):
    """chatglm3 and stablelm through continuous batching, qwen2-vl (vision
    embeddings and M-RoPE positions in its prefill batch) in waves of
    ``--batch`` requests, each wave one prefill."""
    stats = serve_main(["--arch", arch, "--requests", "3", "--batch", "2", "--prompt-len", "24",
                        "--max-new", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert stats["n_requests"] == 3 and stats["logits_finite"] and "served 3 requests" in out
    if arch in WAVE_ARCHS:
        assert stats["prefill_calls"] == 2 and out.startswith("waves: 3 requests")
    else:
        assert out.startswith("continuous: 3 requests")


@pytest.mark.parametrize("arch,mode", [("jamba-v0.1-52b", "continuous"), ("whisper-tiny", "waves")])
def test_serve_cli_takes_jamba_and_whisper(arch, mode, capsys):
    """jamba (a token-only prefill) through continuous batching, whisper
    (frames beside its tokens) in waves of ``--batch`` requests."""
    stats = serve_main(["--arch", arch, "--requests", "3", "--batch", "2", "--prompt-len", "24",
                        "--max-new", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert stats["n_requests"] == 3 and stats["logits_finite"] and "served 3 requests" in out
    assert out.startswith(f"{mode}: 3 requests")
