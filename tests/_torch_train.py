"""Shared checks of the training parity tests (``test_torch_train_*.py``):
the port's loss and gradients, and three train steps, against the JAX
package's on the same weights and batches.

Each case builds the JAX model of a reduced config in float32 (or bf16),
carries its weights into the port (``weights.lm_params_from_numpy`` /
``whisper_params_from_numpy``), draws the JAX CLI's batch, and compares:

- ``check_loss_and_grads``: the loss, and every gradient leaf, the JAX
  gradient tree carried through the same function as the weights, so that
  leaves pair by name. Within ``F32_REL`` of each leaf's max (measured:
  1.1e-6 to 1.5e-6 of max for every architecture without a Mamba scan), or
  ``SCAN_REL`` where a Mamba scan is in the stack: both packages round the
  scan's float32 inputs to bf16 and its cotangents back, and an input
  within ~1e-7 of a rounding boundary rounds the other way in one of them
  (measured: 1.8e-3 of max for falcon-mamba's ``dt_proj``, 1.5e-3 for
  jamba's ``dt_bias``). The bf16 configs are held to ``BF16_REL``
  (measured 0.019 for granite-3-8b's ``norm1``; the two frameworks round
  matmul outputs and P at other places).
- ``check_train_steps``: three steps of the CLI's optimizer (clip to global
  norm 1, AdamW on a cosine schedule with warm-up 2) on the batches the
  JAX CLI draws, jitted in JAX: each loss within ``F32_REL`` of JAX's
  (measured 1.5e-7 relative), and every parameter within ``STEP_ABS``
  (1/300 of a step at lr 3e-4) of JAX's after the three steps, but for
  elements AdamW moves by rounding noise: where a gradient element is a
  sum that cancels to near zero, its relative error is of order one, and
  AdamW divides it by its own root-mean-square, so the update of such an
  element differs by up to a fraction of the learning rate (measured: the
  worst 0.069 lr in qwen2-vl-2b's ``embed``, whose Adam RMS gradient is
  7.9e-6 of the leaf's largest). Such an element must have an RMS gradient
  (JAX's ``nu``) below ``NEAR_ZERO`` of its leaf's largest and stay within
  one learning rate. Behind a Mamba scan, the bf16 input flips move whole
  gradients by up to 2^-8 of max, so there the elements beyond
  ``STEP_ABS`` may have any gradient but are at most ``SCAN_SHARE`` of the
  parameters (measured: 8 of 1.1 M in falcon-mamba, 97 of 6.5 M in jamba,
  within 0.052 lr), and within one learning rate.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax

from repro import optim as jax_optim
from repro.configs import get_config as jax_get_config
from repro.models.api import get_model as jax_get_model
from repro.models.api import make_concrete_batch as jax_make_concrete_batch
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.models.api import get_model, param_tree
from repro_torch.weights import lm_params_from_numpy, whisper_params_from_numpy

F32_REL = 1e-5
SCAN_REL = 2.0 ** -8
BF16_REL = 2.0 ** -5
LR = 3e-4
STEPS = 3
STEP_ABS = 1e-6
NEAR_ZERO = 1e-4
SCAN_SHARE = 1e-4
BATCH, SEQ = 2, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small models (the suite runs in
    several worker processes, and more threads only contend)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a) -> torch.Tensor:
    """A numpy/jax array as a torch tensor with the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def cfgs(arch: str, dtype: str = "float32", **change):
    """(the JAX config, the port's config): the reduced arch in ``dtype``,
    with ``change`` (e.g. ``tie_embeddings=True``)."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype, **change)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **change)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def model_from(cfg, tree):
    """A JAX parameter-shaped tree (weights, gradients, moments) as the
    port's model on the CPU."""
    fn = whisper_params_from_numpy if cfg.encoder_decoder else lm_params_from_numpy
    return fn(cfg, jax.device_get(tree), device="cpu")


def carry(cfg, tree) -> dict:
    """``model_from``'s leaves by name, to pair with the port's."""
    return param_tree(model_from(cfg, tree))


def _np(x) -> np.ndarray:
    return x.detach().to(torch.float64).numpy()


def image_t_stream(batch: dict, n_vision: int, grid: int = 4) -> dict:
    """``batch`` with the t stream of its M-RoPE ``positions`` a real
    Qwen2-VL prompt's: the ``n_vision`` image tokens all at t = 0, the text
    after them from t = ``grid``."""
    pos = np.array(batch["positions"])
    pos[:, :n_vision, 0] = 0
    pos[:, n_vision:, 0] = grid + np.arange(pos.shape[1] - n_vision)
    return dict(batch, positions=jax.numpy.asarray(pos))


def check_loss_and_grads(arch: str, dtype: str = "float32", edit=None, **change) -> dict:
    """The port's ``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad`` of the JAX loss (the config with ``change``, the
    batch through ``edit`` where given); returns the worst gap of a leaf
    over its max, by leaf."""
    jcfg, cfg = cfgs(arch, dtype, **change)
    bundle = jax_get_model(jcfg)
    params = bundle.init(jax.random.PRNGKey(0))
    batch = jax_make_concrete_batch(jcfg, "train", BATCH, SEQ, jax.random.PRNGKey(1))
    if edit is not None:
        batch = edit(batch)
    loss, grads = jax.jit(jax.value_and_grad(bundle.loss_fn))(params, batch)
    model = model_from(cfg, params)
    tree = param_tree(model)
    want = carry(cfg, grads)
    assert list(tree) == list(want)
    for p in tree.values():
        p.requires_grad_(True)
    got_loss = get_model(cfg).loss_fn(model, {k: _t(v) for k, v in batch.items()})
    assert got_loss.dtype == torch.float32 and got_loss.shape == ()
    got = torch.autograd.grad(got_loss, list(tree.values()), allow_unused=True)
    rel = BF16_REL if dtype == "bfloat16" else SCAN_REL if cfg.ssm else F32_REL
    assert abs(float(got_loss.detach()) - float(loss)) <= rel * abs(float(loss)), (got_loss, loss)
    gaps = {}
    for (name, param), grad in zip(tree.items(), got):
        assert grad is not None, f"{name}: no gradient"
        assert grad.dtype == param.dtype and grad.shape == param.shape, name
        ref = _np(want[name])
        gaps[name] = float(np.abs(_np(grad) - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
        assert gaps[name] <= rel, (name, gaps[name], rel)
    return gaps


def check_train_steps(arch: str, **change) -> dict:
    """Three steps of the CLI's optimizer in both packages from the same
    weights on the same batches (the config with ``change``); returns the
    measured gaps."""
    jcfg, cfg = cfgs(arch, **change)
    jb = jax_get_model(jcfg)
    params = jb.init(jax.random.PRNGKey(0))
    jopt = jax_optim.chain(jax_optim.clip_by_global_norm(1.0), jax_optim.adamw(
        jax_optim.cosine_schedule(LR, warmup_steps=2, total_steps=STEPS)))
    topt = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(
        optim.cosine_schedule(LR, warmup_steps=2, total_steps=STEPS)))
    model = model_from(cfg, params)
    jstate, tstate = jopt.init(params), topt.init(param_tree(model))
    jstep, tstep = jax.jit(jb.make_train_step(jopt)), get_model(cfg).make_train_step(topt)
    rng = jax.random.PRNGKey(1)
    loss_gaps = []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        batch = jax_make_concrete_batch(jcfg, "train", BATCH, SEQ, sub)
        params, jstate, jloss = jstep(params, jstate, batch)
        model, tstate, tloss = tstep(model, tstate, {k: _t(v) for k, v in batch.items()})
        assert tloss.shape == () and not tloss.requires_grad
        loss_gaps.append(abs(float(tloss) - float(jloss)) / abs(float(jloss)))
        assert loss_gaps[-1] <= F32_REL, loss_gaps
    want, nu = carry(cfg, params), carry(cfg, jstate[1].nu)
    n_over = n_total = 0
    worst = 0.0
    for name, p in param_tree(model).items():
        d = np.abs(_np(p) - _np(want[name]))
        rms = np.sqrt(_np(nu[name]))
        over = d > STEP_ABS
        n_over += int(over.sum())
        n_total += d.size
        worst = max(worst, float(d.max()))
        assert d.max() <= LR, (name, float(d.max()))
        if not cfg.ssm and over.any():
            assert (rms[over] < NEAR_ZERO * rms.max()).all(), (
                name, rms[over] / rms.max(), d[over])
    assert n_over <= (SCAN_SHARE * n_total if cfg.ssm else n_total), (n_over, n_total)
    return {"loss_gaps": loss_gaps, "over": n_over, "of": n_total, "worst_over_lr": worst / LR}
