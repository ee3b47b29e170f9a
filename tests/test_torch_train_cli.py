"""The port's training entry points on the CPU: ``launch/train.py`` runs the
reduced configs with finite losses and saves its checkpoint; a train batch
is the JAX package's bit for bit (``make_batch_specs``/
``make_concrete_batch`` with ``labels`` last, one split per input); the
train step returns its loss as a tensor and reads nothing back from the
device (no ``.item()`` or ``nonzero`` inside it, which would stall the
card's queue every step).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.api import make_batch_specs as jax_make_batch_specs  # noqa: E402
from repro.models.api import make_concrete_batch as jax_make_concrete_batch  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.checkpoint import load_pytree_auto  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import make_optimizer  # noqa: E402
from repro_torch.models.api import (  # noqa: E402
    get_model,
    make_batch_specs,
    make_concrete_batch,
    param_tree,
)
from _torch_train import one_torch_thread  # noqa: E402,F401 (fixture)

ARCHS = ["falcon-mamba-7b", "granite-3-8b", "chatglm3-6b", "stablelm-12b", "qwen2-vl-2b",
         "deepseek-moe-16b", "moonshot-v1-16b-a3b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
         "whisper-tiny"]


@pytest.mark.parametrize("arch", ["granite-3-8b", "falcon-mamba-7b", "qwen2-vl-2b",
                                  "whisper-tiny"])
def test_train_cli_runs_the_reduced_config_on_the_cpu(arch):
    stats = train_main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                        "--seq", "24"])
    assert len(stats["losses"]) == 3 and all(np.isfinite(stats["losses"]))
    assert stats["n_params"] > 0 and stats["peak_bytes"] is None
    assert len(stats["step_ms"]) == 3 and stats["tok_per_s"] > 0


def test_train_cli_saves_the_trained_parameters(tmp_path):
    stats = train_main(["--arch", "granite-3-8b", "--reduced", "--device", "cpu", "--steps", "2",
                        "--seq", "16", "--ckpt", str(tmp_path)])
    saved = load_pytree_auto(str(tmp_path), "granite-3-8b")
    assert stats["ckpt"].endswith("granite-3-8b.npz")
    cfg = get_config("granite-3-8b").reduced()
    assert set(saved) == set(param_tree(get_model(cfg).init(torch.Generator())))
    assert all(bool(torch.isfinite(torch.as_tensor(v).float()).all()) for v in saved.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_batch_is_the_jax_batch(arch):
    """The same key draws the same train batch in both packages: the specs'
    names, order, shapes and dtypes, and every value bit for bit."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jspecs, specs = jax_make_batch_specs(jcfg, "train", 2, 40), make_batch_specs(cfg, "train", 2,
                                                                                 40)
    assert list(specs) == list(jspecs) and list(specs)[-1] == "labels"
    assert all(specs[k][0] == jspecs[k][0] and str(specs[k][1])[6:] == np.dtype(jspecs[k][1]).name
               for k in specs)
    want = jax_make_concrete_batch(jcfg, "train", 2, 40, jax.random.PRNGKey(5))
    got = make_concrete_batch(cfg, "train", 2, 40, prng.PRNGKey(5))
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16).numpy(), w.view(np.int16)
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=k)


class _NoHostRead(TorchDispatchMode):
    """Fails on the aten ops that read a tensor's value back to the host."""

    BANNED = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED:
            raise AssertionError(f"host read inside a train step: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["granite-3-8b", "falcon-mamba-7b", "deepseek-v2-lite-16b",
                                  "whisper-tiny"])
def test_train_step_reads_nothing_back(arch):
    cfg = get_config(arch).reduced()
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(3e-4, 4)
    state = opt.init(param_tree(model))
    step = bundle.make_train_step(opt)
    batch = make_concrete_batch(cfg, "train", 2, 16, prng.PRNGKey(2))
    before = {k: v.detach().clone() for k, v in param_tree(model).items()}
    with _NoHostRead():
        model, state, loss = step(model, state, batch)
        model, state, loss = step(model, state, batch)
    assert isinstance(loss, torch.Tensor) and loss.shape == () and not loss.requires_grad
    assert any(not torch.equal(before[k], v) for k, v in param_tree(model).items())
