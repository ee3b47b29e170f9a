"""Training parity of the dense GQA decoders (granite-3-8b; chatglm3-6b's half
RoPE; stablelm-12b; qwen2-vl-2b's M-RoPE and vision stub, whose prefix
logits are cut off) and the encoder-decoder whisper-tiny (non-causal
attention gradients in its encoder and cross-attention): the port's loss and
every gradient leaf against ``jax.value_and_grad`` of the JAX loss, and
three steps of the CLI's optimizer against the JAX train step, on the same
weights and batches (reduced configs in float32; tolerances and what they
allow for in ``tests/_torch_train.py``).
"""

import pytest

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

from _torch_train import check_loss_and_grads, check_train_steps, one_torch_thread  # noqa: E402,F401

ARCHS = ['granite-3-8b', 'chatglm3-6b', 'stablelm-12b', 'qwen2-vl-2b', 'whisper-tiny']


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    check_train_steps(arch)


def test_granite_bf16_loss_and_grads_match_jax():
    """The config's own dtype: every gradient leaf within 2^-5 of its max
    (measured 0.0194, granite's ``norm1``, both before and after the bf16
    backward rounded P and dS to bf16 at the wgmma kernel's points; the
    next leaves moved by up to 1.6e-3)."""
    check_loss_and_grads("granite-3-8b", "bfloat16")
