"""Training parity of the MoE family (deepseek-moe-16b and moonshot-v1-16b-a3b:
GQA with a dense first layer and capacity-bounded MoE layers whose aux loss
enters the loss at 0.01; deepseek-v2-lite-16b: MLA at the reduced (48, 32)
head dims): the port's loss and every gradient leaf against
``jax.value_and_grad`` of the JAX loss, and three steps of the CLI's
optimizer against the JAX train step, on the same weights and batches
(reduced configs in float32; tolerances and what they allow for in
``tests/_torch_train.py``).
"""

import pytest

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

from _torch_train import check_loss_and_grads, check_train_steps, one_torch_thread  # noqa: E402,F401

ARCHS = ['deepseek-moe-16b', 'moonshot-v1-16b-a3b', 'deepseek-v2-lite-16b']


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    check_train_steps(arch)
