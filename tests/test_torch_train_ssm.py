"""Training parity of the Mamba stacks (falcon-mamba-7b; the hybrid
jamba-v0.1-52b, Mamba and attention layers with MoE and dense FFNs), whose
scans train through models.ssm_vjp.selective_scan: the port's loss and every
gradient leaf against ``jax.value_and_grad`` of the JAX loss, and three
steps of the CLI's optimizer against the JAX train step, on the same weights
and batches (reduced configs in float32; tolerances and what they allow for
in ``tests/_torch_train.py``).
"""

import pytest

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

from _torch_train import check_loss_and_grads, check_train_steps, one_torch_thread  # noqa: E402,F401

ARCHS = ['falcon-mamba-7b', 'jamba-v0.1-52b']


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch):
    check_train_steps(arch)
