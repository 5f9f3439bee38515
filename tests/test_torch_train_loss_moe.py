"""The port's training loss and its gradients against the JAX reference
on the CPU: the MoE archs, their load-balance loss too.  Inputs, weights and tolerances are
``tests/test_torch_train_loss.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

from test_torch_train_loss import check_loss_and_grads  # noqa: E402

ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
