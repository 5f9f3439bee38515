"""The port's training loss and its gradients against the JAX reference
on the CPU: xlstm-125m (the mLSTM's chunk loop and the sLSTM's time loop
differentiated through), at ``XLSTM_GRAD_TOL``.  Inputs, weights and
tolerances are ``tests/test_torch_train_loss.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

from test_torch_train_loss import check_loss_and_grads  # noqa: E402


def test_loss_and_grads_match_jax_xlstm():
    check_loss_and_grads("xlstm-125m")
