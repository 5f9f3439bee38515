"""The port's tensor parallelism over ``model`` on the MoE: the training
loss and its gradients against the JAX reference's single-device
``jax.value_and_grad(model.loss)``, on the CPU, for the reduced
llama4-maverick (4 experts over a ``model`` axis of 2: expert parallel)
and a reduced grok-1 of 3 experts (d_ff split inside every expert), at
meshes (data 1, model 2) and (data 2, model 2).  The cases, gates and
readings are ``tests/test_torch_tp_loss.py``'s."""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

from test_torch_tp_loss import SHAPES, check, run_cases  # noqa: E402

NAMES = ["llama4", "grok_dff"]


@pytest.fixture(scope="module")
def runs():
    return run_cases(NAMES)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradient_shards_match_jax(runs, shape, name):
    check(runs, shape, name)
