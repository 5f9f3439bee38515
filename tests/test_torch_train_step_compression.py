"""The port's train step against the JAX reference on the CPU, part 2:
the compressed step on the reference's own gradients, and the planted
fault that the state tolerances must see.  Setup and tolerances are
``tests/test_torch_train_step.py``'s.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import numpy as np  # noqa: E402

from test_torch_train_step import (  # noqa: E402
    METRIC_RTOL,
    SAME_GRADS_STEP_TOL,
    SAME_GRADS_TOL,
    STEP_TOL,
    run_both,
    state_errors,
)


def test_planted_fault_reads_above_the_state_tolerance():
    """The port's learning rate 1 % high: every step's parameters move
    about 1e-2 of a step apart."""
    jmet, tmet, want, got = run_both({}, steps=2, lr_scale=1.01)[-1]
    assert state_errors(got, want, jmet["lr"])["params"] > 10 * STEP_TOL


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compressed_step_on_the_reference_gradients(scheme):
    """Three compressed steps of the port's train step fed the
    reference's gradients (``loss_and_grads`` replaced): the same
    compressor inputs make the same decisions, so the error feedback, m
    and v agree to SAME_GRADS_TOL of their largest entries and the
    parameters to SAME_GRADS_STEP_TOL of the learning rate."""
    steps = run_both({"grad_compression": scheme}, same_grads=True)
    assert len(steps) == 3
    for jmet, tmet, want, got in steps:
        np.testing.assert_allclose(tmet["grad_norm"], jmet["grad_norm"],
                                   rtol=METRIC_RTOL)
        errs = state_errors(got, want, jmet["lr"] or 1.0)
        for k in ("m", "v", "error_fb"):
            assert errs[k] <= SAME_GRADS_TOL, (k, errs)
        for k in ("params", "master"):
            assert errs[k] <= SAME_GRADS_STEP_TOL, (k, errs)
