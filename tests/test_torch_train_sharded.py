"""The port's data-parallel train step (``make_train_step(mesh=)``)
against the JAX reference, on the CPU: reduced smollm-135m.

Four gloo ranks on a (data 2, model 2) mesh run 3 steps from the
reference's initial state on seeded 8 × 32-token batches, each rank on
its rows (``shard_batch``), at one and two microbatches (with two, each
rank's microbatch j is its block of the reference's microbatch j).  Each
step's metrics (loss, lm_loss, aux_loss, grad_norm, lr) and the state
after it (parameters, AdamW's master, m and v) are held against the
reference's train step on one device and its step jitted on
``make_mesh((2, 2))`` under ``activation_sharding_ctx`` with batches
sharded over ``data`` (the reference's own sharded training), both run
in one subprocess on forced host devices
(``torch_train_helpers.run_step_cases``).  Every rank must end with the
same bits.  ``tests/test_torch_train_sharded_moe.py`` does the same for
the MoE.

Tolerances, from readings on the CPU (the port against either
reference run; the reference's mesh run against its single-device run
in brackets):
  * METRIC_RTOL 2e-6 — loss, lm_loss, grad_norm and aux_loss, relative
    (readings at most 2.1e-7); the learning rate to LR_RTOL 1e-6;
  * STATE_TOL — each tree's largest |port − reference| over its largest
    entry: m 1e-5 (1.3e-6 [8.0e-7]), v 2e-5 (1.1e-6 [5.5e-7]); the
    master and the parameters in units of the learning rate, STEP_TOL
    1e-3 (3.8e-4 [1.3e-4]), as ``tests/test_torch_train_step.py``.
A planted fault, the first data rank's gradient alone summed, reads
0.99 on m and 2.0 on the parameters after step 1.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_train_helpers as T  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402

STEPS = 3
KW = dict(total_steps=10, learning_rate=2e-3, warmup_steps=1)
CASES = [("smollm", "smollm-135m", dict(KW), 0, None),
         ("smollm_mb2", "smollm-135m", dict(KW, microbatches=2), 0, None)]
FAULT = ("fault", "smollm-135m", dict(KW), 0, "drop")
METRIC_RTOL = 2e-6
LR_RTOL = 1e-6
STATE_TOL = {"m": 1e-5, "v": 2e-5}
STEP_TOL = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    return T.run_step_cases(CASES + [FAULT], STEPS, KW, path)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_step_matches_jax(runs, case):
    ranks, ref = runs
    worst = T.check_case(case[0], case[1], ranks, ref, STEPS, METRIC_RTOL,
                         LR_RTOL)
    for k, tol in STATE_TOL.items():
        assert worst[k] <= tol, worst
    assert worst["params"] <= STEP_TOL and worst["master"] <= STEP_TOL, worst


def test_planted_fault_reads_above_the_tolerance(runs):
    """Only the first data rank's gradient summed: the state after step
    1 parts from the reference's (step 0's learning rate is 0)."""
    ranks, ref = runs
    want = ref["smollm"]["single"]
    errs = T.state_errors(
        ranks[0]["fault"]["states"][1],
        T.port_state(get_reduced_config("smollm-135m"), want["states"][1]),
        want["metrics"][1]["lr"])
    assert errs["m"] > 10 * STATE_TOL["m"], errs
    assert errs["params"] > STEP_TOL, errs
