"""The port's data-parallel train step on the MoE against the JAX
reference, on the CPU: reduced grok-1 with ``moe_groups`` 0 and 2.

As ``tests/test_torch_train_sharded.py`` (four gloo ranks, mesh (data 2,
model 2), 3 steps, the reference on one device and on ``make_mesh((2,
2))``), on the MoE, whose dispatch couples the rows: with ``moe_groups``
0 each rank places its assignments after the earlier ranks' (the
reference's one global dispatch), with 2 each data rank holds one whole
group; the aux loss is the global batch's on every rank.

Tolerances, from readings on the CPU (the port against either reference
run; the reference's mesh run against its single-device run in
brackets): METRIC_RTOL 2e-6 on the metrics, aux_loss included
(readings at most 3.2e-7); m 1e-5 (1.8e-6 [7.3e-7]), v 2e-5 (2.4e-6
[1.2e-6]); the master and the parameters STEP_TOL 5e-3 of the learning
rate (2.0e-3 [9.8e-4]: Adam's first steps divide by |g|, and the
router's and the dropped experts' small gradients part the most, in
the reference's own two runs too).  The port's global dispatch held to
the reference's grouped one reads above STEP_TOL: the check tells the
two dispatches apart.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_train_helpers as T  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402

STEPS = 3
KW = dict(total_steps=10, learning_rate=2e-3, warmup_steps=1)
CASES = [("grok_g0", "grok-1-314b", dict(KW), 0, None),
         ("grok_g2", "grok-1-314b", dict(KW), 2, None)]
METRIC_RTOL = 2e-6
LR_RTOL = 1e-6
STATE_TOL = {"m": 1e-5, "v": 2e-5}
STEP_TOL = 5e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    return T.run_step_cases(CASES, STEPS, KW, path)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_moe_step_matches_jax(runs, case):
    ranks, ref = runs
    worst = T.check_case(case[0], case[1], ranks, ref, STEPS, METRIC_RTOL,
                         LR_RTOL)
    for k, tol in STATE_TOL.items():
        assert worst[k] <= tol, worst
    assert worst["params"] <= STEP_TOL and worst["master"] <= STEP_TOL, worst
    assert all(m["aux_loss"] > 0 for m in ranks[0][case[0]]["metrics"])


def test_dispatch_modes_are_told_apart(runs):
    """The port's moe_groups 0 run against the reference's moe_groups 2
    run: capacity drops other assignments, and the states part above
    STEP_TOL."""
    ranks, ref = runs
    want = ref["grok_g2"]["single"]
    errs = T.state_errors(
        ranks[0]["grok_g0"]["states"][1],
        T.port_state(get_reduced_config("grok-1-314b"), want["states"][1]),
        want["metrics"][1]["lr"])
    assert errs["params"] > STEP_TOL, errs
