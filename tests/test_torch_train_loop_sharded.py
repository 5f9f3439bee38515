"""The port's data-parallel training loop (``train_loop(mesh=)``) with
DASH selection in the loop against the JAX reference, on the CPU.

Four gloo ranks on a (data 2, model 2) mesh train reduced smollm-135m
for 4 steps from the reference's initial state, selecting every 2 steps
a coreset of 8 from pools of 24 (DASH on grad features, 4 samples, the
selection's columns sharded over ``model``; keys through ``JaxKey``, the
reference's ``jax.random``), beside the reference's ``train_loop(mesh=
make_mesh((2, 2)))`` in a subprocess on forced host devices (inside
``with mesh``: its sharding constraints take bare ``PartitionSpec``s,
which this JAX resolves only against a context mesh).  Each rank
computes the features of its 12 rows of a pool and all-gathers them.

* Selections and losses: period 0 selects from identical parameters on
  features that agree to rounding, so its ids must be the reference's;
  each later period's ids must be equal unless the packages' runs part
  on a decision (the ROADMAP's rule), and the losses of every step
  trained on equal ids must agree within LOSS_RTOL 1e-5, relative
  (readings below; ``tests/test_torch_train_loop.py``'s single-device
  gate).
* Kill and resume: the run killed at step 3 and resumed from its step-2
  checkpoint equals the uninterrupted run bit for bit (losses, every
  period's ids, the final state on every rank).
* Another world: the uninterrupted run's checkpoints cut back to step 2
  and restored on a world-2 (data 1, model 2) mesh of ranks 0 and 1
  resume at step 3 (the last): a finite loss within LOSS_RTOL of the
  world-4 run's.

Readings on the CPU: losses against the reference at most 8.2e-8
relative; the world-2 resume's step 3 8.2e-8.  A planted fault, the
first batch taken one pool row off the reference's period-0 ids, moves
the step-0 loss by 2.9e-2 (the port's loss on the right rows reads
7.8e-8).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dist_helpers as H  # noqa: E402
import torch_train_helpers as T  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402

LOSS_RTOL = 1e-5
SEED = TrainConfig().seed + 1

REFERENCE = """
import os, pickle
import torch_train_helpers as T
from repro.configs import TrainConfig, get_reduced_config
from repro.data.pipeline import TokenPipeline
from repro.data.selection import BatchSelector
from repro.data.synthetic import make_lm_tokens
from repro.models import build_model
from repro.train.loop import train_loop
from repro.train.step import init_train_state

cfg = get_reduced_config(T.LOOP_ARCH)
model = build_model(cfg)
tcfg = TrainConfig(**T.LOOP)
init = init_train_state(model, jax.random.PRNGKey(tcfg.seed), tcfg)
with open({path!r} + ".tmp", "wb") as f:
    pickle.dump(T.plain_state(jax.tree_util.tree_map(np.asarray, init)), f)
os.replace({path!r} + ".tmp", {path!r} + ".init")
mesh = make_mesh((2, 2), ("data", "model"))
# The reference's constraints take bare PartitionSpecs, which this JAX
# resolves against the context mesh only: enter it.
with mesh, TokenPipeline(make_lm_tokens(1, 60_000, cfg.vocab_size),
                         batch=T.BATCH, seq=T.SEQ) as pipe:
    res = train_loop(model, tcfg, pipe, mesh=mesh,
                     selector=BatchSelector(T.BATCH, **T.SELECT),
                     selection_every=T.EVERY,
                     selection_pool_factor=T.FACTOR)
print(json.dumps({{"losses": res.losses, "selections": {{
    str(p): [int(i) for i in v] for p, v in res.selections.items()}}}}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import pickle
    import time

    root = tmp_path_factory.mktemp("loop")
    path = str(root / "ref.pkl")
    proc = H.start_reference(REFERENCE.format(path=path))
    deadline = time.monotonic() + H.REFERENCE_TIMEOUT_S
    while not (root / "ref.pkl.init").exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            H.finish_reference(proc)
            raise RuntimeError("the reference wrote no initial state")
        time.sleep(0.1)
    with open(path + ".init", "rb") as f:
        state0 = pickle.load(f)
    ranks = H.launch(T.loop_rank, 4, state0, SEED, str(root))
    ref = H.finish_reference(proc)
    ref["selections"] = {int(p): np.asarray(v)
                         for p, v in ref["selections"].items()}
    return ranks, ref, state0


def first_parted(got, want):
    for p in sorted(want):
        if not np.array_equal(got[p], want[p]):
            return p
    return None


def test_selections_and_losses_match_jax(runs):
    ranks, ref, _ = runs
    got = ranks[0]["clean"]
    assert got["steps_run"] == 4 and got["restarts"] == 0
    assert sorted(got["selections"]) == sorted(ref["selections"]) == [0, 1]
    np.testing.assert_array_equal(got["selections"][0], ref["selections"][0])
    parted = first_parted(got["selections"], ref["selections"])
    last = 4 if parted is None else T.EVERY * parted
    np.testing.assert_allclose(got["losses"][:last], ref["losses"][:last],
                               rtol=LOSS_RTOL)
    assert parted is None, f"period {parted} parted"
    for r in ranks[1:]:                        # every rank the same run
        assert r["clean"]["digest"] == got["digest"]
        assert r["clean"]["losses"] == got["losses"]
        for p, v in got["selections"].items():
            np.testing.assert_array_equal(r["clean"]["selections"][p], v)


def test_kill_and_resume_is_bitwise(runs):
    ranks, _, _ = runs
    for r in ranks:
        clean, killed = r["clean"], r["killed"]
        assert killed["restarts"] == 1 and clean["restarts"] == 0
        assert killed["losses"] == clean["losses"]
        assert killed["digest"] == clean["digest"]
        assert sorted(killed["selections"]) == sorted(clean["selections"])
        for p, v in clean["selections"].items():
            np.testing.assert_array_equal(killed["selections"][p], v)
        # the resume reused period 1's stored ids: 2 selections, not 3
        assert killed["selection_seconds"] == clean["selection_seconds"] == 2


def test_world4_checkpoint_resumes_at_world2(runs):
    ranks, _, _ = runs
    clean = ranks[0]["clean"]
    for r in ranks[:2]:
        w2 = r["world2"]
        assert w2["steps_run"] == 4 - (T.RESUME_FROM + 1) == 1
        assert np.isfinite(w2["losses"]).all()
        np.testing.assert_allclose(w2["losses"][0],
                                   clean["losses"][T.RESUME_FROM + 1],
                                   rtol=LOSS_RTOL)
    assert "world2" not in ranks[2] and "world2" not in ranks[3]


def test_planted_fault_reads_above_the_tolerance(runs):
    """The loss of the initial state on a period's first batch against
    the batch of the same pool shifted by one row."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model

    _, ref, state0 = runs
    cfg = get_reduced_config(T.LOOP_ARCH)
    params = T.port_state(cfg, state0).params
    model = build_model(cfg)
    with TokenPipeline(T.loop_tokens(cfg.vocab_size), batch=T.BATCH,
                       seq=T.SEQ) as pipe:
        pool, ids = pipe.pool_for_step(0, T.BATCH * T.EVERY * T.FACTOR)
    rows = np.asarray([list(ids).index(i)
                       for i in ref["selections"][0][:T.BATCH]])

    def loss(r):
        return float(model.loss(params, {"tokens": torch.from_numpy(
            pool["tokens"][r])})[0])

    assert abs(loss(rows) - ref["losses"][0]) / ref["losses"][0] <= LOSS_RTOL
    moved = (rows + 1) % len(pool["tokens"])
    assert abs(loss(moved) - loss(rows)) / loss(rows) > 100 * LOSS_RTOL
