"""The port's selection-in-the-loop trainer against the JAX reference on
the CPU: ``BatchSelector`` and ``train_loop`` with a DASH selector on
reduced smollm-135m, and the port's own kill-and-resume.

The port starts from the reference's initial state (carried in with
``train_state_from_numpy``) and selects with ``JaxKey``, the port's key
protocol over ``jax.random`` (``split``, ``fold_in``, ``gumbel``,
``normal`` and ``as_array``/``from_array``), so both packages draw the
same projections and the same noise.  Both read the same
``TokenPipeline`` (4 × 32 tokens, pools of 3 × the period's 8
examples).

The ROADMAP's rule for randomized algorithms: the first period's
selection is made from identical parameters on features that agree to
rounding, so its ids must be the reference's; each later period
selects on parameters that have trained apart by rounding, so its ids
must be equal unless the packages' runs part on a decision, and the
losses of every step trained on equal ids must agree within LOSS_RTOL
(readings below).

Tolerances, from readings on the CPU:
  * LOSS_RTOL 1e-5 — each step's loss (6.1 → 5.6): the loop's steps
    add the train step's differences (``tests/test_torch_train_step.py``)
    step after step; readings at most 1.7e-7 relative over 6 steps;
  * TIE_TOL 1e-6 — the spread of the singleton gains that makes TOP-K's
    and greedy's first decisions ties (unit columns: 1/2 each, in f64).
Kill-and-resume replays bit for bit (one process, fixed thread count).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.core import estimators as jest  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxPipeline  # noqa: E402
from repro.data.selection import BatchSelector as JaxSelector  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train.loop import train_loop as jax_train_loop  # noqa: E402
from repro.train.step import init_train_state as jax_init_state  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.core import SeedKey  # noqa: E402
from repro_torch.data import (  # noqa: E402
    BatchSelector,
    DashBatchSelector,
    TokenPipeline,
    make_lm_tokens,
)
from repro_torch.data.selection import backfill  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.runtime import FailureInjector  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402
from repro_torch import train_lm_with_selection  # noqa: E402

LOSS_RTOL = 1e-5
TIE_TOL = 1e-6
ARCH = "smollm-135m"

_split = jax.jit(jax.random.split, static_argnums=1)
_fold = jax.jit(jax.random.fold_in)
_gumbel = jax.jit(jest.gumbel_noise, static_argnums=1)


class JaxKey:
    """The port's key protocol over a raw JAX PRNG key (numpy uint32)."""

    def __init__(self, key):
        self.key = np.asarray(key)

    def split(self, num):
        return [JaxKey(k) for k in np.asarray(_split(self.key, num))]

    def fold_in(self, i):
        return JaxKey(_fold(self.key, i))

    def gumbel(self, n, device):
        return torch.from_numpy(np.array(_gumbel(self.key, n))).to(device)

    def normal(self, shape, device):
        z = np.array(jax.random.normal(self.key, tuple(shape)))
        return torch.from_numpy(z).to(device)

    def as_array(self):
        return self.key.copy()

    @classmethod
    def from_array(cls, a):
        return cls(np.asarray(a, np.uint32))


def _pool(n=40, dim=16, seed=0):
    """Two clusters, as the reference's own selector test."""
    rng = np.random.default_rng(seed)
    shift = np.zeros(dim)
    shift[0] = 5.0
    return np.concatenate([rng.normal(size=(n // 2, dim)) + shift,
                           rng.normal(size=(n // 2, dim)) - shift]
                          ).astype(np.float32)


def aopt_value(X, idx, beta2=1.0, sigma2=1.0):
    """f_A(S) = Tr(Λ⁻¹) − Tr((Λ + σ⁻² X_S X_Sᵀ)⁻¹), Λ = β²I, in f64."""
    X = np.asarray(X, np.float64)
    d = X.shape[0]
    Xs = X[:, np.asarray(idx)]
    M = beta2 * np.eye(d) + Xs @ Xs.T / sigma2
    return d / beta2 - np.trace(np.linalg.inv(M))


@pytest.mark.parametrize("algo,dim,cap", [("dash", 16, 16),
                                          ("dash", 64, 32),
                                          ("greedy", 16, 16),
                                          ("topk", 64, 32),
                                          ("random", 16, 16)])
def test_batch_selector_picks_the_reference_indices(algo, dim, cap):
    """DASH and RANDOM pick the reference's indices.  The selector
    normalizes every example to unit length, so each singleton gain is
    1/2 up to rounding (σ⁻²‖w‖²/(1 + σ⁻²xᵀw) with w = x/β²): TOP-K's
    order and greedy's first pick are ties broken by rounding, where the
    ROADMAP's rule lets the packages part.  For those two the test
    reads the tie (the reference's singleton gains within TIE_TOL of one
    another) and checks the port's set: k distinct rows, both clusters
    covered."""
    feats = _pool(dim=dim)
    key = jax.random.PRNGKey(7)
    opts = {"n_samples": 4} if algo == "dash" else {}
    jsel = JaxSelector(8, algo=algo, embed_dim_cap=cap, **opts)
    want = np.asarray(jsel.select(jnp.asarray(feats), key))
    got = BatchSelector(8, algo=algo, embed_dim_cap=cap, **opts).select(
        torch.from_numpy(feats), JaxKey(key))
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert len(set(got.tolist())) == 8
    if algo in ("greedy", "topk"):
        X = np.asarray(jsel.objective(jnp.asarray(feats),
                                      jax.random.split(key)[0]).X)
        gains = [aopt_value(X, [i]) for i in range(X.shape[1])]
        assert max(gains) - min(gains) <= TIE_TOL
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    if algo != "random":
        assert (want < 20).any() and (want >= 20).any()
        assert (got.numpy() < 20).any() and (got.numpy() >= 20).any()


def test_backfill_is_the_references():
    rng = np.random.default_rng(3)
    for k in (4, 9):
        mask = rng.uniform(size=30) < 0.1
        m = jnp.asarray(mask)
        idx = jnp.nonzero(m, size=k, fill_value=-1)[0]
        filler = jnp.nonzero(~m, size=k, fill_value=0)[0]
        want = np.asarray(jnp.where(idx < 0, filler, idx))
        np.testing.assert_array_equal(
            backfill(torch.from_numpy(mask), k).numpy(), want)


def test_dash_batch_selector_shim():
    sel = DashBatchSelector(6, method="topk")
    assert sel.algo == "topk" and sel.feature_mode == "embed"
    assert sel.algo_opts == {}
    dsel = DashBatchSelector(6)
    assert dsel.algo_opts == {"alpha": 0.5, "eps": 0.25, "n_samples": 6}
    with pytest.raises(ValueError):
        BatchSelector(4, algo="no-such-algorithm")


def _runs(steps=6, every=2, factor=3):
    cfg = get_reduced_config(ARCH)
    jm = jax_build_model(jax_reduced_config(ARCH))
    kw = dict(total_steps=steps, learning_rate=1e-3, warmup_steps=1,
              checkpoint_every=2)
    jt = JaxTrainConfig(**kw)
    toks = make_lm_tokens(1, 60_000, cfg.vocab_size)
    opts = dict(algo="dash", feature_mode="grad", embed_dim_cap=32,
                n_samples=4)
    with JaxPipeline(toks, batch=4, seq=32) as pipe:
        want = jax_train_loop(jm, jt, pipe, selector=JaxSelector(4, **opts),
                              selection_every=every,
                              selection_pool_factor=factor)
    init = jax_init_state(jm, jax.random.PRNGKey(jt.seed), jt)
    state0 = train_state_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, init), "cpu")
    with TokenPipeline(toks, batch=4, seq=32) as pipe:
        got = train_loop(build_model(cfg), TrainConfig(**kw), pipe,
                         device="cpu", selector=BatchSelector(4, **opts),
                         selection_every=every,
                         selection_pool_factor=factor, init_state=state0,
                         sel_key=JaxKey(jax.random.PRNGKey(jt.seed + 1)))
    return want, got


def test_train_loop_matches_jax():
    want, got = _runs()
    assert got.steps_run == want.steps_run == 6 and got.restarts == 0
    assert sorted(got.selections) == sorted(want.selections) == [0, 1, 2]
    np.testing.assert_array_equal(got.selections[0], want.selections[0])
    parted = None
    for period in sorted(want.selections):
        if not np.array_equal(got.selections[period],
                              want.selections[period]):
            parted = period
            break
    # Steps trained on equal selections: losses within LOSS_RTOL.
    last = 6 if parted is None else 2 * parted
    np.testing.assert_allclose(got.losses[:last], want.losses[:last],
                               rtol=LOSS_RTOL)
    assert parted is None, f"period {parted} parted"
    assert len(got.step_seconds) == 6 and len(got.selection_seconds) == 3


def test_kill_and_resume_replays_bitwise(tmp_path):
    """A failure at step 5, inside period 2 (steps 4-5): the resume
    waits for the write in flight and restores step 4's checkpoint (bf16 parameters: smollm's own dtype,
    carried as their bits) and reuses the period's stored selection; the
    losses and every period's selected ids equal the uninterrupted run's
    bit for bit, and so does the final state."""
    cfg = dataclasses.replace(get_reduced_config(ARCH),
                              param_dtype="bfloat16", dtype="bfloat16")
    model = build_model(cfg)
    toks = make_lm_tokens(1, 60_000, cfg.vocab_size)
    tcfg = TrainConfig(total_steps=8, learning_rate=1e-3, warmup_steps=1,
                       checkpoint_every=2)

    def run(ckpt, inject):
        with TokenPipeline(toks, batch=4, seq=32) as pipe:
            sel = BatchSelector(4, algo="dash", feature_mode="grad",
                                embed_dim_cap=32, n_samples=4)
            return train_loop(model, tcfg, pipe, device="cpu",
                              ckpt_dir=ckpt, selector=sel,
                              selection_every=2, selection_pool_factor=3,
                              failure_injector=inject)

    clean = run(str(tmp_path / "clean"), None)
    faulty = run(str(tmp_path / "faulty"), FailureInjector(fail_at=(5,)))
    assert faulty.restarts == 1 and clean.restarts == 0
    assert faulty.losses == clean.losses and len(clean.losses) == 8
    assert sorted(faulty.selections) == sorted(clean.selections)
    for period in clean.selections:
        np.testing.assert_array_equal(faulty.selections[period],
                                      clean.selections[period])
    # the resumed run selected three times (periods 0-2 before the
    # failure, period 3 after it), not again for period 2
    assert len(faulty.selection_seconds) == len(clean.selection_seconds)
    for a, b in zip(tree_leaves(clean.state), tree_leaves(faulty.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_mesh_raises_until_the_sharded_slice():
    """Named from before sharded training was ported; it now checks that
    ``mesh=`` trains on the mesh's device (another ``device=`` raises),
    and that ``--mesh`` trains on spawned ranks (one gloo rank here;
    tests/test_torch_train_loop_sharded.py holds world 4 to the
    reference)."""
    class StubMesh:
        device = torch.device("meta")

    cfg = get_reduced_config(ARCH)
    with pytest.raises(ValueError, match="not the mesh's"):
        train_loop(build_model(cfg), TrainConfig(total_steps=1),
                   lambda s: None, device="cpu", mesh=StubMesh())
    res = launch_train.main(["--arch", ARCH, "--device", "cpu", "--mesh",
                             "--world", "1", "--steps", "2"])
    assert res.steps_run == 2 and np.isfinite(res.losses).all()


def test_entry_points_train_on_the_cpu():
    res = launch_train.main(["--arch", ARCH, "--device", "cpu", "--steps",
                             "4", "--selection"])
    assert res.steps_run == 4 and len(res.selections) == 2
    assert np.isfinite(res.losses).all()
    res = train_lm_with_selection.main(["--device", "cpu", "--steps", "30",
                                        "--assert-improves"])
    assert res.steps_run == 30 and res.losses[-1] < res.losses[0]


def test_seed_key_round_trips_through_an_array():
    k = SeedKey(2 ** 64 - 5, host=True).fold_in(3)
    back = SeedKey.from_array(k.as_array())
    assert back == k and k.as_array().dtype == np.uint64
