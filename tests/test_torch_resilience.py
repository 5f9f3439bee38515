"""The port's single-device resilience against the JAX reference, on the
CPU: the checkpoint layer, ``run_with_restart``, the hedged resume, the
straggler simulator, deadlines and ``dash_checkpointed``.

The checkpoint, restart and straggler cases are the reference's own
(``tests/test_resilience.py``: ``TestCheckpointLayer``,
``TestRunWithRestart``, ``TestStragglerSimulation``,
``TestFailureInjectorSharing``, ``TestHedgedResume``,
``TestSelectionDeadline``), run against the port on torch trees.  The
arrival masks are numpy in both packages and must be equal bit for bit.
``dash_checkpointed`` must commit the reference's set under ``JaxKey``
(values within VAL_RTOL 1e-5: f32 sums in another order), its own fused
``dash``'s set, value and trace bit for bit, and the same again after a
kill and a resume.
"""

import importlib
import threading

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import estimators as jest  # noqa: E402
from repro.core import selection_loop as jloop  # noqa: E402
from repro.core.objectives import RegressionObjective as JaxRegression  # noqa: E402
from repro.runtime import straggler as jstraggler  # noqa: E402
from repro_torch.ckpt.checkpoint import (  # noqa: E402
    CheckpointManager,
    checkpoint_steps,
    is_complete,
    latest_complete_step,
    prune_checkpoints,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
    to_host,
)
from repro_torch.core import (  # noqa: E402
    DashConfig,
    Deadline,
    RegressionObjective,
    ResilienceConfig,
    SeedKey,
    SelectionDeadlineExceeded,
    dash,
    dash_checkpointed,
    greedy,
    normalize_columns,
)
from repro_torch.core import selection_loop as tloop  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FailureInjector,
    run_with_restart,
)
from repro_torch.runtime.hedging import (  # noqa: E402
    HedgeExhausted,
    HedgePolicy,
    run_resumable,
)
from repro_torch.runtime.straggler import (  # noqa: E402
    StragglerPolicy,
    arrivals_for_rounds,
    robust_estimate,
    simulate_arrivals,
)

jdash = importlib.import_module("repro.core.dash")

VAL_RTOL = 1e-5
_split = jax.jit(jax.random.split, static_argnums=1)
_gumbel = jax.jit(jest.gumbel_noise, static_argnums=1)


class JaxKey:
    """The port's key interface over a raw JAX PRNG key (numpy uint32)."""

    def __init__(self, key):
        self.key = np.asarray(key)

    def split(self, num):
        return [JaxKey(k) for k in np.asarray(_split(self.key, num))]

    def gumbel(self, n, device):
        return torch.from_numpy(np.array(_gumbel(self.key, n))).to(device)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.tensor(rng.normal(size=(5, 3)), dtype=torch.float32),
        "mask": torch.from_numpy(rng.random(7) > 0.5),
        "count": torch.tensor(4, dtype=torch.int32),
        "key": np.array([2 ** 63 + 5, 9], dtype=np.uint64),
        "nested": (torch.arange(6, dtype=torch.int32),
                   torch.tensor(rng.normal(size=(2,)), dtype=torch.float32)),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_trees_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestCheckpointLayer:
    def test_round_trip_identity(self, tmp_path):
        tree = _tree()
        save_checkpoint(str(tmp_path), 3, tree, extra={"round": 3})
        restored, step = restore_checkpoint(str(tmp_path), tree)
        assert step == 3
        _assert_trees_equal(tree, restored)
        for x, y in zip(_leaves(tree), _leaves(restored)):
            assert type(x) is type(y) and x.dtype == y.dtype

    def test_validation_before_restore_shape(self, tmp_path):
        tree = _tree()
        save_checkpoint(str(tmp_path), 0, tree)
        bad = dict(tree, w=torch.zeros((4, 3)))
        with pytest.raises(ValueError, match="shape"):
            restore_checkpoint(str(tmp_path), bad)

    def test_validation_before_restore_dtype(self, tmp_path):
        tree = _tree()
        save_checkpoint(str(tmp_path), 0, tree)
        bad = dict(tree, count=torch.tensor(4.0))
        with pytest.raises(ValueError, match="dtype"):
            restore_checkpoint(str(tmp_path), bad)

    def test_validation_missing_leaf(self, tmp_path):
        tree = _tree()
        save_checkpoint(str(tmp_path), 0, {"w": tree["w"]})
        with pytest.raises(ValueError, match="missing"):
            restore_checkpoint(str(tmp_path), tree)

    def test_truncated_npz_is_incomplete(self, tmp_path):
        tree = _tree()
        save_checkpoint(str(tmp_path), 1, tree, extra={"round": 1})
        save_checkpoint(str(tmp_path), 2, tree, extra={"round": 2})
        npz = tmp_path / "step_00000002" / "arrays.npz"
        raw = npz.read_bytes()
        npz.write_bytes(raw[: len(raw) // 2])
        assert not is_complete(str(tmp_path), 2)
        assert is_complete(str(tmp_path), 1)
        assert latest_complete_step(str(tmp_path)) == 1
        restored, step = restore_checkpoint(str(tmp_path), tree)
        assert step == 1
        _assert_trees_equal(tree, restored)

    def test_prune_keeps_newest_complete(self, tmp_path):
        tree = _tree()
        for s in range(5):
            save_checkpoint(str(tmp_path), s, tree)
        assert prune_checkpoints(str(tmp_path), keep_last=2) == [0, 1, 2]
        assert checkpoint_steps(str(tmp_path)) == [3, 4]
        assert prune_checkpoints(str(tmp_path), keep_last=0) == [3]
        assert checkpoint_steps(str(tmp_path)) == [4]

    def test_prune_never_drops_restore_target_when_newest_truncated(
            self, tmp_path):
        tree = _tree()
        for s in range(4):
            save_checkpoint(str(tmp_path), s, tree)
        npz = tmp_path / "step_00000003" / "arrays.npz"
        npz.write_bytes(npz.read_bytes()[:50])
        dropped = prune_checkpoints(str(tmp_path), keep_last=1)
        assert 2 not in dropped and 3 not in dropped
        assert latest_complete_step(str(tmp_path)) == 2

    def test_save_with_keep_last_prunes_inline(self, tmp_path):
        for s in range(6):
            save_checkpoint(str(tmp_path), s, _tree(), keep_last=3)
        assert checkpoint_steps(str(tmp_path)) == [3, 4, 5]

    def test_manifest_extra_round_trips(self, tmp_path):
        save_checkpoint(str(tmp_path), 7, _tree(),
                        extra={"round": 7, "algo": "dash", "n": 64})
        m = read_manifest(str(tmp_path), 7)
        assert m["extra"] == {"round": 7, "algo": "dash", "n": 64}
        assert m["leaves"]["nested/1"] == {"shape": [2], "dtype": "float32"}

    def test_manager_writes_host_copies_async(self, tmp_path):
        """The writer thread gets numpy copies: a tensor changed after
        ``maybe_save`` returns does not change the snapshot."""
        tree = _tree()
        mgr = CheckpointManager(str(tmp_path), every=2, keep=2)
        for step in range(6):
            mgr.maybe_save(step, tree)
            tree["w"] += 1.0
        mgr.wait()
        assert checkpoint_steps(str(tmp_path)) == [2, 4]
        restored, step = restore_checkpoint(str(tmp_path), tree)
        assert step == 4
        want = _tree()["w"]
        for _ in range(4):
            want += 1.0
        np.testing.assert_array_equal(restored["w"].numpy(), want.numpy())
        host = to_host(tree)
        assert isinstance(host["nested"][0], np.ndarray)


class TestRunWithRestart:
    def _harness(self, ckpt_every=1):
        saved, fired = {}, []

        def make_state():
            return 0, 0

        def restore():
            if not saved:
                return None
            step = max(saved)
            return saved[step], step

        def step_fn(state, step):
            return state + step

        def on_step(state, step):
            fired.append(step)
            if (step + 1) % ckpt_every == 0:
                saved[step + 1] = state

        return saved, fired, make_state, restore, step_fn, on_step

    @pytest.mark.parametrize("every,fail,total", [(1, 3, 6), (3, 5, 7)])
    def test_on_step_fires_at_most_once_per_index(self, every, fail, total):
        """Killed at step ``fail``; the steps replayed after the restore
        do not fire ``on_step`` again."""
        _, fired, mk, rs, st, on = self._harness(ckpt_every=every)
        inj = FailureInjector(fail_at=(fail,))

        def step_fn(state, step):
            inj.check(step)
            return st(state, step)

        out = run_with_restart(total_steps=total, make_state=mk, restore=rs,
                               step_fn=step_fn, on_step=on)
        assert out == sum(range(total))
        assert fired == list(range(total))

    def test_cold_restart_path(self):
        _, fired, _, rs, st, on = self._harness(ckpt_every=10)
        inj = FailureInjector(fail_at=(2,))
        makes = []

        def make_state():
            makes.append(1)
            return 0, 0

        def step_fn(state, step):
            inj.check(step)
            return st(state, step)

        out = run_with_restart(total_steps=5, make_state=make_state,
                               restore=rs, step_fn=step_fn, on_step=on)
        assert out == sum(range(5)) and len(makes) == 2
        assert fired == list(range(5))

    def test_backoff_sequence(self):
        sleeps = []
        inj = FailureInjector(fail_at=(1, 2, 3))
        run_with_restart(
            total_steps=5, make_state=lambda: (0, 0), restore=lambda: None,
            step_fn=lambda s, i: (inj.check(i), s)[1],
            backoff_s=0.5, sleep_fn=sleeps.append)
        assert sleeps == [0.5, 1.0, 2.0]

    def test_max_failures_exceeded_raises(self):
        class AlwaysDies(Exception):
            pass

        def step_fn(state, step):
            raise AlwaysDies()

        with pytest.raises(AlwaysDies):
            run_with_restart(total_steps=3, make_state=lambda: (0, 0),
                             restore=lambda: None, step_fn=step_fn,
                             max_failures=2)

    def test_fatal_passthrough(self):
        class Hopeless(Exception):
            pass

        def step(state, s):
            raise Hopeless()

        with pytest.raises(Hopeless):
            run_with_restart(total_steps=3, make_state=lambda: (0, 0),
                             restore=lambda: None, step_fn=step,
                             max_failures=5, fatal=(Hopeless,))


class TestFailureInjector:
    def test_shared_instance_fires_each_step_once(self):
        inj = FailureInjector(fail_at=(2,))
        with pytest.raises(RuntimeError):
            inj.check(2)
        inj.check(2)

    def test_fork_gives_independent_schedules(self):
        parent = FailureInjector(fail_at=2)
        a, b = parent.fork(), parent.fork()
        for inj in (a, b, parent):
            with pytest.raises(RuntimeError):
                inj.check(2)
        a.check(2)
        b.check(2)

    def test_concurrent_checks_fire_exactly_once(self):
        inj = FailureInjector(fail_at=(1,))
        raised = []
        barrier = threading.Barrier(8)

        def worker():
            barrier.wait()
            try:
                inj.check(1)
            except RuntimeError:
                raised.append(1)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert len(raised) == 1


class TestHedgedResume:
    POLICY = HedgePolicy(max_attempts=3, backoff_s=0.0,
                         sleep_fn=lambda s: None)

    @pytest.mark.parametrize("fail,total", [(3, 5), (0, 3)])
    def test_resumes_from_newest_boundary(self, fail, total):
        """A kill at step 3 replays only 3 and 4; a kill before the first
        boundary restarts cold.  Either way each step runs once."""
        inj = FailureInjector(fail_at=(fail,))
        executed = []

        def step(state, s):
            inj.check(s)
            executed.append(s)
            return state + s

        out, attempts = run_resumable(total, 0, step, policy=self.POLICY)
        assert out == sum(range(total)) and attempts == 2
        assert executed == list(range(total))

    def test_exhaustion_raises_hedge_exhausted(self):
        def step(state, s):
            raise RuntimeError("dead")

        with pytest.raises(HedgeExhausted, match="2 attempts"):
            run_resumable(3, 0, step, policy=HedgePolicy(
                max_attempts=2, backoff_s=0.0, sleep_fn=lambda s: None))

    def test_fatal_exceptions_propagate_unretried(self):
        calls = []

        def step(state, s):
            calls.append(s)
            raise SelectionDeadlineExceeded(s)

        with pytest.raises(SelectionDeadlineExceeded):
            run_resumable(3, 0, step, policy=self.POLICY,
                          fatal=(SelectionDeadlineExceeded,))
        assert calls == [0]


class TestStragglerSimulation:
    @pytest.mark.parametrize("seed,rnd,reps,drop,least", [
        (11, 4, 16, 0.5, 1), (0, 0, 8, 1.0, 2), (3, 7, 5, 0.2, 1)])
    def test_arrivals_equal_reference(self, seed, rnd, reps, drop, least):
        got = simulate_arrivals(seed, rnd, reps, drop, min_arrived=least)
        want = jstraggler.simulate_arrivals(seed, rnd, reps, drop,
                                            min_arrived=least)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)
        assert int(got.sum()) >= least
        np.testing.assert_array_equal(
            arrivals_for_rounds(seed, 6, reps, drop, min_arrived=least),
            jstraggler.arrivals_for_rounds(seed, 6, reps, drop,
                                           min_arrived=least))

    def test_rounds_differ(self):
        rounds = arrivals_for_rounds(11, 8, 16, 0.5)
        assert rounds.shape == (8, 16)
        assert len({tuple(r) for r in rounds}) > 1
        pol = StragglerPolicy()
        assert pol.replicas_to_request(8) == 12
        assert pol.replicas_to_request(2) == 4

    @pytest.mark.parametrize("vals,arrived", [
        ([5.0, 5.0, 5.0, 5.0, 5.0, 5.0, 1e9, float("nan")],
         [1, 1, 1, 1, 1, 1, 0, 0]),
        ([1.0, 2.0, 7.0, 4.0, -3.0, 0.5, 9.0, 2.5], [1, 0, 1, 1, 1, 0, 1, 1]),
        ([1.0, 2.0, 3.0, 4.0], [0, 0, 0, 0]),
    ])
    def test_robust_estimate_matches_reference(self, vals, arrived):
        """Only arrived values count (the garbage in a missing slot does
        not leak in); the same estimate as the reference's."""
        pol = StragglerPolicy(trim_frac=0.125)
        got = float(robust_estimate(torch.tensor(vals),
                                    torch.tensor(arrived, dtype=torch.bool),
                                    pol))
        want = float(jstraggler.robust_estimate(
            jnp.asarray(vals), jnp.asarray(arrived, bool), pol))
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# dash_checkpointed
# ---------------------------------------------------------------------------

def _problem():
    """The reference's kill-and-resume problem (d 64, n 48, k 6)."""
    rng = np.random.default_rng(0)
    d, n, k = 64, 48, 6
    X0 = rng.normal(size=(d, n)) + 0.3 * rng.normal(size=(d, 1))
    X = normalize_columns(torch.tensor(X0, dtype=torch.float32)).numpy()
    w = np.zeros(n)
    w[:k] = rng.uniform(-2, 2, k)
    y = (X0 @ w + 0.1 * rng.normal(size=d)).astype(np.float32)
    obj = RegressionObjective(X, y, k, device="cpu")
    cfg = DashConfig(k=k, eps=0.25, alpha=0.6, n_samples=4)
    opt = float(greedy(obj, k, device="cpu").value) * 1.05
    return obj, cfg, opt, X, y


def _same_run(a, b):
    assert torch.equal(a.sel_mask, b.sel_mask)
    assert float(a.value) == float(b.value)
    for f in a.trace._fields:
        assert torch.equal(getattr(a.trace, f), getattr(b.trace, f)), f


def test_checkpointed_matches_reference_set():
    obj, cfg, opt, X, y = _problem()
    jobj = JaxRegression(jnp.asarray(X), jnp.asarray(y), kmax=6)
    key = jax.random.PRNGKey(0)
    jcfg = jloop.DashConfig(k=6, eps=0.25, alpha=0.6, n_samples=4)
    want = jdash.dash_checkpointed(jobj, jcfg, key, opt,
                                   resilience=jloop.ResilienceConfig())
    got = dash_checkpointed(obj, cfg, JaxKey(key), opt,
                            resilience=ResilienceConfig(), device="cpu")
    np.testing.assert_array_equal(got.sel_mask.numpy(),
                                  np.asarray(want.sel_mask))
    np.testing.assert_array_equal(got.trace.filter_iters.numpy(),
                                  np.asarray(want.trace.filter_iters))
    np.testing.assert_allclose(float(got.value), float(want.value),
                               rtol=VAL_RTOL)


@pytest.mark.parametrize("async_save", [False, True])
def test_stepped_matches_fused_and_survives_kill(tmp_path, async_save):
    obj, cfg, opt, _, _ = _problem()
    key = SeedKey(0)
    fused = dash(obj, cfg, key, opt, device="cpu")
    stepped = dash_checkpointed(obj, cfg, key, opt,
                                resilience=ResilienceConfig(), device="cpu")
    _same_run(fused, stepped)
    res = ResilienceConfig(ckpt_dir=str(tmp_path), every=1,
                           async_save=async_save)
    with pytest.raises(RuntimeError, match="injected"):
        dash_checkpointed(obj, cfg, key, opt, resilience=res,
                          failure_injector=FailureInjector(fail_at=(2,)),
                          device="cpu")
    assert latest_complete_step(str(tmp_path)) == 2
    resumed = dash_checkpointed(obj, cfg, key, opt, resilience=res,
                                resume=True, device="cpu")
    _same_run(stepped, resumed)


def test_run_with_restart_resumes_dash(tmp_path):
    """The restart loop around a kill at round ⌊r/2⌋: the selection
    resumes from the newest snapshot and equals the uninterrupted run."""
    obj, cfg, opt, _, _ = _problem()
    r = cfg.resolve(obj.n).r
    res = ResilienceConfig(ckpt_dir=str(tmp_path), every=1)
    whole = dash(obj, cfg, SeedKey(3), opt, device="cpu")
    inj = FailureInjector(fail_at=(r // 2,))
    attempts = []

    def step_fn(state, step):
        attempts.append(step)
        return dash_checkpointed(obj, cfg, SeedKey(3), opt, resilience=res,
                                 resume=step > 0 or bool(attempts[:-1]),
                                 failure_injector=inj, device="cpu")

    out = run_with_restart(total_steps=1, make_state=lambda: (None, 0),
                           restore=lambda: None, step_fn=step_fn)
    assert len(attempts) == 2
    _same_run(whole, out)


def test_keep_last_retention_and_key_snapshot(tmp_path):
    obj, cfg, opt, _, _ = _problem()
    res = ResilienceConfig(ckpt_dir=str(tmp_path), every=1, keep_last=2,
                           async_save=False)
    dash_checkpointed(obj, cfg, SeedKey(2 ** 64 - 3, host=True), opt,
                      resilience=res, device="cpu")
    steps = checkpoint_steps(str(tmp_path))
    assert len(steps) == 2 and steps[-1] == cfg.resolve(obj.n).r
    carry = tloop.initial_carry(cfg.resolve(obj.n), [SeedKey(1)],
                                obj.init(1), torch.ones((1, obj.n),
                                                        dtype=torch.bool))
    snap, rounds = tloop.restore_carry(str(tmp_path), carry)
    assert rounds == steps[-1] and isinstance(snap.key[0], SeedKey)
    assert snap.key[0].host
    m = read_manifest(str(tmp_path), steps[-1])
    assert m["leaves"]["key/seed"]["dtype"] == "uint64"


def test_key_without_snapshot_form_raises_before_round_zero(tmp_path):
    obj, cfg, opt, _, _ = _problem()
    res = ResilienceConfig(ckpt_dir=str(tmp_path))
    inj = FailureInjector(fail_at=(0,))
    with pytest.raises(TypeError, match="snapshot"):
        dash_checkpointed(obj, cfg, JaxKey(jax.random.PRNGKey(0)), opt,
                          resilience=res, failure_injector=inj, device="cpu")
    assert checkpoint_steps(str(tmp_path)) == []
    with pytest.raises(RuntimeError, match="injected"):  # not yet consumed
        inj.check(0)


def test_deadline_raises_with_carry():
    obj, cfg, opt, _, _ = _problem()
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    with pytest.raises(SelectionDeadlineExceeded) as ei:
        dash_checkpointed(obj, DashConfig(k=6, r=4, n_samples=4), SeedKey(0),
                          0.8, resilience=ResilienceConfig(),
                          deadline=Deadline(2.5, clock=clock), device="cpu")
    assert ei.value.rounds_done >= 1 and ei.value.carry is not None
    with pytest.raises(SelectionDeadlineExceeded) as ei:
        dash_checkpointed(obj, cfg, SeedKey(0), opt,
                          resilience=ResilienceConfig(),
                          deadline=Deadline(0.0), device="cpu")
    assert ei.value.rounds_done == 0
    assert isinstance(ei.value.carry, tloop.SelectionCarry)


@pytest.mark.parametrize("async_save", [False, True])
def test_failed_round_write_raises(tmp_path, async_save):
    """A round snapshot that cannot be written raises from the
    checkpointed run; blocking, at its save, async, at the next wait,
    where ``raise_errors=False`` keeps the error for the call after."""
    obj, cfg, opt, _, _ = _problem()
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    res = ResilienceConfig(ckpt_dir=str(blocker / "ckpt"),
                           async_save=async_save)
    with pytest.raises(OSError):
        dash_checkpointed(obj, cfg, SeedKey(0), opt, resilience=res,
                          device="cpu")
    ckpt = tloop.RoundCheckpointer(res)
    carry = tloop.initial_carry(cfg.resolve(obj.n), [SeedKey(1)],
                                obj.init(1), torch.ones((1, obj.n),
                                                        dtype=torch.bool))
    if async_save:
        ckpt.save(1, carry)
        ckpt.wait(raise_errors=False)
        with pytest.raises(OSError):
            ckpt.wait()
    else:
        with pytest.raises(OSError):
            ckpt.save(1, carry)
    ckpt.wait()                     # reported once


def test_blocking_save_on_an_async_config_is_on_disk_at_return(
        tmp_path, monkeypatch):
    """``RoundCheckpointer.save(blocking=True)`` on an ``async_save``
    config has written its snapshot when it returns, as the reference's
    does; a save without it has not (the writer is slowed down)."""
    import time as _time

    import repro.ckpt.checkpoint as jckpt
    import repro_torch.ckpt.checkpoint as tckpt

    def slow(real):
        def save(*a, **kw):
            _time.sleep(0.3)
            return real(*a, **kw)
        return save

    monkeypatch.setattr(jckpt, "save_checkpoint", slow(jckpt.save_checkpoint))
    monkeypatch.setattr(tckpt, "save_checkpoint", slow(tckpt.save_checkpoint))
    obj, cfg, _, _, _ = _problem()
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jck = jloop.RoundCheckpointer(jloop.ResilienceConfig(
        ckpt_dir=jdir, async_save=True))
    jck.save(1, {"x": jnp.arange(4)}, blocking=True)
    assert jckpt.latest_complete_step(jdir) == 1
    ck = tloop.RoundCheckpointer(ResilienceConfig(ckpt_dir=tdir,
                                                  async_save=True))
    carry = tloop.initial_carry(cfg.resolve(obj.n), [SeedKey(1)],
                                obj.init(1), torch.ones((1, obj.n),
                                                        dtype=torch.bool))
    ck.save(1, carry, blocking=True)
    assert latest_complete_step(tdir) == 1
    ck.save(2, carry)
    assert latest_complete_step(tdir) == 1
    ck.wait()
    assert latest_complete_step(tdir) == 2
