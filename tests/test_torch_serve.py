"""The port's selection service (``repro_torch.serve``) against the JAX
reference's (``repro.serve``), on the CPU.

Parity: the same offered load (``tests/test_serve.py``'s data, D, N,
KMAX = 60, 40, 8) goes through both servers, each with its own copy of
one stepping fake clock and the port's keys wrapped around the
reference's (``JaxKey``), with and without a chaos schedule.  The
replies agree field by field — status, tier, degraded, ``sel_idx``,
``sel_count``, attempts, ``retry_after_s``, latency and detail —
values within VAL_RTOL 1e-5 (f32 sums in another order), and the
servers' ``stats`` are equal.  Fingerprints are the reference's strings
after ``register`` (float64 and int64 inputs included) and after
``update_columns``.

The rest are the port's counterparts of ``tests/test_serve.py``'s
validation, admission, serving, chaos and cache cases, of the serve
properties of ``tests/test_property.py`` (few examples), the entry point
``python -m repro_torch.serve_selection --device cpu``, and a check that
the service imports neither JAX nor ``repro``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_dist_helpers as H  # noqa: E402
from repro_torch.core import (  # noqa: E402
    RegressionObjective,
    SeedKey,
    select,
    stochastic_greedy,
    top_k_select,
)
from repro_torch.runtime.fault_tolerance import FailureInjector  # noqa: E402
from repro_torch.runtime.hedging import HedgePolicy  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    FAILED,
    OK,
    REJECTED,
    AdmissionController,
    AdmissionPolicy,
    LatencyModel,
    SelectionServer,
    SelectRequest,
    bucket_key,
    build_single_shot,
    chained_fingerprint,
    fingerprint_arrays,
    padded_batch,
)

REPO = Path(__file__).resolve().parent.parent
D, N, KMAX = 60, 40, 8
NOSLEEP = HedgePolicy(max_attempts=4, backoff_s=0.0, sleep_fn=lambda s: None)
VAL_RTOL, VAL_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(D, N)).astype(np.float32)
    y = rng.normal(size=(D,)).astype(np.float32)
    return X, y


def make_server(data, **kw):
    srv = SelectionServer(hedge=kw.pop("hedge", NOSLEEP), device="cpu",
                          **kw)
    srv.register("toy", "regression", data[0], data[1], kmax=KMAX)
    return srv


def _obj(data):
    return RegressionObjective(data[0], data[1], KMAX, device="cpu")


# ---------------------------------------------------------------------------
# parity with the reference service
# ---------------------------------------------------------------------------

def _stepping_clock():
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    return clock


def _parity_load(key):
    """Deadline-degraded requests, a padded DASH bucket with a shed
    request, a second k, stochastic greedy, TOP-k and shedding at the
    global cap."""
    reqs = [SelectRequest("toy", 5, key(20 + s), deadline_s=20.0)
            for s in range(2)]
    reqs += [SelectRequest("toy", 6, key(s)) for s in range(5)]
    reqs += [SelectRequest("toy", 4, key(10 + s)) for s in range(3)]
    reqs += [SelectRequest("toy", 5, key(30 + s), algo="stochastic_greedy")
             for s in range(2)]
    reqs += [SelectRequest("toy", 3, key(40), algo="topk")]
    return reqs


def _parity_server(cls, data, chaos, policy_cls, admission_cls, latency_cls,
                   hedge_cls, injector_cls, **kw):
    lm = latency_cls()
    lm.observe("dash", 50.0)
    lm.observe("stochastic_greedy", 50.0)
    srv = cls(admission=admission_cls(max_batch=4, max_queue=4,
                                      max_pending=10),
              latency=lm, clock=_stepping_clock(),
              hedge=hedge_cls(max_attempts=3, backoff_s=0.0,
                              sleep_fn=lambda s: None),
              chaos=injector_cls(fail_at=chaos) if chaos else None, **kw)
    srv.register("toy", "regression", data[0], data[1], kmax=KMAX)
    return srv


def test_replies_match_reference(data):
    """Under a chaos schedule that kills round 1 of every launch."""
    chaos = (1,)
    import jax

    from repro.runtime.fault_tolerance import FailureInjector as JInjector
    from repro.runtime.hedging import HedgePolicy as JHedge
    from repro.serve import (
        AdmissionPolicy as JAdmission,
        LatencyModel as JLatency,
        SelectionServer as JServer,
        ServePolicy as JPolicy,
    )

    jsrv = _parity_server(JServer, data, chaos, JPolicy, JAdmission,
                          JLatency, JHedge, JInjector)
    want = jsrv.serve(_parity_load(jax.random.PRNGKey))
    srv = _parity_server(SelectionServer, data, chaos, None, AdmissionPolicy,
                         LatencyModel, HedgePolicy, FailureInjector,
                         device="cpu")
    got = srv.serve(_parity_load(H.JaxKey.seed))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("request_id", "status", "tier", "degraded", "sel_count",
                  "attempts", "retry_after_s", "latency_s", "detail"):
            assert getattr(g, f) == getattr(w, f), (w.request_id, f)
        if w.status == OK:
            np.testing.assert_array_equal(g.sel_idx, np.asarray(w.sel_idx))
            np.testing.assert_array_equal(g.sel_mask,
                                          np.asarray(w.sel_mask))
            np.testing.assert_allclose(g.value, w.value, rtol=VAL_RTOL,
                                       atol=VAL_ATOL)
    assert srv.stats == jsrv.stats
    statuses = {r.status for r in got}
    assert statuses == {OK, REJECTED}
    assert {r.tier for r in got if r.ok} == {"dash", "stochastic_greedy",
                                            "topk"}
    assert any(r.degraded for r in got)
    assert srv.stats["hedge_retries"] > 0


def test_fingerprints_match_reference(data):
    from repro.serve import ObjectiveCache as JCache
    from repro.serve import chained_fingerprint as j_chained
    from repro.serve import fingerprint_arrays as j_fingerprint

    X, y = data
    jc = JCache()
    srv = SelectionServer(device="cpu")
    cases = {"f32": (X, y),
             "f64": (X.astype(np.float64), y.astype(np.float64)),
             "i64-y": (X, (y > 0).astype(np.int64)),
             "tensor": (torch.from_numpy(X), torch.from_numpy(y))}
    for name, (Xc, yc) in cases.items():
        want = jc.register(name, "regression",
                           {"X": np.asarray(Xc), "y": np.asarray(yc)},
                           kmax=KMAX)
        assert srv.register(name, "regression", Xc, yc, kmax=KMAX) == want
    cols = np.random.default_rng(3).normal(size=(D, 2))     # float64
    want = jc.update_columns("f32", [3, 7], cols)
    assert srv.update_columns("f32", [3, 7], cols) == want
    assert srv.cache.get("f32").fingerprint == want
    want = jc.update_columns("f32", np.array([1], np.int64), cols[:, :1])
    assert srv.update_columns("f32", torch.tensor([1]),
                              torch.from_numpy(cols[:, :1])) == want
    assert fingerprint_arrays("aopt", {"X": X}) == \
        j_fingerprint("aopt", {"X": X})
    assert chained_fingerprint("abc", np.int32([1]), X[:, :1]) == \
        j_chained("abc", np.int32([1]), X[:, :1])


# ---------------------------------------------------------------------------
# loud validation — caller bugs raise, they don't queue
# ---------------------------------------------------------------------------

class TestValidation:
    def test_unknown_dataset(self, data):
        with pytest.raises(ValueError, match="unknown dataset"):
            make_server(data).submit(SelectRequest("nope", 4, 0))

    def test_nonpositive_k(self, data):
        with pytest.raises(ValueError, match="positive"):
            make_server(data).submit(SelectRequest("toy", 0, 0))

    def test_k_over_capacity(self, data):
        with pytest.raises(ValueError, match="kmax"):
            make_server(data).submit(SelectRequest("toy", KMAX + 1, 0))

    def test_off_ladder_algorithm(self, data):
        with pytest.raises(ValueError, match="ladder"):
            make_server(data).submit(
                SelectRequest("toy", 4, 0, algo="lazy_greedy"))

    def test_bad_deadline(self, data):
        with pytest.raises(ValueError, match="deadline"):
            make_server(data).submit(
                SelectRequest("toy", 4, 0, deadline_s=-1.0))

    def test_unknown_objective_kind(self, data):
        with pytest.raises(ValueError, match="kind"):
            SelectionServer(device="cpu").register(
                "toy", "ranking", data[0], data[1], kmax=KMAX)

    def test_default_device_is_the_card(self, data):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            SelectionServer()


# ---------------------------------------------------------------------------
# admission: bounded queues, bucket shapes, shedding
# ---------------------------------------------------------------------------

class TestAdmission:
    def test_padded_batch_shapes(self):
        assert [padded_batch(b, 8) for b in (1, 2, 3, 4, 5, 8, 9, 100)] \
            == [1, 2, 4, 4, 8, 8, 8, 8]
        with pytest.raises(ValueError):
            padded_batch(0, 8)

    def test_bucket_key_separates_tenants(self):
        a = SelectRequest("fp_a", 4, 0)
        b = SelectRequest("fp_a", 5, 0)
        c = SelectRequest("fp_b", 4, 0)
        d = SelectRequest("fp_a", 4, 0, algo="topk")
        assert len({bucket_key(r) for r in (a, b, c, d)}) == 4
        assert bucket_key(a) == bucket_key(SelectRequest("fp_a", 4, 99))

    def test_queue_cap_sheds_with_retry_hint(self):
        ac = AdmissionController(AdmissionPolicy(max_queue=2, max_pending=10))
        key = ("fp", 4, "dash")
        assert ac.try_admit("r0", key) == (True, 0.0)
        assert ac.try_admit("r1", key) == (True, 0.0)
        ok, retry = ac.try_admit("r2", key)
        assert not ok and retry > 0

    def test_global_cap_sheds(self):
        ac = AdmissionController(AdmissionPolicy(max_queue=8, max_pending=2))
        assert ac.try_admit("a", ("fp", 4, "dash"))[0]
        assert ac.try_admit("b", ("fp", 5, "dash"))[0]
        ok, retry = ac.try_admit("c", ("fp", 6, "dash"))
        assert not ok and retry > 0

    def test_fifo_batches_respect_max_batch(self):
        ac = AdmissionController(AdmissionPolicy(max_batch=2, max_queue=8,
                                                 max_pending=16))
        key = ("fp", 4, "dash")
        for i in range(5):
            ac.try_admit(i, key)
        popped = []
        while (nb := ac.next_batch()) is not None:
            popped.append(nb[1])
        assert popped == [[0, 1], [2, 3], [4]]
        assert ac.pending() == 0


# ---------------------------------------------------------------------------
# end-to-end serving
# ---------------------------------------------------------------------------

class TestServe:
    def test_batch_serves_all_in_one_launch(self, data):
        srv = make_server(data)
        replies = srv.serve([SelectRequest("toy", 6, s) for s in range(5)])
        assert all(r.status == OK and r.tier == "dash" for r in replies)
        assert all(r.sel_count == 6 for r in replies)
        assert all(isinstance(r.sel_mask, np.ndarray) for r in replies)
        assert srv.stats["launches"] == 1
        assert srv.launch_log[0]["lanes"] == 8

    def test_reply_matches_library_dash(self, data):
        """A served request commits what a direct library call with the
        same (key, OPT, α, cfg) commits."""
        srv = make_server(data)
        r = srv.serve([SelectRequest("toy", 6, 2)])[0]
        opt = srv.cache.get("toy").opt_probe[6] * srv.policy.opt_margin
        ref = select("dash", _obj(data), 6, SeedKey(2), opt=opt,
                     eps=srv.policy.eps, alpha=srv.policy.alpha,
                     n_samples=srv.policy.n_samples, device="cpu")
        np.testing.assert_array_equal(r.sel_mask, ref.sel_mask.numpy())

    def test_padding_never_changes_selected_sets(self, data):
        """3 requests pad to 4 lanes; each commits the set it gets when
        served alone (1 lane)."""
        together = make_server(data).serve(
            [SelectRequest("toy", 6, s) for s in range(3)])
        for s in range(3):
            alone = make_server(data).serve([SelectRequest("toy", 6, s)])[0]
            np.testing.assert_array_equal(together[s].sel_mask,
                                          alone.sel_mask)

    def test_distinct_k_form_distinct_buckets(self, data):
        srv = make_server(data)
        replies = srv.serve([SelectRequest("toy", 4, 0),
                             SelectRequest("toy", 6, 0)])
        assert [r.sel_count for r in replies] == [4, 6]
        assert srv.stats["launches"] == 2

    def test_stochastic_greedy_tier_matches_library(self, data):
        srv = make_server(data)
        r = srv.serve([SelectRequest("toy", 5, 7,
                                     algo="stochastic_greedy")])[0]
        assert r.tier == "stochastic_greedy" and not r.degraded
        ref = stochastic_greedy(_obj(data), 5, SeedKey(7), device="cpu")
        np.testing.assert_array_equal(r.sel_mask, ref.sel_mask.numpy())

    def test_topk_tier_broadcasts_deterministic_set(self, data):
        srv = make_server(data)
        replies = srv.serve(
            [SelectRequest("toy", 5, s, algo="topk") for s in range(3)])
        ref = top_k_select(_obj(data), 5, device="cpu").sel_mask.numpy()
        for r in replies:
            np.testing.assert_array_equal(r.sel_mask, ref)

    def test_overload_every_request_gets_terminal_reply(self, data):
        srv = make_server(
            data, admission=AdmissionPolicy(max_batch=2, max_queue=2,
                                            max_pending=2))
        replies = srv.serve([SelectRequest("toy", 6, s) for s in range(7)])
        assert len(replies) == 7
        served = [r for r in replies if r.status == OK]
        shed = [r for r in replies if r.status == REJECTED]
        assert len(served) == 2 and len(shed) == 5
        assert all(r.retry_after_s > 0 for r in shed)

    def test_degradation_is_labeled(self, data):
        lm = LatencyModel()
        lm.observe("dash", 50.0)
        lm.observe("stochastic_greedy", 50.0)
        lm.observe("topk", 1e-4)
        srv = make_server(data, latency=lm)
        r = srv.serve([SelectRequest("toy", 6, 0, deadline_s=0.5)])[0]
        assert r.status == OK and r.tier == "topk" and r.degraded
        assert srv.stats["degraded"] == 1

    def test_deadline_exhausted_in_queue_rejects(self, data):
        t = [0.0]
        srv = make_server(data, clock=lambda: t[0])
        rid = srv.submit(SelectRequest("toy", 6, 0, deadline_s=1.0))
        t[0] = 5.0
        srv.drain()
        r = srv.reply(rid)
        assert r.status == REJECTED and r.retry_after_s > 0
        assert "queued" in r.detail

    def test_drain_timeout_rejects_leftovers(self, data):
        t = [0.0]

        def clock():
            t[0] += 2.0
            return t[0]

        srv = make_server(
            data, clock=clock,
            admission=AdmissionPolicy(max_batch=1, max_queue=8,
                                      max_pending=8))
        ids = [srv.submit(SelectRequest("toy", 6, s)) for s in range(4)]
        srv.drain(timeout_s=1.0)   # expires before the 2nd loop check
        replies = [srv.reply(i) for i in ids]
        assert all(r is not None for r in replies)
        shed = [r for r in replies if r.status == REJECTED]
        assert shed and all(r.retry_after_s > 0 for r in shed)
        assert all("drain deadline" in r.detail for r in shed)

    def test_mid_flight_expiry_serves_the_floor(self, data):
        """A deadline that expires between rounds degrades the bucket to
        the ladder floor: a labeled TOP-k result, not a timeout."""
        t = [0.0]

        def clock():
            t[0] += 1.0
            return t[0]

        srv = make_server(data, clock=clock)
        r = srv.serve([SelectRequest("toy", 6, 0, deadline_s=5.0)])[0]
        assert r.status == OK and r.tier == "topk" and r.degraded
        assert "mid-flight" in r.detail


# ---------------------------------------------------------------------------
# chaos mode: hedged resume, exhaustion, never-hang
# ---------------------------------------------------------------------------

class TestChaos:
    def test_hedged_retry_resumes_bitwise_identical(self, data):
        base = make_server(data).serve(
            [SelectRequest("toy", 6, s) for s in range(3)])
        srv = make_server(data, chaos=FailureInjector(fail_at=(1, 3)))
        replies = srv.serve([SelectRequest("toy", 6, s) for s in range(3)])
        for b, r in zip(base, replies):
            assert r.status == OK and r.attempts == 3
            np.testing.assert_array_equal(b.sel_mask, r.sel_mask)
            assert r.value == b.value
        assert srv.stats["hedge_retries"] == 2

    def test_hedge_exhaustion_is_terminal_failed(self, data):
        srv = make_server(
            data,
            chaos=FailureInjector(fail_at=tuple(range(16))),
            hedge=HedgePolicy(max_attempts=2, backoff_s=0.0,
                              sleep_fn=lambda s: None))
        r = srv.serve([SelectRequest("toy", 6, 0)])[0]
        assert r.status == FAILED and "2 attempts" in r.detail

    def test_chaos_launches_use_independent_schedules(self, data):
        srv = make_server(data, chaos=FailureInjector(fail_at=(0,)))
        replies = srv.serve([SelectRequest("toy", 4, 0),
                             SelectRequest("toy", 6, 0)])
        assert all(r.status == OK and r.attempts == 2 for r in replies)

    def test_no_request_dropped_without_reply_under_chaos(self, data):
        srv = make_server(
            data, chaos=FailureInjector(fail_at=(0, 2)),
            admission=AdmissionPolicy(max_batch=2, max_queue=2,
                                      max_pending=4))
        n = 8
        ids = [srv.submit(SelectRequest("toy", 6, s)) for s in range(n)]
        srv.drain()
        replies = [srv.reply(i) for i in ids]
        assert all(r is not None for r in replies)
        assert all(r.status in (OK, REJECTED, FAILED) for r in replies)
        assert (srv.stats["served"] + srv.stats["rejected"]
                + srv.stats["failed"]) == n


@pytest.mark.parametrize("kind", ["regression", "aopt", "classification"])
def test_bucket_step_writes_no_tensor_of_its_input_carry(data, kind):
    """A hedged resume restores the carry a round started from, so a
    round must leave every tensor of its input carry as it was."""
    from repro_torch.core import (
        AOptimalityObjective,
        ClassificationObjective,
        DashConfig,
    )
    from repro_torch.serve import build_dash_bucket

    X, y = data
    Xn = X / np.linalg.norm(X, axis=0, keepdims=True)
    obj = {"regression": lambda: _obj(data),
           "aopt": lambda: AOptimalityObjective(Xn[:20], KMAX, device="cpu"),
           "classification": lambda: ClassificationObjective(
               Xn, (y > 0).astype(np.float32), KMAX, device="cpu")}[kind]()
    pack = build_dash_bucket(DashConfig(k=6, eps=0.25, alpha=0.5,
                                        n_samples=4).resolve(obj.n))
    keys = SeedKey(1).split(4)
    opts = torch.full((4,), 2.0 * float(top_k_select(
        obj, 6, device="cpu").value))
    alphas = torch.full((4,), 0.5)
    carry = pack.init(obj, keys)
    for rho in range(pack.cfg.r):
        before = [t.clone() for t in _tensors(carry)]
        nxt = pack.step(obj, rho, carry, opts, alphas)
        assert all(torch.equal(a, b)
                   for a, b in zip(before, _tensors(carry))), rho
        carry = nxt
    assert int(pack.finalize(obj, carry).sel_count.max()) > 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


# ---------------------------------------------------------------------------
# objective cache: fingerprints, warm updates, no stale tensors
# ---------------------------------------------------------------------------

class TestObjectiveCache:
    def test_same_data_shares_entry(self, data):
        srv = make_server(data)
        fp2 = srv.register("alias", "regression", data[0], data[1],
                           kmax=KMAX)
        assert fp2 == srv.cache.get("toy").fingerprint
        assert srv.cache.get("alias") is srv.cache.get("toy")

    def test_warm_update_serves_fresh_data_without_new_runners(self, data):
        X, y = data
        rng = np.random.default_rng(7)
        srv = make_server(data)
        srv.serve([SelectRequest("toy", 6, 0)])
        entry = srv.cache.get("toy")
        fp0, builds0 = entry.fingerprint, entry.builds
        X0, obj0 = entry.arrays["X"], entry.objective()
        X0_before = X0.clone()
        objs0 = entry.objective_builds

        cols = rng.normal(size=(D, 2)).astype(np.float32)
        fp1 = srv.update_columns("toy", [3, 7], cols)
        assert fp1 != fp0
        assert entry.opt_probe == {}          # derived scalars dropped
        assert torch.equal(X0, X0_before)     # the old X is not written
        r_warm = srv.serve([SelectRequest("toy", 6, 0)])[0]
        assert srv.cache.get("toy").builds == builds0
        assert entry.objective_builds == objs0 + 1
        assert entry.objective() is not obj0
        assert 6 in entry.opt_probe           # the probe was recomputed

        X2 = X.copy()
        X2[:, [3, 7]] = cols
        fresh = SelectionServer(hedge=NOSLEEP, device="cpu")
        fresh.register("toy2", "regression", X2, y, kmax=KMAX)
        r_fresh = fresh.serve([SelectRequest("toy2", 6, 0)])[0]
        np.testing.assert_array_equal(r_warm.sel_mask, r_fresh.sel_mask)
        assert r_warm.value == pytest.approx(r_fresh.value, abs=1e-6)

    def test_warm_update_shape_mismatch_is_loud(self, data):
        srv = make_server(data)
        with pytest.raises(ValueError, match="patch shape"):
            srv.update_columns("toy", [3], np.zeros((D, 2), np.float32))

    def test_lru_eviction_bounds_entries(self, data):
        X, y = data
        srv = SelectionServer(cache_capacity=2, hedge=NOSLEEP, device="cpu")
        for i in range(3):
            srv.register(f"d{i}", "regression", X + i, y, kmax=KMAX)
        with pytest.raises(ValueError, match="unknown dataset"):
            srv.cache.get("d0")
        srv.cache.get("d2")                   # newest entries survive

    @pytest.mark.parametrize("kind", ["aopt", "classification"])
    def test_other_kinds_serve(self, data, kind):
        X, y = data
        srv = SelectionServer(hedge=NOSLEEP, device="cpu")
        Xn = X / np.linalg.norm(X, axis=0, keepdims=True)
        if kind == "aopt":
            srv.register("t", kind, Xn[:20], kmax=KMAX)
        else:
            srv.register("t", kind, Xn, (y > 0).astype(np.float32),
                         kmax=KMAX)
        replies = srv.serve([SelectRequest("t", 5, s) for s in range(3)])
        assert all(r.status == OK and r.tier == "dash" for r in replies)
        assert all(0 < r.sel_count <= 5 for r in replies)


# ---------------------------------------------------------------------------
# the serve properties of tests/test_property.py
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

SETTINGS = dict(max_examples=10, deadline=None)


@given(b=st.integers(1, 4096), cap=st.sampled_from([1, 2, 4, 8, 16, 32]))
@settings(**SETTINGS)
def test_padded_batch_is_a_compiled_shape(b, cap):
    p = padded_batch(b, cap)
    assert p in {2 ** i for i in range(cap.bit_length())}
    assert p <= cap
    assert p >= min(b, cap)


@given(seed=st.integers(0, 100), n_reqs=st.integers(1, 40),
       max_queue=st.integers(1, 8), max_pending=st.integers(1, 16))
@settings(**SETTINGS)
def test_admission_accounting_and_retry_hints(seed, n_reqs, max_queue,
                                              max_pending):
    rng = np.random.default_rng(seed)
    ac = AdmissionController(AdmissionPolicy(
        max_batch=4, max_queue=max_queue, max_pending=max_pending))
    admitted, rejected = [], []
    for i in range(n_reqs):
        req = SelectRequest(dataset=f"fp{rng.integers(2)}",
                            k=int(rng.integers(1, 3)), key=i)
        ok, retry = ac.try_admit(i, bucket_key(req))
        if ok:
            assert retry == 0.0
            admitted.append((i, bucket_key(req)))
        else:
            assert retry > 0.0
            rejected.append(i)
    assert len(admitted) + len(rejected) == n_reqs
    assert ac.pending() == len(admitted) <= max_pending
    drained = {}
    while (nb := ac.next_batch()) is not None:
        key, batch = nb
        assert 1 <= len(batch) <= 4
        for item in batch:
            assert item not in drained
            drained[item] = key
    assert ac.pending() == 0
    for i, key in admitted:
        assert drained[i] == key


@given(seed=st.integers(0, 30), b=st.integers(1, 5))
@settings(**SETTINGS)
def test_padding_never_changes_selected_sets_property(seed, b):
    """Pad lanes replicate lane 0 and are discarded: b requests commit
    the same per-lane sets with extra pad lanes appended."""
    rng = np.random.default_rng(seed)
    obj = RegressionObjective(rng.normal(size=(16, 12)).astype(np.float32),
                              rng.normal(size=(16,)).astype(np.float32), 4,
                              device="cpu")
    run = build_single_shot("stochastic_greedy", 3)
    keys = SeedKey(seed).split(b)
    bare = run(obj, keys)
    padded = run(obj, keys + [keys[0]] * (padded_batch(b, 8) - b))
    np.testing.assert_array_equal(bare.sel_mask.numpy(),
                                  padded.sel_mask[:b].numpy())


# ---------------------------------------------------------------------------
# the entry point and the import guard
# ---------------------------------------------------------------------------

def _run(args, timeout=120):
    # One intra-op thread: the entry point's deadline slice is timed on the
    # wall clock, and the xdist workers already take the cores.
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_entry_point_exits_zero_on_cpu():
    proc = _run(["-m", "repro_torch.serve_selection", "--device", "cpu"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "hedged-resume bitwise-verified" in proc.stdout


def test_serve_modules_import_no_jax_and_no_repro():
    mods = ["repro_torch.serve", "repro_torch.serve_selection"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr
