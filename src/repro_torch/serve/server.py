"""The selection server: admission → bucketing → one launch per batch.

Ports ``repro/serve/server.py``.  Request lifecycle:

1. ``submit`` validates loudly (caller bugs raise ``ValueError``) and
   offers the request to the admission controller; a full queue turns
   into an immediate ``REJECTED`` reply with a retry-after hint.
2. ``drain`` pops bucketed batches, plans each request's tier against
   its remaining deadline (degradation ladder), pads the batch to a
   power-of-two lane count and runs one launch per tier group — DASH
   buckets stepped round by round from the host, so every round boundary
   is a snapshot, deadline and chaos point.
3. Launches run under hedged retries (``runtime/hedging.py``): a launch
   that dies mid-flight restores the newest round's carry, backs off and
   resumes, so a retried DASH request commits the set an unfailed run
   commits, bit for bit (a round writes no tensor of its input carry).
   A launch that dies through the whole hedge budget gives ``FAILED``
   replies; a deadline that expires mid-flight falls to the ladder
   floor.  Every admitted request ends with exactly one terminal reply.

Pad lanes replicate lane 0.  On the card the padded lane count is also
the G that kernels 1 and 3 plan for (``split_plan``, ``engine_plan``), so
a lane's bits may depend on its bucket's size, within the bits rule of
the sharded runtime; padding keeps the set of those G small.

Chaos mode: with a ``FailureInjector``, every launch takes its own
``fork()`` of the schedule.  ``device=None`` means the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.random import SeedKey
from repro_torch.core.selection_loop import (
    DashConfig,
    Deadline,
    SelectionDeadlineExceeded,
)
from repro_torch.runtime.hedging import (
    HedgeExhausted,
    HedgePolicy,
    run_resumable,
)
from repro_torch.serve.admission import (
    AdmissionController,
    AdmissionPolicy,
    bucket_key,
    padded_batch,
)
from repro_torch.serve.batcher import (
    build_dash_bucket,
    build_opt_probe,
    build_single_shot,
)
from repro_torch.serve.cache import ObjectiveCache
from repro_torch.serve.degradation import (
    DegradationLadder,
    LatencyModel,
    plan_tier,
)
from repro_torch.serve.request import (
    FAILED,
    OK,
    REJECTED,
    SelectReply,
    SelectRequest,
)


@dataclass(frozen=True)
class ServePolicy:
    """Server-level DASH settings shared by every request of a bucket
    (a request chooses only ``key``, ``opt`` and ``alpha``).
    ``opt_margin`` scales the cached TOP-k probe into DASH's OPT guess
    when a request pins none."""

    eps: float = 0.25
    alpha: float = 0.5
    n_samples: int = 4
    r: int = 0
    trim_frac: float = 0.0
    opt_margin: float = 1.25


@dataclass
class _Pending:
    rid: int
    req: SelectRequest
    t_submit: float


def _as_key(key):
    """An int seed becomes a ``SeedKey``; any port key passes through."""
    if isinstance(key, (int, np.integer)):
        return SeedKey(int(key))
    return key


def _sync(t: torch.Tensor) -> None:
    """Wait for the work that produces ``t`` (a launch's end)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class SelectionServer:
    """Multi-tenant batched ``select()`` over registered datasets, on
    ``device`` (``None``: the card; raises without one)."""

    def __init__(self, *, policy: ServePolicy | None = None,
                 admission: AdmissionPolicy | None = None,
                 ladder: DegradationLadder | None = None,
                 hedge: HedgePolicy | None = None,
                 latency: LatencyModel | None = None,
                 cache_capacity: int = 8,
                 chaos=None,
                 clock=time.monotonic,
                 device=None):
        self.policy = policy or ServePolicy()
        self.clock = clock
        self.admission = AdmissionController(admission, clock=clock)
        self.ladder = ladder or DegradationLadder()
        self.hedge = hedge or HedgePolicy()
        self.latency = latency or LatencyModel()
        self.cache = ObjectiveCache(cache_capacity, device=device)
        self.device = self.cache.device
        self.chaos = chaos
        self._next_id = 0
        self._done: dict[int, SelectReply] = {}
        self.stats = {
            "submitted": 0, "admitted": 0, "rejected": 0, "served": 0,
            "failed": 0, "degraded": 0, "launches": 0, "hedge_retries": 0,
        }
        # One record per launch: tier, lanes, rounds, attempts, host s.
        self.launch_log: list[dict] = []

    # -- dataset registry --------------------------------------------------
    def register(self, name: str, kind: str, X, y=None, *, kmax: int,
                 **obj_kw) -> str:
        """Register a dataset; returns its content fingerprint."""
        arrays = {"X": X} if y is None else {"X": X, "y": y}
        return self.cache.register(name, kind, arrays, kmax=kmax, **obj_kw)

    def update_columns(self, dataset: str, idx, cols) -> str:
        """Warm update: new column values, the runners kept."""
        return self.cache.update_columns(dataset, idx, cols)

    # -- request path ------------------------------------------------------
    def _validate(self, req: SelectRequest):
        entry = self.cache.get(req.dataset)     # unknown → ValueError
        k = int(req.k)
        if k <= 0:
            raise ValueError(f"k must be a positive integer, got {req.k!r}")
        if k > entry.kmax:
            raise ValueError(
                f"k={k} exceeds dataset {entry.name!r} capacity "
                f"kmax={entry.kmax} (fixed at registration — the "
                "objective state is allocated for kmax columns)"
            )
        self.ladder.downgrades(req.algo)        # off-ladder → ValueError
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive (or None), got "
                f"{req.deadline_s!r}"
            )
        return entry

    def submit(self, req: SelectRequest) -> int:
        """Validate and enqueue one request; returns its id.  A shed
        request already has its terminal ``REJECTED`` reply."""
        entry = self._validate(req)
        rid = self._next_id
        self._next_id += 1
        self.stats["submitted"] += 1
        item = _Pending(rid=rid, req=req, t_submit=self.clock())
        resolved = SelectRequest(dataset=entry.fingerprint, k=int(req.k),
                                 key=req.key, algo=req.algo)
        ok, retry = self.admission.try_admit(item, bucket_key(resolved))
        if ok:
            self.stats["admitted"] += 1
        else:
            self.stats["rejected"] += 1
            self._done[rid] = SelectReply(
                request_id=rid, status=REJECTED, retry_after_s=retry,
                latency_s=0.0, detail="shed: queue pressure",
            )
        return rid

    def reply(self, rid: int) -> SelectReply | None:
        return self._done.get(rid)

    def drain(self, timeout_s: float | None = None) -> dict:
        """Run queued batches to completion; returns {id: reply}.  At the
        expiry of ``timeout_s`` the still-queued requests get terminal
        ``REJECTED`` replies with retry-after hints."""
        dl = (Deadline(timeout_s, clock=self.clock)
              if timeout_s is not None else None)
        while dl is None or not dl.expired():
            nb = self.admission.next_batch()
            if nb is None:
                break
            key, batch = nb
            self._run_batch(key, batch, drain_deadline=dl)
        for _, leftovers in self.admission.drain_all():
            for it in leftovers:
                self.stats["rejected"] += 1
                self._done[it.rid] = SelectReply(
                    request_id=it.rid, status=REJECTED,
                    retry_after_s=self.admission.retry_after(len(leftovers)),
                    latency_s=self.clock() - it.t_submit,
                    detail="shed: drain deadline expired before launch",
                )
        return dict(self._done)

    def serve(self, requests, timeout_s: float | None = None) -> list:
        """Submit and drain; replies in request order."""
        ids = [self.submit(r) for r in requests]
        self.drain(timeout_s)
        return [self._done[i] for i in ids]

    # -- launch path -------------------------------------------------------
    def _run_batch(self, key: tuple, batch: list, drain_deadline):
        fp, k, algo = key
        entry = self.cache.get(fp)
        now = self.clock()
        groups: dict[str, list] = {}
        for it in batch:
            remaining = None
            if it.req.deadline_s is not None:
                remaining = it.req.deadline_s - (now - it.t_submit)
                if remaining <= 0:
                    self.stats["rejected"] += 1
                    self._done[it.rid] = SelectReply(
                        request_id=it.rid, status=REJECTED,
                        retry_after_s=self.admission.policy.min_retry_after_s,
                        latency_s=now - it.t_submit,
                        detail="deadline exhausted while queued",
                    )
                    continue
            tier, degraded = plan_tier(self.ladder, self.latency, algo,
                                       entry.n, k, remaining)
            groups.setdefault(tier, []).append((it, degraded, remaining))
        for tier, members in groups.items():
            self._launch(entry, k, tier, members, drain_deadline)

    def _launch(self, entry, k: int, tier: str, members: list,
                drain_deadline):
        B = padded_batch(len(members), self.admission.policy.max_batch)
        keys = [_as_key(it.req.key) for it, _, _ in members]
        keys = keys + [keys[0]] * (B - len(members))
        budgets = [rem for _, _, rem in members if rem is not None]
        if drain_deadline is not None:
            budgets.append(drain_deadline.remaining())
        launch_dl = (Deadline(min(budgets), clock=self.clock)
                     if budgets else None)
        inj = self.chaos.fork() if self.chaos is not None else None
        obj = entry.objective()
        t0 = self.clock()
        host0 = time.perf_counter()
        self.stats["launches"] += 1
        rounds = 1
        try:
            if tier == "dash":
                out, attempts, rounds = self._launch_dash(
                    entry, obj, k, members, keys, B, inj, launch_dl)
            else:
                pack = entry.runner(("single", tier, k),
                                    lambda: build_single_shot(tier, k))

                def step(_state, s):
                    if launch_dl is not None and launch_dl.expired():
                        raise SelectionDeadlineExceeded(s)
                    if inj is not None:
                        inj.check(s)
                    o = pack(obj, keys)
                    _sync(o.value)
                    return o

                out, attempts = run_resumable(
                    1, None, step, policy=self.hedge,
                    fatal=(SelectionDeadlineExceeded,))
        except HedgeExhausted as e:
            self.stats["failed"] += len(members)
            for it, degraded, _ in members:
                self._done[it.rid] = SelectReply(
                    request_id=it.rid, status=FAILED, tier=tier,
                    degraded=degraded, attempts=self.hedge.max_attempts,
                    latency_s=self.clock() - it.t_submit, detail=str(e),
                )
            return
        except SelectionDeadlineExceeded as e:
            self._serve_floor_after_expiry(entry, obj, k, tier, members,
                                           keys, e)
            return
        elapsed = self.clock() - t0
        self.latency.observe(tier, elapsed)
        self.admission.observe_drain(len(members), elapsed)
        self.stats["hedge_retries"] += attempts - 1
        self._commit(members, out, tier, attempts)
        self.launch_log.append(dict(
            tier=tier, lanes=B, requests=len(members), rounds=rounds,
            attempts=attempts, host_s=time.perf_counter() - host0))

    def _launch_dash(self, entry, obj, k: int, members: list, keys,
                     B: int, inj, launch_dl):
        cfg = DashConfig(
            k=k, r=self.policy.r, eps=self.policy.eps,
            alpha=self.policy.alpha, n_samples=self.policy.n_samples,
            trim_frac=self.policy.trim_frac,
        ).resolve(entry.n)
        pack = entry.runner(("dash_bucket", cfg),
                            lambda: build_dash_bucket(cfg))
        opts, alphas = [], []
        for it, _, _ in members:
            opts.append(float(it.req.opt) if it.req.opt is not None
                        else self._opt_base(entry, k) * self.policy.opt_margin)
            alphas.append(float(it.req.alpha) if it.req.alpha is not None
                          else self.policy.alpha)
        pad = B - len(members)
        opts = torch.tensor(opts + [opts[0]] * pad, dtype=torch.float32,
                            device=obj.device)
        alphas = torch.tensor(alphas + [alphas[0]] * pad,
                              dtype=torch.float32, device=obj.device)
        carry0 = pack.init(obj, keys)

        def step(carry, rho):
            if launch_dl is not None and launch_dl.expired():
                raise SelectionDeadlineExceeded(rho, carry)
            if inj is not None:
                inj.check(rho)
            c = pack.step(obj, rho, carry, opts, alphas)
            _sync(c.count)
            return c

        final, attempts = run_resumable(
            cfg.r, carry0, step, policy=self.hedge,
            fatal=(SelectionDeadlineExceeded,))
        return pack.finalize(obj, final), attempts, cfg.r

    def _opt_base(self, entry, k: int) -> float:
        """Cached TOP-k probe value for the DASH OPT guess — computed once
        per (dataset, k), dropped by warm updates."""
        if k not in entry.opt_probe:
            probe = entry.runner(("opt_probe", k),
                                 lambda: build_opt_probe(k))
            entry.opt_probe[k] = probe(entry.objective())
        return entry.opt_probe[k]

    def _serve_floor_after_expiry(self, entry, obj, k, tier, members, keys,
                                  e):
        """A deadline expired mid-flight: serve the ladder floor (one
        cheap deterministic launch) labeled degraded."""
        floor = self.ladder.floor
        if tier == floor:
            for it, _, _ in members:
                self.stats["rejected"] += 1
                self._done[it.rid] = SelectReply(
                    request_id=it.rid, status=REJECTED, tier=tier,
                    retry_after_s=self.admission.policy.min_retry_after_s,
                    latency_s=self.clock() - it.t_submit,
                    detail=f"deadline expired at the ladder floor: {e}",
                )
            return
        pack = entry.runner(("single", floor, k),
                            lambda: build_single_shot(floor, k))
        out = pack(obj, keys)
        members = [(it, True, rem) for it, _, rem in members]
        self._commit(members, out, floor, attempts=1,
                     detail=f"degraded mid-flight: {e}")

    def _commit(self, members: list, out, tier: str, attempts: int,
                detail: str = ""):
        masks = out.sel_mask.cpu().numpy()
        counts = out.sel_count.cpu().numpy()
        values = out.value.cpu().numpy()
        now = self.clock()
        for lane, (it, degraded, _) in enumerate(members):
            self.stats["served"] += 1
            if degraded:
                self.stats["degraded"] += 1
            mask = np.array(masks[lane])
            self._done[it.rid] = SelectReply(
                request_id=it.rid, status=OK, tier=tier, degraded=degraded,
                sel_idx=np.nonzero(mask)[0],
                sel_mask=mask,
                sel_count=int(counts[lane]),
                value=float(values[lane]),
                attempts=attempts,
                latency_s=now - it.t_submit,
                detail=detail,
            )


__all__ = ["SelectionServer", "ServePolicy"]
