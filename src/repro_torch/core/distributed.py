"""Distributed DASH — the paper's parallelism on a ``torch.distributed`` mesh.

Ports ``repro/core/distributed.py``.  DASH's O(log n) adaptivity only
buys wall-clock time if every round's oracle sweep runs as one parallel
pass; the reference makes that pass with ``shard_map`` over a device
mesh, the port with one process per rank of a :class:`~repro_torch.
launch.mesh.Mesh`, SPMD: every rank calls the same entry point with the
same objective and key, and every rank returns the same result — the
global selection mask (n,), its count, f(S), the rounds and the trace,
assembled with one ``all_gather`` of the shards' masks.

The round and filter control flow is not re-implemented here: the hooks
below bind the port's lane-batched loop (``core/selection_loop.py``) to
an objective's column-based ``dist_*`` contract
(``objectives/base.py::DistributedObjective``).

Layout:
  * the ground set's columns sharded over the ``model`` axis: each rank
    holds a contiguous copy of its block X[:, lo:hi] on the mesh's device
    and runs the objective's kernels on it (kernels 1 and 3, 4 and 5, 6
    and 7 at shard-local shapes);
  * Monte-Carlo replicas over the ``data`` axis: each data coordinate
    folds its index into the sample keys, and the estimates are reduced
    over the axis (under a straggler deadline the set-gain reduction is
    ``runtime/straggler.py::robust_estimate`` over the responders);
  * the (OPT, α) guesses of ``dash_auto_distributed`` over the ``pod``
    axis: each pod slice runs its share of the lattice as lanes, and the
    winner is committed with an ``all_gather`` of the slices' best
    values, a replicated argmax and a broadcast.

Sampling draws the same (n,) Gumbel vector on every rank from the
replicated key and slices the rank's block, so the sampled set does not
depend on the model-axis width: a snapshot taken on one width resumes on
another to the uninterrupted set (``resilience=`` / ``resume=``, the
round-stepped runtime, ``runtime/elastic.py``).  It does depend on the
data-axis size, which a resume must keep (the snapshot's manifest holds
it).

Collectives per sample draw (b = block, P = model ranks): an
``all_gather`` of P·b scores and indices, a sum of the (d, b) gathered
columns; per estimate a sum over ``data``.  Every decision the host
takes (the filter loop's, FAST's, the lattice commit's) reads values
that are the same bits on every rank: reduced over the axes, or computed
from the same gathered columns by the same operations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dash import (
    DashConfig,
    lattice_grid,
    nan_to_neginf,
    opt_guess_lattice,
    take_lane,
)
from repro_torch.core.estimators import top_k
from repro_torch.core.objectives.base import (
    check_device,
    gather_columns,
    resolve_engine,
    with_precision,
)
from repro_torch.core.selection_loop import (
    DashTrace,
    ResilienceConfig,
    RoundCheckpointer,
    SelectionCarry,
    SelectionHooks,
    carry_from_snapshot,
    carry_snapshot,
    drive_checkpointed_rounds,
    initial_carry,
    keys_snapshot,
    make_round_body,
    round_arrivals,
    run_selection_rounds,
)
from repro_torch.runtime.elastic import gather_tree, tree_map


class DistDashResult(NamedTuple):
    sel_mask: torch.Tensor      # (n,) bool — global (gathered)
    sel_count: torch.Tensor     # () int32
    value: torch.Tensor         # () f32
    rounds: torch.Tensor        # () int32 — filter iterations + r
    values_trace: torch.Tensor  # (r,)
    trace: DashTrace


class LatticeDistResult(NamedTuple):
    """The winning guess's solution and the whole lattice's values (in
    lattice order); ``trace`` is the winner's."""

    sel_mask: torch.Tensor        # (n,) bool
    sel_count: torch.Tensor
    value: torch.Tensor
    rounds: torch.Tensor
    trace: DashTrace
    lattice_values: torch.Tensor  # (n_guesses,) f(S) per joint guess
    best_guess: torch.Tensor      # () int32 — index into the lattice


class DistSelectResult(NamedTuple):
    """Result of the sharded baselines.  ``values`` is the per-pick f(S)
    trace of the greedy family and empty (0,) for TOP-k and RANDOM."""

    sel_mask: torch.Tensor      # (n,) bool — global (gathered)
    sel_count: torch.Tensor     # () int32
    value: torch.Tensor         # () f32
    values: torch.Tensor        # (k,) trace, or (0,)


class FastDistResult(NamedTuple):
    """Result of :func:`fast_distributed`; ``values`` is the winning
    probe's per-round trace, 0-padded to the round cap."""

    sel_mask: torch.Tensor      # (n,) bool — global (gathered)
    sel_count: torch.Tensor     # () int32
    value: torch.Tensor         # () f32
    rounds: torch.Tensor        # () int32
    values: torch.Tensor        # (r_max,)
    opt: torch.Tensor           # () f32 — the OPT guess used


class _Lanes(NamedTuple):
    """Per-lane results on one rank (shard-local masks)."""

    sel_local: torch.Tensor     # (G, n_local) bool
    count: torch.Tensor         # (G,) int32
    value: torch.Tensor         # (G,) f32
    rounds: torch.Tensor        # (G,) int32
    trace: DashTrace            # (G, r) fields


# ---------------------------------------------------------------------------
# sharding and the distributed primitives
# ---------------------------------------------------------------------------

def _check_sharding(obj, mesh, model_axis: str):
    """(n, n_local) for ``obj`` on ``mesh``; raises unless this rank is
    in the mesh, n divides the model axis and the objective lives on the
    mesh's device (a CUDA mesh computes on the card or raises)."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not in the mesh "
                         f"(ranks {mesh.ranks})")
    n = obj.X.shape[1]
    pm = mesh.size(model_axis)
    if n % pm:
        raise ValueError(f"ground set n={n} does not divide the mesh's "
                         f"model axis ({pm}); pad_ground_set first")
    check_device(obj, mesh.device)
    return n, n // pm


def shard_columns(X: torch.Tensor, mesh, model_axis: str) -> torch.Tensor:
    """This rank's column block of X (d, n), contiguous (the kernel
    wrappers raise on a strided view), on X's device."""
    n_local = X.shape[1] // mesh.size(model_axis)
    lo = mesh.index(model_axis) * n_local
    return X[:, lo:lo + n_local].contiguous()


def _global_mask(sel_local: torch.Tensor, mesh, model_axis: str):
    """(..., n) from every rank's (..., n_local) block."""
    parts = mesh.all_gather(sel_local, model_axis)
    return torch.cat(list(parts), dim=-1)


def _local_noise(keys, n_global: int, n_local: int, rank: int, device):
    """(B, n_local): this rank's block of each key's (n,) Gumbel draw."""
    noise = torch.stack([k.gumbel(n_global, device) for k in keys])
    return noise[:, rank * n_local:(rank + 1) * n_local]


def _global_topk(scores: torch.Tensor, k_top: int, mesh, axis: str):
    """Global top-``k_top`` of rank-local scores (B, n_local).

    Each rank's top t = min(k_top, n_local) are gathered rank-major and
    ranked again; ``top_k`` is a stable sort, so ties resolve in global
    index order, as a single-device top-k over the whole vector.  Returns
    (idx_local, owned, valid), each (B, k_top): the winners' local
    indices (meaningful where ``owned``), whether this rank owns them,
    and whether the slot holds a finite score at all.
    """
    b, n_local = scores.shape
    p, rank = mesh.size(axis), mesh.index(axis)
    t = min(k_top, n_local)
    lv, li = top_k(scores, t)
    av = mesh.all_gather(lv, axis).permute(1, 0, 2).reshape(b, p * t)
    ai = mesh.all_gather(li, axis).permute(1, 0, 2).reshape(b, p * t)
    kk = min(k_top, p * t)
    tv, tf = top_k(av, kk)
    idx = torch.gather(ai, 1, tf)
    valid = torch.isfinite(tv)
    owned = (torch.div(tf, t, rounding_mode="floor") == rank) & valid
    if kk < k_top:                  # fewer candidates than slots: pad
        pad = k_top - kk
        idx = torch.cat([idx, idx.new_zeros((b, pad))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
        owned = torch.cat([owned, owned.new_zeros((b, pad))], dim=1)
    return idx, owned, valid


def _dist_sample(keys, alive_local, m: int, n_global: int, mesh,
                 axis: str):
    """Globally uniform sample of ≤ m alive elements per key: the
    replicated Gumbel draw, this rank's slice, the global top-m.  Returns
    the local view (idx_local, owned, valid), each (B, m)."""
    n_local = alive_local.shape[-1]
    noise = _local_noise(keys, n_global, n_local, mesh.index(axis),
                         alive_local.device)
    scores = torch.where(alive_local, noise,
                         torch.full_like(noise, -torch.inf))
    return _global_topk(scores, m, mesh, axis)


def _dist_gather_columns(X_local, idx_local, owned, mesh, axis: str):
    """(*B, d, m) sampled columns, each from the rank that owns it: the
    owned columns of every rank (zeros elsewhere) summed over ``axis``."""
    return mesh.psum(gather_columns(X_local, idx_local, owned), axis)


def _scatter_true(mask: torch.Tensor, idx: torch.Tensor, on: torch.Tensor):
    """``mask`` (B, n) with ``mask[b, idx[b, j]]`` set where ``on``; slots
    off are routed to a spare column that is dropped (an unowned slot's
    index is another rank's and may collide with an owned one)."""
    n = mask.shape[-1]
    spare = torch.zeros((mask.shape[0], 1), dtype=torch.bool,
                        device=mask.device)
    safe = torch.where(on, idx, torch.full_like(idx, n))
    return torch.cat([mask, spare], dim=1).scatter(
        1, safe, torch.ones_like(safe, dtype=torch.bool))[:, :n]


# ---------------------------------------------------------------------------
# the generic sharded runner
# ---------------------------------------------------------------------------

def _make_hooks(obj, cfg: DashConfig, mesh, X_local, n_global: int,
                model_axis: str, data_axis: str | None, engine: bool, *,
                arrived=None, policy=None) -> SelectionHooks:
    """Bind the selection loop to this rank's shard of a
    ``DistributedObjective``; the state is ``(dstate, sel_local)``.

    ``arrived`` (optional, (n_samples,) bool) is the round's responder
    mask: a replica that missed the deadline contributes no weight to the
    filter statistic, and an incomplete round's set-gain estimate is the
    robust reduction under ``policy`` (a complete round is the plain
    mean, bitwise the deadline-free one).  The commit draw never reads
    it, so the selected set is the key's regardless of stragglers.
    """
    block = cfg.block
    n_samples = cfg.n_samples
    d, n_local = X_local.shape
    dev = X_local.device
    didx = mesh.index(data_axis) if data_axis else 0
    slots = torch.arange(block, device=dev)
    arrived_t = (None if arrived is None else
                 torch.as_tensor(arrived, dtype=torch.bool, device=dev))

    def draw(keys, alive, allowed):
        """One global sample per key: the local view and the gathered
        columns.  The collectives stay here; every oracle call on the
        result is shard-local."""
        idx, owned, valid = _dist_sample(keys, alive, block, n_global, mesh,
                                         model_axis)
        slot_ok = valid & (slots < allowed[:, None])
        C = _dist_gather_columns(X_local, idx, owned & slot_ok, mesh,
                                 model_axis)
        return idx, owned, slot_ok, C

    def draw_samples(keys, alive, allowed):
        """``n_samples`` draws per lane, (G, S, ...): each data
        coordinate folds its index into the lane's key first."""
        g = alive.shape[0]
        sk = [kk for key in keys for kk in key.fold_in(didx).split(n_samples)]
        idx, owned, slot_ok, C = draw(
            sk, alive.repeat_interleave(n_samples, 0),
            allowed.repeat_interleave(n_samples, 0))
        return (idx.reshape(g, n_samples, block),
                owned.reshape(g, n_samples, block),
                slot_ok.reshape(g, n_samples, block),
                C.reshape(g, n_samples, d, block))

    def gains_local(ds, sel_local):
        g = obj.dist_gains(ds, X_local)
        return torch.where(sel_local, torch.zeros_like(g), g)

    def estimate_set_gain(state, alive, allowed, keys):
        ds, _ = state
        _, _, slot_ok, C = draw_samples(keys, alive, allowed)
        vals = obj.dist_set_gain(ds, C, slot_ok)              # (G, S)
        if arrived_t is None or bool(arrived_t.all()):
            est = torch.mean(vals, dim=1)
        else:
            from repro_torch.runtime.straggler import robust_estimate

            est = torch.stack([robust_estimate(v, arrived_t, policy)
                               for v in vals])
        return mesh.pmean(est, data_axis)

    def estimate_elem_gains(state, alive, allowed, keys):
        ds, sel_local = state
        g = alive.shape[0]
        idx, owned, slot_ok, C = draw_samples(keys, alive, allowed)
        w = torch.ones((g, n_samples, n_local), device=dev)
        w = w.scatter_add(2, idx, -(owned & slot_ok).to(w.dtype))
        if engine:
            # Shared state + per-sample deltas: one engine call for every
            # lane and sample over the local candidate shard.
            gs = obj.dist_filter_gains_batch(ds, C, slot_ok, X_local)
        else:
            gs = torch.stack([
                obj.dist_gains(obj.dist_add_set(ds, C[:, s], slot_ok[:, s],
                                                X_local), X_local)
                for s in range(n_samples)], dim=1)
        gs = torch.where(sel_local[:, None, :], torch.zeros_like(gs), gs)
        if arrived_t is not None:
            w = w * arrived_t.to(w.dtype)[None, :, None]
        gsum = mesh.psum(torch.sum(gs * w, dim=1), data_axis)
        wsum = mesh.psum(torch.sum(w, dim=1), data_axis)
        est = gsum / torch.clamp(wsum, min=1.0)
        return torch.where(wsum > 0, est, gains_local(ds, sel_local))

    def pick_and_add(state, alive, allowed, keys):
        ds, sel_local = state
        idx, owned, slot_ok, C = draw(keys, alive, allowed)
        ds = obj.dist_add_set(ds, C, slot_ok, X_local)
        mine = owned & slot_ok
        sel_local = _scatter_true(sel_local, idx, mine)
        added = mesh.psum(torch.sum(mine.to(torch.int32), dim=-1),
                          model_axis)
        return (ds, sel_local), added

    return SelectionHooks(
        value=lambda state: obj.dist_value(state[0]),
        sel_mask=lambda state: state[1],
        estimate_set_gain=estimate_set_gain,
        estimate_elem_gains=estimate_elem_gains,
        pick_and_add=pick_and_add,
        count_alive=lambda alive: mesh.psum(
            torch.sum(alive.to(torch.int32), dim=-1), model_axis),
    )


def _init_state_alive(obj, X_local, lanes: int):
    """Round-0 ``(state, alive)`` of ``lanes`` lanes on this shard.  Zero
    columns (``pad_ground_set`` padding) start dead: they add nothing,
    and a round that commits without filtering would otherwise let
    padding burn capacity."""
    n_local = X_local.shape[1]
    state0 = (obj.dist_init(X_local, lanes),
              torch.zeros((lanes, n_local), dtype=torch.bool,
                          device=X_local.device))
    alive0 = (torch.sum(X_local * X_local, dim=0) > 0).expand(
        lanes, n_local).clone()
    return state0, alive0


def _lane_results(obj, cfg: DashConfig, carry) -> _Lanes:
    (ds, sel_local), _, count, _, trace = carry
    rounds = torch.sum(trace.filter_iters, dim=-1) + cfg.r
    return _Lanes(sel_local=sel_local, count=count,
                  value=obj.dist_value(ds), rounds=rounds.to(torch.int32),
                  trace=trace)


def _run_lanes(obj, cfg: DashConfig, mesh, X_local, n_global: int, keys,
               opts, alphas, model_axis: str, data_axis: str | None,
               engine: bool) -> _Lanes:
    """DASH on len(keys) lanes of this rank, lane g with guess (opts[g],
    alphas[g]); collectives only over ``model_axis`` / ``data_axis``."""
    hooks = _make_hooks(obj, cfg, mesh, X_local, n_global, model_axis,
                        data_axis, engine)
    state0, alive0 = _init_state_alive(obj, X_local, len(keys))
    carry = run_selection_rounds(hooks, cfg, opts, keys, state0, alive0,
                                 alpha=alphas)
    return _lane_results(obj, cfg, carry)


def _guess_tensor(x, lanes: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device).reshape(lanes)


def _dist_result(res: _Lanes, mesh, model_axis: str) -> DistDashResult:
    one = take_lane(res, 0)
    return DistDashResult(
        sel_mask=_global_mask(one.sel_local, mesh, model_axis),
        sel_count=one.count, value=one.value, rounds=one.rounds,
        values_trace=one.trace.values, trace=one.trace)


def dash_distributed(
    obj, cfg: DashConfig, key, opt, mesh,
    *, model_axis: str = "model", data_axis: str | None = "data",
    precision: str | None = None,
    resilience: ResilienceConfig | None = None,
    resume: str | bool | None = None,
    failure_injector=None,
) -> DistDashResult:
    """DASH for any ``DistributedObjective`` on a mesh, one (OPT, α)
    guess.

    ``obj.X`` (d, n) is sharded over ``model_axis`` (n must divide its
    size — ``pad_ground_set`` first); Monte-Carlo replicas ride
    ``data_axis`` (``None`` for a model-only mesh).  The loop, thresholds
    and trace are ``core.selection_loop``'s, so the solution is
    exchangeable with the single-device ``dash``'s (the data index folded
    into the sample keys makes it another draw, not the same one).

    The objective's ``use_filter_engine`` flag picks the filter
    statistic's path (``resolve_engine``): off, one ``dist_add_set`` +
    ``dist_gains`` a sample.  ``precision`` runs the kernels through a ``with_precision`` view.

    Any of ``resilience`` / ``resume`` / ``failure_injector`` switches to
    the round-stepped runtime: the carry is snapshotted at round
    boundaries (the global view, written by the mesh's first rank), a
    straggler deadline is simulated when ``resilience.drop_rate > 0``,
    and ``resume`` (a directory, or ``True`` for ``resilience.ckpt_dir``)
    restores onto this mesh even when the snapshot was taken at another
    model-axis width; the data-axis size must be the snapshot's.
    """
    if precision is not None:
        obj = with_precision(obj, precision)
    n, _ = _check_sharding(obj, mesh, model_axis)
    cfg = cfg.resolve(n)
    engine = resolve_engine(obj, dist=True)
    if resilience is not None or resume or failure_injector is not None:
        return _dash_distributed_stepped(
            obj, cfg, key, opt, mesh, model_axis, data_axis, engine,
            resilience, resume, failure_injector)
    X_local = shard_columns(obj.X, mesh, model_axis)
    dev = X_local.device
    res = _run_lanes(obj, cfg, mesh, X_local, n, [key],
                     _guess_tensor(float(opt), 1, dev),
                     _guess_tensor(cfg.alpha, 1, dev), model_axis,
                     data_axis, engine)
    return _dist_result(res, mesh, model_axis)


def dash_distributed_regression(
    X, y, cfg: DashConfig, key, opt, mesh,
    *, model_axis: str = "model", data_axis: str | None = "data",
    use_filter_engine: bool = True,
) -> DistDashResult:
    """Regression DASH on the generic runner with ``kmax = cfg.k`` (the
    reference's wrapper); the objective lives on the mesh's device."""
    from repro_torch.core.objectives.regression import RegressionObjective

    obj = RegressionObjective(X, y, kmax=cfg.k,
                              use_filter_engine=use_filter_engine,
                              device=mesh.device)
    return dash_distributed(obj, cfg, key, opt, mesh, model_axis=model_axis,
                            data_axis=data_axis)


# ---------------------------------------------------------------------------
# the guess lattice over the pod axis
# ---------------------------------------------------------------------------

def _commit_lattice_winner(res: _Lanes, g_local: int, mesh, pod_axis: str,
                           model_axis: str) -> LatticeDistResult:
    """The pod slice's best lane, then the global commit: an
    ``all_gather`` of the slices' best values, a replicated argmax, and a
    broadcast of the winning slice's result.  A NaN lane never wins
    (``nan_to_neginf`` in both argmaxes)."""
    dev = res.value.device
    bi = int(torch.argmax(nan_to_neginf(res.value)))
    best = take_lane(res, bi)
    vals_pod = mesh.all_gather(best.value, pod_axis)           # (Pp,)
    gbi = int(torch.argmax(nan_to_neginf(vals_pod)))
    best = tree_map(lambda x: mesh.broadcast(x, pod_axis, gbi), best)
    bi_w = mesh.broadcast(torch.tensor(bi, device=dev), pod_axis, gbi)
    lattice_values = mesh.all_gather(res.value, pod_axis).reshape(-1)
    return LatticeDistResult(
        sel_mask=_global_mask(best.sel_local, mesh, model_axis),
        sel_count=best.count, value=best.value, rounds=best.rounds,
        trace=best.trace, lattice_values=lattice_values,
        best_guess=(gbi * g_local + bi_w).to(torch.int32))


def dash_auto_distributed(
    obj, k: int, key, mesh,
    *, eps: float = 0.2, alpha: float = 0.5, r: int = 0,
    n_samples: int = 8, n_guesses: int = 8, trim_frac: float = 0.0,
    alphas=None, pod_axis: str = "pod", model_axis: str = "model",
    data_axis: str | None = "data", precision: str | None = None,
    resilience: ResilienceConfig | None = None,
    resume: str | bool | None = None, failure_injector=None,
) -> LatticeDistResult:
    """Distributed DASH over the whole (OPT, α) guess lattice.

    The joint lattice (``opt_guess_lattice`` × ``alphas``, OPT-major, the
    grid of the single-device ``dash_auto``) is laid over the ``pod``
    axis: each pod slice runs its n_guesses_total / pod guesses as lanes
    in lockstep over its own ``data`` / ``model`` ranks.  The only
    traffic across pods is the final commit.  The mesh needs the ``pod``
    axis, and the joint guesses must divide its size.

    ``resilience`` / ``resume`` / ``failure_injector`` switch to the
    round-stepped runtime (see :func:`dash_distributed`), which
    snapshots every guess's carry; a resume keeps the lattice width, the
    pod and the data axis sizes, and may change the model-axis width.
    """
    if precision is not None:
        obj = with_precision(obj, precision)
    n, _ = _check_sharding(obj, mesh, model_axis)
    if pod_axis not in mesh.shape:
        raise ValueError(f"dash_auto_distributed needs a {pod_axis!r} axis; "
                         f"the mesh has {tuple(mesh.shape)}")
    cfg = DashConfig(k=k, r=r, eps=eps, alpha=alpha, n_samples=n_samples,
                     trim_frac=trim_frac).resolve(n)
    pp = mesh.size(pod_axis)
    guesses = opt_guess_lattice(obj, eps, n_guesses, k)
    opts, alphas_arr = lattice_grid(guesses,
                                    [alpha] if alphas is None else alphas)
    n_runs = int(opts.shape[0])
    if n_runs % pp:
        raise ValueError(f"joint guesses {n_runs} must be divisible by the "
                         f"pod axis ({pp})")
    g_local = n_runs // pp
    keys = key.split(n_runs)
    engine = resolve_engine(obj, dist=True)
    if resilience is not None or resume or failure_injector is not None:
        return _dash_auto_distributed_stepped(
            obj, cfg, keys, opts, alphas_arr, mesh, g_local, pod_axis,
            model_axis, data_axis, engine, resilience, resume,
            failure_injector)
    p = mesh.index(pod_axis)
    mine = slice(p * g_local, (p + 1) * g_local)
    X_local = shard_columns(obj.X, mesh, model_axis)
    res = _run_lanes(obj, cfg, mesh, X_local, n, keys[mine], opts[mine],
                     alphas_arr[mine], model_axis, data_axis, engine)
    return _commit_lattice_winner(res, g_local, mesh, pod_axis, model_axis)


# ---------------------------------------------------------------------------
# the round-stepped runtime: snapshots, elastic resume, stragglers
# ---------------------------------------------------------------------------

def _state_specs(obj, pod_axis: str | None, model_axis: str):
    """Per-leaf specs of the objective's dist state, found without
    extending the contract: ``dist_init`` on probes of 1 and 2 lanes and
    of 1 and 2 columns; the dimension that moves with the lanes is the
    lane axis (over ``pod`` in a lattice), the one that moves with the
    columns is the shard's column axis (over ``model``)."""
    probe = {w: torch.zeros((obj.d, w), device=obj.device) for w in (1, 2)}
    base = obj.dist_init(probe[1], 1)
    more_lanes = obj.dist_init(probe[1], 2)
    more_cols = obj.dist_init(probe[2], 1)

    def spec(a, b, c):
        out = [None] * a.dim()
        for dim in range(a.dim()):
            if a.shape[dim] != b.shape[dim] and pod_axis:
                out[dim] = pod_axis
            if a.shape[dim] != c.shape[dim]:
                out[dim] = model_axis
        return tuple(out)

    return type(base)(*(spec(a, b, c)
                        for a, b, c in zip(base, more_lanes, more_cols)))


def _carry_specs(obj, pod_axis: str | None, model_axis: str):
    """Specs of a carry in snapshot form (``carry_snapshot``): lanes over
    ``pod`` (lattice only), shard columns over ``model``."""
    lane = (pod_axis,) if pod_axis else ()
    lane_cols = (pod_axis, model_axis) if pod_axis else (None, model_axis)
    return SelectionCarry(
        state=(_state_specs(obj, pod_axis, model_axis), lane_cols),
        alive=lane_cols, count=lane,
        key={"seed": lane, "host": lane},
        trace=DashTrace(values=lane, alive=lane, filter_iters=lane,
                        est_set_gain=lane))


def _snapshot_meta(algo: str, cfg: DashConfig, n: int,
                   data_size: int) -> dict:
    """Manifest ``extra`` of a round snapshot: what a resume must agree
    on.  The model-axis width is absent — that is the freedom the
    elastic restore has."""
    return {"algo": algo, "n": int(n), "k": int(cfg.k), "r": int(cfg.r),
            "n_samples": int(cfg.n_samples),
            "data_axis_size": int(data_size)}


def _global_like(snap, specs, mesh):
    """Meta tensors (numpy zeros for numpy leaves) of the global shapes
    of a local snapshot — the ``like`` tree of a restore."""
    import numpy as np

    def one(x, spec):
        shape = list(x.shape)
        for dim, axis in enumerate(tuple(spec or ())):
            if axis:
                shape[dim] *= mesh.size(axis)
        if isinstance(x, torch.Tensor):
            return torch.empty(shape, dtype=x.dtype, device="meta")
        return np.zeros(shape, dtype=np.asarray(x).dtype)

    return tree_map(one, snap, specs)


class _Stepper:
    """What the stepped runtimes share for one mesh: the local initial
    carry, the snapshot view, the restore and the round step."""

    def __init__(self, obj, cfg: DashConfig, mesh, keys, opts, alphas,
                 model_axis, data_axis, pod_axis, engine, resilience):
        n = obj.X.shape[1]
        self.obj, self.cfg, self.mesh = obj, cfg, mesh
        self.model_axis, self.data_axis = model_axis, data_axis
        self.engine = engine
        self.X_local = shard_columns(obj.X, mesh, model_axis)
        dev = self.X_local.device
        self.keys = list(keys)
        self.opts = _guess_tensor(opts, len(self.keys), dev)
        self.alphas = _guess_tensor(alphas, len(self.keys), dev)
        self.n = n
        res = resilience if resilience is not None else ResilienceConfig()
        self.policy = res.resolved_policy() if res.straggler else None
        self.specs = _carry_specs(obj, pod_axis, model_axis)

    def init(self):
        state0, alive0 = _init_state_alive(self.obj, self.X_local,
                                           len(self.keys))
        return initial_carry(self.cfg, self.keys, state0, alive0)

    def step(self, rho, carry, arrived):
        hooks = _make_hooks(
            self.obj, self.cfg, self.mesh, self.X_local, self.n,
            self.model_axis, self.data_axis, self.engine,
            arrived=arrived if self.policy is not None else None,
            policy=self.policy)
        return make_round_body(hooks, self.cfg)(rho, carry, self.opts,
                                                self.alphas)

    def view(self, carry):
        """The global carry on the mesh's writer, ``None`` elsewhere
        (collective: every member gathers)."""
        glob = gather_tree(carry_snapshot(carry), self.specs, self.mesh)
        return carry_from_snapshot(glob) if self.mesh.is_writer else None

    def restore(self, resume_dir: str, expect_meta: dict):
        """The newest complete snapshot resharded onto this mesh, and
        its round; ``None`` without one.  The manifest's meta must agree
        with ``expect_meta`` (another data-axis size, lattice or problem
        fails loudly instead of diverging)."""
        from repro_torch.ckpt.checkpoint import (
            latest_complete_step,
            read_manifest,
            restore_checkpoint,
        )

        self.mesh.barrier()        # the writer's last save has landed
        step = latest_complete_step(resume_dir)
        if step is None:
            return None
        meta = read_manifest(resume_dir, step).get("extra", {})
        for name, want in expect_meta.items():
            got = meta.get(name)
            if got is not None and got != want:
                raise ValueError(
                    f"snapshot {resume_dir} step {step}: {name}={got!r} is "
                    f"incompatible with the resume target ({name}={want!r})")
        like = _global_like(carry_snapshot(self.init()), self.specs,
                            self.mesh)
        snap, _ = restore_checkpoint(resume_dir, like, step=step,
                                     mesh=self.mesh, specs=self.specs)
        return carry_from_snapshot(snap), int(meta["round"])


def _drive_stepped(stepper: _Stepper, cfg: DashConfig, resilience, resume,
                   failure_injector, meta: dict):
    carry, start_round = None, 0
    if resume:
        resume_dir = resume
        if resume is True:
            resume_dir = resilience.ckpt_dir if resilience else None
            if not resume_dir:
                raise ValueError("resume=True needs resilience.ckpt_dir")
        restored = stepper.restore(resume_dir, meta)
        if restored is not None:
            carry, start_round = restored
    if carry is None:
        carry = stepper.init()
    return drive_checkpointed_rounds(
        stepper.step, carry, cfg, resilience=resilience,
        start_round=start_round, failure_injector=failure_injector,
        snapshot_extra=meta, snapshot_view=stepper.view)


def _dash_distributed_stepped(obj, cfg, key, opt, mesh, model_axis,
                              data_axis, engine, resilience, resume,
                              failure_injector) -> DistDashResult:
    """Host-stepped :func:`dash_distributed` (resolved cfg)."""
    stepper = _Stepper(obj, cfg, mesh, [key], float(opt), cfg.alpha,
                       model_axis, data_axis, None, engine, resilience)
    meta = _snapshot_meta("dash_distributed", cfg, stepper.n,
                          mesh.size(data_axis))
    carry = _drive_stepped(stepper, cfg, resilience, resume,
                           failure_injector, meta)
    return _dist_result(_lane_results(obj, cfg, carry), mesh, model_axis)


def _dash_auto_distributed_stepped(obj, cfg, keys, opts, alphas, mesh,
                                   g_local, pod_axis, model_axis, data_axis,
                                   engine, resilience, resume,
                                   failure_injector) -> LatticeDistResult:
    """Host-stepped lattice: snapshot and resume the whole pod sweep."""
    p = mesh.index(pod_axis)
    mine = slice(p * g_local, (p + 1) * g_local)
    stepper = _Stepper(obj, cfg, mesh, keys[mine], opts[mine], alphas[mine],
                       model_axis, data_axis, pod_axis, engine, resilience)
    meta = _snapshot_meta("dash_auto_distributed", cfg, stepper.n,
                          mesh.size(data_axis))
    # The guess → pod layout is part of the key stream.
    meta["n_runs"] = int(opts.shape[0])
    meta["pod_axis_size"] = int(mesh.size(pod_axis))
    carry = _drive_stepped(stepper, cfg, resilience, resume,
                           failure_injector, meta)
    return _commit_lattice_winner(_lane_results(obj, cfg, carry), g_local,
                                  mesh, pod_axis, model_axis)


def dash_distributed_restartable(
    obj, cfg: DashConfig, key, opt,
    *, resilience: ResilienceConfig, mesh_provider,
    model_axis: str = "model", data_axis: str | None = "data",
    precision: str | None = None, failure_injector=None,
    max_failures: int = 3, backoff_s: float = 0.0, sleep_fn=None,
) -> DistDashResult:
    """``run_with_restart`` driving restore → (elastic) reshard →
    continue.

    ``mesh_provider()`` is asked at every (re)start and may return
    another mesh than the last attempt ran on (a lost rank shrinks the
    fleet; ``runtime/elastic.py::elastic_mesh`` builds the survivors'
    mesh); the newest complete snapshot in ``resilience.ckpt_dir`` is
    resharded onto it.  ``failure_injector`` (checked before each round,
    on every rank) makes this the kill-and-resume test.  Saves ride
    ``run_with_restart``'s at-most-once ``on_step`` hook, so replayed
    rounds never save twice.
    """
    from repro_torch.runtime.fault_tolerance import run_with_restart

    if not resilience.ckpt_dir:
        raise ValueError(
            "dash_distributed_restartable needs resilience.ckpt_dir")
    if precision is not None:
        obj = with_precision(obj, precision)
    n = obj.X.shape[1]
    cfg = cfg.resolve(n)
    engine = resolve_engine(obj, dist=True)
    ctx: dict = {}
    ckpt = RoundCheckpointer(resilience)

    def activate():
        mesh = mesh_provider()
        _check_sharding(obj, mesh, model_axis)
        ctx["mesh"] = mesh
        ctx["stepper"] = _Stepper(obj, cfg, mesh, [key], float(opt),
                                  cfg.alpha, model_axis, data_axis, None,
                                  engine, resilience)
        ctx["meta"] = _snapshot_meta("dash_distributed", cfg, n,
                                     mesh.size(data_axis))

    def make_state():
        activate()
        carry = ctx["stepper"].init()
        keys_snapshot(carry.key)      # a key without a snapshot form raises
        return carry, 0

    def restore():
        ckpt.wait(raise_errors=False)
        activate()
        return ctx["stepper"].restore(resilience.ckpt_dir, ctx["meta"])

    def step_fn(carry, rho):
        if failure_injector is not None:
            failure_injector.check(rho)
        return ctx["stepper"].step(rho, carry,
                                   round_arrivals(resilience, cfg, rho))

    def on_step(carry, rho):
        if (rho + 1) % resilience.every == 0:
            view = ctx["stepper"].view(carry)
            if view is not None:
                ckpt.save(rho + 1, view, extra=ctx["meta"])

    kw = {} if sleep_fn is None else {"sleep_fn": sleep_fn}
    carry = run_with_restart(
        total_steps=cfg.r, make_state=make_state, restore=restore,
        step_fn=step_fn, on_step=on_step, max_failures=max_failures,
        backoff_s=backoff_s, **kw)
    ckpt.wait()
    return _dist_result(_lane_results(obj, cfg, carry), ctx["mesh"],
                        model_axis)


# ---------------------------------------------------------------------------
# the sharded §5 baselines — every competitor on the same contract
# ---------------------------------------------------------------------------

def greedy_distributed(obj, k: int, mesh, *, key=None,
                       model_axis: str = "model") -> DistSelectResult:
    """Parallel SDS_MA on a mesh: each of the k picks is one shard-local
    gain sweep (``dist_gains``, the kernel on the card), an
    ``all_gather`` of the shards' best and one summed column fetch.  Ties
    go to the lowest rank, hence the lowest global index.  ``key`` is
    unused (greedy is deterministic)."""
    return _greedy_family(obj, int(k), mesh, model_axis, None, None)


def stochastic_greedy_distributed(
    obj, k: int, key, mesh, *, subsample: int | None = None,
    eps: float = 0.1, model_axis: str = "model",
) -> DistSelectResult:
    """Distributed stochastic greedy: each round's sample is the global
    top-s of the replicated per-round Gumbel draw (the single-device
    noise layout), so for the same key the two runtimes select the same
    set.  Each shard sweeps its whole block and masks it to the sample
    (the column contract has no subset oracle)."""
    from repro_torch.core.greedy import subsample_size

    n = obj.X.shape[1]
    s = (subsample_size(n, int(k), eps) if subsample is None
         else max(1, min(int(subsample), n)))
    return _greedy_family(obj, int(k), mesh, model_axis, s, key)


def _greedy_family(obj, k: int, mesh, model_axis: str,
                   subsample: int | None, key) -> DistSelectResult:
    from repro_torch.core.greedy import round_gumbel

    n, n_local = _check_sharding(obj, mesh, model_axis)
    X_local = shard_columns(obj.X, mesh, model_axis)
    dev = X_local.device
    rank = mesh.index(model_axis)
    alive0 = torch.sum(X_local * X_local, dim=0) > 0
    ds = obj.dist_init(X_local, 1)
    sel = torch.zeros((1, n_local), dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    values = torch.zeros((k,), device=dev)
    ninf = torch.full((1, n_local), -torch.inf, device=dev)
    for i in range(k):
        g = torch.where(sel | ~alive0, ninf, obj.dist_gains(ds, X_local))
        if subsample is not None:
            noise = round_gumbel(key, i, n, dev)[rank * n_local:
                                                 (rank + 1) * n_local]
            noise = torch.where(sel, ninf, noise[None])
            t = min(subsample, n_local)
            lv = top_k(noise, t)[0]
            av = mesh.all_gather(lv, model_axis).reshape(1, -1)
            thr = top_k(av, subsample)[0][:, -1:]
            g = torch.where(noise >= thr, g, ninf)
        # Per-shard best → all_gather → replicated argmax (the lowest
        # shard on ties) → the winning column summed over the axis.
        lmax = torch.max(g)
        larg = torch.argmax(g[0])
        allmax = mesh.all_gather(lmax, model_axis)
        wshard = torch.argmax(allmax)
        accept = torch.isfinite(allmax[wshard]) & (count < k)
        win = (wshard == rank) & accept
        col = torch.where(win, X_local[:, larg], torch.zeros_like(X_local[:, 0]))
        C = mesh.psum(col, model_axis)[None, :, None]
        ds = obj.dist_add_set(ds, C, accept.reshape(1, 1), X_local)
        sel = _scatter_true(sel, larg.reshape(1, 1), win.reshape(1, 1))
        values[i] = obj.dist_value(ds)[0]
        count = count + accept.to(torch.int32)
    return DistSelectResult(_global_mask(sel[0], mesh, model_axis), count,
                            obj.dist_value(ds)[0], values)


def _one_shot(obj, kk: int, mesh, model_axis: str, key) -> DistSelectResult:
    """TOP-k (``key`` None: the singleton gains) or RANDOM (the
    replicated Gumbel draw's slice) in one round: the global top-k, one
    column fetch, one state update."""
    from repro_torch.core.estimators import gumbel_noise

    n, n_local = _check_sharding(obj, mesh, model_axis)
    X_local = shard_columns(obj.X, mesh, model_axis)
    dev = X_local.device
    rank = mesh.index(model_axis)
    alive0 = torch.sum(X_local * X_local, dim=0) > 0
    ds0 = obj.dist_init(X_local, 1)
    if key is None:
        scores = obj.dist_gains(ds0, X_local)
    else:
        scores = gumbel_noise(key, n, dev)[None, rank * n_local:
                                           (rank + 1) * n_local]
    scores = torch.where(alive0, scores, torch.full_like(scores, -torch.inf))
    idx, owned, valid = _global_topk(scores, kk, mesh, model_axis)
    C = _dist_gather_columns(X_local, idx, owned, mesh, model_axis)
    ds = obj.dist_add_set(ds0, C, valid, X_local)
    sel = _scatter_true(torch.zeros((1, n_local), dtype=torch.bool,
                                    device=dev), idx, owned)
    count = mesh.psum(torch.sum(owned.to(torch.int32)), model_axis)
    return DistSelectResult(_global_mask(sel[0], mesh, model_axis), count,
                            obj.dist_value(ds)[0],
                            torch.zeros((0,), device=dev))


def top_k_distributed(obj, k: int, mesh, *, key=None,
                      model_axis: str = "model") -> DistSelectResult:
    """TOP-k on a mesh: one sharded singleton sweep, the global top-k,
    one column fetch.  ``k > n`` is clamped; zero (padding) columns never
    take a slot."""
    return _one_shot(obj, min(int(k), obj.X.shape[1]), mesh, model_axis,
                     None)


def random_distributed(obj, k: int, key, mesh, *,
                       model_axis: str = "model") -> DistSelectResult:
    """RANDOM on a mesh: the global top-k of the replicated Gumbel draw —
    the single-device ``random_select``'s set for the same key (padding
    excluded).  ``sel_count`` can be < k when fewer are alive."""
    return _one_shot(obj, min(int(k), obj.X.shape[1]), mesh, model_axis,
                     key)


# ---------------------------------------------------------------------------
# FAST on a mesh
# ---------------------------------------------------------------------------

def _fast_core_distributed(obj, k: int, mesh, X_local, n: int,
                           model_axis: str, eps: float, r_max: int,
                           engine: bool):
    """The single-guess FAST run on this shard: ``run(key, opt) ->
    FastResult`` with a shard-local ``sel_mask``; mirrors
    ``core.fast._fast_core`` (every host decision reads replicated
    values)."""
    from repro_torch.core.estimators import gumbel_noise
    from repro_torch.core.fast import (
        FastResult,
        ladder_commit,
        prefix_masks,
        q_cmp,
    )

    n_local = X_local.shape[1]
    dev = X_local.device
    rank = mesh.index(model_axis)
    L = min(int(k), int(n))
    ar = torch.arange(L, device=dev)
    masks0 = prefix_masks(L, dev)

    def run(key, opt):
        opt = torch.as_tensor(opt, dtype=torch.float32, device=dev)
        ds = obj.dist_init(X_local, 1)
        g0 = obj.dist_gains(ds, X_local)[0]
        # Argmax seed: greedy's global commit on the bf16-compared gains,
        # then the ladder opens one rung below the top singleton gain.
        qg0 = q_cmp(g0).float()
        allmax = mesh.all_gather(torch.max(qg0), model_axis)
        win = torch.argmax(allmax) == rank
        larg = torch.argmax(qg0)
        col = X_local[:, larg]
        col = torch.where(win, col, torch.zeros_like(col))
        C0 = mesh.psum(col, model_axis)[None, :, None]
        one = torch.ones((1, 1), dtype=torch.bool, device=dev)
        ds = obj.dist_add_set(ds, C0, one, X_local)
        sel = _scatter_true(torch.zeros((1, n_local), dtype=torch.bool,
                                        device=dev), larg.reshape(1, 1),
                            win.reshape(1, 1))[0]
        t = (1.0 - eps) * mesh.pmax(torch.max(g0), model_axis)
        t_min = eps * opt / k
        alive = (q_cmp(obj.dist_gains(ds, X_local)[0]) >= q_cmp(t)) & ~sel
        count = torch.ones((), dtype=torch.int32, device=dev)
        values = torch.zeros((r_max,), device=dev)
        rho = 0
        while rho < r_max and bool((count < k) & (t >= t_min)):
            key, k_seq = key.split(2)
            noise = gumbel_noise(k_seq, n, dev)[rank * n_local:
                                                (rank + 1) * n_local]
            scores = torch.where(alive, noise,
                                 torch.full_like(noise, -torch.inf))
            idx, owned, valid = _global_topk(scores[None], L, mesh,
                                             model_axis)
            idx, owned, valid = idx[0], owned[0], valid[0]
            allowed = torch.clamp(k - count, 0, L)
            slot_ok = valid & (ar < allowed)
            C = _dist_gather_columns(X_local, idx, owned & slot_ok, mesh,
                                     model_axis)                 # (d, L)
            masks = masks0 & slot_ok[None, :]
            if engine:
                Cs = C[None, None].expand(1, L + 1, -1, -1)
                G = obj.dist_filter_gains_batch(ds, Cs, masks[None],
                                                X_local)[0]
            else:
                G = torch.cat([
                    obj.dist_gains(obj.dist_add_set(ds, C[None], m[None],
                                                    X_local), X_local)
                    for m in masks])
            G = torch.where(sel[None, :], torch.zeros_like(G), G)
            # The prefix decision: each shard adds the insertion-point
            # gains of the sequence elements it owns.
            gi = G[ar, idx]
            marg = mesh.psum(torch.where(owned, gi, torch.zeros_like(gi)),
                             model_axis)
            c_len, t = ladder_commit(slot_ok, marg, t, eps)
            commit = ar < c_len
            ds = obj.dist_add_set(ds, C[None], commit[None], X_local)
            sel = _scatter_true(sel[None], idx[None],
                                (owned & commit)[None])[0]
            count = count + c_len
            g_c = G[c_len.long()]
            alive = (q_cmp(g_c) >= q_cmp(t)) & ~sel
            values[rho] = obj.dist_value(ds)[0]
            rho += 1
        return FastResult(
            sel_mask=sel, sel_count=count, value=obj.dist_value(ds)[0],
            rounds=torch.tensor(rho, dtype=torch.int32, device=dev),
            values=values, opt=opt)

    return run


def fast_distributed(
    obj, k: int, key, mesh, *, eps: float = 0.06, opt=None,
    n_guesses: int = 8, max_rounds: int = 0,
    model_axis: str = "model", precision: str | None = None,
) -> FastDistResult:
    """FAST on a mesh — the distributed twin of ``core.fast.fast``.

    The sequence draw is the global top-L of the replicated Gumbel
    vector, so for the same key (and a pinned ``opt=``, or the binary
    search over the ``n_guesses`` lattice, run the same way on every
    rank) the committed set is the single-device one.  Per round: the
    global top-L, one column fetch, the L + 1 prefix sweeps as one
    shard-local engine call (or, with the objective's
    ``use_filter_engine`` off, one sweep a prefix), and one sum for the
    prefix decision.
    """
    from repro_torch.core.fast import binary_search_opt, fast_round_cap
    from repro_torch.core.random import SeedKey

    if precision is not None:
        obj = with_precision(obj, precision)
    n, _ = _check_sharding(obj, mesh, model_axis)
    k = int(k)
    if k <= 0:
        raise ValueError(f"k must be a positive integer, got {k!r}")
    eps = float(eps)
    if key is None:
        key = SeedKey(0)
    engine = resolve_engine(obj, dist=True)
    r_max = int(max_rounds) or fast_round_cap(k, eps)
    X_local = shard_columns(obj.X, mesh, model_axis)
    if opt is not None:
        guesses = torch.as_tensor(opt, dtype=torch.float32).reshape(1)
        guesses = guesses.to(X_local.device)
    else:
        guesses = opt_guess_lattice(obj, eps, n_guesses, k)
    core = _fast_core_distributed(obj, k, mesh, X_local, n, model_axis, eps,
                                  r_max, engine)
    best = binary_search_opt(core, key, guesses, eps)
    return FastDistResult(
        sel_mask=_global_mask(best.sel_mask, mesh, model_axis),
        sel_count=best.sel_count, value=best.value, rounds=best.rounds,
        values=best.values, opt=best.opt)


def pad_ground_set(X, multiple: int):
    """Pad the candidate columns of X (d, n) with zeros to a multiple of
    ``multiple``; returns ``(X_padded, n)``.  Zero columns are never
    selected: the sharded runner starts them outside the alive set, and
    every objective's accept rule rejects zero columns."""
    d, n = X.shape
    n_pad = (-n) % multiple
    if n_pad == 0:
        return X, n
    return torch.cat([X, torch.zeros((d, n_pad), dtype=X.dtype,
                                     device=X.device)], dim=1), n
