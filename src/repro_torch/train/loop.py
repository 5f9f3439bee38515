"""Training loop: the train step, checkpoint/restart and periodic coreset
selection through the ``select`` registry.

A port of ``repro/train/loop.py``.  Every
``selection_every`` steps the loop draws a candidate pool
(``selection_pool_factor`` × the examples it will train on), scores the
candidates with ``coreset_features`` under the current parameters (on
the card: the backbone's attention through kernel 8, with no gradient),
and keeps the best coreset by running the selector's registry algorithm
(``BatchSelector``: kernel 4, and kernel 5 when a DASH round filters).
The selection key and the current period's selected indices live in the
checkpointed :class:`LoopState`, so kill-and-resume replays the same
selected batches: a restore mid-period reuses the stored indices
instead of selecting again with other parameters.

The pool's features are computed in chunks of at most ``selector.k``
sequences, so that the (rows, S, V) logits of the gradient features stay
a batch's size (a pool of 64 × 2048 tokens of a 49,152-token vocabulary
would hold two 25.8 GB f32 tensors at once).  A row's features depend on
that row alone except through an MoE's capacity, so an arch with
``cfg.moe`` scores its pool whole.

On a mesh (``mesh=``, a ``launch/mesh.py::Mesh`` that every rank builds
and passes; each rank runs the loop, SPMD) the loop is data parallel, as
the reference's under its mesh:
  * each step's batch goes through ``data.pipeline.shard_batch``, and
    the step (``make_train_step(..., mesh=)``) sums the gradients over
    the batch axes; the parameters and every other leaf of the loop's
    state stay replicated;
  * each rank computes the features of its own rows of the pool (in
    chunks of at most ``selector.k`` rows, kernel 8 on the card), and an
    all-gather over the batch axes, in row order, gives every rank the
    whole pool's features; with ``cfg.moe`` every rank computes the
    whole pool, as one device does;
  * the selector runs the algorithm's distributed twin on the mesh
    (the candidates sharded over ``model``), with the same key on every
    rank;
  * one rank writes each checkpoint, whole, and the others wait for it
    at a barrier; on a restart every rank restores, so a run resumes on
    any world size (the state is the same on every rank);
  * a failure raised at the top of a step (``failure_injector``) comes
    before any collective of that step, so every rank fails at the same
    step and each one's ``run_with_restart`` resumes it; a failed
    collective ends the run.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, restore_checkpoint
from repro_torch.core.objectives.coreset import coreset_features
from repro_torch.core.random import SeedKey
from repro_torch.data.pipeline import pool_from_callable, shard_batch
from repro_torch.data.selection import BatchSelector
from repro_torch.kernels.common import resolve_device
from repro_torch.runtime.fault_tolerance import FailureInjector, run_with_restart
from repro_torch.sharding.partitioning import batch_axes_for_mesh
from repro_torch.train.step import TrainState, init_train_state, make_train_step

log = logging.getLogger(__name__)


class LoopState(NamedTuple):
    """The checkpointed tree: model and optimizer, and the selection's
    replay state.  ``cur_sel`` has a fixed shape (k · selection_every,)
    so that every checkpoint has the same manifest; ``cur_period`` = −1
    means that no selection has been made yet."""

    train: TrainState
    sel_key: np.ndarray      # the selection key's ``as_array()``
    cur_period: np.ndarray   # () int32: the period ``cur_sel`` belongs to
    cur_sel: np.ndarray      # (k · selection_every,) int32 pool indices


@dataclass
class LoopResult:
    state: TrainState
    losses: list
    steps_run: int
    restarts: int
    # period → selected example ids (stream ids for TokenPipeline
    # sources, pool-local for bare callables): the restart tests compare
    # them across runs.
    selections: dict = field(default_factory=dict)
    selection_time_s: float = 0.0
    # Host seconds of each step that ran (the train step and the read of
    # its loss), and of each selection (features and select).
    step_seconds: list = field(default_factory=list)
    selection_seconds: list = field(default_factory=list)
    # On a mesh: host seconds of each step's gradient all-reduce.
    allreduce_seconds: list = field(default_factory=list)


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train_loop(
    model,
    tcfg,
    batch_source,
    *,
    device=None,
    mesh=None,
    ckpt_dir: str | None = None,
    selector: BatchSelector | None = None,
    selection_every: int = 1,
    selection_pool_factor: int = 4,
    failure_injector: FailureInjector | None = None,
    log_every: int = 10,
    init_state: TrainState | None = None,
    sel_key=None,
) -> LoopResult:
    """Run ``tcfg.total_steps`` steps on ``device`` (``None``: the card;
    with a ``mesh``, the mesh's device).

    ``batch_source`` is a ``TokenPipeline`` (anything with
    ``batch_for_step`` and ``pool_for_step``) or a bare ``step -> batch``
    callable, pure functions of the step (determinism across restarts).
    With a ``selector``, each selection period (``selection_every``
    steps) trains on a coreset of ``selector.k × selection_every``
    examples picked from a pool ``selection_pool_factor`` × that size.

    ``init_state`` is the state at step 0 (default
    ``init_train_state`` from a generator seeded with ``tcfg.seed``);
    ``sel_key`` the base selection key (default ``SeedKey(tcfg.seed +
    1, host=True)``: the CPU and the card draw the same noise); period
    p selects with ``sel_key.fold_in(p)``.
    """
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh.device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        axes = batch_axes_for_mesh(mesh)
    has_pool = hasattr(batch_source, "pool_for_step")
    batch_for_step: Callable[[int], dict] = (
        batch_source.batch_for_step if has_pool else batch_source)
    selection_every = max(int(selection_every), 1)
    k_sel = (selector.k * selection_every) if selector is not None else 0

    train_step = make_train_step(model, tcfg, mesh=mesh)
    manager = (CheckpointManager(ckpt_dir, every=tcfg.checkpoint_every)
               if ckpt_dir else None)
    losses: list = []
    step_secs: list = []
    sel_secs: list = []
    restarts = [0]
    selections: dict[int, np.ndarray] = {}
    # One pool per period, rebuilt deterministically on demand (also
    # after a restore, so a mid-period resume reads the same rows).
    pool_cache: dict[str, Any] = {"period": None, "batch": None, "ids": None}

    if init_state is None:
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        init_state = init_train_state(model, gen, tcfg)
    if sel_key is None:
        sel_key = SeedKey(tcfg.seed + 1, host=True)
    key_type = type(sel_key)

    def fresh_state() -> LoopState:
        return LoopState(train=init_state, sel_key=sel_key.as_array(),
                         cur_period=np.asarray(-1, np.int32),
                         cur_sel=np.zeros((k_sel,), np.int32))

    def make_state():
        return fresh_state(), 0

    def restore():
        if manager is None:
            return None
        # The write in flight first: a failure right after a save
        # restores that save, so the replay never depends on the writer
        # thread's timing.
        manager.wait(raise_errors=False)
        if manager.latest() is None:
            return None
        restarts[0] += 1 if losses else 0
        state, step = restore_checkpoint(manager.directory, fresh_state())
        log.info("restored checkpoint at step %d", step)
        return state, step + 1

    def pool_for_period(period: int):
        if pool_cache["period"] != period:
            pstep = period * selection_every
            if has_pool:
                pb, ids = batch_source.pool_for_step(
                    pstep, k_sel * selection_pool_factor)
            else:
                pb, ids = pool_from_callable(
                    batch_for_step, pstep,
                    selection_pool_factor * selection_every)
            if next(iter(pb.values())).shape[0] < k_sel:
                raise ValueError("candidate pool smaller than the coreset")
            pool_cache.update(period=period, batch=pb, ids=ids)
        return pool_cache["batch"], pool_cache["ids"]

    def features(params, pb: dict) -> torch.Tensor:
        n = next(iter(pb.values())).shape[0]
        whole = model.cfg.moe is not None
        step = n if whole else selector.k
        rows = (_to_device(pb, dev) if mesh is None or whole
                else shard_batch(pb, mesh))
        mine = next(iter(rows.values())).shape[0]
        with torch.no_grad():
            f = torch.cat([
                coreset_features(
                    model, params, {k: v[i:i + step] for k, v in rows.items()},
                    mode=selector.feature_mode)
                for i in range(0, mine, step)])
        if mine == n:
            return f
        return mesh.all_gather(f, axes).reshape(n, -1)

    def ensure_selection(state: LoopState, period: int) -> LoopState:
        pb, ids = pool_for_period(period)
        if int(state.cur_period) != period:
            t0 = time.perf_counter()
            feats = features(state.train.params, pb)
            pkey = key_type.from_array(state.sel_key).fold_in(period)
            idx = selector.select(feats, pkey, k=k_sel, mesh=mesh)
            state = state._replace(
                cur_period=np.asarray(period, np.int32),
                cur_sel=idx.cpu().numpy().astype(np.int32))
            sel_secs.append(time.perf_counter() - t0)
        # Recorded from the (possibly restored) state, so that a resumed
        # run logs the selection it trains on.
        selections[period] = np.asarray(ids)[state.cur_sel]
        return state

    def batch_at(state: LoopState, step: int):
        if selector is None:
            return batch_for_step(step), state
        period = step // selection_every
        state = ensure_selection(state, period)
        pb, _ = pool_for_period(period)
        off = (step % selection_every) * selector.k
        rows = state.cur_sel[off:off + selector.k]
        return {k: np.asarray(v)[rows] for k, v in pb.items()}, state

    def save(step: int, state: LoopState) -> None:
        if manager is None:
            return
        if mesh is None:
            manager.maybe_save(step, state)
        elif step % manager.every == 0:
            # One writer; the others wait until its write is whole.
            if mesh.is_writer:
                manager.maybe_save(step, state, blocking=True)
            mesh.barrier()

    def step_fn(state: LoopState, step: int) -> LoopState:
        if failure_injector is not None:
            failure_injector.check(step)
        batch, state = batch_at(state, step)
        batch = (_to_device(batch, dev) if mesh is None else
                 shard_batch(batch, mesh, microbatches=tcfg.microbatches))
        t0 = time.perf_counter()
        new_train, metrics = train_step(state.train, batch)
        state = state._replace(train=new_train)
        loss = float(metrics["loss"])
        step_secs.append(time.perf_counter() - t0)
        losses.append(loss)
        if step % log_every == 0:
            log.info("step %d loss %.4f (%.3fs)", step, loss, step_secs[-1])
        save(step, state)
        return state

    state = run_with_restart(total_steps=tcfg.total_steps,
                             make_state=make_state, restore=restore,
                             step_fn=step_fn, fatal=_fatal(mesh))
    if manager is not None:
        manager.wait()
    return LoopResult(state=state.train, losses=losses,
                      steps_run=len(losses), restarts=restarts[0],
                      selections=selections,
                      selection_time_s=float(sum(sel_secs)),
                      step_seconds=step_secs, selection_seconds=sel_secs,
                      allreduce_seconds=list(train_step.allreduce_seconds))


def _fatal(mesh) -> tuple:
    """The failures a rank of ``mesh`` must not restart from: a failed
    collective (its peers are gone or out of step)."""
    if mesh is None:
        return ()
    import torch.distributed as dist

    return (dist.DistError,)
