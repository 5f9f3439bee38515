"""Bucket runners: many requests, one launch per round.

Ports ``repro/serve/batcher.py``.  A bucket of B requests against one
dataset is DASH on B lanes in lockstep — per-lane keys and per-lane
(OPT, α) guesses — so the batcher reuses the selection loop's
``initial_carry`` and ``make_round_body`` over ``_single_device_hooks``
and adds only the serving calling convention:

* a runner is built from the resolved config alone and takes the
  entry's current objective as its first argument at every call, so it
  survives warm cache updates (``serve/cache.py``);
* DASH buckets are stepped round by round from the host
  (:class:`DashBucket`: init/step/finalize), so the server can keep
  every round boundary for hedged resume, enforce deadlines between
  rounds and inject failures deterministically.  One ``step`` advances
  all B lanes one round, and each of its filter iterations scores every
  lane and sample in one engine call (kernel 3 or 5 on the card, kernel
  7 for classification);
* ``topk`` is deterministic: it runs once and is broadcast over the
  lanes.  ``stochastic_greedy`` runs its lanes one after another, as
  ``core/algorithms.py::select_batched`` does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.algorithms import select_batched
from repro_torch.core.baselines import top_k_select
from repro_torch.core.dash import _single_device_hooks
from repro_torch.core.selection_loop import (
    DashConfig,
    initial_carry,
    make_round_body,
)


class BatchOutput(NamedTuple):
    """Per-lane results of one bucket launch (leading axis = lane)."""

    sel_mask: torch.Tensor    # (B, n) bool
    sel_count: torch.Tensor   # (B,) int32
    value: torch.Tensor       # (B,) f32


class DashBucket(NamedTuple):
    """Host-steppable DASH bucket.

    ``init(obj, keys) -> carry`` builds the B-lane round-0 carry;
    ``step(obj, rho, carry, opts, alphas) -> carry`` advances all lanes
    one round (the hedge, snapshot and deadline boundary) and writes no
    tensor of ``carry`` in place; ``finalize(obj, carry) -> BatchOutput``
    reads out the results.
    """

    init: Callable
    step: Callable
    finalize: Callable
    cfg: DashConfig          # resolved — cfg.r is the step count


def build_dash_bucket(cfg: DashConfig) -> DashBucket:
    """The three DASH-bucket entry points for a resolved config; the lane
    count is that of the ``keys`` given to ``init``."""

    def init(obj, keys):
        B = len(keys)
        return initial_carry(cfg, keys, obj.init(B),
                             torch.ones((B, obj.n), dtype=torch.bool,
                                        device=obj.device))

    def step(obj, rho, carry, opts, alphas):
        body = make_round_body(_single_device_hooks(obj, cfg), cfg)
        return body(rho, carry, opts, alphas)

    def finalize(obj, carry):
        return BatchOutput(sel_mask=carry.state.sel_mask,
                           sel_count=carry.count,
                           value=obj.value(carry.state))

    return DashBucket(init=init, step=step, finalize=finalize, cfg=cfg)


def build_single_shot(tier: str, k: int, **opts) -> Callable:
    """One-launch runner ``run(obj, keys) -> BatchOutput`` for the
    degraded tiers."""
    if tier == "stochastic_greedy":

        def run(obj, keys):
            res = select_batched("stochastic_greedy", obj, k, keys,
                                 device=obj.device, **opts)
            return BatchOutput(sel_mask=res.sel_mask,
                               sel_count=res.sel_count, value=res.value)

        return run

    if tier == "topk":

        def run(obj, keys):
            # Deterministic: every lane would compute the same set.
            res = top_k_select(obj, k, device=obj.device)
            B = len(keys)
            return BatchOutput(
                sel_mask=res.sel_mask.expand((B,) + res.sel_mask.shape),
                sel_count=res.sel_count.expand((B,)),
                value=res.value.expand((B,)),
            )

        return run

    raise ValueError(f"no single-shot executor for tier {tier!r}")


def build_opt_probe(k: int) -> Callable:
    """``probe(obj) -> float``: the TOP-k objective value, the cheap lower
    bound the server scales by its ``opt_margin`` into DASH's OPT guess
    (cached per (dataset, k), dropped by warm updates)."""

    def probe(obj):
        return float(top_k_select(obj, k, device=obj.device).value)

    return probe


__all__ = ["BatchOutput", "DashBucket", "build_dash_bucket",
           "build_single_shot", "build_opt_probe"]
