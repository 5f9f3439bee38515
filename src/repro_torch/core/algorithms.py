"""Selection-algorithm registry — one entry point for every §5 competitor.

Ports the single-device half of ``repro/core/algorithms.py``:

    from repro_torch.core import select
    res = select("greedy", obj, k)                  # on the card
    res = select("fast", obj, k, key, device="cpu") # the plain path

    res = select("dash", obj, k, key, mesh=mesh)    # sharded (SPMD)

Every algorithm is an :class:`AlgorithmSpec`: its single-device
implementation, an adaptivity/query cost model for the benchmark tables,
and its ``distributed`` twin on a ``launch/mesh.py::Mesh``
(``core/distributed.py``; ``None`` for lazy greedy and adaptive
sequencing, as in the reference).  ``select`` normalizes every native
result into one :class:`SelectionResult`.  ``device=None`` means the
card (the mesh's device with ``mesh=``), as for every entry point of the
port; it is checked against the objective's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.adaptive_sequencing import adaptive_sequencing
from repro_torch.core.baselines import random_select, top_k_select
from repro_torch.core.fast import fast, fast_cost
from repro_torch.core.greedy import (
    greedy,
    greedy_parallel_cost,
    lazy_greedy,
    lazy_greedy_cost,
    stochastic_greedy,
    stochastic_greedy_cost,
)
from repro_torch.core.objectives.base import check_device, with_precision
from repro_torch.core.random import SeedKey


class SelectionResult(NamedTuple):
    """Normalized result of :func:`select`.

    ``values`` is the per-round f(S) trace when the algorithm has one and
    an empty (0,) tensor for the one-shot selectors; ``raw`` keeps the
    algorithm's native result.
    """

    sel_mask: torch.Tensor
    sel_count: torch.Tensor
    value: torch.Tensor
    values: torch.Tensor
    raw: Any


@dataclass(frozen=True)
class AlgorithmSpec:
    """Registry entry.  ``single(obj, k, key, **opts)`` returns the native
    result; ``distributed(obj, k, key, mesh, **opts)`` is the sharded
    twin (or ``None``); ``needs_key`` marks randomized algorithms;
    ``cost(n, k)`` returns ``{"oracle_calls", "adaptive_rounds"}``."""

    name: str
    single: Callable[..., Any]
    distributed: Callable[..., Any] | None
    needs_key: bool
    cost: Callable[[int, int], dict]
    summary: str


_REGISTRY: dict[str, AlgorithmSpec] = {}


def register(spec: AlgorithmSpec) -> AlgorithmSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"algorithm {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def available_algorithms(*, distributed: bool | None = None) -> tuple[str, ...]:
    """Registered names, optionally only those with a distributed twin."""
    return tuple(
        name for name, spec in _REGISTRY.items()
        if distributed is None or (spec.distributed is not None) == distributed
    )


def get_algorithm(name: str) -> AlgorithmSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def algorithm_cost(name: str, n: int, k: int) -> dict:
    """{"oracle_calls", "adaptive_rounds"} for the algorithm at (n, k)."""
    return get_algorithm(name).cost(n, k)


def _normalize(raw) -> SelectionResult:
    sel_mask = raw.sel_mask
    count = getattr(raw, "sel_count", None)
    if count is None:
        count = torch.sum(sel_mask.to(torch.int32), dim=-1)
    values = getattr(raw, "values", None)
    if values is None:
        trace = getattr(raw, "trace", None)
        values = (trace.values if trace is not None
                  else torch.zeros((0,), device=sel_mask.device))
    return SelectionResult(sel_mask=sel_mask, sel_count=count,
                           value=raw.value, values=values, raw=raw)


def _validate_k(k) -> int:
    ki = int(k)
    if ki <= 0:
        raise ValueError(f"k must be a positive integer, got {k!r}")
    return ki


def _prepare(algo, obj, k, opts, device):
    """The spec, k, and the objective at the requested precision; raises
    for an unknown name, k ≤ 0 or a device that is not the objective's."""
    spec = get_algorithm(algo)
    k = _validate_k(k)
    check_device(obj, device)
    precision = opts.pop("precision", None)
    if precision is not None:
        obj = with_precision(obj, precision)
    return spec, k, obj


def _validate_mesh(obj, mesh, algo: str) -> None:
    """Mesh dispatch preconditions, checked before any collective: the
    objective has the ``dist_*`` contract, ``mesh.shape`` is a named-axis
    mapping, and n divides the model axis."""
    if not hasattr(obj, "dist_init"):
        raise ValueError(
            f"objective {type(obj).__name__} does not implement the "
            f"DistributedObjective contract (dist_init/...), so "
            f"select({algo!r}, ..., mesh=...) cannot dispatch the "
            f"distributed twin")
    try:
        axes = dict(mesh.shape)
    except (AttributeError, TypeError):
        raise ValueError(
            f"mesh must expose a named-axis .shape mapping, got "
            f"{type(mesh).__name__}") from None
    model = int(axes.get("model", 1) or 1)
    X = getattr(obj, "X", None)
    if X is not None and model > 1 and X.shape[1] % model:
        raise ValueError(
            f"ground set n={X.shape[1]} does not divide the mesh's model "
            f"axis ({model}) — pad_ground_set the columns first")


def select(algo: str, obj, k: int, key=None, mesh=None, *, device=None,
           **opts) -> SelectionResult:
    """Run any registered selection algorithm — the entry point.

    ``key`` seeds the randomized algorithms and defaults to
    ``SeedKey(0)``.  Extra ``**opts`` pass through to the algorithm
    (``subsample=``, ``opt=``, ``n_guesses=``, ``model_axis=`` …).
    ``precision="bf16"`` runs every kernel call through the objective's
    ``with_precision`` view.  ``mesh=None`` runs the single-device
    implementation; a ``Mesh`` dispatches to the distributed twin, which
    every rank of the mesh calls with the same arguments (SPMD), and
    ``device`` then defaults to the mesh's.  Raises for an algorithm
    without a twin, an objective without the ``dist_*`` contract, or an
    n that does not divide the mesh's model axis.
    """
    if mesh is not None and device is None:
        device = getattr(mesh, "device", None)
    spec, k, obj = _prepare(algo, obj, k, opts, device)
    if spec.needs_key and key is None:
        key = SeedKey(0)
    if mesh is None:
        return _normalize(spec.single(obj, k, key, device=obj.device,
                                      **opts))
    if spec.distributed is None:
        raise ValueError(f"algorithm {algo!r} has no distributed twin")
    _validate_mesh(obj, mesh, algo)
    return _normalize(spec.distributed(obj, k, key, mesh, **opts))


# ---------------------------------------------------------------------------
# the §5 roster
# ---------------------------------------------------------------------------

_DASH_CFG_KEYS = ("r", "eps", "alpha", "n_samples", "trim_frac",
                  "max_filter_iters")


def _dash_single(obj, k, key, **opts):
    from repro_torch.core.dash import DashConfig, dash, dash_auto

    opt = opts.pop("opt", None)
    if opt is not None:
        cfg = DashConfig(k=k, **{kk: opts.pop(kk) for kk in _DASH_CFG_KEYS
                                 if kk in opts})
        return dash(obj, cfg, key, opt, **opts)
    return dash_auto(obj, k, key, **opts)


def _dash_distributed(obj, k, key, mesh, **opts):
    from repro_torch.core.dash import DashConfig
    from repro_torch.core.distributed import (
        dash_auto_distributed,
        dash_distributed,
    )

    opt = opts.pop("opt", None)
    if opt is not None:
        cfg = DashConfig(k=k, **{kk: opts.pop(kk) for kk in _DASH_CFG_KEYS
                                 if kk in opts})
        return dash_distributed(obj, cfg, key, opt, mesh, **opts)
    if "pod" not in mesh.shape:
        raise ValueError(
            "select('dash', ..., mesh=...) without opt= sweeps the (OPT, α) "
            "guess lattice over the mesh's 'pod' axis — build the mesh with "
            "make_lattice_mesh, or pass an explicit opt= guess for a "
            "(data, model) mesh")
    return dash_auto_distributed(obj, k, key, mesh, **opts)


def _dist():
    from repro_torch.core import distributed

    return distributed


def _dash_cost(n: int, k: int) -> dict:
    # Thm 10: O(log n) adaptive rounds, O(n log n) oracle queries.
    r = max(1, min(k, int(math.ceil(math.log2(max(n, 2))))))
    return {"oracle_calls": n * r, "adaptive_rounds": r}


def _adseq_cost(n: int, k: int) -> dict:
    # The BRS round cap min(k, ⌈log₂ n⌉), ≤ n candidates a round.
    r = max(1, min(k, int(math.ceil(math.log2(max(n, 2))))))
    return {"oracle_calls": n * r, "adaptive_rounds": r}


register(AlgorithmSpec(
    name="dash",
    single=_dash_single,
    distributed=_dash_distributed,
    needs_key=True,
    cost=_dash_cost,
    summary="Alg. 1 adaptive sampling: O(log n) rounds, "
            "(1-1/e^{α²}-ε)·OPT for α-differentially-submodular f",
))

register(AlgorithmSpec(
    name="greedy",
    single=lambda obj, k, key, **o: greedy(obj, k, **o),
    distributed=lambda obj, k, key, mesh, **o: _dist().greedy_distributed(
        obj, k, mesh, key=key, **o),
    needs_key=False,
    cost=greedy_parallel_cost,
    summary="parallel SDS_MA: k rounds, batched argmax per round, "
            "(1-1/e^{γ}) via weak submodularity",
))

register(AlgorithmSpec(
    name="lazy_greedy",
    single=lambda obj, k, key, **o: lazy_greedy(obj, k, **o),
    distributed=None,
    needs_key=False,
    cost=lazy_greedy_cost,
    summary="Minoux lazy bounds with batched re-checks; exact for "
            "submodular f (host-driven — no distributed twin)",
))

register(AlgorithmSpec(
    name="stochastic_greedy",
    single=lambda obj, k, key, **o: stochastic_greedy(obj, k, key, **o),
    distributed=lambda obj, k, key, mesh, **o:
        _dist().stochastic_greedy_distributed(obj, k, key, mesh, **o),
    needs_key=True,
    cost=stochastic_greedy_cost,
    summary="Mirzasoleiman subsampled argmax: k rounds of "
            "⌈(n/k)ln(1/ε)⌉ queries, (1-1/e-ε) expected",
))

register(AlgorithmSpec(
    name="topk",
    single=lambda obj, k, key, **o: top_k_select(obj, k, **o),
    distributed=lambda obj, k, key, mesh, **o: _dist().top_k_distributed(
        obj, k, mesh, key=key, **o),
    needs_key=False,
    cost=lambda n, k: {"oracle_calls": n, "adaptive_rounds": 1},
    summary="largest k singleton values in one sweep; γ²-approximation "
            "for feature selection (App. J)",
))

register(AlgorithmSpec(
    name="fast",
    single=lambda obj, k, key, **o: fast(obj, k, key, **o),
    distributed=lambda obj, k, key, mesh, **o: _dist().fast_distributed(
        obj, k, key, mesh, **o),
    needs_key=True,
    cost=fast_cost,
    summary="Breuer et al. FAST: adaptive sequencing + binary-search "
            "threshold ladder, prefix sweeps fused through the filter "
            "engine (prefixes ≈ samples)",
))

register(AlgorithmSpec(
    name="adaptive_sequencing",
    single=lambda obj, k, key, **o: adaptive_sequencing(obj, k, key, **o),
    distributed=None,
    needs_key=True,
    cost=_adseq_cost,
    summary="BRS adaptive sequencing with the residual (OPT − f(S)) "
            "threshold — the single-runtime substrate fast builds on",
))

register(AlgorithmSpec(
    name="random",
    single=lambda obj, k, key, **o: random_select(obj, k, key, **o),
    distributed=lambda obj, k, key, mesh, **o: _dist().random_distributed(
        obj, k, key, mesh, **o),
    needs_key=True,
    cost=lambda n, k: {"oracle_calls": 1, "adaptive_rounds": 1},
    summary="uniform without-replacement sample (Gumbel top-k) — the "
            "§5 floor",
))


# ---------------------------------------------------------------------------
# request-batched dispatch
# ---------------------------------------------------------------------------

def _map_tensors(fn, x):
    """``fn`` on every tensor of a (nested) NamedTuple; other leaves kept."""
    if isinstance(x, tuple):
        return type(x)(*(_map_tensors(fn, v) for v in x))
    return fn(x) if isinstance(x, torch.Tensor) else x


def _stack(results):
    """Stack equal-structured (nested) NamedTuples along a new axis 0."""
    first = results[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack([r[i] for r in results])
                             for i in range(len(first))))
    if isinstance(first, torch.Tensor):
        return torch.stack(results)
    return first


def select_batched(algo: str, obj, k: int, keys, *, opt=None, alpha=None,
                   device=None, **opts) -> SelectionResult:
    """B independent requests ``(keys[i][, opt[i], alpha[i]])`` against
    one objective; every field of the result carries a leading (B,) axis.

    * Deterministic algorithms (greedy, topk, lazy_greedy excepted) run
      once and are broadcast.
    * ``dash`` runs its B requests as lanes in lockstep (``dash_lanes``)
      with a per-request ``opt`` (required) and ``alpha`` (scalars
      broadcast).
    * The other randomized algorithms run their requests in turn and are
      stacked (lane-batched FAST waits for the serving slice).
    * ``lazy_greedy`` raises: its host-driven re-check order cannot be
      request-batched.
    """
    if algo == "lazy_greedy":
        raise ValueError(
            "lazy_greedy is host-driven (data-dependent re-check order) "
            "and cannot be request-batched; use greedy or topk")
    spec, k, obj = _prepare(algo, obj, k, opts, device)
    keys = list(keys)
    B = len(keys)
    dev = obj.device

    if not spec.needs_key:
        res = _normalize(spec.single(obj, k, None, device=dev, **opts))
        return _map_tensors(lambda x: x.expand((B,) + tuple(x.shape)), res)

    if algo == "dash":
        if opt is None:
            raise ValueError(
                "request-batched dash needs an explicit opt= guess "
                "(scalar or (B,) per-request tensor) — derive one via a "
                "topk probe or opt_guess_lattice")
        from repro_torch.core.dash import DashConfig, dash_lanes

        cfg = DashConfig(k=k, **{kk: opts.pop(kk) for kk in _DASH_CFG_KEYS
                                 if kk in opts})
        if opts:
            raise ValueError(f"unknown dash options: {sorted(opts)}")
        opt = torch.as_tensor(opt, dtype=torch.float32).reshape(-1)
        alpha = torch.as_tensor(cfg.alpha if alpha is None else alpha,
                                dtype=torch.float32).reshape(-1)
        opt = opt.to(dev).expand(B).contiguous()
        alpha = alpha.to(dev).expand(B).contiguous()
        return _normalize(dash_lanes(obj, cfg, keys, opt, alpha))

    return _stack([_normalize(spec.single(obj, k, kk, device=dev, **opts))
                   for kk in keys])
