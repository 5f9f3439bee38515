"""The paper's §5 comparison on the port: every selector through ``select``.

Ports the single-device part of ``benchmarks/bench_selection.py``:

* ``--suite paper`` (the reference's ``run``): D1 regression, the D2
  clinical surrogate, D3 classification, the D4 gene surrogate and the
  D1 design, each with greedy, DASH (6 OPT guesses × 8 samples), TOP-K,
  RANDOM and — on D1–D3 — LASSO (``lasso_path_select``, 150 FISTA
  iterations), plus DASH's value per round against greedy's on D1 and
  the design (``accuracy_vs_rounds``).  Sizes are a quarter of the
  paper's unless ``--full``.  The reference's A/B of the filter engine
  against DASH's per-sample path is not ported: the port's DASH has no
  per-sample path.
* ``--suite baselines`` (the value-vs-k family of ``run_baselines``):
  every registered algorithm on the three objectives of the reference's
  baseline suite (``_baseline_datasets``).
* ``--suite main``: the D1 protocol at the regression main's scale (d =
  n = 8192, support 256, k = 128): lazy and stochastic greedy, FAST,
  adaptive sequencing and TOP-K through ``select``, and LASSO.  Sized
  for the card.

Each selector prints one line: its value, host seconds (around a
``torch.cuda.synchronize()`` on the card), the rounds it measured where
its result carries them, the cost model's rounds and queries
(``algorithm_cost``), and its kernel launches.  Nothing is written to
disk.

    PYTHONPATH=src python -m repro_torch.bench_selection --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    AOptimalityObjective,
    ClassificationObjective,
    DashConfig,
    RegressionObjective,
    SeedKey,
    algorithm_cost,
    dash,
    greedy,
    lasso_path_select,
    select,
)
from repro_torch.core.objectives.base import normalize_columns
from repro_torch.data.synthetic import (
    make_d1_design,
    make_d1_regression,
    make_d2_clinical,
    make_d3_classification,
    make_d4_gene,
)
from repro_torch.kernels.aopt_gains import aopt_gains
from repro_torch.kernels.filter_gains import (
    aopt_filter_gains,
    filter_gains,
    logistic_filter_gains,
)
from repro_torch.kernels.logistic_gains import logistic_gains
from repro_torch.kernels.marginal_gains import regression_gains
from repro_torch.kernels.common import resolve_device

SUITES = ("paper", "baselines", "main")
KERNELS = {f.__name__: f for f in (
    regression_gains, filter_gains, aopt_gains, aopt_filter_gains,
    logistic_gains, logistic_filter_gains)}
# The regression main's data: the D1 protocol at the scale of the
# quickstart's card run.
MAIN = dict(d=8192, n=8192, k=128, support=256)
MAIN_ALGOS = ("lazy_greedy", "stochastic_greedy", "fast",
              "adaptive_sequencing", "topk")
# The registry roster of the baseline suite, with its select() options.
BASELINE_ALGOS = (
    ("dash", {"n_samples": 4, "n_guesses": 4}),
    ("greedy", {}),
    ("lazy_greedy", {}),
    ("fast", {}),
    ("stochastic_greedy", {}),
    ("topk", {}),
    ("random", {}),
)


def launch_counts() -> dict:
    return {name: f.launches for name, f in KERNELS.items()}


def timed(fn, dev):
    """Run ``fn``; return (host seconds, its result, the kernel launches
    it made, by kernel)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    res = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    after = launch_counts()
    return secs, res, {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}


def emit(row: dict, verbose: bool = True) -> dict:
    if verbose:
        parts = [f"{row['dataset']}/k={row['k']}/{row['algo']}",
                 f"value={row['value']:.4f}", f"host_s={row['seconds']:.3f}"]
        if row.get("rounds") is not None:
            parts.append(f"rounds_measured={row['rounds']}")
        if row.get("cost"):
            parts.append(f"rounds={row['cost']['adaptive_rounds']} "
                         f"queries={row['cost']['oracle_calls']}")
        if row.get("nnz") is not None:
            parts.append(f"nnz={row['nnz']}")
        if row.get("launches"):
            parts.append(f"launches={row['launches']}")
        print("  ".join(parts), flush=True)
    return row


def _row(dataset, k, algo, secs, res, launches, n):
    raw = res.raw
    rounds = getattr(raw, "rounds", None)
    return dict(dataset=dataset, k=k, algo=algo, value=float(res.value),
                seconds=secs, rounds=None if rounds is None else int(rounds),
                sel_count=int(res.sel_count), launches=launches,
                cost=algorithm_cost(algo, n, k), result=res)


def run_select(dataset, obj, k, algo, dev, *, timer=timed, verbose=True,
               **opts):
    """One registered algorithm through ``select`` (key ``SeedKey(0)``),
    timed; returns its row."""
    secs, res, launches = timer(
        lambda: select(algo, obj, k, key=SeedKey(0), device=dev, **opts), dev)
    return emit(_row(dataset, k, algo, secs, res, launches, obj.n), verbose)


def lasso_value(obj, support: torch.Tensor, k: int) -> float:
    """f of LASSO's support as the reference benchmark scores it: the
    first k indices of the support, padded with index 0."""
    sup = torch.nonzero(support).flatten()[:k]
    idx = torch.zeros((k,), dtype=torch.int64, device=obj.device)
    idx[:sup.numel()] = sup
    st = obj.add_set(obj.init(), idx[None],
                     torch.ones((1, k), dtype=torch.bool, device=obj.device))
    return float(obj.value(st)[0])


def run_lasso(dataset, obj, X, y, k, dev, *, task="linear", timer=timed,
              verbose=True):
    secs, (best, _), _ = timer(
        lambda: lasso_path_select(X, y, k, task=task, iters=150, device=dev),
        dev)
    row = dict(dataset=dataset, k=k, algo="lasso",
               value=lasso_value(obj, best.support, k), seconds=secs,
               rounds=None, nnz=int(best.nnz), launches={}, cost=None,
               result=best)
    return emit(row, verbose)


# ---------------------------------------------------------------------------
# --suite paper
# ---------------------------------------------------------------------------

def bench_objective(name, obj, k_grid, dev, *, lasso_xy=None, task="linear",
                    alpha=0.6, verbose=True):
    """Greedy, DASH (the paper's lattice), TOP-K, RANDOM and LASSO per k."""
    rows = []
    for k in k_grid:
        rows.append(run_select(name, obj, k, "greedy", dev, verbose=verbose))
        rows.append(run_select(name, obj, k, "dash", dev, verbose=verbose,
                               eps=0.25, alpha=alpha, n_samples=8,
                               n_guesses=6))
        rows.append(run_select(name, obj, k, "topk", dev, verbose=verbose))
        rows.append(run_select(name, obj, k, "random", dev, verbose=verbose))
        if lasso_xy is not None:
            rows.append(run_lasso(name, obj, *lasso_xy, k, dev, task=task,
                                  verbose=verbose))
    return rows


def accuracy_vs_rounds(name, obj, k, dev, verbose=True):
    """DASH's f(S) per adaptive round (one guess, OPT pinned at 1.05 ×
    greedy's value) beside greedy's per pick."""
    g = greedy(obj, k, device=dev)
    cfg = DashConfig(k=k, eps=0.25, alpha=0.6, n_samples=6)
    res = dash(obj, cfg, SeedKey(0), float(g.value) * 1.05, device=dev)
    if verbose:
        print(f"rounds/{name}: greedy value={float(g.value):.4f} rounds={k}"
              f"  dash value={float(res.value):.4f} "
              f"rounds={int(res.rounds)}  dash per round "
              f"{[round(v, 4) for v in res.trace.values.tolist()]}",
              flush=True)
    return res.trace.values.cpu().numpy(), g.values.cpu().numpy()


def run_paper(dev, full: bool = False, verbose: bool = True) -> list:
    dev = resolve_device(dev)
    s = 1 if full else 4
    rows = []
    X, y, _ = make_d1_regression(n_samples=1000 // s * s,
                                 n_features=500 // s, support=100 // s)
    obj = RegressionObjective(X, y, 100 // s, device=dev)
    rows += bench_objective("D1_regression", obj, [25 // s, 50 // s, 100 // s],
                            dev, lasso_xy=(X, y), verbose=verbose)
    accuracy_vs_rounds("D1_regression", obj, 100 // s, dev, verbose)

    X2, y2 = make_d2_clinical(n_samples=1200 // s, n_features=385 // s)
    obj2 = RegressionObjective(X2, y2, 100 // s, device=dev)
    rows += bench_objective("D2_clinical", obj2, [50 // s, 100 // s], dev,
                            lasso_xy=(X2, y2), verbose=verbose)

    X3, y3, _ = make_d3_classification(n_samples=600 // s,
                                       n_features=200 // s, support=50 // s)
    obj3 = ClassificationObjective(X3, y3, 60 // s, device=dev)
    rows += bench_objective("D3_classification", obj3, [20 // s, 40 // s],
                            dev, lasso_xy=(X3, y3), task="logistic",
                            verbose=verbose)

    X4, y4, _ = make_d4_gene(n_samples=800 // s, n_features=2500 // s)
    obj4 = ClassificationObjective(X4, y4, 200 // s, device=dev)
    rows += bench_objective("D4_gene", obj4, [100 // s, 200 // s], dev,
                            verbose=verbose)

    Xd = make_d1_design(n_samples=1024 // s, n_features=256 // s)
    objd = AOptimalityObjective(Xd, 100 // s, beta2=1.0, sigma2=1.0,
                                device=dev)
    rows += bench_objective("D1_design_aopt", objd, [50 // s, 100 // s], dev,
                            alpha=0.4, verbose=verbose)
    accuracy_vs_rounds("D1_design_aopt", objd, 100 // s, dev, verbose)
    return rows


# ---------------------------------------------------------------------------
# --suite baselines
# ---------------------------------------------------------------------------

def baseline_datasets(scale: int, dev):
    """The reference baseline suite's three objectives, as ``(name, obj,
    k_grid, dash opts)``: the same draws from one seeded generator."""
    rng = np.random.default_rng(0)

    d, n, k = 96 * scale, 64 * scale, 8 * scale
    X0 = rng.normal(size=(d, n)) + 0.4 * rng.normal(size=(d, 1))
    X = normalize_columns(torch.as_tensor(X0, dtype=torch.float32))
    w = np.zeros(n)
    w[:k] = rng.uniform(-2, 2, k)
    y = (X0 @ w + 0.1 * rng.normal(size=d)).astype(np.float32)
    reg = ("regression", RegressionObjective(X, y, k, device=dev),
           [k // 2, k], {"alpha": 0.6, "eps": 0.25})

    da, na, ka = 24 * scale, 48 * scale, 6 * scale
    Xa0 = rng.normal(size=(da, na))
    Xa = (Xa0 / np.linalg.norm(Xa0, axis=0, keepdims=True)).astype(
        np.float32)
    aopt = ("aopt", AOptimalityObjective(Xa, ka, device=dev), [ka // 2, ka],
            {"alpha": 0.5, "eps": 0.25})

    dc, nc, kc = 96 * scale, 32 * scale, 4 * scale
    Xc0 = rng.normal(size=(dc, nc))
    Xc = normalize_columns(torch.as_tensor(Xc0, dtype=torch.float32)) \
        * np.sqrt(dc)
    wc = np.zeros(nc)
    wc[:kc] = rng.uniform(-2, 2, kc)
    yc = (1 / (1 + np.exp(-Xc0 @ wc)) > 0.5).astype(np.float32)
    logi = ("logistic", ClassificationObjective(
        Xc, yc, kc, newton_steps=3, newton_gain_steps=2, device=dev), [kc],
        {"alpha": 0.4, "eps": 0.3})
    return [reg, aopt, logi]


def run_baselines(dev, full: bool = False, verbose: bool = True) -> list:
    dev = resolve_device(dev)
    rows = []
    for name, obj, k_grid, dash_opts in baseline_datasets(2 if full else 1,
                                                           dev):
        for k in k_grid:
            for algo, opts in BASELINE_ALGOS:
                use = dict(dash_opts, **opts) if algo == "dash" else opts
                rows.append(run_select(name, obj, k, algo, dev,
                                       verbose=verbose, **use))
    return rows


# ---------------------------------------------------------------------------
# --suite main
# ---------------------------------------------------------------------------

def run_main(dev, *, d: int = MAIN["d"], n: int = MAIN["n"],
             k: int = MAIN["k"], support: int = MAIN["support"],
             timer=timed, verbose: bool = True) -> dict:
    """The D1 protocol at (d, n, support, k): MAIN_ALGOS through
    ``select``, then LASSO.  Returns the objective and a row per
    algorithm (``timer(fn, dev) -> (seconds, result, launches)``)."""
    dev = resolve_device(dev)
    X, y, _ = make_d1_regression(seed=0, n_samples=d, n_features=n,
                                 support=support)
    obj = RegressionObjective(X, y, k, device=dev)
    rows = {algo: run_select("D1_main", obj, k, algo, dev, timer=timer,
                             verbose=verbose) for algo in MAIN_ALGOS}
    rows["lasso"] = run_lasso("D1_main", obj, X, y, k, dev, timer=timer,
                              verbose=verbose)
    return {"objective": obj, "rows": rows}


def main(device=None, suite: str = "paper", full: bool = False,
         verbose: bool = True):
    if suite not in SUITES:
        raise ValueError(f"unknown suite {suite!r}; expected one of {SUITES}")
    if suite == "paper":
        return run_paper(device, full, verbose)
    if suite == "baselines":
        return run_baselines(device, full, verbose)
    return run_main(device, verbose=verbose)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--suite", default="paper", choices=SUITES)
    ap.add_argument("--full", action="store_true",
                    help="the paper's sizes (paper suite), twice the "
                         "baseline suite's")
    args = ap.parse_args()
    main(device=args.device, suite=args.suite, full=args.full)
