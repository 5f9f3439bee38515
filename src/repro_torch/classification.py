"""Logistic-classification feature selection with DASH (paper §3.1, Cor. 8).

The single-device D3 flow of ``benchmarks/bench_selection.py``: on the
paper's D3 protocol (App. I.2: correlated features, cov 0.4, β ~ U(−2, 2)
on a planted support, y = 1[σ(Xβ) > 0.5], columns centred and scaled to
norm √d) it runs greedy, DASH (``dash_auto``: eps 0.25, α 0.6, m = 8
samples, 6 OPT guesses — the benchmark's ``_dash_call``), TOP-K and
RANDOM with the objective's default Newton steps, and reports each one's
f = ℓ(w^S) − ℓ(0), DASH's adaptive rounds and selected count, and
planted-support recovery.  At α 0.6 DASH filters on this data (several
lanes run filter iterations), so unlike the design entry point it needs
no α lattice.

On the card every algorithm is timed with the host clock around a
``torch.cuda.synchronize()``, and the result records how many times
each algorithm launched each kernel, and each DASH lane's α, value and
filter iterations.

    PYTHONPATH=src python -m repro_torch.classification --device cpu

The benchmark's LASSO baseline and the other §5 selectors run in
``repro_torch.bench_selection``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (
    ClassificationObjective,
    SeedKey,
    dash_auto,
    greedy,
    random_select,
    top_k_select,
)
from repro_torch.data.synthetic import make_d3_classification
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.filter_gains import logistic_filter_gains
from repro_torch.kernels.logistic_gains import logistic_gains

ALPHA = 0.6   # the benchmark's differential-submodularity guess


def _counts():
    return {"logistic_gains": logistic_gains.launches,
            "logistic_filter_gains": logistic_filter_gains.launches}


def _timed(name, fn, dev, out):
    """Run ``fn``; record its host seconds and kernel launches in
    ``out`` under ``name``."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    before = _counts()
    t0 = time.perf_counter()
    res = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out[f"{name}_s"] = time.perf_counter() - t0
    out.setdefault("launches", {})[name] = {
        k: v - before[k] for k, v in _counts().items()}
    return res


def main(device=None, d: int = 600, n: int = 200, k: int = 20,
         support: int = 50, seed: int = 2, n_guesses: int = 6,
         n_samples: int = 8, verbose: bool = True) -> dict:
    """Run the four selectors on a D3 problem of d samples × n features
    (support planted features, kmax = k); returns their results."""
    dev = resolve_device(device)
    X, y, sup = make_d3_classification(seed=seed, n_samples=d, n_features=n,
                                       support=support)
    obj = ClassificationObjective(X, y, kmax=k, device=dev)
    out = {"d": d, "n": n, "k": k, "support": support, "alpha": ALPHA}

    g = _timed("greedy", lambda: greedy(obj, k, device=dev), dev, out)
    res, lattice = _timed("dash", lambda: dash_auto(
        obj, k, SeedKey(0), eps=0.25, alpha=ALPHA, n_samples=n_samples,
        n_guesses=n_guesses, return_lattice=True, device=dev), dev, out)
    # One lane per OPT guess, in the order of core.dash.opt_guess_lattice.
    iters = lattice.trace.filter_iters.sum(dim=-1).tolist()
    lanes = [{"alpha": ALPHA, "value": v, "filter_iters": it}
             for v, it in zip(lattice.value.tolist(), iters)]
    t = _timed("topk", lambda: top_k_select(obj, k, device=dev), dev, out)
    r = _timed("random", lambda: random_select(obj, k, SeedKey(1),
                                               device=dev), dev, out)

    sel = set(torch.nonzero(res.sel_mask).flatten().tolist())
    out.update(
        objective=obj, greedy=g, dash=res, topk=t, random=r,
        greedy_value=float(g.value), dash_value=float(res.value),
        dash_rounds=int(res.rounds), dash_selected=int(res.sel_count),
        lanes=lanes, topk_value=float(t.value), random_value=float(r.value),
        recovered=len(sel & {int(s) for s in sup}),
    )
    if verbose:
        print(f"D3 d={d} n={n} support={support} k={k}; DASH α={ALPHA} "
              f"× {n_guesses} OPT guesses")
        print(f"greedy (SDS_MA):  f = {out['greedy_value']:.4f}  "
              f"rounds={k}  seconds={out['greedy_s']:.3f}")
        print(f"DASH:             f = {out['dash_value']:.4f}  "
              f"rounds={out['dash_rounds']}  "
              f"selected={out['dash_selected']}  "
              f"seconds={out['dash_s']:.3f}")
        print(f"TOP-K:            f = {out['topk_value']:.4f}  "
              f"seconds={out['topk_s']:.3f}")
        print(f"RANDOM:           f = {out['random_value']:.4f}  "
              f"seconds={out['random_s']:.3f}")
        print(f"planted-support recovery (DASH): {out['recovered']}/{k}")
        for i, lane in enumerate(lanes):
            print(f"DASH lane {i:2d}: α={lane['alpha']:.3f}  "
                  f"f = {lane['value']:.4f}  "
                  f"filter iterations={lane['filter_iters']}")
        for algo in ("greedy", "dash", "topk", "random"):
            print(f"launches {algo}: {out['launches'][algo]}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--d", type=int, default=600, help="samples (rows of X)")
    ap.add_argument("--n", type=int, default=200,
                    help="candidate features (columns of X)")
    ap.add_argument("--k", type=int, default=20, help="features to pick")
    ap.add_argument("--support", type=int, default=50,
                    help="planted support size")
    a = ap.parse_args()
    main(device=a.device, d=a.d, n=a.n, k=a.k, support=a.support)
