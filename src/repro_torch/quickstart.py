"""Quickstart of the port: DASH vs greedy feature selection on D1.

Runs greedy, DASH (``dash_auto``: eps 0.25, α 0.6, m = 8 samples,
G = 6 OPT guesses), TOP-K and RANDOM on the paper's D1 protocol and
reports values, adaptive rounds, selected counts and planted-support
recovery.  On the card every algorithm is timed with the host clock
around a ``torch.cuda.synchronize()``, and the result records how many
times each algorithm launched each kernel.

    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (
    RegressionObjective,
    SeedKey,
    dash_auto,
    greedy,
    random_select,
    top_k_select,
)
from repro_torch.data.synthetic import make_d1_regression
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.filter_gains import filter_gains
from repro_torch.kernels.marginal_gains import regression_gains


def _counts():
    return {"regression_gains": regression_gains.launches,
            "filter_gains": filter_gains.launches}


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


def main(device=None, d: int = 600, n: int = 200, k: int = 40,
         support: int = 40, seed: int = 0, n_guesses: int = 6,
         n_samples: int = 8, verbose: bool = True) -> dict:
    """Run the four selectors; returns a dict of their results."""
    dev = resolve_device(device)
    X, y, sup = make_d1_regression(seed=seed, n_samples=d, n_features=n,
                                   support=support)
    obj = RegressionObjective(X, y, kmax=k, device=dev)
    out = {"d": d, "n": n, "k": k}

    g = _timed("greedy", lambda: greedy(obj, k, device=dev), dev, out)
    res = _timed("dash", lambda: dash_auto(
        obj, k, SeedKey(seed), eps=0.25, alpha=0.6, n_samples=n_samples,
        n_guesses=n_guesses, device=dev), dev, out)
    t = _timed("topk", lambda: top_k_select(obj, k, device=dev), dev, out)
    r = _timed("random", lambda: random_select(obj, k, SeedKey(seed + 1),
                                               device=dev), dev, out)

    sel = set(torch.nonzero(res.sel_mask).flatten().tolist())
    out.update(
        objective=obj, greedy=g, dash=res, topk=t, random=r,
        greedy_value=float(g.value), dash_value=float(res.value),
        dash_rounds=int(res.rounds), dash_selected=int(res.sel_count),
        topk_value=float(t.value), random_value=float(r.value),
        recovered=len(sel & {int(s) for s in sup}),
    )
    if verbose:
        print(f"greedy (SDS_MA):  value={out['greedy_value']:.4f}  "
              f"rounds={k}  seconds={out['greedy_s']:.3f}")
        print(f"DASH:             value={out['dash_value']:.4f}  "
              f"rounds={out['dash_rounds']}  "
              f"selected={out['dash_selected']}  "
              f"seconds={out['dash_s']:.3f}")
        print(f"TOP-K:            value={out['topk_value']:.4f}")
        print(f"RANDOM:           value={out['random_value']:.4f}")
        print(f"planted-support recovery: {out['recovered']}/{k}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
