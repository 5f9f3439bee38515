"""Bayesian A-optimal experimental design with DASH (paper §3.1, Cor. 9).

The single-device, plain A-optimality part of
``examples/experimental_design.py``: on the paper's D1 design protocol
(correlated features, cov 0.8, rows ℓ2-normalized; the columns of X are
the candidate experiments) it sets α = max(γ², 0.3) from the Cor. 9
bound and runs greedy, DASH (``dash_auto``: eps 0.25, m = 8 samples,
6 OPT guesses), TOP-K and RANDOM, reporting each one's f_A-opt value.

DASH sweeps the (OPT, α) lattice of paper App. G: the 6 OPT guesses
crossed with α ∈ {max(γ², 0.3), 1}, the Cor. 9 floor and the submodular
end of the range, 12 lanes in lockstep.  With the floor alone no lane's
set-gain estimate ever falls below its threshold α²·t/r on this design
at k ≪ d, so DASH never filters and commits uniformly random blocks —
RANDOM's quality — and the filter engine never runs.

The diversified variant (:func:`diversified`) adds the cluster-coverage
regularizer d(S) = 0.2 · Σ_c √|S ∩ G_c| over 4 clusters, the sign
pattern of each stimulus's projection on the top two principal
components of X, and runs ``dash_auto`` (eps 0.25, m = 8, 6 OPT guesses,
the practical α) on f + d.  ``DiversifiedObjective`` has no filter
engine, so its DASH scores the perturbed states one sample at a time
(``aopt_gains`` on the card, never ``aopt_filter_gains``).  It reports
the value and the selection's cluster coverage.

On the card every algorithm is timed with the host clock around a
``torch.cuda.synchronize()``, and the result records how many times
each algorithm launched each kernel, and each DASH lane's α, value and
filter iterations.

    PYTHONPATH=src python -m repro_torch.experimental_design --device cpu --d 64 --n 512 --k 16

:func:`distributed` (``--ranks W``) is the example's first half: the
distributed DASH, ``core/distributed.py::dash_distributed`` on W
spawned ranks laid out by ``make_host_mesh`` (data-major), the stimuli
padded to the model axis's multiple and sharded over it, OPT = 1.05 ×
greedy's value; padding is never selected.

    PYTHONPATH=src python -m repro_torch.experimental_design --device cpu --ranks 4 --d 64 --n 510 --k 16
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (
    AOptimalityObjective,
    ClusterDiversity,
    DiversifiedObjective,
    SeedKey,
    alpha_from_gamma,
    dash_auto,
    gamma_aopt,
    greedy,
    random_select,
    top_k_select,
)
from repro_torch.data.synthetic import make_d1_design
from repro_torch.kernels.aopt_gains import aopt_gains
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.filter_gains import aopt_filter_gains

ALPHA_FLOOR = 0.3   # the example's practical floor under the Cor. 9 bound
DIV_CLUSTERS = 4    # sign patterns of the top two principal components
DIV_WEIGHT = 0.2


def _counts():
    return {"aopt_gains": aopt_gains.launches,
            "aopt_filter_gains": aopt_filter_gains.launches}


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


def pc_sign_clusters(X: torch.Tensor) -> torch.Tensor:
    """(n,) cluster ids in [0, 4): 2·[p₀ > 0] + [p₁ > 0], with p the
    projection of each column of X (d, n) on the top two principal
    directions (eigenvectors of X Xᵀ, in float64 on X's device).  Each
    direction's sign is fixed so that its largest-magnitude entry is
    positive, the choice an SVD leaves open."""
    Xd = X.to(torch.float64)
    _, vecs = torch.linalg.eigh(Xd @ Xd.T)
    U = vecs[:, [-1, -2]]                               # (d, 2)
    lead = torch.gather(U, 0, torch.argmax(U.abs(), dim=0)[None])
    U = U * torch.sign(lead)
    proj = Xd.T @ U                                     # (n, 2)
    return ((proj[:, 0] > 0).to(torch.int64) * 2
            + (proj[:, 1] > 0).to(torch.int64))


def diversified(obj, k: int, alpha: float, *, seed: int = 0,
                n_guesses: int = 6, n_samples: int = 8, out=None) -> dict:
    """DASH on f_A-opt + d over the PC sign clusters of ``obj.X``;
    returns the result, the clusters and the selection's coverage (and
    times it into ``out`` under ``"diversified"``)."""
    dev = obj.device
    out = {} if out is None else out
    clusters = pc_sign_clusters(obj.X)
    div = ClusterDiversity(clusters, DIV_CLUSTERS, DIV_WEIGHT, device=dev)
    dobj = DiversifiedObjective(obj, div)
    res = _timed("diversified", lambda: dash_auto(
        dobj, k, SeedKey(seed), eps=0.25, alpha=alpha, n_samples=n_samples,
        n_guesses=n_guesses, device=dev), dev, out)
    coverage = torch.bincount(clusters[res.sel_mask],
                              minlength=DIV_CLUSTERS).tolist()
    out.update(div_objective=dobj, div_result=res, clusters=clusters,
               div_value=float(res.value), div_rounds=int(res.rounds),
               div_selected=int(res.sel_count), coverage=coverage)
    return out


def _distributed_rank(d: int, n: int, k: int, seed: int,
                      n_samples: int) -> dict:
    from repro_torch.core import DashConfig
    from repro_torch.core.distributed import dash_distributed, pad_ground_set
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()
    dev = mesh.device
    X = make_d1_design(seed=seed, n_samples=n, n_features=d)
    gamma = float(gamma_aopt(torch.as_tensor(X).to(dev), 1.0, 1.0))
    alpha = max(float(alpha_from_gamma(gamma)), ALPHA_FLOOR)
    Xp, n_real = pad_ground_set(torch.as_tensor(X), mesh.size("model"))
    obj = AOptimalityObjective(Xp, kmax=k, device=dev)
    out = {"mesh": dict(mesh.shape), "alpha": alpha}
    g = _timed("greedy", lambda: greedy(obj, k, device=dev), dev, out)
    cfg = DashConfig(k=k, eps=0.25, alpha=alpha, n_samples=n_samples)
    res = _timed("dash", lambda: dash_distributed(
        obj, cfg, SeedKey(seed), float(g.value) * 1.05, mesh), dev, out)
    out.update(greedy_value=float(g.value), dash_value=float(res.value),
               dash_rounds=int(res.rounds), dash_selected=int(res.sel_count),
               padding_selected=bool(torch.any(res.sel_mask[n_real:])))
    return out


def distributed(ranks: int = 2, device=None, d: int = 128, n: int = 512,
                k: int = 32, seed: int = 0, n_samples: int = 8,
                verbose: bool = True) -> dict:
    """Distributed DASH on ``ranks`` spawned ranks of the device (the
    example's first half); returns rank 0's report, which every rank
    shares."""
    from repro_torch.launch.mesh import spawn_ranks

    dev = resolve_device(device)
    out = spawn_ranks(_distributed_rank, ranks, (d, n, k, seed, n_samples),
                      device=dev)[0]
    if out["padding_selected"]:
        raise RuntimeError("distributed DASH selected a padding column")
    if verbose:
        print(f"greedy:           f_A = {out['greedy_value']:.4f} "
              f"({k} rounds)")
        print(f"DASH distributed: f_A = {out['dash_value']:.4f} "
              f"({out['dash_rounds']} adaptive rounds, mesh {out['mesh']}, "
              f"|S| = {out['dash_selected']}, α = {out['alpha']:.3f})")
    return out


def main(device=None, d: int = 128, n: int = 512, k: int = 32,
         seed: int = 0, n_guesses: int = 6, n_samples: int = 8,
         verbose: bool = True) -> dict:
    """Run the four selectors on a (d, n) design with β² = σ² = 1, then
    the diversified DASH; returns their results."""
    dev = resolve_device(device)
    X = make_d1_design(seed=seed, n_samples=n, n_features=d)
    obj = AOptimalityObjective(X, kmax=k, device=dev)
    gamma = float(gamma_aopt(obj.X, 1.0, 1.0))
    alpha = max(float(alpha_from_gamma(gamma)), ALPHA_FLOOR)
    out = {"d": d, "n": n, "k": k, "gamma": gamma, "alpha": alpha}

    g = _timed("greedy", lambda: greedy(obj, k, device=dev), dev, out)
    alphas = sorted({alpha, 1.0})
    res, lattice = _timed("dash", lambda: dash_auto(
        obj, k, SeedKey(seed), eps=0.25, alpha=alpha, alphas=alphas,
        n_samples=n_samples, n_guesses=n_guesses, return_lattice=True,
        device=dev), dev, out)
    # Lanes run OPT-major over the α lattice (core.dash.lattice_grid).
    lanes = [{"alpha": alphas[i % len(alphas)], "value": v,
              "filter_iters": it}
             for i, (v, it) in enumerate(zip(
                 lattice.value.tolist(),
                 lattice.trace.filter_iters.sum(dim=-1).tolist()))]
    t = _timed("topk", lambda: top_k_select(obj, k, device=dev), dev, out)
    r = _timed("random", lambda: random_select(obj, k, SeedKey(seed + 1),
                                               device=dev), dev, out)
    out.update(
        objective=obj, greedy=g, dash=res, topk=t, random=r,
        greedy_value=float(g.value), dash_value=float(res.value),
        dash_rounds=int(res.rounds), dash_selected=int(res.sel_count),
        alphas=alphas, lanes=lanes,
        topk_value=float(t.value), random_value=float(r.value),
    )
    diversified(obj, k, alpha, seed=seed, n_guesses=n_guesses,
                n_samples=n_samples, out=out)
    if verbose:
        print(f"γ (Cor. 9 bound) = {gamma:.4e}; practical α = {alpha:.3f}; "
              f"DASH α lattice {alphas}")
        print(f"greedy (SDS_MA):  f_A = {out['greedy_value']:.4f}  "
              f"rounds={k}  seconds={out['greedy_s']:.3f}")
        print(f"DASH:             f_A = {out['dash_value']:.4f}  "
              f"rounds={out['dash_rounds']}  "
              f"selected={out['dash_selected']}  "
              f"seconds={out['dash_s']:.3f}")
        print(f"TOP-K:            f_A = {out['topk_value']:.4f}  "
              f"seconds={out['topk_s']:.3f}")
        print(f"RANDOM:           f_A = {out['random_value']:.4f}  "
              f"seconds={out['random_s']:.3f}")
        for i, lane in enumerate(lanes):
            print(f"DASH lane {i:2d}: α={lane['alpha']:.3f}  "
                  f"f_A = {lane['value']:.4f}  "
                  f"filter iterations={lane['filter_iters']}")
        print(f"DASH + diversity: f_A-div = {out['div_value']:.4f}  "
              f"rounds={out['div_rounds']}  "
              f"selected={out['div_selected']}  "
              f"seconds={out['diversified_s']:.3f}")
        print(f"cluster coverage of diversified selection: "
              f"{out['coverage']}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--d", type=int, default=128,
                    help="features per experiment (rows of X)")
    ap.add_argument("--n", type=int, default=512,
                    help="candidate experiments (columns of X)")
    ap.add_argument("--k", type=int, default=32, help="experiments to pick")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run the distributed DASH on this many ranks")
    a = ap.parse_args()
    if a.ranks:
        distributed(a.ranks, device=a.device, d=a.d, n=a.n, k=a.k)
    else:
        main(device=a.device, d=a.d, n=a.n, k=a.k)
