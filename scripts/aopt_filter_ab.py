#!/usr/bin/env python3
"""Time kernel 5 (``aopt_filter_gains``) of one or more checkouts on the card.

    python3 scripts/aopt_filter_ab.py [TREE ...]

Each TREE is the root of a checkout of this repository (default: the
checkout that holds this script).  The trees are run in turn, each in a
Python process of its own that imports that tree's ``src/repro_torch``
and builds its kernels, so an order such as ``OLD NEW NEW OLD`` times two
versions in turns on one card.  Every process makes the same operands
from seed 0 on the card (random values of the design's magnitudes: the
time does not depend on them) at the design shapes d = 1024, n = 65536,
m = 8:

    G = 12, b = 8    the design lattice (f32 and bf16)
    G = 6,  b = 8    the lanes of one α
    G = 6,  b = 128  past one 64-column chunk

and prints one JSON line per tree: milliseconds per call (CUDA events,
10 calls after 2; 3 after 1 at b = 128), the bound, the card's name and
power limit, and a sha256 prefix of each output.  ``--check`` also holds
every output against the tree's plain version at 2e-4.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
D, N, M = 1024, 65536, 8
CASES = (("f32", 12, 8), ("bf16", 12, 8), ("f32", 6, 8), ("f32", 6, 128))
F32_PEAK_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12


def bound_ms(g, b, elem):
    """The least time: f32 flops of t, u, F t and the closing terms, or
    the bytes of X once, W, E and F once and the gains, at the peaks."""
    flops = 4.0 * D * N * g + g * M * N * (4.0 * D * b + 2.0 * b * b
                                           + 6.0 * b + 6.0)
    nbytes = elem * D * N * (1 + g) + 4 * g * M * (D * b + b * b + N)
    return max(flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3


def run_tree(tree: Path, check: bool) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels.common import quantize, set_full_f32_matmul
    from repro_torch.kernels.filter_gains import (
        aopt_filter_gains,
        aopt_filter_gains_lattice_ref,
    )

    set_full_f32_matmul()
    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((D, N), device="cuda", generator=gen) / D ** 0.5
    W = 0.5 * X + 0.05 * torch.randn((12, D, N), device="cuda",
                                     generator=gen) / D ** 0.5

    def factors(g, b):
        E = torch.randn((g, M, D, b), device="cuda",
                        generator=gen) * (0.1 / D ** 0.5)
        return E, (E.transpose(-1, -2) @ E).contiguous()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = []
    for prec, g, b in CASES:
        E, F = factors(g, b)
        Wg = W[:g]
        sdt = torch.float32 if prec == "f32" else torch.bfloat16
        Xs, Ws = X.to(sdt), Wg.to(sdt)

        def call():
            return aopt_filter_gains(Xs, Ws, E, F, 1.0, precision=prec)

        iters, warm = (3, 1) if b > 64 else (10, 2)
        for _ in range(warm):
            out = call()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            call()
        t1.record()
        t1.synchronize()
        ms = t0.elapsed_time(t1) / iters
        row = {"precision": prec, "G": g, "b": b, "ms": ms,
               "bound_ms": bound_ms(g, b, 4 if prec == "f32" else 2),
               "digest": hashlib.sha256(
                   out.cpu().numpy().tobytes()).hexdigest()[:16]}
        if check:
            want = aopt_filter_gains_lattice_ref(
                quantize(X, prec), quantize(Wg, prec), E, F, 1.0)
            row["max_abs_err"] = float((out - want).abs().max())
            row["ok"] = bool(torch.allclose(out, want, rtol=2e-4, atol=2e-4))
            del want
        rows.append(row)
        del E, F, Xs, Ws, out
    return {"tree": str(tree), "device": smi, "cases": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(run_tree(args.one.resolve(), args.check)),
              flush=True)
        return 0
    ok = True
    for tree in args.trees or [ROOT]:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one",
               str(tree.resolve())] + (["--check"] if args.check else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        ok = ok and proc.returncode == 0 and all(
            c.get("ok", True) for line in proc.stdout.splitlines()
            if line.startswith("{") for c in json.loads(line)["cases"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
