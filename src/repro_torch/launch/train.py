"""Training launcher: ``python -m repro_torch.launch.train --arch <id> …``.

A port of ``repro/launch/train.py`` with its flags, plus ``--device``
(default the card; raises without one).  The reduced config of the arch
runs unless ``--full-config`` asks for the published one (card only).
``--selection`` picks each batch as a coreset through the ``select``
registry (``--algo``), over ``--feature-mode`` features of a pool
``--pool-factor`` times the period's examples.

``--mesh`` trains data parallel on a mesh of local ranks
(``launch/mesh.py::spawn_ranks``): one rank per card by default, or
``--world`` ranks (gloo; NCCL refuses two ranks on one card, so several
ranks share a one-card machine's card that way), each building
``make_host_mesh`` (world 4 gives (data 2, model 2)) and running
``train_loop(mesh=)``; with ``--selection`` the selection runs the
algorithm's distributed twin over the model axis.  ``--device cpu``
runs the ranks on the CPU (gloo).  World 1 on the card runs NCCL.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --device cpu --mesh --world 4 --steps 4 --selection
    python3 -m repro_torch.launch.train --arch smollm-135m --mesh \\
        --world 2 --steps 4
"""

from __future__ import annotations

import argparse
import logging

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.selection import BatchSelector
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.kernels.common import resolve_device, set_full_f32_matmul
from repro_torch.launch.mesh import make_host_mesh, spawn_ranks
from repro_torch.models import build_model
from repro_torch.train.loop import LoopResult, train_loop

# Seconds for a whole ``--mesh`` launch and for each of its collectives:
# the default 200 steps of a reduced arch at world 4 on the CPU fit.
MESH_TIMEOUT_S = 3600.0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full-config", action="store_true",
                    help="the published config instead of the reduced "
                         "smoke config (card only)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="train data parallel on a mesh of local ranks, "
                         "one per card (or --world)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks of --mesh (default: the cards; gloo above "
                         "1, also when they share a card)")
    ap.add_argument("--selection", "--dash-selection", action="store_true",
                    dest="selection",
                    help="coreset batch selection through the select "
                         "registry (--algo picks the algorithm)")
    ap.add_argument("--algo", default="dash",
                    help="any core.algorithms registry name")
    ap.add_argument("--feature-mode", default="grad",
                    choices=["embed", "hidden", "grad"])
    ap.add_argument("--selection-every", type=int, default=2)
    ap.add_argument("--pool-factor", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    return ap


def run(args, device, mesh=None) -> LoopResult:
    """Build the arch, the token stream and the selector of ``args`` and
    train on ``device`` (or on ``mesh``)."""
    set_full_f32_matmul()
    cfg = (get_config(args.arch) if args.full_config
           else get_reduced_config(args.arch))
    model = build_model(cfg)
    tokens = make_lm_tokens(0, max(2_000_000, 4 * args.batch * args.seq),
                            cfg.vocab_size)
    tcfg = TrainConfig(
        total_steps=args.steps, learning_rate=args.lr, warmup_steps=20,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        checkpoint_every=max(args.steps // 4, 1),
    )
    selector = None
    if args.selection:
        opts = {"n_samples": 4} if args.algo == "dash" else {}
        selector = BatchSelector(k=args.batch, algo=args.algo,
                                 feature_mode=args.feature_mode,
                                 embed_dim_cap=32, **opts)
    with TokenPipeline(tokens, args.batch, args.seq) as pipeline:
        return train_loop(model, tcfg, pipeline,
                          device=None if mesh is not None else device,
                          mesh=mesh, ckpt_dir=args.ckpt_dir,
                          selector=selector,
                          selection_every=args.selection_every,
                          selection_pool_factor=args.pool_factor,
                          log_every=max(args.steps // 20, 1))


def train_rank(args) -> dict:
    """One rank of ``--mesh``: the host mesh over the world, then
    ``run``; returns what the parent reports (no state)."""
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    mesh = make_host_mesh()
    res = run(args, mesh.device, mesh)
    return {"losses": res.losses, "steps_run": res.steps_run,
            "restarts": res.restarts, "selections": res.selections,
            "selection_time_s": res.selection_time_s,
            "step_seconds": res.step_seconds,
            "selection_seconds": res.selection_seconds,
            "allreduce_seconds": res.allreduce_seconds}


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    dev = resolve_device(args.device)
    if args.mesh:
        world = args.world or (torch.cuda.device_count()
                               if dev.type == "cuda" else 1)
        ranks = spawn_ranks(train_rank, world, (args,), device=dev,
                            timeout_s=MESH_TIMEOUT_S)
        result = LoopResult(state=None, **ranks[0])
        print(f"mesh: {world} ranks on {dev.type}")
    else:
        result = run(args, dev)
    print(f"done: {result.steps_run} steps, "
          f"loss {result.losses[0]:.3f} → {result.losses[-1]:.3f}"
          + (f", selection {result.selection_time_s:.1f}s"
             if args.selection else ""))
    return result


if __name__ == "__main__":
    main()
