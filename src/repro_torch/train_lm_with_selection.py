"""Train an LM on coreset-selected batches, routed through the
``select`` registry (``select(algo, CoresetObjective, ...)``), with
checkpoint/restart.

A port of ``examples/train_lm_with_selection.py`` with its flags, plus
``--device`` (default the card; raises without one) and ``--full``, the
arch at its published width (card only; by default the reduced config,
which runs on the CPU).  Any registry algorithm is a one-string swap
(``--algo dash | greedy | lazy_greedy | stochastic_greedy | topk |
random``).  ``--assert-improves`` exits nonzero unless the mean loss of
the last 5 steps is below that of the first 5.  Checkpoints go to
``--ckpt-dir``, by default a temporary directory removed at the end.

    PYTHONPATH=src python -m repro_torch.train_lm_with_selection \\
        --device cpu --assert-improves
"""

from __future__ import annotations

import argparse
import logging
import tempfile

import numpy as np

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.selection import BatchSelector
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.kernels.common import resolve_device, set_full_f32_matmul
from repro_torch.models import build_model
from repro_torch.train.loop import train_loop


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--algo", default="dash",
                    help="any core.algorithms registry name")
    ap.add_argument("--feature-mode", default="grad",
                    choices=["embed", "hidden", "grad"])
    ap.add_argument("--selection-every", type=int, default=2)
    ap.add_argument("--pool-factor", type=int, default=4)
    ap.add_argument("--no-selection", action="store_true")
    ap.add_argument("--assert-improves", action="store_true",
                    help="fail unless the tail loss beats the head loss")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="the arch at its published width (card only)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    dev = resolve_device(args.device)
    set_full_f32_matmul()
    cfg = get_config(args.arch) if args.full else get_reduced_config(
        args.arch)
    model = build_model(cfg)
    tokens = make_lm_tokens(0, 2_000_000, cfg.vocab_size)
    tcfg = TrainConfig(total_steps=args.steps, learning_rate=3e-3,
                       warmup_steps=min(20, max(args.steps // 10, 1)),
                       checkpoint_every=100)
    selector = None
    if not args.no_selection:
        opts = {"n_samples": 4} if args.algo == "dash" else {}
        selector = BatchSelector(k=args.batch, algo=args.algo,
                                 feature_mode=args.feature_mode,
                                 embed_dim_cap=32, **opts)
    with tempfile.TemporaryDirectory() as tmp, \
            TokenPipeline(tokens, args.batch, args.seq) as pipeline:
        result = train_loop(model, tcfg, pipeline, device=dev,
                            ckpt_dir=args.ckpt_dir or tmp,
                            selector=selector,
                            selection_every=args.selection_every,
                            selection_pool_factor=args.pool_factor,
                            log_every=25)
    head = float(np.mean(result.losses[:5]))
    tail = float(np.mean(result.losses[-5:]))
    print(f"ran {result.steps_run} steps; loss {head:.3f} → {tail:.3f} "
          f"(restarts: {result.restarts}, "
          f"selection {result.selection_time_s:.1f}s, "
          f"{len(result.selections)} selection periods)")
    if args.assert_improves and not tail < head:
        raise SystemExit(f"loss did not improve: {head:.3f} → {tail:.3f}")
    return result


if __name__ == "__main__":
    main()
