"""Serve an LM with batched requests: prefill + autoregressive decode
through the KV-cache runtime (ring caches for windowed archs).

A port of ``examples/serve_lm.py`` with its flags, plus ``--device``
(default ``cuda``; raises without a card), ``--full`` and
``--n-layers``.  By default the arch runs at its reduced (smoke) width,
the only size meant for the CPU; ``--full`` (``main(full=True)``) builds
it at its published width, in its own dtype.  ``--n-layers`` cuts the
depth (a multiple of the block pattern's period) and keeps every width:
the MoE archs at published width hold a few layers on one card.  Weights
and prompt (and the image embeddings of a VLM, the encoder frames of an
encoder-decoder) are random, from seed 0, and sampling is top-k 40, as
the example's.

On the card the run is timed with a clock that synchronises the device:
``generate`` reads it before the prefill and before every decode step
(the deadline is infinite, so it never cuts the loop), which splits the
wall time into prefill (with the first sample) and decode per token.

    PYTHONPATH=src python -m repro_torch.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.serve_lm --arch grok-1-314b \
        --device cpu
    python -m repro_torch.serve_lm --arch grok-1-314b --full --n-layers 4
    python -m repro_torch.serve_lm --arch whisper-base --full
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.random import SeedKey
from repro_torch.kernels.common import resolve_device, set_full_f32_matmul
from repro_torch.lm_serve import generate
from repro_torch.models import build_model


class _SyncClock:
    """perf_counter after a device synchronise; keeps every reading."""

    def __init__(self, dev):
        self.dev, self.times = dev, []

    def __call__(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.times.append(time.perf_counter())
        return self.times[-1]


TOP_K = 40
SEED = 0


def main(arch: str = "h2o-danube-1.8b", batch: int = 4, prompt_len: int = 32,
         new_tokens: int = 24, temperature: float = 0.8, *,
         full: bool = False, n_layers: int | None = None, device=None,
         verbose: bool = True) -> dict:
    """Build the arch (``n_layers`` deep when given), draw weights and a
    prompt of ``batch`` × ``prompt_len`` tokens (behind the arch's
    image embeddings, or beside its encoder frames, drawn N(0, 1) as the
    JAX example's), generate ``new_tokens`` tokens (greedy at
    temperature 0); returns the tokens, timings, the prompt, the whole
    batch and the model and parameters."""
    dev = resolve_device(device)
    set_full_f32_matmul()
    cfg = get_config(arch) if full else get_reduced_config(arch)
    if n_layers is not None:
        if n_layers < 1 or n_layers % cfg.pattern_period:
            raise ValueError(f"n_layers={n_layers}: expected a positive "
                             f"multiple of {cfg.name}'s pattern period "
                             f"{cfg.pattern_period}")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    inputs = {"tokens": tokens}
    if cfg.vision is not None:
        inputs["img_embeds"] = torch.randn(
            (batch, cfg.vision.n_img_tokens, cfg.vision.embed_dim),
            generator=gen, device=dev)
    if cfg.is_encdec:
        inputs["enc_frames"] = torch.randn(
            (batch, cfg.encoder.src_len, cfg.d_model), generator=gen,
            device=dev)

    clock = _SyncClock(dev)
    out = generate(model, params, inputs, n_steps=new_tokens,
                   key=SeedKey(SEED), temperature=temperature, top_k=TOP_K,
                   deadline_s=math.inf, clock=clock, device=dev)
    t_end = clock()
    t = clock.times
    seconds = t_end - t[0]
    prefill_s = (t[1] if new_tokens > 1 else t_end) - t[0]
    decode_s = (t_end - t[1]) / (new_tokens - 1) if new_tokens > 1 else 0.0
    res = {"cfg": cfg, "model": model, "params": params, "prompt": tokens,
           "batch": inputs, "tokens": out, "seconds": seconds, "prefill_s": prefill_s,
           "decode_s_per_token": decode_s,
           "tok_s": batch * new_tokens / seconds, "device": str(dev)}
    if verbose:
        print(f"arch={cfg.name} layers={cfg.n_layers} batch={batch} "
              f"prompt={prompt_len} "
              f"new={new_tokens} device={dev} "
              f"{'full width' if full else 'reduced'}")
        print(f"generated ids[0]: {out[0].tolist()}")
        print(f"{seconds:.2f}s end-to-end ({res['tok_s']:.1f} tok/s; "
              f"prefill {prefill_s:.3f}s, decode "
              f"{decode_s * 1e3:.2f} ms/token)")
    return res


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--full", action="store_true",
                    help="the arch at its published width (card only)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (a multiple of the pattern period)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.arch, a.batch, a.prompt_len, a.new_tokens, a.temperature,
         full=a.full, n_layers=a.n_layers, device=a.device)


if __name__ == "__main__":
    _cli()
