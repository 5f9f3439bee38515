"""LM serving: prefill + decode steps and a host-side generation loop.

A port of ``repro/train/serve.py``.  Sampling is Gumbel-max through the
port's key protocol (``repro_torch.core.random``: ``split``,
``gumbel``): ``argmax(logits + gumbel)``, which is how
``jax.random.categorical`` draws, so a test that passes a JAX-backed key
replays the reference's noise.  The top-k filter sets every logit below
the k-th largest to −1e30 over the padded vocab, as the JAX package does.
"""

from __future__ import annotations

import operator
import time

import torch

from repro_torch.core.random import SeedKey
from repro_torch.kernels.common import resolve_device


# The JAX package's factories jit the model's methods; with nothing to
# compile here they are the bound methods themselves.
make_prefill = operator.attrgetter("prefill")
make_decode_step = operator.attrgetter("decode_step")


def sample_token(logits, key, *, temperature: float = 0.0, top_k: int = 0):
    """Greedy (T = 0) or top-k sampled next token.  logits: (B, V)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        vals = torch.topk(logits, top_k, dim=-1).values
        logits = torch.where(logits < vals[..., -1:], -1e30, logits)
    noise = key.gumbel(logits.numel(), logits.device).reshape(logits.shape)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def generate(model, params, batch, n_steps: int, key=None, *,
             temperature: float = 0.0, top_k: int = 0,
             deadline_s: float | None = None, clock=time.monotonic,
             device=None):
    """Host-side autoregressive generation (batched, greedy by default).

    ``deadline_s`` bounds the host decode loop's wall clock: once the
    budget is spent the loop stops after the current step and the result
    carries fewer than ``n_steps`` columns (the first token always
    completes).  ``clock`` is injectable; it is read before the prefill
    and, when a deadline is set, before every decode step.  ``device``
    (default the card; raises without one) is where the batch goes; the
    parameters must already be there.  Returns (B, ≤ n_steps) int32.
    """
    dev = resolve_device(device)
    key = key if key is not None else SeedKey(0)
    t0 = clock()
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    logits, cache = model.prefill(params, batch)
    pos0 = cache["step_offset"]
    out = []
    tok = sample_token(logits, key, temperature=temperature, top_k=top_k)
    out.append(tok)
    for i in range(n_steps - 1):
        if deadline_s is not None and clock() - t0 >= deadline_s:
            break
        key, sub = key.split(2)
        logits, cache = model.decode_step(params, cache, tok[:, None],
                                          pos0 + i)
        tok = sample_token(logits, sub, temperature=temperature, top_k=top_k)
        out.append(tok)
    return torch.stack(out, dim=1)   # (B, ≤ n_steps)
