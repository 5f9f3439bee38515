"""Continuous-batching serving engine.

A port of ``repro/train/engine.py``: a fixed pool of ``max_batch`` slots
over one batched decode cache allocated once (``Model.init_cache``).
Finished requests free their slot; a pending request is prefilled alone
(batch 1, with ``max_seq − len(prompt)`` positions of headroom, so its
cache has the engine's capacity) and its cache is copied into the free
slot; every ``step()`` decodes one token for every slot at the slot's
own position.  A request retires on ``eos_id``, after ``max_new``
tokens, or when its slot reaches ``max_seq − 1``.  Decoding is greedy,
as the reference's (whose ``temperature`` argument no code reads; the
port has none).

The reference inserts with a ``dynamic_update_slice`` per leaf of its
stacked cache (batch on axis 1 of the layers' leaves, axis 0 of
``step_offset``).  The port's cache is per layer with the batch on axis
0 of every leaf (``KVCache`` k, v and positions, the ring caches'
included; the RG-LRU and xLSTM states; ``step_offset``; ``enc_out``),
so :func:`insert_slot` copies each leaf of the batch-1 cache into its
row of the batched one, in place.  On the card each admission's prefill
runs the flash-attention kernel (kernel 8) in every attention layer, at
the request's own prompt length.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.tree import tree_leaves


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


def insert_slot(engine_cache, one_cache, slot: int) -> None:
    """Copy the batch-1 cache ``one_cache`` into row ``slot`` of the
    batched ``engine_cache``, leaf by leaf, in place.  Raises
    ``ValueError`` where the two trees' leaves do not pair up."""
    dst, src = tree_leaves(engine_cache), tree_leaves(one_cache)
    if len(dst) != len(src):
        raise ValueError(f"caches differ: {len(dst)} and {len(src)} leaves")
    for d, s in zip(dst, src):
        if s.shape[0] != 1 or d.shape[1:] != s.shape[1:]:
            raise ValueError(f"cannot insert a leaf of shape "
                             f"{tuple(s.shape)} into {tuple(d.shape)}")
        d[slot].copy_(s[0])


class ServeEngine:
    """Slots over one batched cache; ``submit`` prompts, then ``step``
    (or ``run_until_done``).  ``device`` (default the card; raises
    without one) must hold ``params``."""

    def __init__(self, model, params, *, max_batch: int = 4,
                 max_seq: int = 256, eos_id: int = 1, device=None):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.cache = model.init_cache(max_batch, max_seq, device=self.device)
        self.pos = np.zeros(max_batch, np.int32)
        self.active: list[Optional[Request]] = [None] * max_batch
        self.pending: list[Request] = []
        self.finished: dict[int, Request] = {}
        self._next_rid = 0
        self.last_tok = np.zeros(max_batch, np.int32)

    # ---- request management ---------------------------------------------
    def submit(self, prompt_tokens, max_new: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(Request(rid, np.asarray(prompt_tokens,
                                                    np.int32), max_new))
        return rid

    def _admit(self):
        for slot in range(self.max_batch):
            if self.active[slot] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            s = len(req.prompt)
            batch = {"tokens": torch.from_numpy(req.prompt[None, :]).to(
                self.device)}
            with torch.no_grad():
                logits, one_cache = self.model.prefill(
                    self.params, batch, max_new_tokens=self.max_seq - s)
            tok = int(torch.argmax(logits[0]))
            req.out.append(tok)
            insert_slot(self.cache, one_cache, slot)
            self.active[slot] = req
            self.pos[slot] = s
            self.last_tok[slot] = tok
            if tok == self.eos_id or len(req.out) >= req.max_new:
                self._retire(slot)

    def _retire(self, slot):
        req = self.active[slot]
        req.done = True
        self.finished[req.rid] = req
        self.active[slot] = None

    # ---- one engine iteration --------------------------------------------
    def step(self) -> int:
        """Admit pending prefills, then decode one token for every active
        slot.  Returns the number of active slots stepped."""
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        toks = torch.from_numpy(self.last_tok[:, None].copy()).to(
            self.device)
        pos = torch.from_numpy(self.pos.copy()).to(self.device)
        with torch.no_grad():
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, toks, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for slot in live:
            req = self.active[slot]
            tok = int(nxt[slot])
            req.out.append(tok)
            self.pos[slot] += 1
            self.last_tok[slot] = tok
            if tok == self.eos_id or len(req.out) >= req.max_new \
                    or self.pos[slot] >= self.max_seq - 1:
                self._retire(slot)
        return len(live)

    def run_until_done(self, max_steps: int = 10_000) -> dict:
        """Step until nothing is pending or active (at most ``max_steps``
        steps); the finished requests' tokens by request id, in order."""
        steps = 0
        while (self.pending or any(r is not None for r in self.active)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return {rid: np.asarray(req.out) for rid, req in
                sorted(self.finished.items())}
