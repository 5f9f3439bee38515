"""Gradient compression with error feedback.

A port of ``repro/optim/compression.py``.  Two schemes, both with error
feedback, so that the compression's error is added to the next step's
gradient instead of being lost (Karimireddy et al. 2019):

  * ``topk`` — keep the largest ``ratio`` fraction of each leaf's
               entries by magnitude (ties at the threshold kept);
  * ``int8`` — per-leaf symmetric int8 quantization with an f32 scale.

On one device nothing crosses a slow axis; the port applies the scheme
to the accumulated gradient as the reference's train step does, so a
run with compression follows the same trajectory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class Int8Leaf(NamedTuple):
    q: torch.Tensor       # int8, the leaf's shape
    scale: torch.Tensor   # () f32


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _topk_leaf(g, ef, ratio: float):
    g = g.to(torch.float32) + ef
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    sent = g * (torch.abs(g) >= thresh)
    return sent, g - sent


def _int8_leaf(g, ef):
    g = g.to(torch.float32) + ef
    scale = torch.clamp(torch.amax(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return Int8Leaf(q, scale), g - deq


def compress_gradients(grads, error_fb, scheme: str, *,
                       topk_ratio: float = 0.05):
    """Returns (compressed, new error feedback); ``decompress_gradients``
    turns ``compressed`` back into f32 gradients."""
    if scheme == "none":
        return grads, error_fb
    gl, el = tree_leaves(grads), tree_leaves(error_fb)
    if scheme == "topk":
        outs = [_topk_leaf(g, e, topk_ratio) for g, e in zip(gl, el)]
    elif scheme == "int8":
        outs = [_int8_leaf(g, e) for g, e in zip(gl, el)]
    else:
        raise ValueError(scheme)
    comp = tree_unflatten(grads, [o[0] for o in outs])
    ef = tree_unflatten(grads, [o[1] for o in outs])
    return comp, ef


def decompress_gradients(compressed, scheme: str):
    if scheme in ("none", "topk"):
        return compressed

    def deq(node):
        if isinstance(node, Int8Leaf):
            return node.q.to(torch.float32) * node.scale
        if isinstance(node, dict):
            return {k: deq(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(deq(v) for v in node)
        raise TypeError(f"unexpected leaf {type(node).__name__}")

    return deq(compressed)
