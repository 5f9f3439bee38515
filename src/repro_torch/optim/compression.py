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

Where a rank holds only a part of a leaf (its ZeRO-1 part over the batch
axes, its shard over ``model``, or both), :func:`compress_parts` gives
the part the whole leaf's threshold or scale: each holder's top-k
magnitudes (the k largest of the whole are among them) or its largest
magnitude, gathered over the axes that split the leaf.  The result is
the single-device one on the same whole gradient, bit for bit; the
error feedback lives with the part.
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


class Holders:
    """The mesh axes over which the parts of one leaf differ (each an
    axis name or the batch axes' tuple, ``launch/mesh.py::Mesh``); none
    for a leaf the rank holds whole."""

    def __init__(self, mesh=None, axes=()):
        self.mesh, self.axes = mesh, tuple(axes)

    def all_gather(self, x):
        """(P·n,): every holder's (n,) ``x``."""
        for a in self.axes:
            x = self.mesh.all_gather(x, a).reshape(-1)
        return x

    def pmax(self, x):
        for a in self.axes:
            x = self.mesh.pmax(x, a)
        return x


def _topk_part(g, numel: int, holders: Holders, ratio: float):
    """``_topk_leaf`` on a part ``g`` (error feedback added) of a leaf of
    ``numel`` entries."""
    k = max(1, int(numel * ratio))
    mag = torch.abs(g.reshape(-1))
    n = min(k, mag.numel())
    vals = torch.topk(mag, n).values
    if n < k:                       # a short part: pad below every |g|
        vals = torch.cat([vals, vals.new_full((k - n,), -1.0)])
    thresh = torch.topk(holders.all_gather(vals), k).values[-1]
    sent = g * (torch.abs(g) >= thresh)
    return sent, g - sent


def _int8_part(g, holders: Holders):
    """``_int8_leaf`` (dequantized) on a part ``g`` (error feedback
    added): the scale from the largest |g| over the holders."""
    mx = (torch.amax(torch.abs(g)) if g.numel()
          else g.new_zeros(()))
    scale = torch.clamp(holders.pmax(mx), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, g - deq


def compress_parts(grads: list, error_fb: list, units: list, scheme: str,
                   *, topk_ratio: float = 0.05):
    """Compress and decompress a rank's parts of the reference's leaves.
    ``grads`` and ``error_fb`` are flat lists of tensors; ``units`` lists
    (indices, numel, holders) per reference leaf: the indices of the
    tensors that hold this rank's part of it (in the reference's stacked
    order; some may be empty), the whole leaf's entry count, and its
    :class:`Holders`.  Returns (the f32 gradients that the compressed
    form decodes to, the new error feedback), as lists."""
    sent: list = [None] * len(grads)
    fb: list = [None] * len(grads)
    for idx, numel, holders in units:
        local = torch.cat([(grads[i].to(torch.float32) + error_fb[i])
                           .reshape(-1) for i in idx])
        if scheme == "topk":
            s, e = _topk_part(local, numel, holders, topk_ratio)
        elif scheme == "int8":
            s, e = _int8_part(local, holders)
        else:
            raise ValueError(scheme)
        sizes = [grads[i].numel() for i in idx]
        for i, a, b in zip(idx, s.split(sizes), e.split(sizes)):
            sent[i] = a.reshape(grads[i].shape)
            fb[i] = b.reshape(grads[i].shape)
    return sent, fb


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
