"""Small tree helpers: a port of ``repro/utils/tree.py`` over the port's
trees (``repro_torch.tree``: nested dicts, lists, tuples and NamedTuples
with tensor leaves)."""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def tree_count(tree) -> int:
    """Total number of scalar entries of the tree's leaves."""
    return int(sum(x.numel() for x in tree_leaves(tree)))


def tree_bytes(tree) -> int:
    """Total bytes of the tree's leaves (by dtype; ``meta`` tensors count
    as the tensors they stand for)."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm of the tree, in f32: the leaves' sums of squares
    added in order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def tree_cast(tree, dtype):
    """Floating leaves cast to ``dtype``; the others as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)
