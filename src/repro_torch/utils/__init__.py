"""Tree and timing helpers, and the dry run's cost count
(``utils/cost.py``)."""

from repro_torch.utils.timing import Timer, timed
from repro_torch.utils.tree import (
    tree_bytes,
    tree_cast,
    tree_count,
    tree_norm,
    tree_zeros_like,
)

__all__ = [
    "tree_bytes",
    "tree_cast",
    "tree_count",
    "tree_norm",
    "tree_zeros_like",
    "Timer",
    "timed",
]
