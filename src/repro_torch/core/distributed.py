"""The single-device piece of ``repro/core/distributed.py``.

Only ``pad_ground_set`` is here, for ``CoresetObjective.from_features``.
The sharded runtime itself (``dash_distributed`` and the other sharded
selectors, the objectives' ``dist_*`` methods, the mesh) is ROADMAP
item 11.
"""

from __future__ import annotations

import torch


def pad_ground_set(X, multiple: int):
    """Pad the candidate columns of X (d, n) with zeros to a multiple of
    ``multiple``; returns ``(X_padded, n)``.  A zero column's gains are
    0; the sharded runner starts the padding outside the alive set."""
    d, n = X.shape
    n_pad = (-n) % multiple
    if n_pad == 0:
        return X, n
    return torch.cat([X, torch.zeros((d, n_pad), dtype=X.dtype,
                                     device=X.device)], dim=1), n
