"""The port's training loss and its gradients against the JAX reference
on the CPU: the RG-LRU hybrid.  Inputs, weights and
tolerances are ``tests/test_torch_train_loss.py``'s.

The reduced recurrentgemma-2b repeats its 2:1 pattern (rglru, rglru,
local_attn) in a period of 13 layers, and the reference's compile of a
13-block loss gradient alone takes 18 s here; so its check runs the
pattern's one repeat as the period, two super-blocks of it (6 layers:
every block kind, at the reduced widths, the window-32 local attention
and the split of stacked super-blocks).
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

from test_torch_train_loss import check_loss_and_grads  # noqa: E402

RGLRU_CUT = dict(n_layers=6, block_pattern=("rglru", "rglru", "local_attn"))


def test_loss_and_grads_match_jax_rglru():
    check_loss_and_grads("recurrentgemma-2b", **RGLRU_CUT)
