"""The port's training loss and its gradients against the JAX reference
on the CPU: the encoder-decoder (the encoder and the cross-attention through
the plain ``full`` path) and the image prefix; and ``cfg.remat``,
whose per-layer checkpoints must give the same gradients bit for bit.
Inputs, weights and tolerances are ``tests/test_torch_train_loss.py``'s.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from test_torch_encdec_vlm import _batch  # noqa: E402
from test_torch_train_loss import _tb, check_loss_and_grads, models  # noqa: E402

ARCHS = ["whisper-base", "internvl2-2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["smollm-135m", "grok-1-314b",
                                  "whisper-base"])
def test_remat_gives_the_same_gradients_bitwise(arch):
    """``cfg.remat`` checkpoints each layer: the recomputed forward is
    the same computation, so the loss and every gradient are bitwise
    equal with and without it on the CPU."""
    _, _, tm, tp = models(arch)
    batch = _tb(_batch(tm.cfg, 2, 32))
    plain = loss_and_grads(tm, tp, batch)
    rm = build_model(dataclasses.replace(tm.cfg, remat=True))
    remat = loss_and_grads(rm, tp, batch)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(tree_leaves(plain[2]), tree_leaves(remat[2])):
        assert torch.equal(a, b)
