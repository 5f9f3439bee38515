"""The port's continuous-batching ``ServeEngine`` against the JAX
reference, on the CPU: the reference's three ``TestServeEngine`` cases
(``tests/test_engine_r2.py``, here ``tests/torch_engine_helpers.py``) on
reduced smollm-135m (linear KV caches) and reduced h2o-danube-1.8b (ring
caches: window 32, prompts and ``max_seq`` past it); reduced
recurrentgemma-2b in ``tests/test_torch_engine_hybrid.py``.

Both packages start from the reference's initial weights (carried in
with ``model_params_from_numpy``).  Greedy decoding: each request's
tokens must equal the reference's ``generate`` of that request alone,
exactly (f32 logits; the first difference would be an argmax flip, and
none is near a tie here).  The reference's own engine is no yardstick
at one super-block: its ``_insert_slot`` takes a stacked leaf whose
super-block axis has length 1 for a (B, ...) leaf and writes it along
the wrong axis, so recurrentgemma at 13 layers decodes other tokens in
the reference's engine (ROADMAP §3, reference caveats).
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_engine_helpers as E  # noqa: E402
from repro_torch.train import insert_slot  # noqa: E402

# arch: (prompt lengths, max_seq)
ARCHS = {"smollm-135m": ((12, 7, 19), 64),
         "h2o-danube-1.8b": ((40, 12, 50), 96)}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_single_request_generate(arch):
    E.check_matches_generate(arch, *ARCHS[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_more_requests_than_slots(arch):
    E.check_more_requests_than_slots(arch, ARCHS[arch][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_eos_stops_early(arch):
    E.check_eos_stops_early(arch)


def test_insert_slot_copies_one_row_in_place():
    """Every leaf of the batch-1 cache lands in its row of the batched
    cache, whose tensors stay the same objects; the other rows stay; a
    leaf of another shape raises."""
    _, _, _, cfg, model, params = E.setup("h2o-danube-1.8b")
    cache = model.init_cache(3, 64, device="cpu")
    before = [t.data_ptr() for t in (cache["layers"][0].k,
                                     cache["step_offset"])]
    _, one = model.prefill(params, {"tokens": torch.from_numpy(
        E.prompts(cfg.vocab_size, (40,), 3)[0][None])},
        max_new_tokens=64 - 40)
    insert_slot(cache, one, 1)
    assert [t.data_ptr() for t in (cache["layers"][0].k,
                                   cache["step_offset"])] == before
    for got, want in ((cache["layers"][1].k, one["layers"][1].k),
                      (cache["layers"][1].positions,
                       one["layers"][1].positions)):
        assert torch.equal(got[1], want[0])
    assert int(cache["step_offset"][1]) == 40
    assert (cache["layers"][0].positions[[0, 2]] == -1).all()
    _, other = model.prefill(params, {"tokens": torch.zeros(
        (1, 8), dtype=torch.int32)}, max_new_tokens=8)     # 16 positions
    with pytest.raises(ValueError, match="cannot insert"):
        insert_slot(model.init_cache(2, 64, device="cpu"), other, 0)
