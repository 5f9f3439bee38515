"""The port's tensor parallelism over ``model`` in serving: prefill and
greedy decode against the JAX reference's single-device ``prefill`` and
``decode_step``, on the CPU.

Gloo ranks on meshes (data 1, model 2) and (data 2, model 2) serve the
reduced configs of ``tests/torch_tp_helpers.py`` from the reference's
perturbed init, each rank on its shards and its rows of a seeded batch
of 4 prompts: a prefill and 8 greedy decode steps.  The prompts (40
tokens; 70 and 71 for smollm, so that both ranks of its split linear
cache hold positions; 24 for the MoE) pass the reduced danube's window
of 32, so its ring caches wrap.  Each case's layer-0 cache is the
layout the placements give it: the KV heads split (danube), the slots
of a linear cache (smollm: 134 slots, 67 a rank) or of a ring
(danube_slots: 32 slots, 16 a rank, the positions split too), or the
cache whole (smollm_whole_cache: 135 slots).  Held against the
reference:

  * the greedy tokens equal;
  * LOGIT_TOL 1e-4 — every step's logits, absolute and relative, as
    ``tests/test_torch_lm.py``'s prefill and decode; readings on the CPU
    at most 4.0e-6.  A planted fault (the decode's merge over the
    ranks' slots without the maxima's maximum) reads 5.2 on smollm.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_helpers as H  # noqa: E402
import torch_tp_helpers as P  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from test_torch_lm import _perturb  # noqa: E402

LOGIT_TOL = 1e-4
STEPS = 8
PROMPTS = {"smollm": 70, "danube": 40, "danube_slots": 40,
           "smollm_whole_cache": 71, "llama4": 24, "odd_vocab": 40}
NAMES = list(PROMPTS)
SHAPES = [(1, 2), (2, 2)]
CACHES = {"smollm": ("SlotKVCache", (67, 1), 67),
          "danube": ("KVCache", (32, 1), 32),
          "danube_slots": ("SlotKVCache", (16, 1), 16),
          "smollm_whole_cache": ("KVCache", (135, 1), 135),
          "llama4": ("KVCache", (88, 1), 88),
          "odd_vocab": ("KVCache", (104, 1), 104)}


def _reference(name):
    """(numpy weights, prompts, greedy tokens (B, STEPS), logits (B,
    STEPS, V)) of the reference."""
    jcfg = P.config(name, jax_reduced_config)
    jm = jax_build_model(jcfg)
    pnp = _perturb(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), 0)
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    tok = P.padded_tokens(jcfg, 4, PROMPTS[name])
    logits, cache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tok)})
    dec = jax.jit(jm.decode_step)
    pos0 = cache["step_offset"]
    toks, logs = [], []
    for i in range(STEPS):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(nxt))
        logs.append(np.asarray(logits))
        if i < STEPS - 1:
            logits, cache = dec(jp, cache, nxt[:, None], pos0 + i)
    return pnp, tok, np.stack(toks, 1), np.stack(logs, 1)


def _launch(fn, refs, names):
    params = {n: refs[n][0] for n in names}
    tokens = {n: refs[n][1] for n in names}
    got: dict = {}

    def launch(shape):
        try:
            got[shape] = H.launch(fn, shape[0] * shape[1], shape, names,
                                  params, tokens, STEPS,
                                  "smollm" if shape == (1, 2) else None)
        except BaseException as e:        # noqa: BLE001 — raised below
            got["error"] = e

    threads = [threading.Thread(target=launch, args=(s,)) for s in SHAPES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if "error" in got:
        raise got["error"]
    return got


@pytest.fixture(scope="module")
def runs():
    refs = {n: _reference(n) for n in NAMES}
    return _launch(P.serve_rank, refs, NAMES), refs


def _rows(ranks, name, key):
    """The whole batch's rows from the ranks of ``model`` coordinate 0,
    in data order."""
    return np.concatenate([np.asarray(r[name][key]) for r in ranks[::2]])


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_and_logits_match_jax(runs, shape, name):
    got, refs = runs
    ranks = got[shape]
    _, _, toks, logs = refs[name]
    for r in ranks:
        kind, (cap, hkv), npos = CACHES[name]
        c = r[name]["cache"]
        assert (c[0], c[1][1:3], c[2][1]) == (kind, (cap, hkv), npos)
    # both model ranks of a data coordinate return the same bits
    for a, b in zip(ranks[::2], ranks[1::2]):
        np.testing.assert_array_equal(np.asarray(a[name]["logits"]),
                                      np.asarray(b[name]["logits"]))
    np.testing.assert_array_equal(_rows(ranks, name, "tokens"), toks)
    np.testing.assert_allclose(_rows(ranks, name, "logits"), logs,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_planted_merge_fault_reads_above_the_gate(runs):
    """smollm's decode merged without the maxima's maximum over the
    ranks' slots: the decode logits part from the reference's."""
    got, refs = runs
    logs = refs["smollm"][3]
    got = np.asarray(got[(1, 2)][0]["fault"]["logits"])
    assert np.abs(got[:, 1:] - logs[:, 1:]).max() > 1e3 * LOGIT_TOL
