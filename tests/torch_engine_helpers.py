"""Shared pieces of the port's ``ServeEngine`` parity files
(``tests/test_torch_engine.py``, ``tests/test_torch_engine_hybrid.py``):
the reduced archs with the reference's initial weights, the prompts,
and the reference's three ``TestServeEngine`` cases as checks."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro.train.serve import generate as jax_generate
from repro_torch.configs import get_reduced_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import build_model
from repro_torch.train import ServeEngine

N_NEW = 6


def _cut(cfg):
    """recurrentgemma at one pattern period (13 layers)."""
    return (dataclasses.replace(cfg, n_layers=13)
            if cfg.name.startswith("recurrentgemma") else cfg)


@functools.lru_cache(maxsize=None)
def setup(arch):
    jcfg, cfg = _cut(jax_reduced(arch)), _cut(get_reduced_config(arch))
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jm, jparams, cfg, build_model(cfg), params


def prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def check_matches_generate(arch, lens, max_seq):
    """Greedy continuous batching (2 slots) equals each request's greedy
    decoding alone in the reference."""
    _, jm, jparams, cfg, model, params = setup(arch)
    ps = prompts(cfg.vocab_size, lens, 0)
    engine = ServeEngine(model, params, max_batch=2, max_seq=max_seq,
                         eos_id=-1, device="cpu")
    rids = [engine.submit(p, max_new=N_NEW) for p in ps]
    outs = engine.run_until_done()
    assert set(outs) == set(rids)
    for p, rid in zip(ps, rids):
        ref = jax_generate(jm, jparams, {"tokens": jnp.asarray(p[None])},
                           n_steps=N_NEW)
        np.testing.assert_array_equal(outs[rid], np.asarray(ref[0]))


def check_more_requests_than_slots(arch, max_seq):
    _, jm, jparams, cfg, model, params = setup(arch)
    ps = prompts(cfg.vocab_size, (8,) * 5, 1)
    engine = ServeEngine(model, params, max_batch=2, max_seq=max_seq,
                         eos_id=-1, device="cpu")
    rids = [engine.submit(p, max_new=4) for p in ps]
    outs = engine.run_until_done()
    assert len(outs) == 5 and all(len(v) == 4 for v in outs.values())
    ref = jax_generate(jm, jparams, {"tokens": jnp.asarray(np.stack(ps))},
                       n_steps=4)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], np.asarray(ref[i]))


def check_eos_stops_early(arch):
    _, jm, jparams, cfg, model, params = setup(arch)
    p = prompts(cfg.vocab_size, (8,), 2)[0]
    ref = jax_generate(jm, jparams, {"tokens": jnp.asarray(p[None])},
                       n_steps=1)
    eos = int(ref[0, 0])
    engine = ServeEngine(model, params, max_batch=1, max_seq=48, eos_id=eos,
                         device="cpu")
    rid = engine.submit(p, max_new=10)
    outs = engine.run_until_done()
    assert len(outs[rid]) == 1 and int(outs[rid][0]) == eos
