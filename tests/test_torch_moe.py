"""The port's Mixture-of-Experts layer against the JAX reference, on the
CPU.

The same seeded numpy weights and hidden states go through
``repro.models.layers.moe`` and ``repro_torch.models.layers.moe`` on the
reduced grok-1 (8 → 4 experts, top-2) and llama4-maverick (128 → 4
experts, top-1) configs.  Tolerance TOL 1e-5 (rtol and atol) on the
output and the aux loss: f32 products over d_model 64 and d_ff 128 in
another summation order, values of order 1.  The dispatch itself (sort
order, capacity cut, destinations, counts) must be equal exactly,
including under a router that sends every token to one expert, where
capacity drops most of them and the other experts' probabilities tie
(``jax.lax.top_k`` puts the lower index first; the port's stable sort
does too).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402

TOL = 1e-5
MOE_ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _params(cfg, seed=0, skew=False):
    """Seeded numpy weights with the JAX init's shapes and scales; with
    ``skew`` the router prefers expert 0 by 10 and ties the others."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {"router": rng.normal(size=(d, e)) * d ** -0.5,
         "w1": rng.normal(size=(e, d, f)) * d ** -0.5,
         "w2": rng.normal(size=(e, f, d)) * f ** -0.5,
         "w3": rng.normal(size=(e, d, f)) * d ** -0.5}
    if skew:
        p["router"] = np.zeros((d, e))
        p["router"][:, 0] = 10.0
    return {k: v.astype(np.float32) for k, v in p.items()}


def _x(cfg, b, s, seed=1, skew=False):
    """Hidden states; with ``skew`` positive, so that the skewed router
    sends every token to expert 0 first."""
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model))
    return (np.abs(x) if skew else x).astype(np.float32)


def _configs(arch, capacity_factor=None):
    jcfg, cfg = jax_reduced_config(arch), get_reduced_config(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case", ["random", "skewed", "ample"])
def test_moe_apply_matches_jax(arch, case):
    """Output and aux loss; ``skewed`` overflows expert 0 (capacity
    drops most assignments and rows come out 0), ``ample`` (capacity
    factor 4) drops none."""
    jcfg, cfg = _configs(arch, 4.0 if case == "ample" else None)
    p = _params(cfg, skew=case == "skewed")
    x = _x(cfg, 2, 16, skew=case == "skewed")
    want, jaux = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_apply({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    counts, kept, cap = tmoe.dispatch_counts({k: _t(v) for k, v in
                                              p.items()}, _t(x), cfg)
    assert torch.equal(kept, torch.clamp(counts, max=cap))
    rows = got.reshape(-1, cfg.d_model).norm(dim=-1)
    if case == "skewed":   # expert 0 first, the tied others in order
        assert int(counts[0]) == 32 > cap
        if cfg.moe.top_k == 2:
            assert int(counts[1]) == 32
        assert float(rows.min()) == 0.0
    if case == "ample":
        assert torch.equal(kept, counts)
        assert float(rows.min()) > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("skew", [False, True])
def test_dispatch_and_combine_match_jax(arch, skew):
    """The dispatch buffer, destinations, keep mask, sort order and
    counts exactly as the reference's; the combine as its."""
    _, cfg = _configs(arch)
    p = _params(cfg, seed=2, skew=skew)
    x = _x(cfg, 3, 8, seed=3, skew=skew).reshape(-1, cfg.d_model)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    _, _, top_e = tmoe.route({n: _t(v) for n, v in p.items()},
                                     _t(x), cfg)
    jlogits = jnp.asarray(x) @ jnp.asarray(p["router"])
    _, je = jax.lax.top_k(jax.nn.softmax(jlogits, axis=-1), k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(je))
    flat = top_e.reshape(-1)
    cap = tmoe.expert_capacity(flat.shape[0], e, cfg.moe.capacity_factor)
    got = tmoe._dispatch_group(_t(x), flat, e, cap, k)
    want = jmoe._dispatch_group(jnp.asarray(x), jnp.asarray(flat.numpy()),
                                e, cap, k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out_buf = np.random.default_rng(4).normal(
        size=(e, cap, cfg.d_model)).astype(np.float32)
    tc = tmoe._combine_group(_t(out_buf), *got[1:4], e, cap, k,
                             torch.float32)
    jc = jmoe._combine_group(jnp.asarray(out_buf), *want[1:4], e, cap, k,
                             jnp.float32)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("tk,e,cf,cap", [
    (32, 4, 1.25, 10), (30, 4, 1.25, 10), (2, 128, 1.25, 1), (7, 3, 1.0, 3),
    (16384, 8, 1.25, 2560), (9, 4, 0.1, 1), (36, 8, 1.25, 6)])
def test_expert_capacity_truncates_like_the_reference(tk, e, cf, cap):
    """The reference's ``max(int(⌈tk/e⌉ · cf), 1)``: ⌈30/4⌉ · 1.25 = 10,
    ⌈36/8⌉ · 1.25 = 6.25 → 6, 3 · 0.1 → 1."""
    assert tmoe.expert_capacity(tk, e, cf) == cap


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_shapes_and_scales(arch):
    jcfg, cfg = _configs(arch)
    want = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    got = tmoe.init_moe(torch.Generator().manual_seed(0), cfg,
                        torch.float32)
    d, f = cfg.d_model, cfg.d_ff
    scales = {"router": d ** -0.5, "w1": d ** -0.5, "w2": f ** -0.5,
              "w3": d ** -0.5}
    assert set(got) == set(want) == set(scales)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape
        # the sample std of n normals strays by about 1/√(2n)
        slack = 5 / np.sqrt(2 * w.size)
        assert abs(float(got[name].std()) / scales[name] - 1) < slack
