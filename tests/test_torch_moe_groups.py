"""The MoE layer's grouped dispatch (``moe_groups``) and its data-parallel
form against the JAX reference, on the CPU.

Single device: under ``moe_groups`` 2 and 4 (the reference's
``set_flags(moe_groups=...)`` and the port's) the same seeded numpy
weights and hidden states (4 rows × 8 tokens) go through both layers on
reduced grok-1 (top-2) and llama4-maverick (top-1): output, aux loss
and the gradients of Σ(out · w) + aux with respect to the weights and
the hidden states.  ``skewed`` routes every token to expert 0 first, so
each group's capacity drops assignments.

Data parallel: four gloo ranks, mesh (data 2, model 2); each data rank
takes its 2 rows under ``activation_sharding_ctx`` and takes the
gradient of its share (its rows' Σ(out · w) plus aux / 2).  Its rows of
the output, the aux loss (global), the sum of the ranks' weight
gradients and the rows' hidden-state gradients must equal the
reference's single-device values, under ``moe_groups`` 0 (the global
dispatch: each rank places its assignments after the earlier ranks'),
2 and 4 (whole groups per rank), on the skewed router where capacity
binds.  A planted fault, rank 1 dispatching as if its rows were the
whole batch, reads above the tolerance.

Tolerances, from readings on the CPU: TOL 1e-5 (rtol and atol) on the
output and the aux loss, as ``tests/test_torch_moe.py`` (readings: the
output 6.1e-7, the aux loss 9.3e-10); GRAD_TOL 1e-5 on a gradient's
largest difference over its largest entry, for the weights over the
layer's largest weight-gradient entry (readings 2.5e-7 for the weights,
5.4e-7 for the hidden states).  The fault reads 1.06.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_helpers as H  # noqa: E402
import torch_train_helpers as T  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro.sharding import flags as jax_flags  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402
from repro_torch.sharding import reset_flags, set_flags  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-5
ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]
B, S = 4, 8
MESH_CASES = [(a, g, None) for a in ARCHS for g in (0, 2, 4)]
FAULT = ("grok-1-314b", 0, "alone")


def _params(cfg, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {"router": rng.normal(size=(d, e)) * d ** -0.5,
         "w1": rng.normal(size=(e, d, f)) * d ** -0.5,
         "w2": rng.normal(size=(e, f, d)) * f ** -0.5}
    if cfg.moe.gated:
        p["w3"] = rng.normal(size=(e, d, f)) * d ** -0.5
    if skew:
        p["router"] = np.zeros((d, e))
        p["router"][:, 0] = 10.0
    return {k: v.astype(np.float32) for k, v in p.items()}


def _inputs(cfg, seed=1, skew=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model))
    w = rng.normal(size=(B, S, cfg.d_model))
    return ((np.abs(x) if skew else x).astype(np.float32),
            w.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _ref_fn(arch, groups):
    jcfg = jax_reduced_config(arch)

    def f(pp, xx, ww):
        out, aux = jmoe.moe_apply(pp, xx, jcfg)
        return jnp.sum(out * ww) + aux, (out, aux)

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


def reference(arch, groups, p, x, w):
    """(out, aux, weight gradients, x gradient) of the reference (traced
    under its ``moe_groups`` flag)."""
    jax_flags.set_flags(moe_groups=groups)
    try:
        (_, (out, aux)), (gp, gx) = _ref_fn(arch, groups)(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            jnp.asarray(w))
    finally:
        jax_flags.reset_flags()
    return (np.asarray(out), float(aux),
            {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx))


def rel_err(got, want, scale=None):
    """Largest difference over ``scale`` (default: ``want``'s largest
    entry)."""
    if scale is None:
        scale = np.abs(want).max()
    return float(np.abs(got - want).max() / max(scale, 1e-30))


def weight_scale(gp: dict) -> float:
    """The layer's largest weight-gradient entry: the scale of every
    weight gradient's error (top-1 routing's router gradient is the aux
    loss's alone, of the order of rounding in the others)."""
    return max(float(np.abs(g).max()) for g in gp.values())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("skew", [False, True], ids=["random", "skewed"])
def test_grouped_dispatch_matches_jax(arch, groups, skew):
    cfg = get_reduced_config(arch)
    p = _params(cfg, skew=skew)
    x, w = _inputs(cfg, skew=skew)
    want_out, want_aux, want_gp, want_gx = reference(arch, groups, p, x, w)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    set_flags(moe_groups=groups)
    try:
        out, aux = tmoe.moe_apply(tp, tx, cfg)
        grads = torch.autograd.grad(
            torch.sum(out * torch.from_numpy(w)) + aux,
            list(tp.values()) + [tx])
    finally:
        reset_flags()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux.detach()), want_aux, rtol=TOL,
                               atol=TOL)
    for k, g in zip(tp, grads):
        assert rel_err(g.numpy(), want_gp[k], weight_scale(want_gp)) \
            <= GRAD_TOL, k
    assert rel_err(grads[-1].numpy(), want_gx) <= GRAD_TOL
    if skew:   # capacity binds in every group: some rows come out 0
        rows = out.detach().reshape(-1, cfg.d_model).norm(dim=-1)
        assert float(rows.min()) == 0.0


def test_groups_that_span_ranks_raise():
    """moe_groups = 2 over 4 data ranks would cut a group across ranks."""
    from repro_torch.sharding import partitioning

    class Group:
        size, index = 4, 0

    cfg = get_reduced_config("grok-1-314b")
    p = {k: torch.from_numpy(v) for k, v in _params(cfg).items()}
    x = torch.from_numpy(_inputs(cfg)[0][:1])
    orig = tmoe.batch_group
    tmoe.batch_group = lambda: Group()
    set_flags(moe_groups=2)
    try:
        with pytest.raises(ValueError, match="span ranks"):
            tmoe.moe_apply(p, x, cfg)
    finally:
        tmoe.batch_group = orig
        reset_flags()
    assert partitioning.batch_group() is None     # no context: one device


@pytest.fixture(scope="module")
def mesh_runs():
    params, xs, ws = {}, {}, {}
    for arch in ARCHS:
        cfg = get_reduced_config(arch)
        params[arch] = _params(cfg, skew=True)
        xs[arch], ws[arch] = _inputs(cfg, skew=True)
    ranks = H.launch(T.moe_rank, 4, MESH_CASES + [FAULT], params, xs, ws)
    return ranks, params, xs, ws


def _gathered(ranks, case):
    """The data ranks' rows in order (ranks 0 and 2), and the sum of
    their weight gradients."""
    parts = [ranks[0][case], ranks[2][case]]
    for twin, part in ((1, parts[0]), (3, parts[1])):     # model twins
        np.testing.assert_array_equal(ranks[twin][case]["out"], part["out"])
    out = np.concatenate([q["out"] for q in parts])
    gx = np.concatenate([q["x_grad"] for q in parts])
    gp = {k: parts[0]["grads"][k] + parts[1]["grads"][k]
          for k in parts[0]["grads"]}
    return out, [q["aux"] for q in parts], gp, gx


@pytest.mark.parametrize("arch,groups,fault", MESH_CASES)
def test_data_parallel_moe_matches_jax(mesh_runs, arch, groups, fault):
    ranks, params, xs, ws = mesh_runs
    want_out, want_aux, want_gp, want_gx = reference(
        arch, groups, params[arch], xs[arch], ws[arch])
    out, auxes, gp, gx = _gathered(ranks, (arch, groups, fault))
    np.testing.assert_allclose(out, want_out, rtol=TOL, atol=TOL)
    assert auxes[0] == auxes[1]            # global, the same bits
    np.testing.assert_allclose(auxes[0], want_aux, rtol=TOL, atol=TOL)
    for k in gp:
        assert rel_err(gp[k], want_gp[k], weight_scale(want_gp)) \
            <= GRAD_TOL, k
    assert rel_err(gx, want_gx) <= GRAD_TOL
    rows = np.linalg.norm(out.reshape(-1, out.shape[-1]), axis=-1)
    assert rows.min() == 0.0               # capacity dropped some


def test_planted_fault_reads_above_the_tolerance(mesh_runs):
    ranks, params, xs, ws = mesh_runs
    arch, groups, _ = FAULT
    want_out, *_ = reference(arch, groups, params[arch], xs[arch], ws[arch])
    out, *_ = _gathered(ranks, FAULT)
    assert rel_err(out, want_out) > 100 * TOL
