"""The port's ``utils`` (tree and timing helpers, the dry run's cost
count), its shape-only mesh and kernel 8's meta route, on the CPU.

``utils/tree.py`` and ``utils/timing.py`` are held to the reference's
(``repro/utils``) on the same seeded numpy trees: counts and bytes
exactly, the f32 global norm to 1e-6 relative (the leaves' sums of
squares in the same order, each leaf's sum in another).
``utils/cost.py`` is held to exact counts on a known program, two
matmuls and an add, the counterpart of
``tests/test_system.py::test_hlo_cost_parser_on_known_program``; its dot
FLOPs also equal those the reference's ``module_costs`` reads from the
program compiled by XLA.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.utils import timing as jtiming  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from repro_torch.utils import cost as tcost  # noqa: E402
from repro_torch.utils import timing as ttiming  # noqa: E402
from repro_torch.utils import tree as ttree  # noqa: E402


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    t = {"b": [rng.normal(size=(3, 5)).astype(np.float32),
               rng.integers(0, 9, (4,)).astype(np.int32)],
         "a": {"w": rng.normal(size=(7,)).astype(np.float32),
               "h": rng.normal(size=(2, 2, 3)).astype(np.float16)}}
    return (jax.tree_util.tree_map(jnp.asarray, t),
            {"b": [torch.from_numpy(x) for x in t["b"]],
             "a": {k: torch.from_numpy(v) for k, v in t["a"].items()}})


def test_tree_helpers_match_jax():
    jt, tt = _trees()
    assert ttree.tree_count(tt) == jtree.tree_count(jt) == 15 + 4 + 7 + 12
    assert ttree.tree_bytes(tt) == jtree.tree_bytes(jt)
    np.testing.assert_allclose(float(ttree.tree_norm(tt)),
                               float(jtree.tree_norm(jt)), rtol=1e-6)
    assert ttree.tree_norm(tt).dtype == torch.float32
    zeros = ttree.tree_zeros_like(tt)
    for z, w in zip(jax.tree_util.tree_leaves(jtree.tree_zeros_like(jt)),
                    [zeros["a"]["h"], zeros["a"]["w"], *zeros["b"]]):
        assert tuple(z.shape) == tuple(w.shape) and not bool(w.any())
    cast = ttree.tree_cast(tt, torch.bfloat16)
    jcast = jtree.tree_cast(jt, jnp.bfloat16)
    assert cast["b"][1].dtype == torch.int32
    assert jcast["b"][1].dtype == jnp.int32
    np.testing.assert_array_equal(
        cast["a"]["w"].to(torch.float32).numpy(),
        np.asarray(jcast["a"]["w"].astype(jnp.float32)))


def test_tree_bytes_count_meta_tensors():
    t = {"w": torch.empty((1 << 20, 1 << 10), dtype=torch.bfloat16,
                          device="meta")}
    assert ttree.tree_bytes(t) == 2 << 30
    assert ttree.tree_count(t) == 1 << 30


def test_timer_report_matches_jax():
    mine, ref = ttiming.Timer(), jtiming.Timer()
    for timer in (mine, ref):
        for name in ("b", "a", "b"):
            with timer.section(name):
                pass
        timer.totals = {"a": 0.5, "b": 1.25}
    assert mine.counts == ref.counts == {"a": 1, "b": 2}
    assert mine.report() == ref.report()


def test_timed_calls_as_the_reference():
    calls = {"t": 0, "j": 0}

    def tf(x):
        calls["t"] += 1
        return torch.ones(3) * x

    def jf(x):
        calls["j"] += 1
        return jnp.ones(3) * x

    out, secs = ttiming.timed(tf, 2.0, warmup=2, iters=3)
    jout, jsecs = jtiming.timed(jf, 2.0, warmup=2, iters=3)
    assert calls == {"t": 5, "j": 5}
    assert secs > 0 and jsecs > 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def _known(x, w1, w2, b):
    return (x @ w1) @ w2 + b


def test_cost_mode_counts_a_known_program():
    """(64×32)·(32×16), then ·(16×8), then + (8,): FLOPs 2·m·n·k per
    product; bytes each operation's operands and output; the peak the
    arguments and the two live intermediates at the second product."""
    m, k, n, o = 64, 32, 16, 8
    x, w1, w2, b = (torch.empty(s, device="meta") for s in
                    ((m, k), (k, n), (n, o), (o,)))
    with tcost.CostMode() as cm:
        cm.track((x, w1, w2, b))
        _known(x, w1, w2, b)
    c = cm.costs()
    f = 4
    assert c["flops"] == 2 * m * n * k + 2 * m * o * n
    mm1 = (m * k + k * n + m * n) * f
    mm2 = (m * n + n * o + m * o) * f
    assert c["dot_bytes"] == mm1 + mm2
    assert c["bytes"] == mm1 + mm2 + (m * o + o + m * o) * f
    args = (m * k + k * n + n * o + o) * f
    assert c["peak_bytes"] == args + (m * n + m * o) * f
    assert c["collectives"] == {} and c["kernels"] == {}
    # the reference's count of the same program, compiled by XLA
    from repro.utils.hlo import module_costs

    compiled = jax.jit(_known).lower(
        *(jnp.ones(s, jnp.float32) for s in
          ((m, k), (k, n), (n, o), (o,)))).compile()
    assert module_costs(compiled.as_text())["flops"] == c["flops"]


def test_cost_mode_sees_the_backward_and_frees_storage():
    """The gradient of x·w with respect to w (xᵀ·g) adds one product of
    the same FLOPs; a temporary dropped before the next allocation is
    not counted twice in the peak."""
    w = torch.empty((32, 32), device="meta", requires_grad=True)
    x = torch.empty((8, 32), device="meta")
    with tcost.CostMode() as cm:
        cm.track((w, x))
        y = (x @ w).sum()
        torch.autograd.grad(y, [w])
    assert cm.costs()["flops"] == 2 * 2 * 8 * 32 * 32
    with tcost.CostMode() as cm:
        cm.track(x)
        for _ in range(5):
            t = torch.empty((1000,), device="meta")
            del t
    assert cm.costs()["peak_bytes"] == x.numel() * 4 + 4000


def test_shape_mesh_collectives_record_their_bytes():
    from repro_torch.launch.mesh import (
        ShapeMesh,
        collective_bytes,
        make_production_mesh,
    )

    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.index(("pod", "data")) == 0 and mesh.size(("pod",
                                                           "data")) == 32
    x = torch.empty((64, 3), dtype=torch.bfloat16, device="meta")
    assert mesh.psum(x, ("pod", "data")).shape == x.shape
    assert mesh.all_gather(x, "data").shape == (16, 64, 3)
    assert mesh.psum_scatter(x, ("pod", "data")).shape == (2, 3)
    assert mesh.broadcast(x, "model", 0).shape == x.shape
    n = 64 * 3 * 2
    assert mesh.collectives == {
        "all-reduce": {"bytes": n, "count": 1},
        "all-gather": {"bytes": 16 * n, "count": 1},
        "reduce-scatter": {"bytes": n // 32, "count": 1},
        "broadcast": {"bytes": n, "count": 1}}
    assert collective_bytes("all-gather", x, 16) == 16 * n
    one = ShapeMesh((1, 4), ("data", "model"))
    assert one.psum(x, "data") is x and one.psum_scatter(x, "data") is x
    assert one.collectives == {}
    with pytest.raises(ValueError, match="meta"):
        mesh.psum(torch.zeros(3), "data")


def test_flash_meta_route_records_without_launching():
    from repro_torch.kernels.common import meta_launch_recorder
    from repro_torch.kernels.flash_attention import (
        count_valid_pairs,
        flash_attention,
        flash_cost,
    )

    q = torch.empty((2, 300, 8, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 500, 2, 64), dtype=torch.bfloat16, device="meta")
    seen = []
    before = flash_attention.launches
    with meta_launch_recorder(lambda *a: seen.append(a)):
        out = flash_attention(q, k, k, causal=True, window=128, q_offset=200)
    assert out.device.type == "meta" and out.shape == q.shape
    assert flash_attention.launches == before
    flops, nbytes, _ = flash_cost(2, 300, 500, 8, 2, 64, causal=True,
                                  window=128, q_offset=200)
    assert seen == [("flash_attention", flops, nbytes)]
    pairs = count_valid_pairs(300, 500, True, 128, 200)
    assert flops == 4.0 * 64 * pairs * 2 * 8
    assert nbytes == 2 * (2 * 2 * 300 * 8 * 64 + 2 * 2 * 500 * 2 * 64)
    k3 = torch.empty((2, 500, 3, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k3, k3)


@pytest.mark.parametrize("sq,skv,causal,window,off", [
    (7, 7, True, 0, 0), (7, 9, False, 0, 0), (5, 12, True, 3, 6),
    (16, 16, True, 4, 0), (1, 1500, False, 0, 0), (3, 4, True, 0, 9)])
def test_count_valid_pairs_is_the_masks_count(sq, skv, causal, window,
                                              off):
    from repro_torch.kernels.flash_attention import count_valid_pairs
    from repro_torch.kernels.flash_attention.ref import attention_mask

    want = int(attention_mask(sq, skv, causal=causal, window=window,
                              q_offset=off, device="cpu").sum())
    assert count_valid_pairs(sq, skv, causal, window, off) == want


def test_expert_counts_equal_bincount():
    from repro_torch.models.layers.moe import expert_counts

    e = torch.from_numpy(np.random.default_rng(1).integers(0, 6, 50))
    np.testing.assert_array_equal(expert_counts(e, 8).numpy(),
                                  torch.bincount(e, minlength=8).numpy())
    assert expert_counts(e.to("meta"), 8).shape == (8,)
