"""The port's placements (``repro_torch.sharding``) against the JAX
reference's ``PartitionSpec`` trees, leaf for leaf, for every arch of
the registry at its reduced and its published width.

Shapes only: the reference's trees come from ``jax.eval_shape`` (no
weights), the port's from ``meta`` tensors (``Model.param_specs`` and
``Model.init_cache(device="meta")``).  The reference stacks each
pattern position's layers over super-blocks (``blocks``, and the
encoder's layers in ``enc_blocks``; a cache's ``layers`` likewise), the
port keeps one leaf per layer: the reference's placement of a stacked
leaf, with its leading entry dropped, must equal the port's placement of
every layer in that stack.  Meshes are stubs with a ``.shape`` mapping
and ``.axis_names``: (16, 16), (2, 16, 16), (2, 4) and (1, 2), with
``fsdp`` off and on.  Exact equality: placements are discrete.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.sharding import flags as jax_flags  # noqa: E402
from repro.sharding import partitioning as jax_part  # noqa: E402
from repro.sharding import cache_specs as jax_cache  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    get_config,
    get_reduced_config,
    list_archs,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    batch_axes_for_mesh,
    batch_partition_specs,
    cache_partition_specs,
    param_partition_specs,
    reset_flags,
    set_flags,
    zero1_specs,
)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((1, 2), ("data", "model"))]
WIDTHS = ("reduced", "published")
# A decode cell per width: batch and cache capacity.
CACHE = {"reduced": (1, 64), "published": (32, 8192)}
BATCH = {"reduced": (4, 64), "published": (32, 4096)}
CASES = [(a, w) for a in list_archs() for w in WIDTHS]


class StubMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


@functools.lru_cache(maxsize=None)
def configs(arch, width):
    if width == "reduced":
        return jax_reduced(arch), get_reduced_config(arch)
    return jax_config(arch), get_config(arch)


def _key(p):
    for attr in ("key", "name", "idx"):
        if hasattr(p, attr):
            return getattr(p, attr)
    return str(p)


def ref_leaves(tree, is_leaf=None):
    """{path: leaf} of a reference tree (paths of keys and indices)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(_key(p) for p in path): leaf for path, leaf in flat}


def port_leaves(tree, path=()):
    """{path: leaf} of a port tree; a placement (a tuple of entries) is
    a leaf, a NamedTuple's fields enter the path by name."""
    out = {}
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(port_leaves(getattr(tree, f), path + (f,)))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(port_leaves(v, path + (k,)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(port_leaves(v, path + (i,)))
    else:
        out[path] = tree
    return out


def per_layer(ref_path, cfg, stacks):
    """The port paths that the reference's leaf at ``ref_path`` stands
    for, and whether it is stacked.  ``stacks`` maps a stacked subtree's
    name in the reference to (the port's name, the layer count, the
    period)."""
    head = ref_path[0]
    if head not in stacks:
        return [ref_path], False
    name, n, period = stacks[head]
    if period is None:                       # the encoder: one stack
        return [(name, i) + ref_path[1:] for i in range(n)], True
    j = ref_path[1]
    return [(name, i) + ref_path[2:] for i in range(j, n, period)], True


def compare(ref_specs, port_specs, cfg, stacks):
    want = ref_leaves(ref_specs,
                      is_leaf=lambda x: isinstance(x, jax.sharding.
                                                   PartitionSpec))
    got = port_leaves(port_specs)
    seen = set()
    for path, spec in want.items():
        ports, stacked = per_layer(path, cfg, stacks)
        entries = tuple(spec)[1:] if stacked else tuple(spec)
        for pp in ports:
            assert pp in got, (pp, sorted(got)[:5])
            assert got[pp] == entries, (path, pp, got[pp], entries)
            seen.add(pp)
    assert seen == set(got), sorted(set(got) - seen)[:5]


def param_stacks(cfg):
    out = {"blocks": ("layers", cfg.n_layers, cfg.pattern_period)}
    if cfg.is_encdec:
        out["enc_blocks"] = ("enc_layers", cfg.encoder.n_layers, None)
    return out


@functools.lru_cache(maxsize=None)
def ref_shapes(arch, width):
    jcfg, _ = configs(arch, width)
    jm = jax_build(jcfg)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    b, cap = CACHE[width]
    cache = jax.eval_shape(lambda: jm.init_cache(b, cap))
    return params, cache


@functools.lru_cache(maxsize=None)
def port_shapes(arch, width):
    _, cfg = configs(arch, width)
    model = build_model(cfg)
    b, cap = CACHE[width]
    return model.param_specs(), model.init_cache(b, cap, device="meta")


def batch_shapes(cfg, width, meta):
    b, s = BATCH[width]

    def spec(shape, dtype):
        return (torch.empty(shape, device="meta") if meta
                else jax.ShapeDtypeStruct(shape, dtype))

    out = {"tokens": spec((b, s), jnp.int32)}
    if cfg.vision is not None:
        out["img_embeds"] = spec((b, cfg.vision.n_img_tokens,
                                  cfg.vision.embed_dim), jnp.bfloat16)
    if cfg.is_encdec:
        out["enc_frames"] = spec((b, cfg.encoder.src_len, cfg.d_model),
                                 jnp.bfloat16)
    return out


@pytest.fixture(params=[False, True], ids=["fsdp_off", "fsdp_on"])
def fsdp(request):
    jax_flags.set_flags(fsdp=request.param)
    set_flags(fsdp=request.param)
    yield request.param
    jax_flags.reset_flags()
    reset_flags()


@pytest.mark.parametrize("arch,width", CASES)
def test_param_and_zero1_specs_match_jax(arch, width, fsdp):
    jcfg, cfg = configs(arch, width)
    jparams, _ = ref_shapes(arch, width)
    params, _ = port_shapes(arch, width)
    for shape, axes in MESHES:
        mesh = StubMesh(shape, axes)
        want = jax_part.param_partition_specs(jparams, jcfg, mesh)
        got = param_partition_specs(params, cfg, mesh)
        compare(want, got, cfg, param_stacks(cfg))
        baxes = jax_part.batch_axes_for_mesh(mesh)
        assert batch_axes_for_mesh(mesh) == baxes
        compare(jax_cache.zero1_specs(want, jparams, mesh, baxes),
                zero1_specs(got, params, mesh, baxes, cfg=cfg), cfg,
                param_stacks(cfg))


@pytest.mark.parametrize("arch,width", CASES)
def test_cache_and_batch_specs_match_jax(arch, width):
    jcfg, cfg = configs(arch, width)
    _, jcache = ref_shapes(arch, width)
    _, cache = port_shapes(arch, width)
    stacks = {"layers": ("layers", cfg.n_layers, cfg.pattern_period)}
    for shape, axes in MESHES:
        mesh = StubMesh(shape, axes)
        baxes = jax_part.batch_axes_for_mesh(mesh)
        compare(jax_cache.cache_partition_specs(jcache, jcfg, mesh, baxes),
                cache_partition_specs(cache, cfg, mesh, baxes), cfg, stacks)
        compare(jax_cache.batch_partition_specs(
                    batch_shapes(cfg, width, False), mesh, baxes),
                batch_partition_specs(batch_shapes(cfg, width, True), mesh,
                                      baxes), cfg, {})


def test_fsdp_moves_a_placement():
    """The fsdp case is not vacuous: on (2, 4) it changes some leaf of
    published smollm's placements, and the reference's stacked axis
    takes ``data`` for some (30 super-blocks over data 2)."""
    _, cfg = configs("smollm-135m", "published")
    params, _ = port_shapes("smollm-135m", "published")
    mesh = StubMesh((2, 4), ("data", "model"))
    off = port_leaves(param_partition_specs(params, cfg, mesh))
    set_flags(fsdp=True)
    try:
        on = port_leaves(param_partition_specs(params, cfg, mesh))
    finally:
        reset_flags()
    moved = [p for p in off if off[p] != on[p]]
    assert moved and any(p[0] != "layers" for p in moved)
