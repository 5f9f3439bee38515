"""Tensor parallelism over the ``model`` axis: the rank's parameter shards
and the collectives that make the model code compute the single-device
function on them.

The reference places parameters over ``model`` by name
(``param_partition_specs``) and lets GSPMD insert the collectives.  The
port runs them by hand.  Inside ``activation_sharding_ctx(...,
tensor_parallel=True)`` with a mesh whose ``model`` axis holds more than
one rank, :func:`model_group` gives the model code a :class:`ModelGroup`:
the axis, this rank's coordinate and the :class:`Layout` that the
placements give each kind of leaf of the config,

  * attention: ``heads`` where both head counts divide the axis (``wq``,
    ``wk``, ``wv`` and their biases by columns: whole heads, a rank's q
    heads exactly those of its kv heads; ``wo`` by rows, then a sum),
    else ``contract`` where d_model divides (``wq``, ``wk``, ``wv`` by
    rows: the input sliced, the partial q, k, v summed, attention whole
    on every rank; ``wo`` by columns, then an all-gather), else whole;
  * the MLP: d_ff by columns in ``w1``/``w3``, by rows in ``w2``, then
    a sum;
  * the MoE: ``experts`` where E divides (a rank runs its experts on the
    replicated dispatch, the outputs summed), else ``dff`` inside every
    expert;
  * the vocabulary: the embedding's rows and the head's columns where
    the padded vocab divides (a masked local lookup then a sum; the
    logits vocab-parallel);
  * the decode cache (``cache_partition_specs``): the KV heads where
    they divide, else the slots (:func:`kv_layout`).

The collectives that carry autograd come in the four pairs of Megatron's
f and g: :meth:`ModelGroup.enter` (identity forward, sum backward) where
a replicated activation meets split weights; :meth:`ModelGroup.reduce`
(sum forward, identity backward) after a product over a split
contracting dimension, summed in f32 and then cast, so that the sum adds
no rounding of its own; :meth:`ModelGroup.gather_last` (all-gather
forward, slice backward) after a product split on its output columns;
:meth:`ModelGroup.slice_last` (slice forward, all-gather backward) where
a replicated input meets weights split on their rows.  Every activation
between the layers stays replicated over ``model``, so a replicated
leaf (a norm, the router) gets the same gradient on every rank with no
reduction.

:func:`shard_params` cuts a tree of whole leaves (parameters, or the
optimizer's trees of their shapes) into this rank's shards by the
placements' ``model`` entries, and :func:`gather_params` puts it back.
The RG-LRU, the xLSTM and the encoder-decoder are not covered
(:func:`tp_gap`): there the context runs the model whole.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.sharding.partitioning import (
    _ACT_CTX,
    _attn_spec,
    _divisible,
    _leaf_spec,
    _rebuild,
)

MODEL = "model"


def tp_gap(cfg) -> str | None:
    """None where the port's tensor parallelism covers every leaf of
    ``cfg``; else what stays whole (the context then runs the model whole
    on every rank)."""
    if cfg.is_encdec:
        return "the encoder and the cross-attention"
    if "rglru" in cfg.block_pattern:
        return "the RG-LRU width"
    if any(k in ("mlstm", "slstm") for k in cfg.block_pattern):
        return "the xLSTM inner dimension"
    return None


def _model_dim(spec) -> int | None:
    """The dimension a placement puts on ``model``, or None."""
    for i, e in enumerate(spec):
        if e == MODEL or (isinstance(e, tuple) and MODEL in e):
            return i
    return None


@dataclass(frozen=True)
class Layout:
    """What the placements put on ``model`` in a config, by kind of leaf
    (the module docstring)."""
    attn: str | None
    mlp: bool
    moe: str | None
    vocab: bool

    @staticmethod
    @functools.lru_cache(maxsize=64)
    def of(cfg, size: int) -> "Layout":
        a, d = cfg.attn, cfg.d_model
        attn = {1: "heads", 0: "contract", None: None}[_model_dim(
            _attn_spec("wq", (d, a.n_heads * a.head_dim), cfg, size))]
        mlp = moe = None
        if cfg.d_ff > 0 and cfg.moe is None:
            dim = _model_dim(_leaf_spec(["mlp", "w1"], (d, cfg.d_ff), cfg,
                                        size))
            if dim == 0:
                raise NotImplementedError("d_model equal to d_ff: the "
                                          "placement splits w1's rows")
            mlp = dim == 1
        if cfg.moe is not None:
            dim = _model_dim(_leaf_spec(["moe", "w1"], (cfg.moe.n_experts,
                                                        d, cfg.d_ff), cfg,
                                        size))
            if dim == 1:
                raise NotImplementedError("d_model equal to d_ff: the "
                                          "placement splits w1's rows")
            moe = {0: "experts", 2: "dff", None: None}[dim]
        vocab = _model_dim(_leaf_spec(["embed"], (cfg.padded_vocab, d), cfg,
                                      size)) == 0
        return Layout(attn, bool(mlp), moe, vocab)


def kv_layout(cfg, capacity: int, size: int, rows_split: bool) -> tuple:
    """(mode, positions split) of a KV cache of ``capacity`` slots under
    ``cache_partition_specs``: ``heads`` where the KV heads divide the
    axis, else ``slots`` where the capacity does (the ring's
    ``positions`` too, where the batch rows are placed over the batch
    axes), else None (whole)."""
    if _divisible(cfg.attn.n_kv_heads, size):
        return "heads", False
    if _divisible(capacity, size):
        return "slots", rows_split
    return None, False


# ---------------------------------------------------------------------------
# the four autograd pairs
# ---------------------------------------------------------------------------

class _Enter(torch.autograd.Function):
    """Identity forward, sum over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g.contiguous(), MODEL), None


class _Reduce(torch.autograd.Function):
    """Sum over ``model`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.psum(x, MODEL)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _cat_gathered(mesh, x):
    """Every member's ``x`` along its last dimension, in coordinate
    order."""
    parts = mesh.all_gather(x.contiguous(), MODEL)
    return torch.cat(list(parts.unbind(0)), dim=-1)


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dimension forward, this rank's slice
    backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[-1]
        return _cat_gathered(mesh, x)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(MODEL)
        return g.narrow(-1, i * ctx.n, ctx.n).contiguous(), None


class _SliceLast(torch.autograd.Function):
    """This rank's slice of the last dimension forward, all-gather
    backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        size = mesh.size(MODEL)
        n = x.shape[-1] // size
        return x.narrow(-1, mesh.index(MODEL) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _cat_gathered(ctx.mesh, g), None


def partial_matmul(x, w):
    """``x @ w`` in f32: a partial product whose sum over ``model`` is
    cast once (:meth:`ModelGroup.reduce`)."""
    if x.dtype != torch.float32:
        x = x.float()
    if w.dtype != torch.float32:
        w = w.float()
    return x @ w


class ModelGroup:
    """The ``model`` axis of this rank under tensor parallelism: ``size``
    ranks, this one at ``index``, the config's :class:`Layout`, and
    whether the batch rows are placed over the batch axes
    (``rows_split``: the ring cache's positions follow them)."""

    def __init__(self, mesh, layout: Layout, rows_split: bool, ctx: dict):
        self.mesh = mesh
        self.size = mesh.size(MODEL)
        self.index = mesh.index(MODEL)
        self.layout = layout
        self.rows_split = rows_split
        self._ctx = ctx

    def enter(self, x):
        """``x`` unchanged; its gradient summed over the axis."""
        return _Enter.apply(x, self.mesh)

    def reduce(self, partial, dtype):
        """The sum over the axis of an f32 ``partial``, cast to
        ``dtype``; the gradient passes through."""
        return _Reduce.apply(partial, self.mesh).to(dtype)

    def gather_last(self, x):
        """Every rank's ``x`` concatenated along the last dimension; the
        gradient sliced back."""
        return _GatherLast.apply(x, self.mesh)

    def slice_last(self, x):
        """This rank's block of ``x``'s last dimension; the gradient
        all-gathered."""
        return _SliceLast.apply(x, self.mesh)

    def psum(self, x):
        """Sum over the axis, no gradient."""
        return self.mesh.psum(x.detach(), MODEL)

    def pmax(self, x):
        """Maximum over the axis, no gradient."""
        return self.mesh.pmax(x.detach(), MODEL)

    def cat_last(self, x):
        """Every rank's ``x`` along the last dimension, no gradient."""
        return _cat_gathered(self.mesh, x.detach())

    def once(self, key: str) -> bool:
        """True the first time ``key`` is asked for inside this context
        (a check made on the first call only)."""
        seen = self._ctx.setdefault("once", set())
        if key in seen:
            return False
        seen.add(key)
        return True


def model_group(cfg) -> ModelGroup | None:
    """The active context's :class:`ModelGroup` for ``cfg``, or None:
    outside a tensor-parallel context, where ``model`` holds one rank,
    or where the port does not cover the config (:func:`tp_gap`)."""
    ctx = _ACT_CTX.get()
    if ctx is None or not ctx.get("tp") or ctx["mesh"] is None:
        return None
    mesh = ctx["mesh"]
    size = mesh.size(MODEL)
    if size == 1 or tp_gap(cfg) is not None:
        return None
    rows_split = any(a in mesh.shape for a in ctx["batch"])
    return ModelGroup(mesh, Layout.of(cfg, size), rows_split, ctx)


# ---------------------------------------------------------------------------
# shards of whole trees
# ---------------------------------------------------------------------------

def model_dims(params, pspecs) -> list:
    """Per leaf of ``params`` (``tree_leaves`` order), the dimension its
    placement in ``pspecs`` puts on ``model``, or None."""
    from repro_torch.tree import tree_leaves_with_path

    specs = _spec_of(pspecs)
    return [_model_dim(specs[p]) for p, _ in tree_leaves_with_path(params)]


def _spec_of(pspecs):
    from repro_torch.sharding.cache_specs import _walk_specs

    return dict(_walk_specs(pspecs))


def shard_params(tree, pspecs, mesh):
    """This rank's shards (copies) of a tree of whole leaves with the
    structure of the placements ``pspecs`` (the parameters, or the
    optimizer's master, m, v or error feedback): each leaf cut along the
    dimension its placement puts on ``model``.  A tree with no leaves
    (``()``) is returned as it is."""
    size = mesh.size(MODEL)
    if size == 1:
        return tree
    return tree_map_shards(tree, pspecs, size, mesh.index(MODEL),
                           lambda x: x.clone())


def tree_map_shards(tree, pspecs, size: int, index: int, fn=None):
    """The ``index``-th of ``size`` shards of each leaf of ``tree`` by the
    placements' ``model`` entries (views, or ``fn`` of them)."""
    specs = _spec_of(pspecs)

    def cut(path, x):
        dim = _model_dim(specs[path])
        if dim is None:
            return x
        n = x.shape[dim] // size
        part = x.narrow(dim, index * n, n)
        return fn(part) if fn is not None else part

    return _rebuild(tree, cut)


def gather_params(tree, pspecs, mesh):
    """The whole leaves from every rank's shards (:func:`shard_params`'
    inverse; a collective: every member of the axis calls it)."""
    size = mesh.size(MODEL)
    if size == 1:
        return tree
    specs = _spec_of(pspecs)

    def whole(path, x):
        dim = _model_dim(specs[path])
        if dim is None:
            return x
        return torch.cat(list(mesh.all_gather(x.contiguous(),
                                              MODEL).unbind(0)), dim=dim)

    return _rebuild(tree, whole)
