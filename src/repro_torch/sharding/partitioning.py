"""Mesh partitioning rules and the batch-axes context of the model code.

A port of ``repro/sharding/partitioning.py``.

**Placements.**  :func:`param_partition_specs` gives, for every leaf of
the port's parameter tree, a placement: a tuple with one entry per
dimension, each an axis name, a tuple of axis names or ``None``
(replicated), under the reference's name-based rules over the leaf's
path, with shape divisibility checks against the mesh:

  * vocab (embedding rows, the head's columns) → ``model``
  * d_ff (MLP hidden)                          → ``model``
  * MoE experts E                              → ``model`` (else the
                                                  experts' d_ff)
  * attention heads                            → ``model`` iff both
                                                  head counts divide it,
                                                  else the contracting
                                                  d_model iff it divides
  * RG-LRU width, the xLSTM inner dimension    → ``model``
  * everything else                            → replicated
  * ``fsdp`` (``sharding/flags.py``)           → also the first free
                                                  dimension that divides
                                                  the data axis

The reference stacks each pattern position's layers over super-blocks
(and the encoder's over its layers) and gives those leaves a leading
placement for the stacked axis.  The port's leaves are one layer each,
so a placement of a layer's leaf is the reference's with that leading
entry dropped.  Two rules look at the stacked leaf as a whole, and the
port follows them on the stacked shape it stands for: ``fsdp`` skips a
leaf of fewer than 2^20 elements counted over the whole stack, and
takes the stacked axis itself when the data axis divides it (the
per-layer placement then carries no ``data``: each layer lives whole on
the data shard of its super-block).  ``cache_specs.zero1_specs`` does
the same.  The port's dry run (``launch/dryrun.py``) uses these
placements as the reference's does: for one device's argument bytes on
the production mesh, and ``zero1_specs`` for the ZeRO-1 train step
(``train/step.py``, through ``cache_specs.zero1_layout``), which cuts
the optimizer's state over the batch axes.  Under tensor parallelism
(``make_train_step(..., tensor_parallel=True)``, the dry run) a rank
holds its shards of the parameters by their ``model`` entries
(``tensor_parallel.shard_params``); ``train_loop`` keeps them
replicated, as the reference's loop does.

**Activations.**  The reference constrains activations to the batch
axes ``('pod', 'data')`` (``('data',)`` on one pod) at block boundaries
(``constrain``, ``constrain_moe_buffer``, ``constrain_moe_hidden``,
``constrain_attention_seq``) and lets GSPMD insert the collectives that
make the sharded program compute the single-device function.  The port
runs its collectives by hand, so it has no counterpart of those calls:
``activation_sharding_ctx`` carries the mesh and its batch axes to the
model code instead, and each place where the reference's function
couples rows of the batch runs an explicit collective over the batch
axes' group (:func:`batch_group`): the loss's count of supervised
tokens (``Model.loss``), and the MoE's capacity and load-balance loss
(``models/layers/moe.py``).  Everything else in the model is per row.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any

from repro_torch.sharding.flags import get_flags

_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding_ctx(batch_axes, *, mesh=None,
                            tensor_parallel: bool = False):
    """Make the model code data-parallel over ``batch_axes`` of ``mesh``.

    Inside the context, with a ``mesh`` (``launch/mesh.py::Mesh``) whose
    batch axes hold more than one rank, the model's batch-coupled
    quantities are reduced over the batch axes' group
    (:func:`batch_group`).  With ``tensor_parallel`` and a mesh whose
    ``model`` axis holds more than one rank, the model code runs on the
    rank's parameter shards (``sharding/tensor_parallel.py``); without
    it the parameters are whole on every rank and ``model`` shards
    nothing.  The reference's sequence argument has no counterpart: the
    port shards no activation over the model axis.
    """
    tok = _ACT_CTX.set({"batch": tuple(batch_axes), "mesh": mesh,
                        "tp": bool(tensor_parallel)})
    try:
        yield
    finally:
        _ACT_CTX.reset(tok)


def captured_context():
    """A context manager that re-enters the sharding context active now.
    The backward of a checkpointed layer recomputes its forward on the
    autograd engine's thread for the device, which does not see the
    caller's context; the layer runs under this to see it there too."""
    saved = _ACT_CTX.get()

    @contextlib.contextmanager
    def enter():
        tok = _ACT_CTX.set(saved)
        try:
            yield
        finally:
            _ACT_CTX.reset(tok)

    return enter


class BatchGroup:
    """The batch axes' group of this rank: ``size`` ranks, this one at
    row-major coordinate ``index``; its collectives run over them."""

    def __init__(self, mesh, axes: tuple):
        self.mesh = mesh
        self.axes = axes
        self.size = mesh.size(axes)
        self.index = mesh.index(axes)

    def psum(self, x):
        """Sum over the group without a gradient (every rank the same
        bits)."""
        return self.mesh.psum(x.detach(), self.axes)

    def psum_grad(self, x):
        """Sum over the group that carries autograd: the backward sums
        the ranks' incoming gradients."""
        return _psum_grad().apply(x, self.mesh, self.axes)

    def all_gather(self, x):
        """(size, *x.shape): every rank's ``x`` in coordinate order, no
        gradient."""
        return self.mesh.all_gather(x.detach(), self.axes)


def _psum_grad():
    """An autograd function: the sum over a mesh's axes, whose gradient
    is the sum of the ranks' gradients (each rank's input feeds every
    rank's output)."""
    import torch

    class PsumGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mesh, axes):
            ctx.mesh, ctx.axes = mesh, axes
            return mesh.psum(x, axes)

        @staticmethod
        def backward(ctx, g):
            return ctx.mesh.psum(g.contiguous(), ctx.axes), None, None

    return PsumGrad


def batch_group() -> BatchGroup | None:
    """The active context's batch group, or None outside a context, with
    no mesh, or where the batch axes hold one rank (the single-device
    function needs no collective)."""
    ctx = _ACT_CTX.get()
    if ctx is None or ctx["mesh"] is None:
        return None
    mesh = ctx["mesh"]
    axes = tuple(a for a in ctx["batch"] if a in mesh.shape)
    if not axes or mesh.size(axes) == 1:
        return None
    return BatchGroup(mesh, axes)


# ---------------------------------------------------------------------------
# parameter partition specs
# ---------------------------------------------------------------------------

def _divisible(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _attn_spec(name: str, shape, cfg, model_size: int) -> tuple:
    """Attention weights: the heads' dimension iff the heads divide the
    axis, else the contracting d_model iff it divides, else replicated."""
    a = cfg.attn
    heads_div = (_divisible(a.n_heads, model_size)
                 and _divisible(a.n_kv_heads, model_size))
    spec = [None] * len(shape)
    if name in ("wq", "wk", "wv"):
        if heads_div:
            spec[1] = "model"              # (d, H·dh): the output
        elif _divisible(shape[0], model_size):
            spec[0] = "model"              # the contracting d_model
    elif name == "wo":
        if heads_div:
            spec[0] = "model"              # (H·dh, d): the contracting
        elif _divisible(shape[1], model_size):
            spec[1] = "model"
    elif name in ("bq", "bk", "bv"):
        if heads_div:
            spec[0] = "model"
    return tuple(spec)


def _leaf_spec(names: list, shape: tuple, cfg, model_size: int) -> tuple:
    """The placement of one leaf (a layer's, not stacked) at ``names``."""
    name = names[-1]
    if name == "embed":
        return ("model", None) if _divisible(shape[0], model_size) else ()
    if name == "lm_head":
        return (None, "model") if _divisible(shape[1], model_size) else ()
    if name == "img_proj":
        return ()
    spec = [None] * len(shape)
    if "moe" in names:
        # Expert parallel when E divides the axis, else tensor parallel
        # within the experts (d_ff over model): grok-1's 8 experts on a
        # 16-wide axis take the second path.
        if name == "router":
            return tuple(spec)
        if _divisible(shape[0], model_size):
            spec[0] = "model"
        elif cfg.moe is not None and _divisible(cfg.d_ff, model_size):
            for i in range(1, len(shape)):
                if shape[i] == cfg.d_ff:
                    spec[i] = "model"
                    break
        return tuple(spec)
    if "mlp" in names:
        for i in range(len(shape)):
            if shape[i] == cfg.d_ff and _divisible(cfg.d_ff, model_size):
                spec[i] = "model"
                break
        return tuple(spec)
    if "attn" in names or "xattn" in names or "enc_attn" in names:
        return _attn_spec(name, shape, cfg, model_size)
    if "rglru" in names:
        w = cfg.recurrent.width if cfg.recurrent else -1
        if name in ("w_in", "w_gate") and _divisible(w, model_size):
            spec[1] = "model"
        elif name == "w_out" and _divisible(w, model_size):
            spec[0] = "model"
        elif name in ("w_a", "w_i"):
            if len(shape) == 3:                # block-local gates
                if _divisible(shape[0], model_size):
                    spec[0] = "model"
            elif _divisible(w, model_size):
                spec[1] = "model"
        elif name in ("b_a", "b_i", "lam", "conv") and _divisible(
                w, model_size):
            spec[-1] = "model"
        return tuple(spec)
    if "xlstm" in names:
        if name == "w_up" and _divisible(shape[1], model_size):
            spec[1] = "model"
        elif name == "w_down" and _divisible(shape[0], model_size):
            spec[0] = "model"
        elif name in ("wq", "wk", "wv", "w_gates") and _divisible(
                shape[1], model_size):
            spec[1] = "model"
        return tuple(spec)
    return tuple(spec)


def _rebuild(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; a
    NamedTuple's fields enter the path by name."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, path + (f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def stack_count(path: tuple, cfg) -> int:
    """How many layers the reference stacks into the leaf that the
    port's leaf at ``path`` is one slice of: the super-blocks for a
    decoder layer's leaf, the encoder's layers for an encoder layer's,
    1 (not stacked) for the rest."""
    if cfg is None or not path:
        return 1
    if path[0] == "layers":
        return cfg.n_layers // cfg.pattern_period
    if path[0] == "enc_layers":
        return cfg.encoder.n_layers
    return 1


def _fsdp_skips(shape: tuple, stacked: int) -> bool:
    """``fsdp`` leaves norms, biases and small tensors alone: fewer than
    2 dimensions or 2^20 elements, counted on the reference's stacked
    leaf."""
    return (len(shape) + (stacked > 1) < 2
            or math.prod(shape) * stacked < (1 << 20))


def fsdp_takes_stack(path: tuple, shape: tuple, cfg, mesh) -> bool:
    """True where ``fsdp`` puts ``data`` on the reference's stacked axis
    of the leaf the port's leaf at ``path`` is a slice of."""
    stacked = stack_count(path, cfg)
    return (get_flags().fsdp and stacked > 1
            and not _fsdp_skips(shape, stacked)
            and _divisible(stacked, mesh.shape.get("data", 1)))


def extend_first_free(spec: tuple, shape: tuple, stacked: int, axes,
                      size: int) -> tuple:
    """``spec`` with ``axes`` put on the first dimension that has no
    placement and that ``size`` divides, where the reference's stacked
    axis of ``stacked`` layers (if ``stacked`` > 1) comes first: taking
    that axis leaves the per-layer placement as it was."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    if stacked > 1 and _divisible(stacked, size):
        return tuple(dims)
    for i, d in enumerate(dims):
        if d is None and _divisible(shape[i], size):
            dims[i] = axes
            break
    return tuple(dims)


def param_partition_specs(params, cfg, mesh) -> Any:
    """A tree of placements (tuples, see the module docstring) with the
    structure of ``params``, a parameter tree of real or ``meta``
    tensors.  ``mesh`` needs only a ``.shape`` mapping of axis sizes."""
    model_size = mesh.shape.get("model", 1)
    fsdp = get_flags().fsdp
    data_size = mesh.shape.get("data", 1)

    def spec_for(path, leaf):
        names = [p for p in path if isinstance(p, str)]
        shape = tuple(leaf.shape)
        spec = _leaf_spec(names, shape, cfg, model_size)
        stacked = stack_count(path, cfg)
        if not fsdp or _fsdp_skips(shape, stacked):
            return spec
        return extend_first_free(spec, shape, stacked, "data", data_size)

    return _rebuild(params, spec_for)


def batch_axes_for_mesh(mesh) -> tuple:
    """('pod', 'data') on a mesh with a pod axis, ('data',) otherwise."""
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)
