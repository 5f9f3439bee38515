"""The multi-pod dry run of the port: a port of ``repro/launch/dryrun.py``.

For every assigned (architecture × input shape) cell the reference lowers
and compiles the real step (``train_step`` with ZeRO-1 for train shapes,
``prefill`` for prefill shapes, ``decode_step`` for decode shapes)
against the production mesh (16×16 single-pod, 2×16×16 multi-pod) with
the real parameter, optimizer, cache and batch placements, from shapes
alone, and records per-device memory, FLOPs, bytes and collective bytes.

The port compiles nothing and cannot start 256 ranks.  Per cell it runs
the step of one rank (the first: coordinate 0 on every axis) on ``meta``
tensors at that rank's shapes, on a ``launch.mesh.ShapeMesh`` of the
production mesh whose collectives record their bytes, under
``utils.cost.CostMode``, which counts FLOPs, bytes and the peak of live
storage.  Nothing is allocated: a full-width cell of grok-1 traces on a
laptop.

  * train cells run ``make_train_step(mesh=, grad_specs=zero1_specs(...))``
    on the rank's ZeRO-1 state (``shard_train_state``) and its rows of the
    batch, in its two halves: the loss and gradients
    (``step.accumulate``) and the rest (``step.update``);
  * prefill cells run ``Model.prefill`` on the rank's rows (kernel 8's
    wrapper takes its meta route);
  * decode cells run ``Model.decode_step`` on a cache whose rows follow
    ``cache_partition_specs``.

A meta operation costs host time, and a layer's host loops (the loss's
chunked attention, the sLSTM's steps) dispatch thousands.  So the
model's work is traced on cut copies of the model and summed
(``_depth``, ``_along``): identical layers dispatch identical
operations, and the sum equals a trace of the whole model
(``tests/test_torch_dryrun.py`` checks it, the peak included, on
reduced configs).  ``update`` is traced whole.

A batch that the batch axes' ranks do not divide stays whole on every
rank, as the reference's placement leaves it; the model code then runs
outside the data-parallel context (prefill, decode) or, in the train
step, treats the rows as the rank's share of as many identical copies as
there are ranks (the mean loss and gradient are the batch's; the record
notes it).

Tensor parallelism: where the port's covers the arch
(``sharding.tensor_parallel.tp_gap``; all but recurrentgemma-2b,
xlstm-125m and whisper-base), the rank holds its shards of the
parameters, the optimizer's state and the decode cache by their
placements' ``model`` entries and runs the model code under the
tensor-parallel context, whose collectives over ``model`` join the
record's; without ``--fsdp`` its ``held_bytes`` then equal the
placements' ``placed_argument_bytes``.  On the other three archs every
rank holds every parameter (``NOTE_NO_TP`` names what is whole).

Each record carries the reference's keys (``memory``, ``cost_raw``,
``cost``, ``collectives``, ``n_chips``, ``lower_s`` and ``compile_s``,
here the seconds of the set-up and of the traced step) and two more:
``placed_argument_bytes``, one device's argument bytes under the
reference's placements (what XLA reports as ``argument_size_in_bytes``),
and ``held_bytes``, what the port's rank really holds (the parameters
whole, its ZeRO-1 optimizer parts, its batch or cache rows), which is
also ``memory.argument_bytes``.  ``memory.peak_est_bytes`` is the traced
peak of live storage; ``output_bytes`` the outputs' storage,
``alias_bytes`` the part of it that is an argument's (decode's cache,
written in place), ``temp_bytes`` the rest of the peak.  Every figure is
a reckoning from shapes, not a measurement.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from dataclasses import replace

from repro_torch.configs.base import ALL_SHAPES, TrainConfig
from repro_torch.configs.registry import (
    cell_skip_reason,
    get_config,
    get_shape,
    list_archs,
)
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.layers import MetaGenerator
from repro_torch.sharding import (
    activation_sharding_ctx,
    batch_axes_for_mesh,
    batch_partition_specs,
    cache_partition_specs,
    get_flags,
    param_partition_specs,
    set_flags,
    zero1_layout,
    zero1_specs,
)
from repro_torch.sharding.partitioning import fsdp_takes_stack
from repro_torch.sharding.tensor_parallel import shard_params, tp_gap
from repro_torch.train.step import (
    init_train_state,
    make_train_step,
    shard_train_state,
    tp_param_specs,
)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.utils.cost import CostMode
from repro_torch.utils.tree import tree_bytes

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results")

# What the port's rank cannot do as the reference's program does.
NOTE_NO_TP = ("the port's tensor parallelism does not cover {}: every "
              "rank holds every parameter, and the model axis shards "
              "nothing")
NOTE_FSDP = ("fsdp: placed_argument_bytes follow the reference's fsdp "
             "placements; the port's step does not shard parameters "
             "over the data axis, and its ZeRO-1 parts are those "
             "without fsdp")


def _entry_size(entry, mesh) -> int:
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names if a is not None)


def _walk(tree, path=()):
    """(path, leaf) of a tree of dicts, lists and NamedTuples (by field
    name); a plain tuple (a placement) is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), path + (f,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def placed_bytes(tree, specs, mesh, stacked=None) -> int:
    """One device's bytes of ``tree`` under the placements ``specs``: each
    leaf's bytes over the ranks of the axes its placement names.
    ``stacked(path, leaf)``, where given, names the ranks over which the
    reference's stack of this layer goes (1 where it is not placed)."""
    spec_of = dict(_walk(specs))
    total = 0
    for path, leaf in _walk(tree):
        ranks = math.prod(_entry_size(e, mesh) for e in spec_of[path])
        if stacked is not None:
            ranks *= stacked(path, leaf)
        n = leaf.numel() * leaf.element_size()
        if n % ranks:
            raise ValueError(f"{path}: {n} bytes do not split over {ranks} "
                             f"ranks")
        total += n // ranks
    return total


def _fsdp_stack(cfg, mesh):
    def ranks(path, leaf):
        if fsdp_takes_stack(path, tuple(leaf.shape), cfg, mesh):
            return mesh.shape["data"]
        return 1
    return ranks


def _zero1_stack(layout, mesh):
    parts = dict(_walk(layout))

    def ranks(path, leaf):
        p = parts[path]
        return mesh.size(p.axes) if p.axes and p.dim is None else 1
    return ranks


def _rows(batch: dict, specs: dict, mesh):
    """The rank's rows (the first block) of each batch entry whose
    placement splits its first dimension; the others whole."""
    import torch

    out = {}
    for k, x in batch.items():
        ranks = _entry_size(specs[k][0], mesh)
        out[k] = torch.empty((x.shape[0] // ranks,) + tuple(x.shape[1:]),
                             dtype=x.dtype, device=x.device)
    return out


@contextlib.contextmanager
def _flags(**kw):
    old = get_flags()
    set_flags(**kw)
    try:
        yield
    finally:
        set_flags(**{k: getattr(old, k) for k in kw})


def _storage_bytes(tree) -> dict:
    """{storage key: bytes} of the tensors of ``tree``."""
    import torch

    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _traced(mesh, args, run) -> dict:
    """``run()`` under ``CostMode`` on a fresh copy of ``mesh``, ``args``
    live from the start: the costs, and the argument, output and aliased
    output bytes."""
    mesh = ShapeMesh(tuple(mesh.shape.values()), mesh.axis_names)
    with CostMode(mesh) as cm:
        cm.track(args)
        out = run(mesh)
    ins, outs = _storage_bytes(args), _storage_bytes(out)
    c = cm.costs()
    c["args"] = sum(ins.values())
    c["out"] = sum(outs.values())
    c["alias"] = sum(n for k, n in outs.items() if k in ins)
    c["notes"] = mesh.notes
    return c


def _combine(terms) -> dict:
    """Σ weight · trace of ``terms`` (weight, trace), key by key (the
    collectives and kernels by kind and field); counts and bytes come out
    whole."""
    def add(acc, x, w):
        for k, v in x.items():
            if isinstance(v, dict):
                add(acc.setdefault(k, {}), v, w)
            elif isinstance(v, (int, float)):
                acc[k] = acc.get(k, 0) + w * v
        return acc

    out: dict = {}
    for w, t in terms:
        add(out, t, w)

    def whole(d):
        for k, v in d.items():
            if isinstance(v, dict):
                whole(v)
            else:
                d[k] = int(round(v)) if k != "flops" else float(v)
    whole(out)
    for kind in ("collectives", "kernels"):
        out[kind] = {k: v for k, v in out.get(kind, {}).items()
                     if v.get("count", v.get("launches", 0))}
    return out


def _cut(cfg, super_blocks: int, enc_layers: int):
    enc = cfg.encoder
    return replace(cfg, n_layers=super_blocks * cfg.pattern_period,
                   encoder=replace(enc, n_layers=enc_layers) if enc else None)


def _recurrent_only(cfg) -> bool:
    """Every mixer an xLSTM block: no attention, no log-depth scan, so
    every operation of a layer scales with the sequence length."""
    return cfg.encoder is None and all(k in ("mlstm", "slstm")
                                       for k in cfg.block_pattern)


def _depth(cfg) -> list:
    """(weight, config) of the cut models whose weighted sum stands for
    the whole model.

    From two super-blocks on: the model with two super-blocks (and, for
    an encoder-decoder, two encoder layers), or with all it has where it
    has fewer, and with one more super-block or encoder layer, weighted
    by the count past the base.  Identical layers dispatch identical
    operations, so FLOPs, bytes, collectives and launches add up
    exactly.  The peak of live bytes grows by what each layer leaves live
    (a prefill's cache, a train step's saved inputs and gradients) only
    from the second layer on: a layer's short-lived bytes (its
    activations under ``no_grad``, a block recomputed under remat) lie in
    every trace, and so do the last layer's leftovers that the next one
    still holds, which the first layer has none of.  Differences taken
    below two layers would count some of these once a layer."""
    n_super = cfg.n_layers // cfg.pattern_period
    n_enc = cfg.encoder.n_layers if cfg.encoder else 0
    d, e = min(n_super, 2), min(n_enc, 2)
    terms = [(1 - (n_super - d) - (n_enc - e), _cut(cfg, d, e)),
             (n_super - d, _cut(cfg, d + 1, e)),
             (n_enc - e, _cut(cfg, d, e + 1))]
    return [(w, c) for w, c in terms if w]


def _along(at, s: int, q: int) -> dict:
    """``at(s)``, the costs at length ``s`` of a model whose work is
    linear in the length, from traces on the grid of ``q``-token chunks.

    The peak of live bytes is the largest of linear functions of the
    length, one for each point of the program, so it grows linearly once
    the point with the steepest slope leads.  The traces go on from two
    chunks (a loop's first and last chunk differ from the others in the
    backward) until every figure, the peak included, grows by as much
    from one length to the next as from the one before, and extrapolate
    from the last two.  Where that does not happen below ``s``, or ``s``
    is off the grid, ``s`` itself is traced."""
    if s % q:
        return at(s)
    seen = []
    for k in range(2, s // q):
        seen.append(at(k * q))
        if len(seen) >= 3:
            x, y, z = seen[-3:]
            if _combine([(1, z), (-1, y)]) == _combine([(1, y), (-1, x)]):
                f = s // q - k
                return _combine([(-f, y), (1 + f, z)])
    return at(s)


def uses_tp(cfg, mesh) -> bool:
    """True where the rank runs tensor parallel: the ``model`` axis holds
    several ranks and the port covers the arch."""
    return mesh.size("model") > 1 and tp_gap(cfg) is None


def _ctx(mesh, axes, tp):
    """The context a traced rank runs its model code in."""
    return activation_sharding_ctx(axes, mesh=mesh, tensor_parallel=tp)


def _model_phase(cfg, shape, mesh, axes, tcfg, split):
    """The costs of the model's work at ``shape`` (the loss and
    gradients of a train step; a prefill; a decode step) on one rank,
    from the cut models of ``_depth``; for a recurrent-only model (every
    mixer an xLSTM block, whose sLSTM loops over every step) also cut in
    the length (``_along``), but for a decode step, which takes the
    cache's length as it is.  ``notes`` names the traces."""
    import torch

    tp = uses_tp(cfg, mesh)

    def trace(c, sh):
        model = build_model(c)
        batch = model.input_specs(sh)
        batch.pop("cache", None)
        local = _rows(batch, batch_partition_specs(batch, mesh, axes), mesh)
        rows = local["tokens"].shape[0]
        cut = ((lambda t: shard_params(t, tp_param_specs(model, mesh),
                                       mesh)) if tp else (lambda t: t))
        if sh.kind == "train":
            acc = make_train_step(model, tcfg).accumulate
            state = init_train_state(model, MetaGenerator(), tcfg)
            state = state._replace(params=cut(state.params))

            def run(m):
                with _ctx(m, axes, tp):
                    return acc(state, local)
            return _model_trace(mesh, (state.params, local), run)
        params = cut(model.param_specs())
        if sh.kind == "prefill":
            args = (params, local)

            def run(m):
                return _serve(m, axes, split, tp,
                              lambda: model.prefill(params, local))
        else:
            with _ctx(mesh, axes if split else (), tp):
                cache = model.init_cache(rows, sh.seq_len,
                                         device=torch.device("meta"))
            args = (params, cache, local)

            def run(m):
                return _serve(m, axes, split, tp, lambda: model.decode_step(
                    params, cache, local["tokens"], local["pos"]))
        return _model_trace(mesh, args, run)

    traced = []

    def at(s):
        terms = []
        for w, c in _depth(cfg):
            traced.append((c.n_layers, s))
            terms.append((w, trace(c, replace(shape, seq_len=s))))
        return _combine(terms)

    if _recurrent_only(cfg) and not shape.is_decode:
        out = _along(at, shape.seq_len, cfg.xlstm.chunk_size)
    else:
        out = at(shape.seq_len)
    layers = sorted({n for n, _ in traced})
    lengths = sorted({n for _, n in traced})
    out["notes"] = [
        f"the layers' cost is a weighted sum of traces of cut models of "
        f"{layers} layers (launch/dryrun.py::_depth) at S {lengths}"
        + ("" if shape.seq_len in lengths else
           f", extrapolated to S {shape.seq_len} (_along)")
        + "; the peak above the arguments likewise"]
    return out


def _model_trace(mesh, args, run) -> dict:
    """``_traced``, with ``temp``: the peak of live bytes above the
    arguments."""
    t = _traced(mesh, args, run)
    t["temp"] = t["peak_bytes"] - t["args"]
    return t


def _serve(mesh, axes, split, tp, call):
    """``call()`` without gradients in the rank's context: data parallel
    where the rows are split, tensor parallel with ``tp``."""
    import torch

    with _ctx(mesh, axes if split else (), tp), torch.no_grad():
        return call()


def cell_arguments(cfg, shape, mesh, tcfg) -> dict:
    """What one rank of a cell holds before its step runs, and what the
    reference's placements give one device: ``placed`` and ``held``
    bytes, the rank's arguments (``held_args``), the train step's
    ``update`` half (train cells) and the record's first notes."""
    import torch

    axes = batch_axes_for_mesh(mesh)
    ranks = mesh.size(axes)
    tp = uses_tp(cfg, mesh)
    gap = tp_gap(cfg)
    notes = [] if gap is None else [NOTE_NO_TP.format(gap)]
    model = build_model(cfg)
    batch = model.input_specs(shape)
    cache = batch.pop("cache", None)
    bspecs = batch_partition_specs(batch, mesh, axes)
    split = bspecs["tokens"][0] is not None
    local = _rows(batch, bspecs, mesh)
    rows = local["tokens"].shape[0]
    if not split:
        notes.append(f"global batch {shape.global_batch} does not divide "
                     f"the {ranks} ranks of the batch axes: every rank "
                     f"holds all rows (the reference's placement)"
                     + ("; the data-parallel step takes them as its share "
                        f"of {ranks} identical copies"
                        if shape.kind == "train" else ""))
    if get_flags().fsdp:
        notes.append(NOTE_FSDP)
    update = None
    if shape.kind == "train":
        state = init_train_state(model, MetaGenerator(), tcfg)
        pspecs = param_partition_specs(state.params, cfg, mesh)
        ospecs = zero1_specs(pspecs, state.opt.master, mesh, axes, cfg)
        opt_stack = _zero1_stack(
            zero1_layout(ospecs, state.opt.master, mesh, axes, cfg), mesh)
        placed = (placed_bytes(state.params, pspecs, mesh,
                               _fsdp_stack(cfg, mesh))
                  + state.opt.step.element_size()
                  + 3 * placed_bytes(state.opt.master, ospecs, mesh,
                                     opt_stack)
                  + placed_bytes(batch, bspecs, mesh))
        with _flags(fsdp=False):
            tspecs = param_partition_specs(state.params, cfg, mesh)
            specs = zero1_specs(tspecs, state.opt.master, mesh, axes, cfg)
            zstate = shard_train_state(state, mesh, specs, cfg,
                                       param_specs=tspecs if tp else None)
        del state
        held_args = (zstate, local)

        def update(m):
            step = make_train_step(model, tcfg, mesh=m, grad_specs=specs,
                                   tensor_parallel=tp)
            f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,
                                        device=p.device)
            scalar = lambda: torch.empty((), dtype=torch.float32,
                                         device="meta")
            acc = [scalar(), {"lm_loss": scalar(), "aux_loss": scalar()},
                   tree_map(f32, zstate.params)]
            with _flags(fsdp=False):
                return step.update(zstate, acc)
    else:
        params = model.param_specs()
        pspecs = param_partition_specs(params, cfg, mesh)
        placed = (placed_bytes(params, pspecs, mesh, _fsdp_stack(cfg, mesh))
                  + placed_bytes(batch, bspecs, mesh))
        if tp:
            params = shard_params(params, tp_param_specs(model, mesh), mesh)
        if cache is not None:
            placed += placed_bytes(cache, cache_partition_specs(
                cache, cfg, mesh, axes), mesh)
            with _ctx(mesh, axes if split else (), tp):
                held_args = (params, model.init_cache(
                    rows, shape.seq_len, device=torch.device("meta")),
                    local)
        else:
            held_args = (params, local)
    del cache
    return {"placed": placed, "held": tree_bytes(held_args),
            "held_args": held_args, "update": update, "notes": notes,
            "split": split, "rows": rows, "axes": axes}


def trace_cell(cfg, shape, mesh, *, microbatches: int = 1) -> dict:
    """The port's record of one rank's step at ``shape`` on ``mesh`` (a
    ``ShapeMesh``) without the reference's identifying keys: placed and
    held bytes, memory, costs, collectives, kernels, notes, seconds.

    The layers' work is traced at two and three super-blocks (and
    encoder layers) and weighted by the config's counts (``_depth``;
    xlstm's also cut in the length, ``_along``): FLOPs, bytes,
    collectives and kernel launches add up exactly, and the peak of live
    bytes above the arguments grows by what each layer leaves live.  The
    rest of a train step, ``update`` (the ZeRO-1 collectives, AdamW, the
    gather), is traced whole, at full depth.  Where the port's tensor
    parallelism covers the arch and ``model`` holds several ranks, the
    rank holds its shards and runs tensor parallel (module docstring)."""
    t0 = time.time()
    tcfg = TrainConfig(microbatches=microbatches)
    a = cell_arguments(cfg, shape, mesh, tcfg)
    axes, split, rows, notes = a["axes"], a["split"], a["rows"], a["notes"]
    held, held_args, update = a["held"], a["held_args"], a["update"]
    placed = a["placed"]
    t_lower = time.time() - t0
    with _flags(fsdp=False):
        m = _model_phase(cfg, shape, mesh, axes, tcfg, split)
    peak = held + m["temp"]
    out_bytes, alias = m["out"], m["alias"]
    costs = m
    if update is not None:
        u = _traced(mesh, held_args, update)
        notes += u["notes"]
        costs = _combine([(1, m), (1, u)])
        peak = max(peak, u["peak_bytes"])
        out_bytes, alias = u["out"], u["alias"]
    notes += m["notes"]
    return {
        "lower_s": round(t_lower, 2),
        "compile_s": round(time.time() - t0 - t_lower, 2),
        "rows_per_rank": rows,
        "placed_argument_bytes": placed,
        "held_bytes": held,
        "memory": {
            "argument_bytes": held,
            "output_bytes": out_bytes,
            "temp_bytes": max(peak - held - out_bytes + alias, 0),
            "alias_bytes": alias,
            "peak_est_bytes": peak,
        },
        # the eager step has no loop body to fold: the raw figures are
        # the counted ones; transcendentals are not counted
        "cost_raw": {"flops": costs["flops"],
                     "bytes_accessed": costs["bytes"],
                     "transcendentals": None},
        "cost": {"flops": costs["flops"], "bytes_accessed": costs["bytes"],
                 "dot_bytes": costs["dot_bytes"]},
        "collectives": costs["collectives"],
        "kernels": costs["kernels"],
        "notes": notes,
    }


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               microbatches: int = 1, seq_shard: bool = False,
               extra_tags: str = ""):
    """Trace one (arch × shape × mesh) cell on meta tensors.  Returns a
    record dict (or a skip record)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    skip = cell_skip_reason(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    base = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "tags": extra_tags,
    }
    if skip:
        return {**base, "skipped": skip}
    if seq_shard:
        raise ValueError("seq_shard lays the reference's activations out "
                         "over the model axis; the port's tensor "
                         "parallelism keeps every activation replicated "
                         "over it, and its hand-written collectives "
                         "follow no activation layout (ROADMAP: the rest "
                         "of tensor parallelism)")
    mesh = make_production_mesh(multi_pod=multi_pod)
    return {**base, "n_chips": 512 if multi_pod else 256,
            **trace_cell(cfg, shape, mesh, microbatches=microbatches)}


def print_record(r):
    if "skipped" in r:
        print(f"[SKIP] {r['arch']} × {r['shape']} ({r['mesh']}): "
              f"{r['skipped']}")
        return
    m = r["memory"]
    c = r["cost"]
    coll_total = sum(v["bytes"] for v in r["collectives"].values())
    print(
        f"[ OK ] {r['arch']} × {r['shape']} ({r['mesh']}): "
        f"compile={r['compile_s']:.1f}s "
        f"args/dev={m['argument_bytes'] / 2**30:.2f}GiB "
        f"temp/dev={m['temp_bytes'] / 2**30:.2f}GiB "
        f"flops/dev={c['flops']:.3e} "
        f"coll/dev={coll_total / 2**30:.3f}GiB"
    )
    sys.stdout.flush()


def error_record(arch, shape, mesh_name, tags, exc) -> dict:
    return {"arch": arch, "shape": shape, "mesh": mesh_name, "tags": tags,
            "error": f"{type(exc).__name__}: {exc}",
            "traceback": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--fsdp", action="store_true",
                    help="perf flag: shard params over the data axis too "
                         "(placements only: the port's step does not)")
    ap.add_argument("--moe2d", action="store_true",
                    help="perf flag: 2D (C×f) MoE dispatch layout "
                         "(refused: the port lays out no activation over "
                         "the model axis)")
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="perf flag: group-local MoE dispatch (G groups)")
    ap.add_argument("--rglru-chunk", type=int, default=0,
                    help="perf flag: chunked RG-LRU scan")
    ap.add_argument("--rglru-block-gates", action="store_true",
                    help="perf flag: block-local RG-LRU gate matrices")
    ap.add_argument("--tags", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for flag, name in ((args.moe2d, "--moe2d"), (args.seq_shard,
                                                 "--seq-shard")):
        if flag:
            ap.error(f"{name} steers the reference's layout of activations "
                     "over the model axis; the port's tensor parallelism "
                     "keeps every activation replicated over it, and its "
                     "hand-written collectives follow no activation "
                     "layout (ROADMAP: the rest of tensor parallelism)")

    set_flags(fsdp=args.fsdp, moe_groups=args.moe_groups,
              rglru_chunk=args.rglru_chunk,
              rglru_block_gates=args.rglru_block_gates)
    if not args.tags:
        auto = []
        if args.fsdp:
            auto.append("fsdp")
        if args.moe_groups:
            auto.append(f"moeg{args.moe_groups}")
        if args.rglru_chunk:
            auto.append(f"rglru{args.rglru_chunk}")
        if args.rglru_block_gates:
            auto.append("blockgates")
        if args.microbatches > 1:
            auto.append(f"mb{args.microbatches}")
        args.tags = "+".join(auto)

    out_path = args.out or os.path.abspath(
        os.path.join(RESULTS, "dryrun.json"))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    existing = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            existing = {(r["arch"], r["shape"], r["mesh"], r.get("tags", "")):
                        r for r in json.load(f)}

    if args.all:
        cells = [(a, s.name) for a in list_archs() for s in ALL_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = list(existing.values())
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            if (arch, shape, mesh_name, args.tags) in existing:
                print(f"[CACHED] {arch} × {shape} ({mesh_name})")
                continue
            try:
                r = lower_cell(arch, shape, multi_pod=mp,
                               microbatches=args.microbatches,
                               extra_tags=args.tags)
            except Exception as e:  # record the failure: it's a bug to fix
                r = error_record(arch, shape, mesh_name, args.tags, e)
                print(f"[FAIL] {arch} × {shape} ({mesh_name}): "
                      f"{r['error'][:200]}")
                records.append(r)
                _write(out_path, records)
                continue
            print_record(r)
            records.append(r)
            _write(out_path, records)
    _write(out_path, records)


def _write(path, records):
    with open(path, "w") as f:
        json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
