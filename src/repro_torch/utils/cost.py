"""The dry run's cost count of one rank's step: the port's counterpart of
``repro/utils/hlo.py``.

The reference compiles each cell's step with XLA and reads the optimized
HLO text: dot FLOPs, bytes of the top-level instructions, collective
bytes by kind, with loop trip counts folded in (XLA's own
``cost_analysis`` counts a loop body once).  The port compiles nothing:
a step is eager PyTorch, its layers a Python loop, so there is no
program text to parse and no loop to fold.  Instead the dry run runs
the step itself on ``meta`` tensors (shapes and dtypes, no storage) at
one rank's shapes, and :class:`CostMode`, a ``TorchDispatchMode``, sees
every ATen operation it dispatches, the backward's and a checkpoint's
recomputation included.  It counts:

  * dot FLOPs, 2·out·K, of ``mm``, ``bmm``, ``addmm`` and ``baddbmm``
    (what ``matmul``, ``@`` and ``einsum`` lower to);
  * bytes accessed, the operand and output bytes of every operation
    (``hlo.py``'s model of top-level instructions, each operation here
    being one), views and allocations free; ``dot_bytes`` those of the
    dots alone;
  * peak live bytes: every storage from the operation that allocates it
    until it is collected, the tensors given to ``track`` (the step's
    arguments) live from the start;
  * kernel 8's launches that its wrapper's meta route stands in for
    (``kernels.common.record_meta_launch``), with their FLOPs and bytes,
    which also enter the totals (the kernel's QKᵀ and PV are dots);
  * the collectives of a ``launch.mesh.ShapeMesh``, by kind.

Elementwise FLOPs are not counted, as in ``hlo.py``.  The counts are a
reckoning from shapes, not a measurement.

Most ATen operations compute their meta outputs in Python (``torch._refs``
and ``torch._meta_registrations``), and that is where a trace spends its
time; a layer's host loops (the sLSTM's steps, the chunked scans) repeat
a few operations on the same shapes thousands of times.  So the mode
keeps each operation's output shapes and costs by its arguments' shapes
(``_MEMO``) and makes a repeated call's outputs directly, where the
operation writes nothing and returns fresh tensors (no alias in its
schema): the counts are those of the operation itself.
"""

from __future__ import annotations

import weakref
from functools import partial

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.common import meta_launch_recorder
from repro_torch.tree import tree_leaves

_aten = torch.ops.aten
# dot products: (the index of the left operand, its contraction axis -1)
_DOTS = {_aten.mm.default: 0, _aten.bmm.default: 0,
         _aten.addmm.default: 1, _aten.baddbmm.default: 1}
# allocations without data movement
_FREE = {_aten.empty.memory_format, _aten.empty_like.default,
         _aten.empty_strided.default, _aten.new_empty.default,
         _aten.new_empty_strided.default}


# what an operation's meta outputs may depend on besides its tensors
_ATOMS = {int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format}
_FRESH: dict = {}
# (operation, its arguments' keys) → its outputs' shapes and its costs:
# pure functions of the key, so shared by every trace of the process
_MEMO: dict = {}


def _fresh(func) -> bool:
    """Whether ``func`` writes none of its arguments and returns only new
    tensors (no alias in its schema)."""
    ok = _FRESH.get(func)
    if ok is None:
        schema = func._schema
        ok = _FRESH[func] = (
            not func.is_view and len(schema.returns) > 0
            and all(a.alias_info is None for a in schema.arguments)
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in schema.returns))
    return ok


def _key(x):
    """``x`` as a meta kernel sees it, hashable: a tensor by its shape,
    strides, offset and dtype, a scalar by its type and value.  Raises
    ``KeyError`` for what has no such key (a tensor off ``meta``, a
    generator)."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise KeyError(x.device)
        return (x.shape, x.stride(), x.storage_offset(), x.dtype)
    kind = type(x)
    if kind is tuple or kind is list:
        return tuple(map(_key, x))
    if kind in _ATOMS:
        return (kind, x)
    raise KeyError(kind)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs) -> list:
    """The tensors among ``xs`` and in its lists and tuples (an ATen
    operation's arguments and results)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _cost(func, args, ins, outs) -> tuple:
    """(dot FLOPs, bytes accessed, dot bytes) of one operation."""
    moved = sum(map(_nbytes, ins + outs))
    if func in _DOTS:
        k = args[_DOTS[func]].shape[-1]
        return 2.0 * outs[0].numel() * k, moved, moved
    if func.is_view or func in _FREE:
        return 0.0, 0, 0
    return 0.0, moved, 0


class CostMode(TorchDispatchMode):
    """Count the cost of the operations dispatched inside the block (the
    module docstring); ``costs()`` returns the counts."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.flops = 0.0
        self.bytes = 0.0
        self.dot_bytes = 0.0
        self.kernels: dict[str, dict] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, tuple] = {}
        self._recording = None

    def __enter__(self):
        self._recording = meta_launch_recorder(self._launch)
        self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._recording.__exit__(*exc)

    def _launch(self, name, flops, nbytes):
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        self.dot_bytes += nbytes

    def _free(self, key, _ref=None):
        n, _ = self._live.pop(key, (0, None))
        self.live_bytes -= n

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live from now."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        # the weak reference (its callback frees the count) lives as long
        # as the entry
        self._live[key] = (n, weakref.ref(st, partial(self._free, key)))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = None
        if _fresh(func):
            try:
                key = (func, _key(args),
                       _key(tuple(sorted(kwargs.items()))) if kwargs else ())
            except KeyError:
                key = None
        hit = _MEMO.get(key) if key is not None else None
        if hit is None:
            out = func(*args, **kwargs)
            outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
            cost = _cost(func, args, _tensors(args)
                         + _tensors(kwargs.values()), outs)
            if key is not None and all(t.is_meta and t.storage_offset() == 0
                                       for t in outs):
                _MEMO[key] = ([(t.shape, t.stride(), t.dtype) for t in outs],
                              cost)
        else:
            shapes, cost = hit
            outs = [torch.empty_strided(size, stride, dtype=dtype,
                                        device="meta")
                    for size, stride, dtype in shapes]
            out = outs[0] if len(outs) == 1 else tuple(outs)
        self.flops += cost[0]
        self.bytes += cost[1]
        self.dot_bytes += cost[2]
        for t in outs:
            self._hold(t)
        return out

    def costs(self) -> dict:
        """``module_costs``' keys (``flops``, ``bytes``, ``dot_bytes``,
        ``collectives``: per kind {"bytes", "count"}, from the mesh),
        and ``peak_bytes`` and ``kernels`` (per kernel name its stood-in
        launches, FLOPs and bytes)."""
        coll = getattr(self.mesh, "collectives", None) or {}
        return {"flops": self.flops, "bytes": self.bytes,
                "dot_bytes": self.dot_bytes,
                "collectives": {k: dict(v) for k, v in coll.items()},
                "peak_bytes": self.peak_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}
