"""Process meshes on ``torch.distributed``, and a launcher of local ranks.

Ports ``repro/launch/mesh.py``.  The JAX reference lays its sharded
runtime over a device mesh and runs one ``shard_map`` program on it; the
port runs one process per rank, SPMD: every rank calls the same entry
point with the same objective and key, and the collectives of an axis run
on that axis's process group.

The reference's ``make_production_mesh`` builds a real 16×16 (or
2×16×16) mesh over forced host devices for its dry run; the port cannot
start 256 ranks, so its production mesh is a :class:`ShapeMesh`: the
axes and sizes seen from the first rank, no process group, and every
collective an operation on ``meta`` tensors that returns the right shape
and records its bytes (``launch/dryrun.py``).

A :class:`Mesh` names its axes and their sizes (``mesh.shape`` is the
mapping the registry validates), and holds, for this rank, one process
group per axis — the ranks that share every other coordinate — with this
rank's coordinate on each axis and its device.  Every rank builds every
group, in the same order, which ``torch.distributed.new_group`` demands:
a rank that skipped one would hang the others.  The ranks are laid out
row-major over the axes, so the last axis (``model``) varies fastest.

:func:`spawn_ranks` is the port's counterpart of the reference's forced
host devices: it starts W local ranks (``spawn``, a ``file://``
rendezvous in a temporary directory, a timeout on every collective),
runs one function on each and joins them within a time limit.  The CPU
runs gloo; on the card world 1 runs NCCL and a larger world gloo, whose
collectives take CUDA tensors (staged through host memory) while every
kernel still runs on the card.  NCCL refuses two ranks on one GPU.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch

# Canonical axis names.
POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"

# The device the launcher gave this rank (None outside a launch).
_RANK_DEVICE: torch.device | None = None
_MESHES: dict = {}


def _dist():
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a Mesh needs an initialized torch.distributed process group; "
            "start the ranks with repro_torch.launch.mesh.spawn_ranks")
    return dist


class Mesh:
    """Named axes over the ranks of the process group (or a subset).

    ``ranks`` (default: every rank of the world) are laid out row-major
    over ``shape``.  Every rank of the world must construct the mesh,
    members or not (``member`` is False outside ``ranks``).  ``device``
    defaults to the one the launcher gave this rank, else the card.
    """

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 ranks: Sequence[int] | None = None, device=None):
        dist = _dist()
        shape = tuple(int(s) for s in shape)
        axes = tuple(str(a) for a in axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             "match")
        world, me = dist.get_world_size(), dist.get_rank()
        members = list(range(world)) if ranks is None else [int(r)
                                                            for r in ranks]
        if int(np.prod(shape)) != len(members):
            raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))}"
                             f" ranks, got {len(members)}")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.ranks = tuple(members)
        self.member = me in members
        self.rank = me
        self.coords: dict[str, int] = {}
        self._groups: dict[str, tuple] = {}
        grid = np.asarray(members).reshape(shape)
        # One group per axis, and one over the batch axes together (every
        # axis but ``model``) where there are several: the data-parallel
        # group of the trainer, ranked row-major over those axes.
        batch = tuple(a for a in axes if a != MODEL_AXIS)
        spans = [(axis,) for axis in axes]
        if len(batch) > 1:
            spans.append(batch)
        for span in spans:
            dims = [axes.index(a) for a in span]
            rest = [i for i in range(len(axes)) if i not in dims]
            width = int(np.prod([shape[i] for i in dims]))
            lines = np.transpose(grid, rest + dims).reshape(-1, width)
            key = span[0] if len(span) == 1 else span
            for line in lines:
                line = [int(r) for r in line]
                group = dist.new_group(line)
                if me in line:
                    self._groups[key] = (group, line)
                    self.coords[key] = line.index(me)
        if device is None:
            device = _RANK_DEVICE if _RANK_DEVICE is not None else "cuda"
        self.device = torch.device(device)

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")

    # -- axes -------------------------------------------------------------
    # ``axis`` is an axis name, None, or a tuple of names: the batch axes
    # (every axis but ``model``) taken together, ranked row-major.
    def _key(self, axis):
        """The group key of ``axis`` (a name or the batch axes' tuple),
        or None where it spans no axis of the mesh."""
        if isinstance(axis, tuple):
            present = tuple(a for a in axis if a in self.shape)
            if len(present) > 1:
                if present not in self._groups and self.member:
                    raise ValueError(f"axes {present} have no group: only "
                                     "the batch axes (every axis but "
                                     "'model') are grouped together")
                return present
            axis = present[0] if present else None
        return axis if axis and axis in self.shape else None

    def size(self, axis) -> int:
        """Size of ``axis`` (a product for a tuple); 1 for ``None`` or an
        axis the mesh lacks."""
        if isinstance(axis, tuple):
            return int(np.prod([self.shape.get(a, 1) for a in axis]))
        return int(self.shape.get(axis, 1)) if axis else 1

    def index(self, axis) -> int:
        """This rank's coordinate on ``axis`` (0 for ``None``)."""
        key = self._key(axis)
        if key is None:
            return 0
        self._check_member()
        return self.coords[key]

    def group(self, axis):
        """(process group, its ranks in coordinate order) of ``axis``."""
        self._check_member()
        return self._groups[self._key(axis)]

    def _check_member(self):
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is not in this mesh "
                               f"(ranks {self.ranks})")

    def barrier(self) -> None:
        """Return once every member has entered: one reduction per axis,
        in order, so each rank has heard, transitively, from all."""
        token = torch.zeros((1,), device=self.device)
        for axis in self.axis_names:
            self.psum(token, axis)

    @property
    def is_writer(self) -> bool:
        """True on the one member that writes the mesh's files."""
        return self.rank == self.ranks[0]

    # -- collectives over one axis (identity for None or a missing axis) --
    def psum(self, x: torch.Tensor, axis: str | None) -> torch.Tensor:
        """Sum over ``axis``; every member gets the same bits."""
        return self._all_reduce(x, axis, "sum")

    def pmax(self, x: torch.Tensor, axis: str | None) -> torch.Tensor:
        return self._all_reduce(x, axis, "max")

    def pmean(self, x: torch.Tensor, axis: str | None) -> torch.Tensor:
        return self.psum(x, axis) / self.size(axis)

    def _all_reduce(self, x, axis, op):
        if self._key(axis) is None:
            return x
        import torch.distributed as dist

        group, _ = self.group(axis)
        is_bool = x.dtype == torch.bool
        y = (x.to(torch.int32) if is_bool else x).clone().contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)
        return y > 0 if is_bool else y

    def all_gather(self, x: torch.Tensor, axis: str | None) -> torch.Tensor:
        """(P, *x.shape): every member's ``x`` in coordinate order."""
        if self._key(axis) is None:
            return x[None]
        import torch.distributed as dist

        group, line = self.group(axis)
        is_bool = x.dtype == torch.bool
        y = (x.to(torch.uint8) if is_bool else x).contiguous()
        out = [torch.empty_like(y) for _ in line]
        dist.all_gather(out, y, group=group)
        out = torch.stack(out)
        return out.bool() if is_bool else out

    def broadcast(self, x: torch.Tensor, axis: str | None,
                  src: int) -> torch.Tensor:
        """The ``x`` of the member at coordinate ``src`` on ``axis``."""
        if self._key(axis) is None:
            return x
        import torch.distributed as dist

        group, line = self.group(axis)
        is_bool = x.dtype == torch.bool
        y = (x.to(torch.uint8) if is_bool else x).clone().contiguous()
        dist.broadcast(y, src=line[int(src)], group=group)
        return y.bool() if is_bool else y

    def psum_scatter(self, x: torch.Tensor,
                     axis: str | None) -> torch.Tensor:
        """The sum over ``axis`` of ``x`` (first dimension P·n for the P
        members), cut into P blocks of n rows: this member's block, at
        its coordinate.  NCCL runs a reduce-scatter; gloo has none, so
        there it is an all-reduce and then a slice (the same sums)."""
        if self._key(axis) is None:
            return x
        import torch.distributed as dist

        group, line = self.group(axis)
        p = len(line)
        if x.shape[0] % p:
            raise ValueError(f"psum_scatter: {x.shape[0]} rows do not "
                             f"split over {p} members")
        n = x.shape[0] // p
        x = x.contiguous()
        if dist.get_backend(group) == "nccl":
            out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out, x, group=group)
            return out
        y = x.clone()
        dist.all_reduce(y, group=group)
        i = line.index(self.rank)
        return y[i * n:(i + 1) * n].clone()


def collective_bytes(kind: str, x: torch.Tensor, size: int) -> int:
    """Bytes one member's collective of ``kind`` over ``size`` members
    outputs for an input ``x`` (the reference's count in
    ``utils/hlo.py``: a collective's output bytes): an all-reduce or a
    broadcast its input's, an all-gather ``size`` times that, a
    reduce-scatter a ``size``-th of it."""
    n = x.numel() * x.element_size()
    if kind == "all-gather":
        return n * size
    if kind == "reduce-scatter":
        return n // size
    return n


class ShapeMesh(Mesh):
    """A mesh of shapes alone: ``shape`` over ``axes`` seen from its first
    rank (coordinate 0 on every axis), with no process group.

    Its collectives take and return ``meta`` tensors of the right shapes
    (an all-gather's (P, …), a reduce-scatter's block) and record, per
    kind under the reference's names (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, and ``broadcast``, which the reference's programs
    have no use for), the count and the bytes of ``collective_bytes``
    in ``collectives``; an axis of one member moves nothing and records
    nothing.  ``notes`` collects what a caller could not do on it (the
    train step's first-call state check compares no checksums here)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        axes = tuple(str(a) for a in axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             "match")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.ranks = tuple(range(int(np.prod(shape))))
        self.member = True
        self.rank = 0
        self.coords = {a: 0 for a in axes}
        self._groups = {}
        self.device = torch.device("meta")
        self.collectives: dict[str, dict] = {}
        self.notes: list[str] = []

    def __repr__(self):
        return f"ShapeMesh({self.shape})"

    def index(self, axis) -> int:
        return 0

    def group(self, axis):
        raise RuntimeError("a ShapeMesh has no process groups")

    def _record(self, kind, x, axis) -> bool:
        """Record a collective of ``kind`` on ``x`` over ``axis``; False
        where the axis has one member (nothing moves)."""
        if x.device.type != "meta":
            raise ValueError(f"a ShapeMesh's collectives take meta "
                             f"tensors, got one on {x.device}")
        size = self.size(axis)
        if size == 1:
            return False
        slot = self.collectives.setdefault(kind, {"bytes": 0, "count": 0})
        slot["bytes"] += collective_bytes(kind, x, size)
        slot["count"] += 1
        return True

    def _all_reduce(self, x, axis, op):
        if not self._record("all-reduce", x, axis):
            return x
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def all_gather(self, x: torch.Tensor, axis: str | None) -> torch.Tensor:
        if not self._record("all-gather", x, axis):
            return x[None]
        return torch.empty((self.size(axis),) + tuple(x.shape),
                           dtype=x.dtype, device=x.device)

    def broadcast(self, x: torch.Tensor, axis: str | None,
                  src: int) -> torch.Tensor:
        if not self._record("broadcast", x, axis):
            return x
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def psum_scatter(self, x: torch.Tensor,
                     axis: str | None) -> torch.Tensor:
        p = self.size(axis)
        if x.shape[0] % p:
            raise ValueError(f"psum_scatter: {x.shape[0]} rows do not "
                             f"split over {p} members")
        if not self._record("reduce-scatter", x, axis):
            return x
        return torch.empty((x.shape[0] // p,) + tuple(x.shape[1:]),
                           dtype=x.dtype, device=x.device)


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The reference's production mesh as a :class:`ShapeMesh`: 16×16
    (data, model), or 2×16×16 (pod, data, model)."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), (POD_AXIS, DATA_AXIS, MODEL_AXIS))
    return ShapeMesh((16, 16), (DATA_AXIS, MODEL_AXIS))


def make_mesh(shape, axes, *, ranks=None, device=None) -> Mesh:
    """The mesh of ``shape`` over ``axes`` (cached per process: every
    rank asks for the same meshes in the same order)."""
    key = (tuple(int(s) for s in shape), tuple(axes),
           None if ranks is None else tuple(int(r) for r in ranks),
           None if device is None else str(torch.device(device)))
    if key not in _MESHES:
        _MESHES[key] = Mesh(shape, axes, ranks=ranks, device=device)
    return _MESHES[key]


def _square_factor(n: int) -> int:
    """The largest factor of ``n`` at most √n."""
    for cand in range(int(n ** 0.5), 0, -1):
        if n % cand == 0:
            return cand
    return 1


def make_lattice_mesh(pod: int, axes=(POD_AXIS, DATA_AXIS, MODEL_AXIS), *,
                      device=None) -> Mesh:
    """(pod, data, model) mesh for the OPT-guess lattice runtime: the
    world's ranks over ``pod`` slices, the rest of each slice factored
    data-major over the trailing two axes (8 ranks with pod 2 give
    (2, 2, 2))."""
    n = _dist().get_world_size()
    if n % pod:
        raise ValueError(f"{n} ranks not divisible by pod={pod}")
    rest = n // pod
    d = _square_factor(rest)
    return make_mesh((pod, rest // d, d), axes, device=device)


def make_host_mesh(max_devices: int | None = None, axes=(DATA_AXIS,
                                                          MODEL_AXIS), *,
                   device=None) -> Mesh:
    """Best-effort mesh over the world's ranks (at most ``max_devices``),
    factored data-major."""
    n = _dist().get_world_size()
    if max_devices:
        n = min(n, max_devices)
    ranks = list(range(n))
    if len(axes) == 2:
        d = _square_factor(n)
        return make_mesh((n // d, d), axes, ranks=ranks, device=device)
    return make_mesh((n,), axes[:1], ranks=ranks, device=device)


def mesh_num_devices(mesh: Mesh) -> int:
    return int(np.prod(list(mesh.shape.values())))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def to_numpy(tree):
    """``tree`` with every tensor leaf copied to a numpy array (NamedTuples,
    tuples, lists and dicts rebuilt) — what a rank sends its parent."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree


def _rank_main(rank, world, init, backend, device, timeout_s, fn, args,
               results):
    global _RANK_DEVICE
    try:
        import torch.distributed as dist

        dev = torch.device(device)
        if dev.type == "cuda":
            # A spawned process does not inherit these (ROADMAP "Numerics").
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            # Ranks share the host's cores: one intra-op thread each.
            torch.set_num_threads(1)
        _RANK_DEVICE = dev
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = to_numpy(fn(*args))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            results.put((rank, True, out))
        finally:
            _MESHES.clear()
            dist.destroy_process_group()
    except BaseException:        # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable, world: int, args: tuple = (), *,
                device="cpu", timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world`` fresh local ranks; returns the
    ranks' results (tensors as numpy arrays) in rank order.

    ``fn`` must be importable by name (a module-level function), as must
    everything in ``args``.  Each rank initializes the process group —
    gloo on the CPU; on the card NCCL at world 1 and gloo above it (NCCL
    refuses two ranks on one GPU) — with ``timeout_s`` on every
    collective, so a rank left waiting on a collective that another rank
    skipped fails instead of hanging.  A rank that raises fails the
    launch with its traceback; the launch as a whole also fails after
    ``timeout_s``, and the ranks still running are killed.  A CPU rank
    runs one intra-op thread.
    """
    world = int(world)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn_ranks(device='cuda'): no CUDA device")
    backend = "nccl" if dev.type == "cuda" and world == 1 else "gloo"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got: dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_main,
            args=(r, world, init, backend, str(dev), float(timeout_s), fn,
                  tuple(args), results))
            for r in range(world)]
        deadline = time.monotonic() + float(timeout_s)
        try:
            for p in procs:
                p.start()
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn_ranks: {world - len(got)} of {world} ranks "
                        f"gave no result within {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(
                            f"spawn_ranks: rank {dead[0]} died with exit "
                            f"code {procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn_ranks: rank {rank} of "
                                       f"{world} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.pid is None:          # never started (args unpicklable)
                    continue
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [got[r] for r in range(world)]


__all__ = [
    "POD_AXIS", "DATA_AXIS", "MODEL_AXIS", "Mesh", "ShapeMesh",
    "collective_bytes", "make_mesh", "make_lattice_mesh", "make_host_mesh",
    "make_production_mesh", "mesh_num_devices", "spawn_ranks", "to_numpy",
]
