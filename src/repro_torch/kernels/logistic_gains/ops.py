"""Wrapper of the 1-D-Newton logistic singleton-gain kernel.

On a CUDA tensor ``logistic_gains`` launches the hand-written kernel of
``csrc/logistic_gains.cu`` (it raises on what the kernel cannot take and
on a failed launch); on a CPU tensor it runs the plain version of
``ref.py``.  There is no size threshold above which the plain version
takes over.  ``logistic_gains.launches`` counts wrapper calls that
launch: one device kernel per call.  The kernel template also serves
the logistic filter engine (``filter_gains.logistic_filter_gains``),
through ``launch`` at ``ENGINE_STATES_PER_PASS`` states per pass.
``cluster_plan`` is the geometry a launch uses (clusters of CTAs over
d, panel width, slab rows, tail, states per pass), ``wide_copies`` its
choice of copy width, and ``kernel_info`` describes the kernel at a
plan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_tensor,
    quantize,
    resolve_precision,
    sm_count,
    stream_dtype,
    use_kernel,
)
from repro_torch.kernels.logistic_gains.ref import logistic_gains_ref

# The kernel's geometry (csrc/logistic_gains.cu): 256 threads, each owning
# 4 adjacent columns of a panel of BN columns for L states at a time;
# clusters of at most 8 CTAs (the portable size) split the panel's rows.
WIDTHS = (32, 16, 8, 4)          # panel widths BN, widest first
MAX_CLUSTER = 8
LABEL_BYTES = 8                  # per slab row: a, s in f32
STATE_BYTES = 8                  # per slab row and state: η, ℓ_i(η) in f32
# States per pass of the filter engine's instance (csrc: ENGINE_L); the
# singleton sweep runs L = 1.  No other instance is built.
ENGINE_STATES_PER_PASS = 4
STATES_PER_PASS = (1, ENGINE_STATES_PER_PASS)
# Dynamic shared memory a CTA may take when k CTAs share an SM's 233,472
# bytes, less 1 KB reserved for each (one CTA may opt in to 227 KB).
SMEM_PER_CTA = {2: 233_472 // 2 - 1024, 1: 232_448}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
             _P]
# logistic_gains_kernel_info's out[5], in order (csrc: describe).
_INFO_KEYS = ("registers", "spill_bytes", "smem_bytes", "threads",
              "active_clusters")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ClusterPlan(NamedTuple):
    """A launch's geometry: clusters of ``cluster`` CTAs over each panel
    of ``bn`` columns; CTA c holds rows [c·rows, (c+1)·rows) of the panel
    in shared memory (its slab) and reads tail rows [cluster·rows +
    c·tail_per_cta, … + tail_per_cta) from global memory in every pass,
    for ``states_per_pass`` states at a time."""

    cluster: int
    rows: int
    bn: int
    smem_bytes: int     # dynamic shared memory per CTA
    ctas: int           # the grid: ⌈n / bn⌉ · cluster
    ctas_per_sm: int    # 2 or 1, as the shared memory allows
    tail_rows: int      # rows of d not held on chip
    tail_per_cta: int
    states_per_pass: int


def scratch_bytes(bn: int, states_per_pass: int = 1) -> int:
    """The reduction scratch: 11 rows (8 warps, 2 cluster buffers, the
    totals) of 2·4 f32 sums per state and column group, at least the
    widest panel's at one state (csrc: red_floats)."""
    return 4 * 11 * 8 * max(bn // 4 * states_per_pass, 8)


def smem_bytes(rows: int, bn: int, elem: int,
               states_per_pass: int = 1) -> int:
    """A CTA's dynamic shared memory: the slab (16-byte aligned), the
    state records and the label of each slab row, the reduction scratch
    (csrc: smem_bytes)."""
    return (_cdiv(rows * bn * elem, 16) * 16
            + (STATE_BYTES * states_per_pass + LABEL_BYTES) * rows
            + scratch_bytes(bn, states_per_pass))


@functools.lru_cache(maxsize=None)
def cluster_plan(g: int, d: int, n: int, dtype: torch.dtype, sms: int,
                 states_per_pass: int = 1) -> ClusterPlan:
    """The cluster geometry for X (d, n) in ``dtype`` on a card of ``sms``
    SMs, for the kernel instance that sweeps ``states_per_pass`` states
    per pass (1: the singleton sweep; ``ENGINE_STATES_PER_PASS``: the
    filter engine; no other instance is built, so any other L raises).
    Every CTA loops over the G lanes (or states) with its
    slab, so G does not change the geometry.

    The widest panel whose slab holds all d rows in the smallest cluster
    that can (1, 2, 4 or 8 CTAs) at two CTAs per SM, else at one: a
    wider panel shares each barrier and row record among more columns,
    and a second CTA per SM works while the first waits.  The cluster is
    then widened (up to 8) while the grid stays within one wave of CTA
    slots and every CTA keeps a row, so a short panel count still spreads
    over the card.  Past the largest capacity (BN = 4, 8 CTAs, one per
    SM, as many rows as fit) the rest of d is the tail, split over the
    cluster."""
    L = states_per_pass
    if g < 1 or d < 1 or n < 1 or L not in STATES_PER_PASS:
        raise ValueError(f"cluster_plan: G={g}, d={d}, n={n}, "
                         f"states_per_pass={L} (instances: "
                         f"{STATES_PER_PASS})")
    elem = torch.empty((), dtype=dtype).element_size()
    for per_sm, budget in SMEM_PER_CTA.items():
        for bn in WIDTHS:
            for c in (1, 2, 4, 8):
                if smem_bytes(_cdiv(d, c), bn, elem, L) > budget:
                    continue
                panels = _cdiv(n, bn)
                while (c < MAX_CLUSTER and panels * 2 * c <= per_sm * sms
                       and _cdiv(d, 2 * c) * (2 * c - 1) < d):
                    c *= 2
                rows = _cdiv(d, c)
                return ClusterPlan(c, rows, bn,
                                   smem_bytes(rows, bn, elem, L),
                                   panels * c, per_sm, 0, 0, L)
    bn, c = WIDTHS[-1], MAX_CLUSTER
    rows = ((SMEM_PER_CTA[1] - scratch_bytes(bn, L) - 16)
            // (bn * elem + STATE_BYTES * L + LABEL_BYTES))
    tail = d - c * rows
    return ClusterPlan(c, rows, bn, smem_bytes(rows, bn, elem, L),
                       _cdiv(n, bn) * c, 1, tail, _cdiv(tail, c), L)


def wide_copies(X: torch.Tensor, bn: int) -> bool:
    """Whether the kernel stages X (d, n) by 16-byte copies: every row of
    X starts on 16 bytes and a panel row is at least 16 bytes.  Otherwise
    it copies one element at a time."""
    e = X.element_size()
    return (X.data_ptr() % 16 == 0 and (X.shape[-1] * e) % 16 == 0
            and bn * e >= 16)


def _library():
    lib = _build.load("logistic_gains")
    fn = lib.logistic_gains_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def kernel_info(dtype, plan: ClusterPlan) -> dict:
    """Registers, spill bytes, shared memory per CTA, threads per CTA and
    the clusters the card holds at once, for the kernel instance that a
    launch at ``plan`` runs for X in ``dtype`` (needs the card: it asks
    the CUDA runtime)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"logistic_gains: no kernel for {dtype}")
    fn = _build.load("logistic_gains").logistic_gains_kernel_info
    fn.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = ctypes.c_int
    out = (_I * len(_INFO_KEYS))()
    _build.check(fn(int(dtype == torch.bfloat16), plan.bn,
                    plan.states_per_pass, plan.cluster, plan.rows, out),
                 "logistic_gains_kernel_info")
    return dict(zip(_INFO_KEYS, out))


def log1p_check() -> int:
    """The floats a in [0, 1] where the kernels' branch-free log1pf and
    the CUDA math library's log1pf differ in a bit: all 1,065,353,217 are
    tried on the card (0 expected)."""
    fn = _build.load("logistic_gains").logistic_log1p_check
    fn.argtypes, fn.restype = [_P, _P], ctypes.c_int
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    _build.check(fn(bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
                 "logistic_log1p_check")
    return int(bad)


def check_steps(steps) -> int:
    """Newton steps as a non-negative int, or raise."""
    if int(steps) != steps or steps < 0:
        raise ValueError(f"steps={steps!r}: expected an int ≥ 0")
    return int(steps)


def launch(X, y, eta, steps: int, states_per_pass: int, what: str):
    """One launch of the kernel instance that sweeps ``states_per_pass``
    states per pass: X (d, n) f32 or bf16, y (d,) and eta (S, d) f32, all
    contiguous on the card; returns the (S, n) f32 gains.  Raises on what
    the kernel cannot take and on a failed launch (``what`` names the
    wrapper); counts nothing (the wrappers count their own launches)."""
    d, n = X.shape
    s = eta.shape[0]
    dev = X.device
    check_tensor("X", X, (d, n), (torch.float32, torch.bfloat16), dev)
    check_tensor("y", y, (d,), (torch.float32,), dev)
    check_tensor("eta", eta, (s, d), (torch.float32,), dev)
    if s < 1 or d < 1 or n < 1:
        raise ValueError(f"{what}: unsupported shape S={s}, d={d}, n={n}")
    plan = cluster_plan(s, d, n, X.dtype, sm_count(dev), states_per_pass)
    out = torch.empty((s, n), dtype=torch.float32, device=dev)
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(),
                  eta.data_ptr(), d, n, s, steps, plan.cluster, plan.rows,
                  plan.bn, plan.states_per_pass, plan.tail_per_cta,
                  int(wide_copies(X, plan.bn)), out.data_ptr(), stream)
    _build.check(code, what)
    return out


def logistic_gains(X, y, eta, *, steps: int = 3,
                   precision: str | None = None):
    """Batched 1-D-Newton logistic gains: the CUDA kernel on the card,
    the plain version on the CPU.

    X: (d, n) candidate columns; y: (d,) labels; eta: (d,) logits or,
    with a leading lane axis, (G, d).  Returns (n,) or (G, n) f32 gains
    after ``steps`` Newton iterations.  ``precision="bf16"`` streams X
    in bf16; the recurrence, y and η stay f32 (the plain version
    quantizes X identically).
    """
    prec = resolve_precision(precision)
    steps = check_steps(steps)
    lanes = eta.dim() == 2
    E = eta if lanes else eta.unsqueeze(0)
    if use_kernel(X):
        out = launch(X.to(stream_dtype(prec)), y, E, steps, 1,
                     "logistic_gains")
        logistic_gains.launches += 1
    else:
        Xq = quantize(X, prec)
        out = torch.stack([logistic_gains_ref(Xq, y, e, steps=steps)
                           for e in E])
    return out if lanes else out[0]


logistic_gains.launches = 0
