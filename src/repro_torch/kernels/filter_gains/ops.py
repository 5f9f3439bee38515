"""Wrappers of the sample-batched filter-engine kernels.

On a CUDA tensor ``filter_gains`` (regression epilogue,
``csrc/filter_gains.cu``: the regression singleton sweep's split-d
partial kernel over one stacked basis of the G guess bases and the G·m
perturbed states, then a fixed-order epilogue), ``aopt_filter_gains``
(A-optimality Woodbury epilogue, ``csrc/aopt_filter_gains.cu``: one
launch over the G·m states after a copy that packs their factors) and
``logistic_filter_gains`` (logistic Newton-sweep epilogue: one launch
of ``csrc/logistic_gains.cu``'s kernel template over the G·m states,
several states per pass, the old
log-likelihood terms made in the same launch) run their engine on the
current stream, and raise on what the kernel cannot take and on a failed
launch.  On a CPU tensor they run the plain lattice versions of
``ref.py``.  The guess axis is always explicit: the port carries the
DASH lattice as a leading lane axis instead of batching a kernel under
``vmap``.  ``filter_gains.launches``, ``aopt_filter_gains.launches`` and
``logistic_filter_gains.launches`` count wrapper calls that launch an
engine: two hand-written device kernels per call for ``filter_gains``
(after the copies that pack its basis), one for ``aopt_filter_gains``
(after the copy that packs its factors) and ``logistic_filter_gains``.  ``StackPlan``, ``pack_basis`` and
``engine_plan`` are the regression engine's layout and split of d;
``AoptPlan``, ``aopt_plan`` and ``pack_factors`` the A-optimality
engine's column layout.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

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
from repro_torch.kernels.filter_gains.ref import (
    SPAN_TOL,
    aopt_filter_gains_lattice_ref,
    filter_gains_lattice_ref,
    logistic_filter_gains_lattice_ref,
)
from repro_torch.kernels.logistic_gains.ops import (
    ENGINE_STATES_PER_PASS,
    check_steps,
    launch as logistic_launch,
)
from repro_torch.kernels.marginal_gains.ops import (
    BASIS_TILE,
    BLOCK_COLS,
    CTAS_PER_SM,
    STAGE_ROWS,
    partial_kernel_info,
    split_plan,
    wide_copies,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P,
             ctypes.c_float, _I, _I, _P, ctypes.c_longlong, _P]


@dataclass(frozen=True)
class StackPlan:
    """Column layout of the regression engine's stacked basis (d, kp):
    the k base vectors of each guess g < G, then for each state
    s = g·m + i its b delta vectors and its residual r_s, then zero
    columns up to kp, a multiple of BASIS_TILE (at least one tile)."""

    g: int
    m: int
    k: int
    b: int

    @property
    def width(self) -> int:
        """Stacked vectors before the padding: G·k + G·m·(b+1)."""
        return self.g * self.k + self.g * self.m * (self.b + 1)

    @property
    def kp(self) -> int:
        return BASIS_TILE * max(1, -(-self.width // BASIS_TILE))

    def base_cols(self, g: int) -> range:
        """Columns of guess g's base vectors Q_g."""
        return range(g * self.k, (g + 1) * self.k)

    def state_cols(self, s: int) -> range:
        """Columns of state s's deltas D_s; its residual follows them."""
        lo = self.g * self.k + s * (self.b + 1)
        return range(lo, lo + self.b)

    def resid_col(self, s: int) -> int:
        return self.g * self.k + s * (self.b + 1) + self.b


def pack_basis(Q, D, R, plan: StackPlan) -> torch.Tensor:
    """The stacked basis (d, kp) f32 of ``plan`` from Q (G, d, k), D (G, m,
    d, b) and R (G, m, d), on their device: a few copies."""
    g, d, k = Q.shape
    gm, b = plan.g * plan.m, plan.b
    B = torch.empty((d, plan.kp), dtype=torch.float32, device=Q.device)
    B[:, :g * k].view(d, g, k).copy_(Q.permute(1, 0, 2))
    states = B[:, g * k:plan.width].view(d, gm, b + 1)
    states[:, :, :b].copy_(D.reshape(gm, d, b).permute(1, 0, 2))
    states[:, :, b].copy_(R.reshape(gm, d).t())
    B[:, plan.width:].zero_()
    return B


@functools.lru_cache(maxsize=None)
def engine_plan(g: int, m: int, d: int, n: int, k: int, b: int,
                sms: int) -> tuple[StackPlan, int, int]:
    """(stack plan, S, rows per slice): the partial kernel runs one lane
    of kp basis vectors over S contiguous slices of d.

    S starts from the regression sweep's split (``split_plan``: one wave
    of CTA slots, S = 1 once the basis tiles and column panels fill it)
    and takes up to 3 more slices where that shortens the waves: a grid
    of c CTAs per slice on w slots takes about ⌈S·c/w⌉ / S of one
    unsplit CTA's time.  At the regression lattice on the H100 (704 CTAs
    per slice, 264 slots) S = 3 fills its last wave."""
    plan = StackPlan(g, m, k, b)
    s, rows = split_plan(1, d, n, plan.kp, sms)
    ctas = plan.kp // BASIS_TILE * -(-n // BLOCK_COLS)
    slots = CTAS_PER_SM * sms
    stages = -(-d // STAGE_ROWS)
    waves = -(-s * ctas // slots)
    for more in range(s + 1, min(s + 3, stages) + 1):
        r = -(-stages // more) * STAGE_ROWS
        t = -(-d // r)                     # slices that hold rows
        w = -(-t * ctas // slots)
        if w * s < waves * t:              # w / t < waves / s
            s, rows, waves = t, r, w
    return plan, s, rows


def workspace_elems(plan: StackPlan, n: int, s: int) -> int:
    """f32 elements of the (S, kp, np) partial workspace."""
    return s * plan.kp * BLOCK_COLS * -(-n // BLOCK_COLS)


def _library():
    lib = _build.load("filter_gains")
    fn = lib.filter_gains_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def kernel_info(dtype) -> dict:
    """The partial kernel that ``filter_gains`` launches for X in
    ``dtype``: registers, spill bytes, shared memory, threads and CTAs per
    SM (needs the card)."""
    return partial_kernel_info("filter_gains", "filter_gains_kernel_info",
                               dtype)


def _launch(X, Q, D, R, col_sq, span_tol):
    d, n = X.shape
    g, _, k = Q.shape
    m, b = D.shape[1], D.shape[3]
    dev = X.device
    check_tensor("X", X, (d, n), (torch.float32, torch.bfloat16), dev)
    check_tensor("Q", Q, (g, d, k), (torch.float32,), dev)
    check_tensor("D", D, (g, m, d, b), (torch.float32,), dev)
    check_tensor("R", R, (g, m, d), (torch.float32,), dev)
    check_tensor("col_sq", col_sq, (n,), (torch.float32,), dev)
    if g < 1 or m < 1 or n < 1:
        raise ValueError(
            f"filter_gains: unsupported shape G={g}, m={m}, n={n}")
    plan, s, rows = engine_plan(g, m, d, n, k, b, sm_count(dev))
    basis = pack_basis(Q, D, R, plan)
    elems = workspace_elems(plan, n, s)
    ws = torch.empty(elems, dtype=torch.float32, device=dev)
    out = torch.empty((g, m, n), dtype=torch.float32, device=dev)
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(X.data_ptr(), int(X.dtype == torch.bfloat16),
                  int(wide_copies(X, basis)), d, n, basis.data_ptr(),
                  plan.kp, g, m, k, b, col_sq.data_ptr(), out.data_ptr(),
                  float(span_tol), s, rows, ws.data_ptr(), elems, stream)
    _build.check(code, "filter_gains")
    filter_gains.launches += 1
    return out


def filter_gains(X, Q, D, R, col_sq, *, precision: str | None = None,
                 span_tol: float = SPAN_TOL):
    """Sample-batched regression filter gains for the whole guess lattice.

    X: (d, n) in f32 or already in the stream dtype; Q: (G, d, k)
    per-guess bases; D: (G, m, d, b) per-sample orthonormal deltas (⊥ Q);
    R: (G, m, d) per-sample residuals; col_sq: (n,).  Returns (G, m, n)
    unnormalized gains.  ``precision="bf16"`` streams X in bf16 with f32
    accumulation (the plain version quantizes X identically).
    """
    prec = resolve_precision(precision)
    if use_kernel(X):
        return _launch(X.to(stream_dtype(prec)), Q, D, R, col_sq, span_tol)
    return filter_gains_lattice_ref(quantize(X, prec), Q, D, R, col_sq,
                                    span_tol=span_tol)


filter_gains.launches = 0


# ---------------------------------------------------------------------------
# A-optimality epilogue
# ---------------------------------------------------------------------------

_AOPT_ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I,
                  _I, ctypes.c_float, _P, ctypes.c_longlong, _P, _P]
# Woodbury columns per sample that one chunk of the kernel holds; a wider
# b runs in chunks of this many, one sample per CTA.
AOPT_ROUND_B = 64
_AOPT_STAGES, _AOPT_STAGE_ROWS = 2, 32   # csrc/aopt_filter_gains.cu's ring


@dataclass(frozen=True)
class AoptPlan:
    """Column layout of kernel 5 (``csrc/aopt_filter_gains.cu``).  Each
    sample's b Woodbury columns take a slot of ``bs`` columns; a unit, one
    CTA's work on a 128-candidate panel, is ``ms`` slots in ``nc`` chunks of
    AOPT_ROUND_B columns; a guess has ``units`` units, packed one after
    another into ``bw`` columns."""

    bs: int
    ms: int
    nc: int
    units: int

    @property
    def bw(self) -> int:
        return self.units * self.nc * AOPT_ROUND_B

    def column(self, i: int, k: int) -> int:
        """Packed column of sample i's Woodbury column k < b."""
        return ((i // self.ms) * self.nc * AOPT_ROUND_B
                + (i % self.ms) * self.bs + k)


def aopt_plan(m: int, b: int) -> AoptPlan:
    """Kernel 5's layout for m samples of b columns: for b ≤ 64, slots of
    bs = 8·⌈b/8⌉ columns (b = 0 takes one zero group of 8), as many as fit
    in one 64-column chunk (at most m) per unit; past 64, one sample per
    unit in ⌈b/64⌉ chunks."""
    if b <= AOPT_ROUND_B:
        bs = 8 * max(1, -(-b // 8))
        ms = min(m, AOPT_ROUND_B // bs)
        return AoptPlan(bs, ms, 1, -(-m // ms))
    nc = -(-b // AOPT_ROUND_B)
    return AoptPlan(nc * AOPT_ROUND_B, 1, nc, m)


def pack_factors(E, plan: AoptPlan) -> torch.Tensor:
    """E (G, m, d, b) f32 packed into the kernel's (G, d, bw) layout on
    its device: sample i's column k at ``plan.column(i, k)``, zero in
    every other column."""
    g, m, d, b = E.shape
    slots = plan.units * plan.ms
    Ep = torch.zeros((g, d, plan.units, plan.nc * AOPT_ROUND_B),
                     dtype=torch.float32, device=E.device)
    dst = Ep[..., :plan.ms * plan.bs].unflatten(-1, (plan.ms, plan.bs))
    src = E if slots == m else torch.cat(
        [E, E.new_zeros((g, slots - m, d, b))], dim=1)
    dst[..., :b].copy_(src.view(g, plan.units, plan.ms, d, b)
                       .permute(0, 3, 1, 2, 4))
    return Ep.view(g, d, plan.bw)


def aopt_smem_bytes(dtype) -> int:
    """Dynamic shared memory of one CTA of kernel 5 (the same for every
    plan): its two-stage ring, or after it the last chunk of t with one staged
    64 × 68 F block, whichever is larger, and the per-thread sums (20 rows
    of 128)."""
    elem = 4 if dtype == torch.float32 else 2
    stage = _AOPT_STAGE_ROWS * (2 * BLOCK_COLS * elem + AOPT_ROUND_B * 4)
    epi = 4 * (AOPT_ROUND_B * BLOCK_COLS + AOPT_ROUND_B * (AOPT_ROUND_B + 4))
    return max(_AOPT_STAGES * stage, epi) + 4 * 20 * BLOCK_COLS


def aopt_scratch_elems(g: int, m: int, n: int, b: int) -> int:
    """f32 elements of the kernel's scratch of t: the chunks before the
    last of each CTA's unit (b > 64), 64 × 128 each; none for b ≤ 64."""
    plan = aopt_plan(m, b)
    if plan.nc == 1:
        return 0
    ctas = -(-n // BLOCK_COLS) * g * plan.units
    return ctas * (plan.nc - 1) * AOPT_ROUND_B * BLOCK_COLS


def _aopt_library():
    lib = _build.load("aopt_filter_gains")
    fn = lib.aopt_filter_gains_launch
    fn.argtypes, fn.restype = _AOPT_ARGTYPES, ctypes.c_int
    return fn


def aopt_kernel_info(dtype) -> dict:
    """Kernel 5 (16-byte staging) for X in ``dtype``: registers, spill
    bytes, shared memory per CTA, threads and CTAs per SM, from the CUDA
    runtime (needs the card)."""
    return partial_kernel_info("aopt_filter_gains", "aopt_filter_kernel_info",
                               dtype)


def _aopt_launch(X, W, E, F, isig2):
    d, n = X.shape
    g = W.shape[0]
    m, b = E.shape[1], E.shape[3]
    dev = X.device
    check_tensor("X", X, (d, n), (torch.float32, torch.bfloat16), dev)
    check_tensor("W", W, (g, d, n), (X.dtype,), dev)
    check_tensor("E", E, (g, m, d, b), (torch.float32,), dev)
    check_tensor("F", F, (g, m, b, b), (torch.float32,), dev)
    if g < 1 or m < 1 or n < 1 or d < 1:
        raise ValueError(
            f"aopt_filter_gains: unsupported shape G={g}, m={m}, d={d}, "
            f"n={n}")
    plan = aopt_plan(m, b)
    Ep = pack_factors(E, plan)
    out = torch.empty((g, m, n), dtype=torch.float32, device=dev)
    scratch = torch.empty(aopt_scratch_elems(g, m, n, b), dtype=torch.float32,
                          device=dev)
    wide = all(t.data_ptr() % 16 == 0 for t in (X, W)) and (
        n * X.element_size()) % 16 == 0
    fn = _aopt_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(X.data_ptr(), W.data_ptr(), int(X.dtype == torch.bfloat16),
                  int(wide), d, n, g, m, Ep.data_ptr(), F.data_ptr(), b,
                  plan.bs, plan.ms, plan.nc, plan.units, float(isig2),
                  scratch.data_ptr(), scratch.numel(), out.data_ptr(), stream)
    _build.check(code, "aopt_filter_gains")
    aopt_filter_gains.launches += 1
    return out


def aopt_filter_gains(X, W, E, F, isig2, *, precision: str | None = None):
    """Sample-batched A-optimality (Woodbury) filter gains for the whole
    guess lattice.

    X: (d, n) candidate columns; W: (G, d, n) per-guess shared solves
    M_g⁻¹X; E: (G, m, d, b) per-sample Woodbury factors (M_gi⁻¹ = M_g⁻¹ −
    E_gi E_giᵀ); F: (G, m, b, b) their Grams; isig2 = 1/σ².  Returns
    (G, m, n) gains w.r.t. every perturbed state.  ``precision="bf16"``
    streams X and W in bf16 with f32 accumulation; E and F stay f32 (the
    plain version quantizes X and W identically, and its ‖w‖² and xᵀw
    are those of the quantized values, as the kernel sums the stored
    ones).
    """
    prec = resolve_precision(precision)
    if use_kernel(X):
        sdt = stream_dtype(prec)
        return _aopt_launch(X.to(sdt), W.to(sdt), E, F, isig2)
    return aopt_filter_gains_lattice_ref(quantize(X, prec), quantize(W, prec),
                                         E, F, isig2)


aopt_filter_gains.launches = 0


# ---------------------------------------------------------------------------
# logistic epilogue
# ---------------------------------------------------------------------------


def logistic_filter_gains(X, y, etas, *, steps: int = 3,
                          precision: str | None = None):
    """Sample-batched logistic filter gains for the whole guess lattice.

    X: (d, n) candidate columns; y: (d,) labels; etas: (G, m, d) refit
    logits of every perturbed state S_g ∪ R_gi.  Returns (G, m, n): row
    (g, i) is the ``steps``-step Newton gain of each candidate at η_gi.
    The lattice is folded guess-major into one sweep over the G·m
    states, X fetched once for all of them.  ``precision="bf16"``
    streams X in bf16; the recurrence, y and the logits stay f32 (the
    plain version quantizes X identically).
    """
    prec = resolve_precision(precision)
    steps = check_steps(steps)
    if etas.dim() != 3:
        raise ValueError(f"etas: shape {tuple(etas.shape)}, expected "
                         "(G, m, d)")
    g, m, d = etas.shape
    if use_kernel(X):
        check_tensor("etas", etas, (g, m, d), (torch.float32,), X.device)
        out = logistic_launch(X.to(stream_dtype(prec)), y,
                              etas.view(g * m, d), steps,
                              ENGINE_STATES_PER_PASS,
                              "logistic_filter_gains")
        logistic_filter_gains.launches += 1
        return out.reshape(g, m, -1)
    return logistic_filter_gains_lattice_ref(quantize(X, prec), y, etas,
                                             steps=steps)


logistic_filter_gains.launches = 0
