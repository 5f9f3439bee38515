"""Wrappers of the sample-batched filter-engine kernels.

On a CUDA tensor ``filter_gains`` (regression epilogue,
``csrc/filter_gains.cu``: a base pass over the G guess bases and a sample
pass over the G·m perturbed states), ``aopt_filter_gains``
(A-optimality Woodbury epilogue, ``csrc/aopt_filter_gains.cu``: one
launch over the G·m states) and ``logistic_filter_gains`` (logistic
Newton-sweep epilogue: one launch of ``csrc/logistic_gains.cu``'s kernel
template over the G·m states, several states per pass, the old
log-likelihood terms made in the same launch) run their engine on the
current stream, and raise on what the kernel cannot take and on a failed
launch.  On a CPU tensor they run the plain lattice versions of
``ref.py``.  The guess axis is always explicit: the port carries the
DASH lattice as a leading lane axis instead of batching a kernel under
``vmap``.  ``filter_gains.launches``, ``aopt_filter_gains.launches`` and
``logistic_filter_gains.launches`` count wrapper calls that launch an
engine: two device kernels per call for ``filter_gains``, one for
``aopt_filter_gains`` and ``logistic_filter_gains``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_tensor,
    quantize,
    resolve_precision,
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

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P,
             ctypes.c_float, _P]
_MAX_COL_BLOCKS = 65535  # gridDim.y of the launch; 64 columns per block


def _library():
    lib = _build.load("filter_gains")
    fn = lib.filter_gains_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


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
    if g < 1 or m < 1 or n < 1 or -(-n // 64) > _MAX_COL_BLOCKS:
        raise ValueError(
            f"filter_gains: unsupported shape G={g}, m={m}, n={n}")
    base = torch.empty((g, n), dtype=torch.float32, device=dev)
    out = torch.empty((g, m, n), dtype=torch.float32, device=dev)
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(X.data_ptr(), int(X.dtype == torch.bfloat16), d, n, g, m,
                  Q.data_ptr(), k, D.data_ptr(), b, R.data_ptr(),
                  col_sq.data_ptr(), base.data_ptr(), out.data_ptr(),
                  float(span_tol), stream)
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

_AOPT_ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, ctypes.c_float,
                  _P, _P]
AOPT_MAX_B = 64            # Woodbury columns per sample the kernel holds
_AOPT_MAX_COL_BLOCKS = 65535  # gridDim.y of the launch; 128 columns each


def _aopt_library():
    lib = _build.load("aopt_filter_gains")
    fn = lib.aopt_filter_gains_launch
    fn.argtypes, fn.restype = _AOPT_ARGTYPES, ctypes.c_int
    return fn


def _aopt_launch(X, W, E, F, isig2):
    d, n = X.shape
    g = W.shape[0]
    m, b = E.shape[1], E.shape[3]
    dev = X.device
    check_tensor("X", X, (d, n), (torch.float32, torch.bfloat16), dev)
    check_tensor("W", W, (g, d, n), (X.dtype,), dev)
    check_tensor("E", E, (g, m, d, b), (torch.float32,), dev)
    check_tensor("F", F, (g, m, b, b), (torch.float32,), dev)
    if b > AOPT_MAX_B:
        raise ValueError(f"aopt_filter_gains: b={b} Woodbury columns per "
                         f"sample; the kernel holds at most {AOPT_MAX_B}")
    if g < 1 or m < 1 or n < 1 or -(-n // 128) > _AOPT_MAX_COL_BLOCKS:
        raise ValueError(
            f"aopt_filter_gains: unsupported shape G={g}, m={m}, n={n}")
    out = torch.empty((g, m, n), dtype=torch.float32, device=dev)
    fn = _aopt_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(X.data_ptr(), W.data_ptr(), int(X.dtype == torch.bfloat16),
                  d, n, g, m, E.data_ptr(), F.data_ptr(), b, float(isig2),
                  out.data_ptr(), stream)
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
