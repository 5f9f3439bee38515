"""Wrapper of the regression singleton-gain kernel.

On a CUDA tensor ``regression_gains`` launches the hand-written kernel of
``csrc/marginal_gains.cu`` (it raises on what the kernel cannot take and
on a failed launch); on a CPU tensor it runs the plain version of
``ref.py``.  ``regression_gains.launches`` counts kernel launches.
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
from repro_torch.kernels.marginal_gains.ref import SPAN_TOL, regression_gains_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _I, _I, _I, _P, _I, _P, _P, _P, ctypes.c_float, _P]
_MAX_COL_BLOCKS = 65535  # gridDim.y of the launch; 64 columns per block


def _library():
    lib = _build.load("marginal_gains")
    fn = lib.regression_gains_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _launch(X, Q, resid, col_sq, span_tol):
    d, n = X.shape
    g, _, k = Q.shape
    dev = X.device
    check_tensor("X", X, (d, n), (torch.float32, torch.bfloat16), dev)
    check_tensor("Q", Q, (g, d, k), (torch.float32,), dev)
    check_tensor("resid", resid, (g, d), (torch.float32,), dev)
    check_tensor("col_sq", col_sq, (n,), (torch.float32,), dev)
    if g < 1 or n < 1 or -(-n // 64) > _MAX_COL_BLOCKS:
        raise ValueError(f"regression_gains: unsupported shape G={g}, n={n}")
    out = torch.empty((g, n), dtype=torch.float32, device=dev)
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(X.data_ptr(), int(X.dtype == torch.bfloat16), d, n, g,
                  Q.data_ptr(), k, resid.data_ptr(), col_sq.data_ptr(),
                  out.data_ptr(), float(span_tol), stream)
    _build.check(code, "regression_gains")
    regression_gains.launches += 1
    return out


def regression_gains(X, Q, resid, col_sq, *, precision: str | None = None,
                     span_tol: float = SPAN_TOL):
    """Batched regression gains: the CUDA kernel on the card, the plain
    version on the CPU.

    X: (d, n) in f32 or already in the stream dtype; Q: (d, k) or, with a
    leading lane axis, (G, d, k); resid: (d,) or (G, d); col_sq: (n,).
    Returns (n,) or (G, n) f32.  ``precision="bf16"`` streams X in bf16
    with f32 accumulation (the plain version quantizes X identically).
    """
    prec = resolve_precision(precision)
    lanes = Q.dim() == 3
    Qg = Q if lanes else Q.unsqueeze(0)
    rg = resid if lanes else resid.unsqueeze(0)
    if use_kernel(X):
        out = _launch(X.to(stream_dtype(prec)), Qg, rg, col_sq, span_tol)
    else:
        out = regression_gains_ref(quantize(X, prec), Qg, rg, col_sq,
                                   span_tol=span_tol)
    return out if lanes else out[0]


regression_gains.launches = 0
