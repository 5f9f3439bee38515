"""Wrapper of the A-optimality Sherman–Morrison singleton-gain kernel.

On a CUDA tensor ``aopt_gains`` launches the hand-written kernel of
``csrc/aopt_gains.cu`` (it raises on what the kernel cannot take and on
a failed launch); on a CPU tensor it runs the plain version of
``ref.py``.  ``aopt_gains.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.aopt_gains.ref import aopt_gains_ref
from repro_torch.kernels.common import (
    check_tensor,
    quantize,
    resolve_precision,
    stream_dtype,
    use_kernel,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _I, _I, _I, _I, ctypes.c_float, _P, _P]


def _library():
    lib = _build.load("aopt_gains")
    fn = lib.aopt_gains_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _launch(X, W, isig2):
    d, n = X.shape
    g = W.shape[0]
    dev = X.device
    check_tensor("X", X, (d, n), (torch.float32, torch.bfloat16), dev)
    check_tensor("W", W, (g, d, n), (X.dtype,), dev)
    if g < 1 or n < 1:
        raise ValueError(f"aopt_gains: unsupported shape G={g}, n={n}")
    out = torch.empty((g, n), dtype=torch.float32, device=dev)
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(X.data_ptr(), W.data_ptr(), int(X.dtype == torch.bfloat16),
                  d, n, g, float(isig2), out.data_ptr(), stream)
    _build.check(code, "aopt_gains")
    aopt_gains.launches += 1
    return out


def aopt_gains(X, W, isig2, *, precision: str | None = None):
    """Batched Sherman–Morrison gains: the CUDA kernel on the card, the
    plain version on the CPU.

    X: (d, n) candidate columns; W: (d, n) or, with a leading lane axis,
    (G, d, n) shared solves M⁻¹X; isig2 = 1/σ².  Returns (n,) or (G, n)
    f32.  ``precision="bf16"`` streams X and W in bf16 with f32
    accumulation (the plain version quantizes both identically).
    """
    prec = resolve_precision(precision)
    lanes = W.dim() == 3
    Wg = W if lanes else W.unsqueeze(0)
    if use_kernel(X):
        sdt = stream_dtype(prec)
        out = _launch(X.to(sdt), Wg.to(sdt), isig2)
    else:
        out = aopt_gains_ref(quantize(X, prec), quantize(Wg, prec), isig2)
    return out if lanes else out[0]


aopt_gains.launches = 0
