"""Wrapper of the 1-D-Newton logistic singleton-gain kernel.

On a CUDA tensor ``logistic_gains`` launches the hand-written kernel of
``csrc/logistic_gains.cu`` (it raises on what the kernel cannot take and
on a failed launch); on a CPU tensor it runs the plain version of
``ref.py``.  There is no size threshold above which the plain version
takes over.  ``logistic_gains.launches`` counts wrapper calls that
launch: two device kernels per call (the per-row old log-likelihood
terms, then the sweep).
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
from repro_torch.kernels.logistic_gains.ref import logistic_gains_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P]
_MAX_COL_BLOCKS = 65535  # gridDim.y of the launch; 32 columns per block


def _library():
    lib = _build.load("logistic_gains")
    fn = lib.logistic_gains_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def check_steps(steps) -> int:
    """Newton steps as a non-negative int, or raise."""
    if int(steps) != steps or steps < 0:
        raise ValueError(f"steps={steps!r}: expected an int ≥ 0")
    return int(steps)


def _launch(X, y, eta, steps):
    d, n = X.shape
    g = eta.shape[0]
    dev = X.device
    check_tensor("X", X, (d, n), (torch.float32, torch.bfloat16), dev)
    check_tensor("y", y, (d,), (torch.float32,), dev)
    check_tensor("eta", eta, (g, d), (torch.float32,), dev)
    if g < 1 or d < 1 or n < 1 or -(-n // 32) > _MAX_COL_BLOCKS:
        raise ValueError(
            f"logistic_gains: unsupported shape G={g}, d={d}, n={n}")
    c_old = torch.empty((g, d), dtype=torch.float32, device=dev)
    out = torch.empty((g, n), dtype=torch.float32, device=dev)
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(),
                  eta.data_ptr(), d, n, g, steps, c_old.data_ptr(),
                  out.data_ptr(), stream)
    _build.check(code, "logistic_gains")
    logistic_gains.launches += 1
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
        out = _launch(X.to(stream_dtype(prec)), y, E, steps)
    else:
        Xq = quantize(X, prec)
        out = torch.stack([logistic_gains_ref(Xq, y, e, steps=steps)
                           for e in E])
    return out if lanes else out[0]


logistic_gains.launches = 0
