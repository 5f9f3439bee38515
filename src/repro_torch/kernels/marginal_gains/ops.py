"""Wrapper of the regression singleton-gain kernel.

On a CUDA tensor ``regression_gains`` launches the hand-written kernels of
``csrc/marginal_gains.cu`` (it raises on what they cannot take and on a
failed launch); on a CPU tensor it runs the plain version of ``ref.py``.
``regression_gains.launches`` counts wrapper calls that launch (each is
two device kernels: the split-d partial sweep and its epilogue).
``split_plan`` is the split of d that a launch uses, ``wide_copies`` its
choice of copy width, and ``kernel_info`` describes the partial kernel.
"""

from __future__ import annotations

import ctypes
import functools

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

# The kernel's tile (csrc/marginal_gains.cu: BN, BM, TR) and the CTAs an
# SM holds at once (registers: 256 threads at up to 128 each).
BLOCK_COLS = 128
BASIS_TILE = 128
STAGE_ROWS = 32
CTAS_PER_SM = 2
_MAX_LANES = 65535  # gridDim.y of the epilogue kernel: the lanes G

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, ctypes.c_float,
             _I, _I, _P, ctypes.c_longlong, _P]
# describe_partial's out[5], in order (csrc/split_proj.cuh).
_INFO_KEYS = ("registers", "spill_bytes", "smem_bytes", "threads",
              "ctas_per_sm")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def split_plan(g: int, d: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(S, rows_per_slice): how many contiguous slices of d the partial
    kernel's grid (G · basis tiles, ⌈n/128⌉, S) reduces, and the rows of
    each (a multiple of STAGE_ROWS; the last slice is ragged, none empty).

    As many slices as keep the grid within one wave of the SMs' CTA
    slots, so S = 1 once the other grid axes fill them: more slices would
    add a wave and workspace traffic, not parallelism."""
    ctas = g * max(1, _cdiv(k, BASIS_TILE)) * _cdiv(n, BLOCK_COLS)
    stages = max(1, _cdiv(d, STAGE_ROWS))
    s = max(1, min(stages, CTAS_PER_SM * sms // ctas))
    rows = _cdiv(stages, s) * STAGE_ROWS
    return max(1, _cdiv(d, rows)), rows


def workspace_elems(g: int, n: int, k: int, s: int) -> int:
    """f32 elements of the (S, G, kp + 1, np) partial workspace."""
    kp = BASIS_TILE * max(1, _cdiv(k, BASIS_TILE))
    return s * g * (kp + 1) * BLOCK_COLS * _cdiv(n, BLOCK_COLS)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library():
    lib = _build.load("marginal_gains")
    fn = lib.regression_gains_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def partial_kernel_info(library: str, symbol: str, dtype) -> dict:
    """What ``symbol`` of ``csrc/<library>.cu`` reports of the kernel it
    describes (the split-d partial kernel's instance, through
    ``split_proj.cuh::describe_partial``, or kernel 5) for X in
    ``dtype``: registers, spill bytes, shared memory, threads and CTAs per
    SM (needs the card: it asks the CUDA runtime)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{library}: no kernel for {dtype}")
    fn = getattr(_build.load(library), symbol)
    fn.argtypes, fn.restype = [_I, ctypes.POINTER(_I)], ctypes.c_int
    out = (_I * len(_INFO_KEYS))()
    _build.check(fn(int(dtype == torch.bfloat16), out), symbol)
    return dict(zip(_INFO_KEYS, out))


def kernel_info(dtype) -> dict:
    """The partial kernel that ``regression_gains`` launches for X in
    ``dtype``, described as ``partial_kernel_info`` says."""
    return partial_kernel_info("marginal_gains",
                               "regression_gains_kernel_info", dtype)


def wide_copies(X: torch.Tensor, Q: torch.Tensor) -> bool:
    """Whether the kernel stages X (d, n) and Q (G, d, k) by 16-byte copies:
    every row of both starts on 16 bytes.  Otherwise it copies one element
    at a time."""
    return all(t.data_ptr() % 16 == 0
               and (t.shape[-1] * t.element_size()) % 16 == 0 for t in (X, Q))


def _launch(X, Q, resid, col_sq, span_tol):
    d, n = X.shape
    g, _, k = Q.shape
    dev = X.device
    check_tensor("X", X, (d, n), (torch.float32, torch.bfloat16), dev)
    check_tensor("Q", Q, (g, d, k), (torch.float32,), dev)
    check_tensor("resid", resid, (g, d), (torch.float32,), dev)
    check_tensor("col_sq", col_sq, (n,), (torch.float32,), dev)
    if g < 1 or n < 1 or g > _MAX_LANES:
        raise ValueError(f"regression_gains: unsupported shape G={g}, n={n}")
    s, rows = split_plan(g, d, n, k, _sm_count(dev.index or 0))
    elems = workspace_elems(g, n, k, s)
    ws = torch.empty(elems, dtype=torch.float32, device=dev)
    out = torch.empty((g, n), dtype=torch.float32, device=dev)
    wide = wide_copies(X, Q)
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(X.data_ptr(), int(X.dtype == torch.bfloat16), int(wide), d,
                  n, g, Q.data_ptr(), k, resid.data_ptr(), col_sq.data_ptr(),
                  out.data_ptr(), float(span_tol), s, rows, ws.data_ptr(),
                  elems, stream)
    _build.check(code, "regression_gains")
    regression_gains.launches += 1
    return out


def regression_gains(X, Q, resid, col_sq, *, precision: str | None = None,
                     span_tol: float = SPAN_TOL):
    """Batched regression gains: the CUDA kernels on the card, the plain
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
