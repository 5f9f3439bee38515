"""Wrapper of the flash-attention kernel (kernel 8).

On a CUDA tensor ``flash_attention`` launches the hand-written kernel of
``csrc/flash_attention.cu``: for bf16 the tensor cores (wgmma over a K/V
ring that each GQA group shares at head_dim 64, 80, 128 and 256;
mma.sync at 16 and 32), for f32 the CUDA cores.  It raises on what the kernel cannot
take — another dtype, mixed dtypes,
a non-contiguous or unaligned tensor, H % Hkv ≠ 0, a head_dim outside
``KERNEL_HEAD_DIMS`` — and on a failed launch.  On a CPU tensor it runs
the plain version of ``ref.py``.  On a ``meta`` tensor (a dry run's
trace) it checks the inputs as for the kernel, returns an empty output
of the kernel's shape and hands the launch's operations and bytes
(``flash_cost``, the formulas of the kernel's bound in ``chip_smoke.py``)
to ``kernels.common.record_meta_launch``; that is not a launch and is
not counted.  There is no size threshold and no fallback.  The kernel
reads the model's (B, S, H, D) layout directly and masks ragged Sq and
Skv itself, so nothing is padded or transposed.
``flash_attention.launches`` counts launches; ``kernel_info`` describes
the kernel a dtype and head_dim get.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import record_meta_launch, use_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

KERNEL_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535   # gridDim.y (heads) and gridDim.z (batch)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
             _P]
# flash_attention_kernel_info's out[7], in order (csrc: describe).
_INFO_KEYS = ("registers", "spill_bytes", "smem_bytes", "threads",
              "ctas_per_sm", "rows", "block_kv")


def _library():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def kernel_info(dtype, d: int) -> dict:
    """Registers, shared memory and tile geometry of the CUDA kernel that
    ``flash_attention`` launches for ``dtype`` and head_dim ``d`` (needs
    the card: it asks the CUDA runtime)."""
    if d not in KERNEL_HEAD_DIMS or dtype not in _DTYPES:
        raise ValueError(f"flash_attention: no kernel for {dtype}, D={d}")
    fn = _build.load("flash_attention").flash_attention_kernel_info
    fn.argtypes, fn.restype = [_I, _I, ctypes.POINTER(_I)], ctypes.c_int
    out = (_I * len(_INFO_KEYS))()
    _build.check(fn(int(dtype == torch.bfloat16), d, out),
                 "flash_attention_kernel_info")
    return dict(zip(_INFO_KEYS, out))


def count_valid_pairs(sq: int, skv: int, causal: bool, window: int,
                      q_offset: int = 0) -> int:
    """Valid (query, key) pairs of one (batch, head) under the causal
    mask (query i at position i + q_offset) and the window."""
    qp = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(skv - 1, qp) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_cost(b: int, sq: int, skv: int, h: int, hkv: int, d: int, *,
               causal: bool, window: int = 0, q_offset: int = 0,
               itemsize: int = 2) -> tuple:
    """(operations, bytes, exponentials) of one call: 4·d flops (QKᵀ and
    PV) and one exp per valid pair of every (batch, head), and Q, K, V
    read once and O written once."""
    pairs = count_valid_pairs(sq, skv, causal, window, q_offset) * b * h
    nbytes = itemsize * (2 * b * sq * h * d + 2 * b * skv * hkv * d)
    return 4.0 * d * pairs, float(nbytes), float(pairs)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, H, D)")
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if tuple(k.shape) != (b, skv, hkv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not agree")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if sq < 1 or skv < 1 or h > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: unsupported shape B={b} "
                         f"Sq={sq} Skv={skv} H={h}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; q, k "
                             f"and v must all be one of {_DTYPES}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             "aligned")


def _launch(q, k, v, causal, window, softcap, q_offset):
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  int(q.dtype == torch.bfloat16), b, sq, skv, h, hkv, d,
                  int(bool(causal)), int(window or 0), int(q_offset),
                  1.0 / math.sqrt(d), float(softcap or 0.0), stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


def _meta_route(q, k, v, causal, window, q_offset):
    """The kernel's output shape, and its cost handed to the recorders."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    flops, nbytes, _ = flash_cost(b, sq, k.shape[1], h, k.shape[2], d,
                                  causal=causal, window=window or 0,
                                  q_offset=q_offset,
                                  itemsize=q.element_size())
    record_meta_launch("flash_attention", flops, nbytes)
    return torch.empty_like(q)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) → (B, Sq, H, D).

    The CUDA kernel for a CUDA tensor, the plain version for a CPU one,
    the meta route for a ``meta`` one.
    """
    if window and window < 0:
        raise ValueError(f"window={window}: expected ≥ 0")
    if q.device.type == "meta":
        return _meta_route(q, k, v, causal, window, q_offset)
    if use_kernel(q):
        return _launch(q, k, v, causal, window, softcap, q_offset)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)


flash_attention.launches = 0
