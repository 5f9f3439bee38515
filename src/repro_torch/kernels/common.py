"""Shared policy of the port's kernel wrappers (the ops.py layer).

Every kernel package splits into ``ref.py`` (the plain PyTorch version,
a transliteration of the JAX reference) and ``ops.py`` (the wrapper over
the hand-written CUDA kernel in ``repro_torch/kernels/csrc``).  Each
wrapper follows one device rule instead of the JAX package's TPU
tiling heuristics:

  * a CUDA tensor goes to the kernel; a shape, dtype or layout the
    kernel cannot take raises, and so does a build or launch failure —
    there is no size threshold above which the plain version takes over;
  * a CPU tensor goes to the plain version;
  * a ``meta`` tensor (the dry run's trace, ``launch/dryrun.py``) goes to
    the meta route of the wrappers that have one — kernel 8's: an empty
    output of the kernel's shape, and the launch's operations and bytes
    handed to the active recorders (``record_meta_launch``); it launches
    nothing and counts no launch;
  * any other device raises.

Precision policy (as in the JAX package): ``precision="bf16"`` stores
the streamed operands — X, and A-optimality's shared solve W — in bf16;
every accumulation and output is f32.
The plain versions apply the same bf16 round trip (``quantize``) so
kernel and plain version compute the same function per precision.
"""

from __future__ import annotations

import contextlib
import functools

import torch

PRECISIONS = ("f32", "bf16")
_STREAM_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# Asserted parity tolerances per streamed-operand precision — the same
# values as the JAX package.  ``kernel_vs_ref`` bounds the kernel against
# the same-precision plain version (rtol and atol); ``vs_f32`` bounds the
# bf16 result against the f32 result as max-abs error over max f32 gain.
STREAM_PARITY_TOL = {
    "f32": {"kernel_vs_ref": 2e-4, "vs_f32": 0.0},
    "bf16": {"kernel_vs_ref": 2e-4, "vs_f32": 5e-2},
}


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is ≥ ``x``."""
    return ((x + m - 1) // m) * m


def resolve_precision(precision: str | None) -> str:
    """``None`` means f32 streaming."""
    p = "f32" if precision is None else str(precision)
    if p not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}"
        )
    return p


def stream_dtype(precision: str | None) -> torch.dtype:
    """Storage dtype for streamed operands under ``precision``."""
    return _STREAM_DTYPES[resolve_precision(precision)]


def quantize(x: torch.Tensor, precision: str | None) -> torch.Tensor:
    """Round-trip ``x`` through the streamed storage dtype, back to f32.

    The kernel upcasts bf16 storage right after load, so the values it
    computes with are exactly ``f32(bf16(x))``; the plain version applies
    the same round trip.  f32 is the identity.
    """
    dt = stream_dtype(precision)
    if dt == torch.float32:
        return x.to(torch.float32)
    return x.to(dt).to(torch.float32)


# Columns per block of the CPU plain versions (``by_column_blocks``): a
# multiple of 32 (on an AVX-512 host with MKL, blocks of 208 = 13 × 16
# columns still gave width-dependent bits), small enough that a shard of
# a few dozen columns pays little padding.
COLUMN_BLOCK = 128


def by_column_blocks(fn, *cols: torch.Tensor):
    """``fn(*cols)``, on the CPU over fixed-width blocks of the columns.

    ``fn`` maps its arguments column by column to (..., n): the last axis
    of every argument runs over the same n columns (X (d, n), its column
    norms (n,), ...).  On the CPU every call of ``fn`` sees
    ``COLUMN_BLOCK`` columns (the last block zero-padded), so each
    product and each sum over d has one shape whatever n is: a column's
    bits depend on d and the lane and sample shapes, never on the width
    of the call, and a shard of the columns gets the whole sweep's bits
    (torch's vectorized sums and BLAS's blocking order a column's sum by
    the call's width).  Zero columns must map to finite values.  On the
    card a CUDA tensor's sweep goes to the kernels, whose split of d
    depends on n anyway, so there ``fn`` takes all n columns at once.
    """
    if cols[0].device.type != "cpu":
        return fn(*cols)
    n = cols[0].shape[-1]
    nb = -(-n // COLUMN_BLOCK)
    pad = nb * COLUMN_BLOCK - n
    if pad:
        cols = [torch.nn.functional.pad(a, (0, pad)) for a in cols]
    outs = [fn(*(a[..., j * COLUMN_BLOCK:(j + 1) * COLUMN_BLOCK].contiguous()
                 for a in cols)) for j in range(nb)]
    out = outs[0] if nb == 1 else torch.cat(outs, dim=-1)
    return out[..., :n].contiguous() if pad else out


def resolve_device(device) -> torch.device:
    """The port's entry-point rule: ``None`` means the card.

    Raises when ``"cuda"`` is asked for (explicitly or by default) and no
    card is present, so a run never lands on the CPU by accident.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """The wrapper's route: True for a CUDA tensor (launch the kernel),
    False for a CPU tensor (plain version); anything else raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain route for device {t.device}")


_META_RECORDERS: list = []


@contextlib.contextmanager
def meta_launch_recorder(fn):
    """Within the block, ``fn(name, flops, nbytes)`` is called for every
    kernel launch a wrapper's meta route stands in for."""
    _META_RECORDERS.append(fn)
    try:
        yield
    finally:
        _META_RECORDERS.remove(fn)


def record_meta_launch(name: str, flops: float, nbytes: float) -> None:
    """Hand a stood-in launch's operations and bytes to the recorders."""
    for fn in list(_META_RECORDERS):
        fn(name, float(flops), float(nbytes))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(torch.device(device).index or 0)


def set_full_f32_matmul() -> None:
    """The reference is full f32: turn TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_tensor(name: str, t: torch.Tensor, shape: tuple, dtypes,
                 device: torch.device) -> None:
    """Raise unless ``t`` has ``shape``, one of ``dtypes``, lies on
    ``device`` and is contiguous — what a kernel's pointers assume."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
