"""Build and load the port's CUDA kernels: nvcc by hand, bound by ctypes.

Each source ``repro_torch/kernels/csrc/<name>.cu`` exposes a plain C
interface and is compiled at first use into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The library lands in ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the sources it includes,
so an edited source never loads a stale build.  Libraries are cached per
process.  The sources include no PyTorch header: that keeps one build at
seconds instead of minutes.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a nonzero code, so a refused launch (too many
threads, too much shared memory, no image for the card) never passes
silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class BuildInfo:
    """What one build did: seconds spent in nvcc (0 if the library was
    already on disk) and the ptxas register/spill report."""

    library: Path
    seconds: float
    ptxas: str


_LIBS: dict[str, ctypes.CDLL] = {}
_INFO: dict[str, BuildInfo] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    lib = _library_path(name)
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def build(*names: str) -> dict[str, BuildInfo]:
    """Compile the named sources, all nvcc processes started together,
    and load each library.  Raises if any build fails."""
    started = {n: (_start(n), time.perf_counter()) for n in names
               if n not in _LIBS}
    errors = []
    for n, ((lib, tmp, proc), t0) in started.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{log}")
                continue
            os.replace(tmp, lib)
        _INFO[n] = BuildInfo(lib, time.perf_counter() - t0 if proc else 0.0,
                             log)
        _LIBS[n] = ctypes.CDLL(str(lib))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _INFO[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build(name)
    return _LIBS[name]


def check(code: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")
