"""Sample-batched fused gain engine for the DASH filter step (regression
epilogue): one wrapper call scores every perturbed state of the guess
lattice.  ``ops.py`` holds the kernel wrapper, ``ref.py`` the plain
versions."""

from repro_torch.kernels.filter_gains.ops import filter_gains
from repro_torch.kernels.filter_gains.ref import (
    filter_gains_lattice_ref,
    filter_gains_ref,
)

__all__ = ["filter_gains", "filter_gains_lattice_ref", "filter_gains_ref"]
