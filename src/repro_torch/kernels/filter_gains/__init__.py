"""Sample-batched fused gain engine for the DASH filter step, with the
regression, the A-optimality (Woodbury) and the logistic (Newton sweep)
epilogues: one wrapper call scores every perturbed state of the guess
lattice.  ``ops.py`` holds the kernel wrappers, ``ref.py`` the plain
versions."""

from repro_torch.kernels.filter_gains.ops import (
    aopt_filter_gains,
    filter_gains,
    logistic_filter_gains,
)
from repro_torch.kernels.filter_gains.ref import (
    aopt_filter_gains_lattice_ref,
    aopt_filter_gains_ref,
    filter_gains_lattice_ref,
    filter_gains_ref,
    logistic_filter_gains_lattice_ref,
    logistic_filter_gains_ref,
)

__all__ = [
    "aopt_filter_gains",
    "aopt_filter_gains_lattice_ref",
    "aopt_filter_gains_ref",
    "filter_gains",
    "filter_gains_lattice_ref",
    "filter_gains_ref",
    "logistic_filter_gains",
    "logistic_filter_gains_lattice_ref",
    "logistic_filter_gains_ref",
]
