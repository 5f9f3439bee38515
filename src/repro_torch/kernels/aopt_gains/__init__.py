from repro_torch.kernels.aopt_gains.ops import aopt_gains
from repro_torch.kernels.aopt_gains.ref import aopt_gains_ref

__all__ = ["aopt_gains", "aopt_gains_ref"]
