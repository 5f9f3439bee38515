from repro_torch.kernels.logistic_gains.ops import logistic_gains
from repro_torch.kernels.logistic_gains.ref import logistic_gains_ref

__all__ = ["logistic_gains", "logistic_gains_ref"]
