from repro_torch.kernels.marginal_gains.ops import regression_gains
from repro_torch.kernels.marginal_gains.ref import regression_gains_ref

__all__ = ["regression_gains", "regression_gains_ref"]
