from repro_torch.core.objectives.base import (
    Objective,
    SupportsFilterEngine,
    SupportsSubsetGains,
    normalize_columns,
)
from repro_torch.core.objectives.a_optimal import (
    AOptimalityObjective,
    AOptState,
)
from repro_torch.core.objectives.classification import (
    ClassificationObjective,
    ClassificationState,
)
from repro_torch.core.objectives.regression import RegressionObjective

__all__ = [
    "Objective",
    "SupportsFilterEngine",
    "SupportsSubsetGains",
    "normalize_columns",
    "AOptimalityObjective",
    "AOptState",
    "ClassificationObjective",
    "ClassificationState",
    "RegressionObjective",
]
