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
from repro_torch.core.objectives.coreset import (
    CoresetObjective,
    coreset_features,
    prepare_feature_columns,
)
from repro_torch.core.objectives.diversity import (
    ClusterDiversity,
    DiversifiedObjective,
    DiversityObjective,
)
from repro_torch.core.objectives.r2 import R2Objective

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
    "CoresetObjective",
    "coreset_features",
    "prepare_feature_columns",
    "ClusterDiversity",
    "DiversifiedObjective",
    "DiversityObjective",
    "R2Objective",
]
