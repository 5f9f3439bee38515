"""The paper's contribution on PyTorch: the regression, A-optimal design
and logistic-classification objectives, DASH and its yardsticks (slices
1–3 of the port).

Public API:
    objectives: RegressionObjective, AOptimalityObjective,
                ClassificationObjective, normalize_columns
    algorithms: dash, dash_auto, DashConfig, greedy, top_k_select,
                random_select
    spectral:   gamma_aopt, alpha_from_gamma
    keys:       SeedKey
"""

from repro_torch.core.objectives import (
    AOptimalityObjective,
    ClassificationObjective,
    RegressionObjective,
    normalize_columns,
)
from repro_torch.core.dash import DashConfig, DashResult, dash, dash_auto
from repro_torch.core.greedy import GreedyResult, greedy
from repro_torch.core.baselines import SelectResult, random_select, top_k_select
from repro_torch.core.random import SeedKey
from repro_torch.core.spectral import alpha_from_gamma, gamma_aopt

__all__ = [
    "AOptimalityObjective",
    "ClassificationObjective",
    "RegressionObjective",
    "normalize_columns",
    "DashConfig",
    "DashResult",
    "dash",
    "dash_auto",
    "GreedyResult",
    "greedy",
    "SelectResult",
    "random_select",
    "top_k_select",
    "SeedKey",
    "alpha_from_gamma",
    "gamma_aopt",
]
