"""The paper's contribution on PyTorch: the regression objective, DASH
and its yardsticks (slice 1 of the port).

Public API:
    objectives: RegressionObjective, normalize_columns
    algorithms: dash, dash_auto, DashConfig, greedy, top_k_select,
                random_select
    keys:       SeedKey
"""

from repro_torch.core.objectives import RegressionObjective, normalize_columns
from repro_torch.core.dash import DashConfig, DashResult, dash, dash_auto
from repro_torch.core.greedy import GreedyResult, greedy
from repro_torch.core.baselines import SelectResult, random_select, top_k_select
from repro_torch.core.random import SeedKey

__all__ = [
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
]
