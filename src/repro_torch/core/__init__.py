"""The paper's contribution on PyTorch: the regression, A-optimal design,
logistic-classification, R², diversity and coreset objectives, DASH, the
§5 roster behind the ``select`` registry, the γ estimators, and the
single-device resilience of the selection loop (slices 1–3, 5 and 6 of
the port); the sharded runtime is ``core/distributed.py`` (slice 7),
reached through ``select(..., mesh=)``.

Public API:
    objectives: RegressionObjective, AOptimalityObjective,
                ClassificationObjective, R2Objective, CoresetObjective,
                ClusterDiversity, DiversityObjective,
                DiversifiedObjective, normalize_columns
    algorithms: select (registry entry point), select_batched, dash,
                dash_auto, dash_checkpointed, DashConfig, fast, greedy,
                lazy_greedy, stochastic_greedy, adaptive_sequencing,
                top_k_select, random_select, fista, lasso_path_select
    resilience: ResilienceConfig, Deadline, SelectionDeadlineExceeded
    analysis:   gamma_regression, gamma_classification, gamma_aopt,
                alpha_from_gamma
    keys:       SeedKey
"""

from repro_torch.core.objectives import (
    AOptimalityObjective,
    ClassificationObjective,
    ClusterDiversity,
    CoresetObjective,
    DiversifiedObjective,
    DiversityObjective,
    R2Objective,
    RegressionObjective,
    normalize_columns,
)
from repro_torch.core.dash import (
    DashConfig,
    DashResult,
    dash,
    dash_auto,
    dash_checkpointed,
)
from repro_torch.core.selection_loop import (
    Deadline,
    ResilienceConfig,
    SelectionDeadlineExceeded,
)
from repro_torch.core.greedy import (
    GreedyResult,
    greedy,
    greedy_parallel_cost,
    greedy_sequential_cost,
    lazy_greedy,
    lazy_greedy_cost,
    stochastic_greedy,
    stochastic_greedy_cost,
)
from repro_torch.core.baselines import SelectResult, random_select, top_k_select
from repro_torch.core.algorithms import (
    AlgorithmSpec,
    SelectionResult,
    algorithm_cost,
    available_algorithms,
    get_algorithm,
    register,
    select,
    select_batched,
)
from repro_torch.core.lasso import fista, lasso_path_select
from repro_torch.core.adaptive_sequencing import adaptive_sequencing
from repro_torch.core.fast import FastResult, fast, fast_cost
from repro_torch.core.random import SeedKey
from repro_torch.core.spectral import (
    alpha_from_gamma,
    gamma_aopt,
    gamma_classification,
    gamma_regression,
)

__all__ = [
    "AOptimalityObjective",
    "ClassificationObjective",
    "RegressionObjective",
    "R2Objective",
    "CoresetObjective",
    "ClusterDiversity",
    "DiversityObjective",
    "DiversifiedObjective",
    "normalize_columns",
    "DashConfig",
    "DashResult",
    "dash",
    "dash_auto",
    "dash_checkpointed",
    "ResilienceConfig",
    "Deadline",
    "SelectionDeadlineExceeded",
    "GreedyResult",
    "greedy",
    "lazy_greedy",
    "stochastic_greedy",
    "greedy_parallel_cost",
    "greedy_sequential_cost",
    "lazy_greedy_cost",
    "stochastic_greedy_cost",
    "SelectResult",
    "random_select",
    "top_k_select",
    "AlgorithmSpec",
    "SelectionResult",
    "algorithm_cost",
    "available_algorithms",
    "get_algorithm",
    "register",
    "select",
    "select_batched",
    "FastResult",
    "fast",
    "fast_cost",
    "fista",
    "lasso_path_select",
    "adaptive_sequencing",
    "SeedKey",
    "alpha_from_gamma",
    "gamma_aopt",
    "gamma_classification",
    "gamma_regression",
]
