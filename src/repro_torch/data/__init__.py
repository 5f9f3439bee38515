from repro_torch.data.synthetic import (
    make_d1_design,
    make_d1_regression,
    make_d3_classification,
)

__all__ = ["make_d1_design", "make_d1_regression", "make_d3_classification"]
