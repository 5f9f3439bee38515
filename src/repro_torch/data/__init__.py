from repro_torch.data.synthetic import make_d1_design, make_d1_regression

__all__ = ["make_d1_design", "make_d1_regression"]
