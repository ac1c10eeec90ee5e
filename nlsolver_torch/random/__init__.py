from .sampling import box_muller_parity, distinct_indices, rnorm, uniform_like

__all__ = ["box_muller_parity", "distinct_indices", "rnorm", "uniform_like"]
