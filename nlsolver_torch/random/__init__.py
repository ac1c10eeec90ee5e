from .sampling import distinct_indices, uniform_like

__all__ = ["distinct_indices", "uniform_like"]
