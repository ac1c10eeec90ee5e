from .more_thuente import MTResult, cstep, more_thuente, more_thuente_fleet
from .speculative import DEFAULT_GRID, speculative_fleet

__all__ = [
    "DEFAULT_GRID",
    "MTResult",
    "cstep",
    "more_thuente",
    "more_thuente_fleet",
    "speculative_fleet",
]
