from .armijo import ArmijoResult, armijo
from .more_thuente import MTResult, cstep, more_thuente, more_thuente_fleet
from .speculative import DEFAULT_GRID, speculative_fleet

__all__ = [
    "ArmijoResult",
    "DEFAULT_GRID",
    "MTResult",
    "armijo",
    "cstep",
    "more_thuente",
    "more_thuente_fleet",
    "speculative_fleet",
]
