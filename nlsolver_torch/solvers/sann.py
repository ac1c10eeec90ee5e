"""Simulated Annealing configuration (counterpart of
``nlsolver_tpu.solvers.sann``: ``SANNConfig`` field for field, and
``E_MINUS_1``).  The single-instance SANN solver of the JAX package is not
ported yet (ROADMAP.md Queue 1 item 6b); the lane fleet is
``solvers.sann_batched``."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SANNConfig:
    """Defaults from nlsolver.h:2757-2759."""

    max_iter: int = 5000
    temperature_iter: int = 10
    temperature_max: float = 10.0
    # compare a proposal with the best value seen instead of the chain's
    # current value: the reference's quirk, which can freeze a chain
    metropolis_vs_best: bool = False


E_MINUS_1 = 1.7182818  # reference truncation (nlsolver.h:2779)
