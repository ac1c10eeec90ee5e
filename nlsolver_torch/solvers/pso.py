"""Particle Swarm Optimization configuration (counterpart of
``nlsolver_tpu.solvers.pso``: ``PSOConfig`` field for field, and
``_derived_bounds``).  The row-layout single-instance PSO solver of the JAX
package is not ported yet (ROADMAP.md Queue 1 item 6b); the lane fleet is
``solvers.pso_batched``."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PSOConfig:
    """Defaults from nlsolver.h:2522-2526."""

    inertia: float = 0.8
    cognitive_coef: float = 1.8
    social_coef: float = 1.8
    n_particles: int = 10
    max_iter: int = 5000
    best_value_no_change: int = 50
    eps: float = 1e-3
    accelerated: bool = False   # PSOType {Vanilla, Accelerated}


def _derived_bounds(x0: torch.Tensor):
    """The unbounded entry point derives per-dimension bounds +-|x_i|
    (nlsolver.h:2554-2560)."""
    t = x0.abs()
    return -t, t
