"""Differential Evolution configuration (counterpart of
``nlsolver_tpu.solvers.de.DEConfig``, field for field).  The row-layout DE
solver of the JAX package is not ported yet; the batched engine is
``solvers.de_batched``."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DEConfig:
    """Hyperparameters with the reference's defaults (nlsolver.h:2390-2394)."""

    crossover_prob: float = 0.9
    differential_weight: float = 0.8
    eps: float = 1e-3           # reference writes 10e-4
    pop_size: int = 50
    max_iter: int = 1000
    best_value_no_change: int = 50
    strategy: str = "random"    # RecombinationStrategy {random, best} (:2377)
    # partner sampling of the batched engine:
    #   "uniform"  - per-agent uniform distinct partners (reference
    #                semantics, nlsolver.h:2331-2355);
    #   "rotation" - agent i's partners are (i+o1, i+o2, i+o3) mod P, the
    #                three offsets drawn fresh each generation from
    #                disjoint ranges (distinct, nonzero).
    partner_sampling: str = "uniform"
    # batched engine only: run each generation as the fused CUDA kernel
    # (ops/de_fused.py): mutation, crossover, objective and greedy
    # selection in one pass.  Requires partner_sampling="rotation" and,
    # on the card, an objective from the kernel's registry.
    use_fused_kernel: bool = False
