"""Particle Swarm Optimization in the row layout (counterpart of
``nlsolver_tpu.solvers.pso``; the reference's ``PSO``,
nlsolver.h:2496-2742): ``PSOConfig`` and ``_derived_bounds`` (re-exported),
the row state and the single-instance entry points.

The JAX solver keeps one swarm ``[P, n]`` and is batched with
``jax.vmap``, which gives positions ``[B, P, n]``.  The port runs every
PSO through one engine, the batch-minor lane fleet ``solvers.pso_batched``
(``[n, P, B]``), whose semantics are those of the vmapped JAX solver.
``PSOState`` is the fleet's state with its axes reversed, a view:
``init`` and ``step`` take and give it, with ``lower`` and ``upper``
``[B, n]`` and ``InitDraws`` / ``StepDraws`` ``[B, P, n]``, so that a JAX
row state crosses packages as a copy (``interop.pso_state_from_numpy``).
``minimize_batched`` is the fleet's own; ``minimize`` runs it at B = 1,
squeezed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult
from ..core.lanes import as_lanes
from . import pso_batched as engine
from ._lane import Draws, one_lane, reversed_axes, run_single
from .pso_batched import PSOConfig, _derived_bounds, minimize_batched  # noqa: F401

# the draws of init ([B, P, n] each: u, uv) and of a step ([B, P, n]: the
# uniforms r_p and r_g, vanilla, or the normals, accelerated)
InitDraws = engine.PSOInitDraws
StepDraws = engine.PSODraws


class PSOState(NamedTuple):
    positions: torch.Tensor            # [B, P, n]
    velocities: torch.Tensor           # [B, P, n] (the initial ones, accelerated)
    best_positions: torch.Tensor       # [B, P, n] per-particle best
    best_values: torch.Tensor          # [B, P]
    swarm_best_position: torch.Tensor  # [B, n]
    swarm_best_value: torch.Tensor     # [B]
    iteration: torch.Tensor            # [B] int32
    nfev: torch.Tensor                 # [B] int32
    val_no_change: torch.Tensor        # [B] int32
    done: torch.Tensor                 # [B] bool
    converged: torch.Tensor            # [B] bool


def init(fn, x0: torch.Tensor, config: PSOConfig, lower: torch.Tensor, upper: torch.Tensor, *,
         generator: Optional[torch.Generator] = None, draws: Optional[InitDraws] = None,
         data=None) -> PSOState:
    """The fleet's ``init`` of every lane of ``x0 [B, n]`` (``lower``,
    ``upper`` ``[B, n]``), in the row layout."""
    state = engine.init(as_lanes(fn, data), x0, config, lower.T, upper.T, generator=generator,
                        draws=reversed_axes(draws))
    return PSOState(*reversed_axes(state))


def step(fn, state: PSOState, config: PSOConfig, lower: Optional[torch.Tensor] = None,
         upper: Optional[torch.Tensor] = None, clamp_positions: bool = False, *,
         draws: Optional[StepDraws] = None, generator: Optional[torch.Generator] = None,
         data=None) -> PSOState:
    """The fleet's ``step`` of a row state; the lanes that are or become
    done stay frozen."""
    cols = engine.step(as_lanes(fn, data), engine.PSOBatchState(*reversed_axes(state)), config,
                       reversed_axes(lower), reversed_axes(upper), clamp_positions,
                       generator=generator, draws=reversed_axes(draws))
    return PSOState(*reversed_axes(cols))


def minimize(fn, x0: torch.Tensor, config: PSOConfig = PSOConfig(),
             bounds: Optional[Bounds] = None, *, draws: Optional[Draws] = None,
             generator: Optional[torch.Generator] = None, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the engine at B = 1, squeezed; ``draws``
    without the lane axis."""
    return run_single(engine._run, fn, x0, config, data, _minimize, bounds, one_lane(draws),
                      generator)


def maximize(fn, x0, config: PSOConfig = PSOConfig(), bounds=None, *, draws=None, generator=None,
             data=None):
    return minimize(fn, x0, config, bounds, draws=draws, generator=generator, data=data,
                    _minimize=False)
