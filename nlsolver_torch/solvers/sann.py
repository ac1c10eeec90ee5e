"""Simulated annealing in the row layout (counterpart of
``nlsolver_tpu.solvers.sann``; the reference's ``SANN``,
nlsolver.h:2744-2815): ``SANNConfig`` and ``E_MINUS_1`` (re-exported), the
row state and the single-instance entry points.

The JAX solver runs one chain ``[n]`` and is batched with ``jax.vmap``,
which gives chain points ``[B, n]``.  The port runs every SANN through one
engine, the batch-minor lane fleet ``solvers.sann_batched`` (``[n, B]``),
whose semantics are those of the vmapped JAX solver.  ``SANNState`` is the
fleet's state with its axes reversed, a view: ``init`` and ``step`` take
and give it, with ``StepDraws`` of one outer iteration (a normal ``[B, n]``
and a uniform ``[B]`` a proposal), so that a JAX row state crosses
packages as a copy (``interop.sann_state_from_numpy``).  As the fleet's,
its ``converged`` is ``done``: SANN stops on ``max_iter`` alone, which the
JAX row solver reports at its end.  ``minimize_batched`` is the fleet's
own; ``minimize`` runs it at B = 1, squeezed.  The JAX ``minimize`` takes
``bounds`` and ignores them; this one refuses them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult
from ..core.lanes import as_lanes
from . import sann_batched as engine
from ._lane import Draws, one_lane, reversed_axes, run_single
from .sann_batched import E_MINUS_1, SANNConfig, minimize_batched  # noqa: F401


class SANNState(NamedTuple):
    p: torch.Tensor            # [B, n] current chain points
    f_p: torch.Tensor          # [B]
    x_best: torch.Tensor       # [B, n] best points seen
    best_value: torch.Tensor   # [B]
    iteration: torch.Tensor    # [B] int32
    nfev: torch.Tensor         # [B] int32
    done: torch.Tensor         # [B] bool
    converged: torch.Tensor    # [B] bool


class StepDraws(NamedTuple):
    """One outer iteration's draws of every lane."""

    noise: torch.Tensor   # [B, n_inner, n] standard normals
    u: torch.Tensor       # [B, n_inner] acceptance uniforms


def _rows(state: engine.SANNBatchState) -> SANNState:
    return SANNState(*reversed_axes(state))


def init(fn, x0: torch.Tensor, config: SANNConfig = SANNConfig(), *, data=None) -> SANNState:
    return _rows(engine.init(as_lanes(fn, data), x0, config))


def step(fn, state: SANNState, config: SANNConfig = SANNConfig(), *,
         draws: Optional[StepDraws] = None, generator: Optional[torch.Generator] = None,
         data=None) -> SANNState:
    """The fleet's ``step`` of a row state; the lanes that are or become
    done stay frozen."""
    cols = engine.SANNBatchState(*reversed_axes(state))
    return _rows(engine.step(as_lanes(fn, data), cols, config, generator=generator,
                             draws=engine.from_rows(draws)))


def minimize(fn, x0: torch.Tensor, config: SANNConfig = SANNConfig(),
             bounds: Optional[Bounds] = None, *, draws: Optional[Draws] = None,
             generator: Optional[torch.Generator] = None, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the engine at B = 1, squeezed; ``draws``
    without the lane axis."""
    engine.no_bounds(bounds)
    return run_single(engine._run, fn, x0, config, data, _minimize, one_lane(draws), generator)


def maximize(fn, x0, config: SANNConfig = SANNConfig(), bounds=None, *, draws=None,
             generator=None, data=None):
    return minimize(fn, x0, config, bounds, draws=draws, generator=generator, data=data,
                    _minimize=False)
