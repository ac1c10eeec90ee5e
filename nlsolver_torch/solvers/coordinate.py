"""Cyclic coordinate descent with a Brent line minimization per
coordinate, on lane tensors (counterpart of
``nlsolver_tpu.solvers.coordinate``).

Each outer iteration sweeps the coordinates in order, minimizing the 1-D
restriction f(x + t e_i) of every lane with ``brent.minimize_scalar`` over
a bracket that adapts to the last sweep's largest step.  The layout is that
of ``solvers.bfgs``: ``x [B, n]``; the Brent searches of a sweep run on
``[B]`` lanes, each lane's as the vmapped JAX search runs it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, drive, where_lanes
from ..core.lanes import Lanes, as_lanes
from ._lane import finalize, lane_full, no_bounds, run_batched, run_single
from .brent import BrentConfig, minimize_scalar


@dataclass(frozen=True)
class CoordinateDescentConfig:
    max_iter: int = 100           # outer sweeps
    bracket: float = 1.0          # initial half-width of the 1-D bracket
    f_tol: float = 1e-10          # sweep-to-sweep improvement tolerance
    brent_tol: float = 1e-10
    brent_max_iter: int = 60


class CDState(NamedTuple):
    x: torch.Tensor          # [B, n]
    f: torch.Tensor          # [B]
    prev_f: torch.Tensor     # [B]
    bracket: torch.Tensor    # [B]
    iteration: torch.Tensor  # [B] int32
    nfev: torch.Tensor       # [B] int32
    done: torch.Tensor       # [B] bool
    converged: torch.Tensor  # [B] bool


def init(fn, x0: torch.Tensor, config: CoordinateDescentConfig = CoordinateDescentConfig(), *,
         data=None) -> CDState:
    lanes = as_lanes(fn, data)
    i32 = torch.int32
    return CDState(
        x=x0,
        f=lanes.values(x0),
        prev_f=lane_full(x0, float("inf")),
        bracket=lane_full(x0, config.bracket),
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, 1, i32),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def step(fn, state: CDState, config: CoordinateDescentConfig = CoordinateDescentConfig(), *,
         data=None) -> CDState:
    lanes = as_lanes(fn, data)
    n = state.x.shape[-1]

    hit_tol = (state.prev_f - state.f).abs() < config.f_tol
    done_now = (state.iteration >= config.max_iter) | hit_tol

    bcfg = BrentConfig(tol=config.brent_tol, eps=config.brent_tol,
                       max_iter=config.brent_max_iter, lower=-1.0, upper=1.0)
    x, nfev, width = state.x, state.nfev, state.bracket
    steps = []
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    for i in range(n):
        e_i = eye[i]

        def line(t, x=x, e_i=e_i):
            return lanes.values(x + (t * width)[:, None] * e_i)

        res = minimize_scalar(line, bcfg, like=width)
        t_star = res.x * width
        x = x + t_star[:, None] * e_i
        nfev = nfev + res.function_calls
        steps.append(t_star.abs())
    f_new = lanes.values(x)
    # adapt the bracket to the sweep's largest movement
    max_step = torch.stack(steps, dim=-1).amax(dim=-1)
    new_bracket = torch.clamp(4.0 * max_step, 1e-8, config.bracket)

    worked = CDState(
        x=x,
        f=f_new,
        prev_f=state.f,
        bracket=new_bracket,
        iteration=state.iteration + 1,
        nfev=nfev + 1,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    halted = state._replace(done=torch.ones_like(state.done), converged=hit_tol)
    return where_lanes(done_now, halted, worked)


def _run(lanes: Lanes, x0, config: CoordinateDescentConfig, _minimize: bool) -> SolverResult:
    state = init(lanes, x0, config)
    state = drive(lambda s: step(lanes, s, config), state, check_every=1)
    return finalize(lanes, state, not _minimize, function_calls=state.nfev, f_value=state.f)


def minimize_batched(fn, x0: torch.Tensor,
                     config: CoordinateDescentConfig = CoordinateDescentConfig(),
                     bounds: Optional[Bounds] = None, *, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]``: ``jax.vmap`` of the JAX ``minimize``."""
    no_bounds("coordinate", bounds)
    return run_batched(_run, fn, x0, config, data, _minimize)


def minimize(fn, x0: torch.Tensor, config: CoordinateDescentConfig = CoordinateDescentConfig(),
             bounds: Optional[Bounds] = None, *, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the lane engine at B = 1, squeezed."""
    no_bounds("coordinate", bounds)
    return run_single(_run, fn, x0, config, data, _minimize)


def maximize(fn, x0, config: CoordinateDescentConfig = CoordinateDescentConfig(), bounds=None, *,
             data=None):
    return minimize(fn, x0, config, bounds, data=data, _minimize=False)
