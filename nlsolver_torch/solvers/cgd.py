"""Conjugate gradient descent (Fletcher-Reeves) with the Armijo line search,
on lane tensors (counterpart of ``nlsolver_tpu.solvers.cgd``; the
reference's ``ConjugatedGradientDescent``, nlsolver.h:3037-3129).

beta = <g_new, g_new> / <g_old, g_old> (nlsolver.h:3116-3120), Armijo
restarted from the configured alpha each iteration (nlsolver.h:3107-3108),
termination on max_iter, ||g|| < grad_eps or an infinite gradient norm
(nlsolver.h:3100-3101).  The layout is that of ``solvers.bfgs``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, drive, where_lanes
from ..core.lanes import Lanes, as_lanes, lane_dot, lane_norm
from ..deriv import Deriv, make_grad
from ..linesearch.armijo import armijo
from ._lane import finalize, grad_cost, lane_full, no_bounds, run_batched, run_single


@dataclass(frozen=True)
class CGDConfig:
    """Defaults from nlsolver.h:3046-3050."""

    max_iter: int = 500
    grad_eps: float = 5e-3
    alpha: float = 0.03
    deriv: Deriv = field(default_factory=Deriv)


class CGDState(NamedTuple):
    x: torch.Tensor          # [B, n]
    gradient: torch.Tensor   # [B, n]
    direction: torch.Tensor  # [B, n]
    iteration: torch.Tensor  # [B] int32
    nfev: torch.Tensor       # [B] int32
    gfev: torch.Tensor       # [B] int32
    done: torch.Tensor       # [B] bool
    converged: torch.Tensor  # [B] bool


def init(fn, x0: torch.Tensor, config: CGDConfig = CGDConfig(), *, data=None) -> CGDState:
    lanes = as_lanes(fn, data)
    n = x0.shape[-1]
    g = lanes.map(lambda f: make_grad(f, n, config.deriv)[0], x0)
    i32 = torch.int32
    return CGDState(
        x=x0,
        gradient=g,
        direction=-g,
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, grad_cost(n, config.deriv), i32),
        gfev=lane_full(x0, 1, i32),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def step(fn, state: CGDState, config: CGDConfig = CGDConfig(), *, data=None) -> CGDState:
    lanes = as_lanes(fn, data)
    n = state.x.shape[-1]
    g_cost = grad_cost(n, config.deriv)

    grad_norm = lane_norm(state.gradient)
    hit_tol = grad_norm < config.grad_eps
    done_now = (state.iteration >= config.max_iter) | hit_tol | torch.isinf(grad_norm)

    f0 = lanes.values(state.x)  # the armijo overload evaluates f(x) (nlsolver.h:1853)
    ls = armijo(lanes.values, state.x, f0, state.gradient, state.direction, config.alpha)
    new_x = state.x + ls.alpha[:, None] * state.direction

    denom = lane_dot(state.gradient, state.gradient)
    new_grad = lanes.map(lambda f: make_grad(f, n, config.deriv)[0], new_x)
    beta = lane_dot(new_grad, new_grad) / denom  # Fletcher-Reeves
    new_dir = beta[:, None] * state.direction - new_grad

    worked = CGDState(
        x=new_x,
        gradient=new_grad,
        direction=new_dir,
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + ls.nfev + g_cost,
        gfev=state.gfev + 1,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    halted = state._replace(done=torch.ones_like(state.done), converged=hit_tol)
    return where_lanes(done_now, halted, worked)


def _run(lanes: Lanes, x0, config: CGDConfig, _minimize: bool) -> SolverResult:
    state = init(lanes, x0, config)
    state = drive(lambda s: step(lanes, s, config), state, check_every=1)
    return finalize(lanes, state, not _minimize, function_calls=state.nfev + 1,
                    gradient_calls=state.gfev)


def minimize_batched(fn, x0: torch.Tensor, config: CGDConfig = CGDConfig(),
                     bounds: Optional[Bounds] = None, *, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]``: ``jax.vmap`` of the JAX ``minimize``."""
    no_bounds("cgd", bounds)
    return run_batched(_run, fn, x0, config, data, _minimize)


def minimize(fn, x0: torch.Tensor, config: CGDConfig = CGDConfig(),
             bounds: Optional[Bounds] = None, *, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the lane engine at B = 1, squeezed."""
    no_bounds("cgd", bounds)
    return run_single(_run, fn, x0, config, data, _minimize)


def maximize(fn, x0, config: CGDConfig = CGDConfig(), bounds=None, *, data=None):
    return minimize(fn, x0, config, bounds, data=data, _minimize=False)
