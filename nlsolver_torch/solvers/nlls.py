"""Nonlinear least squares: residual-Jacobian Levenberg-Marquardt
(counterpart of ``nlsolver_tpu.solvers.nlls``).

    r(x) in R^m,  cost = ||r(x)||^2
    solve (J^T J + lambda I) delta = J^T r,  x <- x - delta on improvement

with true accept/reject: a failed step keeps x and raises lambda.  The
Jacobian comes from ``torch.func.jacfwd`` (forward mode: m >= n is the
common fit shape).  ``fit_batched`` runs a leading-axis batch of fits, a
``torch.func.vmap`` of ``step`` driven by ``core.driver.drive`` with
finished lanes frozen; ``curve_fit`` is the scipy-style sugar.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from ..core import SolverResult, drive, make_result, where_lanes
from ..linalg import damped_solve
from ..linalg.qr_parallel import least_squares_parallel


@dataclass(frozen=True)
class NLLSConfig:
    lambda0: float = 10.0
    upward_mult: float = 10.0
    downward_mult: float = 10.0
    max_iter: int = 100
    f_delta: float = 1e-12
    grad_eps: float = 1e-12
    # stall ceiling: a tail of rejected steps keeps |prev_cost - cost|
    # fixed; every rejection multiplies lambda by upward_mult, so the
    # ceiling halts it after ~log(lambda_max/lambda0)/log(upward_mult)
    # rejections, converged=False
    lambda_max: float = 1e12
    # "cholesky": damped normal equations (linalg.damped_solve, the
    # reference's get_update_with_hessian path, nlsolver.h:296-330);
    # "qr": least squares on the augmented system [J; sqrt(lam) I] through
    # the parallel Givens QR (linalg.qr_parallel), which does not square
    # the condition number
    solve: str = "cholesky"


class NLLSState(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor
    prev_cost: torch.Tensor
    lam: torch.Tensor
    iteration: torch.Tensor
    nfev: torch.Tensor
    jev: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor


def _cost(residual_fn, x):
    r = residual_fn(x)
    return (r * r).sum()


def _fresh_state(x0, cost, config: NLLSConfig, shape=()) -> NLLSState:
    def full(v, dtype):
        return torch.full(shape, v, dtype=dtype, device=x0.device)

    return NLLSState(
        x=x0,
        cost=cost,
        prev_cost=full(float("inf"), x0.dtype),
        lam=full(config.lambda0, x0.dtype),
        iteration=full(0, torch.int32),
        nfev=full(1, torch.int32),
        jev=full(0, torch.int32),
        done=full(False, torch.bool),
        converged=full(False, torch.bool),
    )


def init(residual_fn: Callable, x0: torch.Tensor, config: NLLSConfig) -> NLLSState:
    return _fresh_state(x0, _cost(residual_fn, x0), config)


def step(residual_fn: Callable, state: NLLSState, config: NLLSConfig) -> NLLSState:
    r = residual_fn(state.x)
    J = jacfwd(residual_fn)(state.x)          # [m, n]
    g = J.T @ r                               # gradient of 0.5*cost
    JtJ = J.T @ J

    hit_tol = ((state.prev_cost - state.cost).abs() < config.f_delta) | (
        (g * g).sum().sqrt() < config.grad_eps
    )
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | torch.isnan(state.cost)
        | (state.lam > config.lambda_max)
    )
    halted = state._replace(done=torch.ones_like(state.done), converged=hit_tol)

    if config.solve == "qr":
        n = J.shape[1]
        eye = torch.eye(n, dtype=J.dtype, device=J.device)
        A_aug = torch.cat([J, torch.sqrt(state.lam) * eye], dim=0)
        y_aug = torch.cat([r, r.new_zeros(n)])
        delta = least_squares_parallel(A_aug, y_aug)
    else:
        delta = damped_solve(JtJ, g, state.lam)
    x_try = state.x - delta
    cost_try = _cost(residual_fn, x_try)
    improved = cost_try < state.cost

    worked = NLLSState(
        x=torch.where(improved, x_try, state.x),
        cost=torch.where(improved, cost_try, state.cost),
        # only accepted steps advance the cost-delta criterion; a rejected
        # step would otherwise make |prev-cur| = 0 and fake convergence
        prev_cost=torch.where(improved, state.cost, state.prev_cost),
        lam=torch.where(
            improved, state.lam / config.downward_mult, state.lam * config.upward_mult
        ),
        iteration=state.iteration + 1,
        nfev=state.nfev + 2,
        jev=state.jev + 1,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    return where_lanes(done_now, halted, worked)


def _finalize(state: NLLSState) -> SolverResult:
    return make_result(
        x=state.x,
        f_value=state.cost,
        iterations=state.iteration,
        function_calls=state.nfev,
        gradient_calls=state.jev,
        converged=state.converged,
    )


def fit(residual_fn: Callable, x0: torch.Tensor, config: NLLSConfig = NLLSConfig()) -> SolverResult:
    """Minimize ||residual_fn(x)||^2 from x0."""
    state = init(residual_fn, x0, config)
    state = drive(lambda s: step(residual_fn, s, config), state)
    return _finalize(state)


def batch(residual_fn: Callable, x0s: torch.Tensor, config: NLLSConfig, data=None):
    """The initial state of a leading-axis batch of fits and its step (a
    ``vmap`` of :func:`step`, each lane on its slice of ``data``)."""
    if data is None:
        costs = vmap(lambda x: _cost(residual_fn, x))(x0s)
        batch_step = vmap(lambda s: step(residual_fn, s, config))
    else:
        costs = vmap(lambda x, d: _cost(lambda p: residual_fn(p, d), x))(x0s, data)
        each = vmap(lambda s, d: step(lambda p: residual_fn(p, d), s, config))
        batch_step = lambda s: each(s, data)  # noqa: E731
    return _fresh_state(x0s, costs, config, shape=(x0s.shape[0],)), batch_step


def fit_batched(
    residual_fn: Callable,
    x0s: torch.Tensor,              # [B, n]
    config: NLLSConfig = NLLSConfig(),
    data: Optional[object] = None,  # per-instance tensor or tuple, leading dim B
) -> SolverResult:
    """A batch of independent fits, one per row of ``x0s``.

    If ``data`` is given, ``residual_fn(x, data_i)`` receives each
    instance's slice (the batched curve-fitting shape).  The step is
    ``vmap``-ed over the batch; every lane runs until all are done, with
    finished lanes frozen, as the JAX package's ``vmap`` of a while loop
    does."""
    state, batch_step = batch(residual_fn, x0s, config, data)
    return _finalize(drive(batch_step, state))


def curve_fit(
    model: Callable,                # model(params, t) -> y_hat
    t: torch.Tensor,
    y: torch.Tensor,
    p0: torch.Tensor,
    config: NLLSConfig = NLLSConfig(),
) -> SolverResult:
    """scipy.optimize.curve_fit-style sugar on top of :func:`fit`."""
    return fit(lambda p: model(p, t) - y, p0, config)
