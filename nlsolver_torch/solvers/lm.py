"""Levenberg-Marquardt in the damped-Hessian form of a scalar objective, on
lane tensors (counterpart of ``nlsolver_tpu.solvers.lm``; the reference's
``LevenbergMarquardt``, nlsolver.h:3428-3545).

Not the residual Gauss-Newton LM (that is ``solvers.nlls``): like the
reference it damps the full Hessian.  Each iteration solves
(H + lambda I) u = g (nlsolver.h:3529-3533) with ``linalg.solve``'s
``damped_solve`` under ``torch.func.vmap`` (a non-PD system gives NaN,
which stops the lane as the reference's garbage solve does), moves
x <- x - u and divides lambda by ``downward_mult`` on improvement or
multiplies it by ``upward_mult`` (nlsolver.h:3534-3542); it stops on
max_iter, |f_prev - f| < f_delta or NaN (nlsolver.h:3520-3527).
Gradients come from ``vmap(grad(fn))`` and Hessians from
``vmap(hessian(fn))``, or from the FD stencils.  The layout is that of
``solvers.bfgs``, with the Hessians ``[B, n, n]``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from ..core import Bounds, SolverResult, drive, where_lanes
from ..core.lanes import Lanes, as_lanes
from ..deriv import Deriv, make_grad, make_hessian
from ..deriv.fd import fd_hessian_cost
from ..linalg.solve import damped_solve as _damped_solve
from ._lane import finalize, grad_cost, lane_full, no_bounds, run_batched, run_single, true_div


@dataclass(frozen=True)
class LMConfig:
    """Defaults from nlsolver.h:3443-3447."""

    lambda0: float = 10.0
    upward_mult: float = 10.0
    downward_mult: float = 10.0
    max_iter: int = 100
    f_delta: float = 1e-12
    deriv: Deriv = field(default_factory=Deriv)
    # "default": the damped Cholesky solve (damped_solve).  "reference":
    # trajectory parity with get_update_with_hessian (nlsolver.h:296-330):
    # its diagonality test has no abs() (:301-302), so a Hessian whose
    # off-diagonals are all <= ~2.2e-4, large negative ones included, takes
    # the elementwise g_i / H_ii path; otherwise an in-place Cholesky and
    # forward / back solve in the reference's arithmetic order (:252-294).
    variant: str = "default"
    # diagonal-Hessian dispatch of the default variant (linalg.solve.
    # damped_solve): True = always the elementwise divide, False = always
    # factorize, None = per lane by the |H_ij| test
    diagonal: Optional[bool] = None


class LMState(NamedTuple):
    x: torch.Tensor          # [B, n]
    gradient: torch.Tensor   # [B, n]
    hessian: torch.Tensor    # [B, n, n]
    lam: torch.Tensor        # [B]
    prev_f: torch.Tensor     # [B]
    cur_f: torch.Tensor      # [B]
    iteration: torch.Tensor  # [B] int32
    nfev: torch.Tensor       # [B] int32
    gfev: torch.Tensor       # [B] int32
    hfev: torch.Tensor       # [B] int32
    done: torch.Tensor       # [B] bool
    converged: torch.Tensor  # [B] bool


def damped_solve(hessian, gradient, lam, *, diagonal=None):
    """(H + lam I) u = g in every lane: H [B, n, n], g [B, n], lam [B]
    (reference: get_update_with_hessian, nlsolver.h:310-330)."""
    return vmap(lambda H, g, l: _damped_solve(H, g, l, diagonal=diagonal))(hessian, gradient, lam)


def _reference_damped_solve_one(H, g, lam):
    """(H + lam I) u = g for one instance exactly as the reference computes
    it (nlsolver.h:296-330, see ``LMConfig.variant``)."""
    n = g.shape[-1]
    dtype = g.dtype
    Hd = H + lam * torch.eye(n, dtype=dtype, device=g.device)
    # signed diagonality test (:301-302): no abs()
    thr = float(torch.finfo(dtype).eps) * 1e12
    off = ~torch.eye(n, dtype=torch.bool, device=g.device)
    is_diag = ~(off & (Hd > thr)).any()
    diag_update = g / torch.diagonal(Hd)

    # in-place Cholesky (:252-270) in the reference's order, its
    # (1 / A_jj) * (A_ij - sum) reciprocal-then-multiply included
    A = [[Hd[i, j] for j in range(n)] for i in range(n)]
    zero = torch.zeros((), dtype=dtype, device=g.device)
    for i in range(n):
        for j in range(i):
            s = zero
            for k in range(j):
                s = s + A[i][k] * A[j][k]
            rcp = 1.0 / A[j][j]
            A[i][j] = rcp * (A[i][j] - s)
        s = zero
        for k in range(i):
            s = s + A[i][k] * A[i][k]
        A[i][i] = torch.sqrt(A[i][i] - s)
    # forwardsolve_inplace (:283-294)
    u = [None] * n
    for i in range(n):
        s = zero
        for j in range(i):
            s = s + A[i][j] * u[j]
        u[i] = (g[i] - s) / A[i][i]
    # backsolve_inplace_t (:271-282)
    for i in range(n - 1, -1, -1):
        s = zero
        for j in range(i + 1, n):
            s = s + A[j][i] * u[j]
        u[i] = (u[i] - s) / A[i][i]
    return torch.where(is_diag, diag_update, torch.stack(u))


def _reference_damped_solve(H, g, lam):
    """:func:`_reference_damped_solve_one` in every lane."""
    return vmap(_reference_damped_solve_one)(H, g, lam)


def _hess_cost(n: int, deriv: Deriv) -> int:
    return fd_hessian_cost(n, deriv.accuracy) if deriv.mode == "fd" else 0


def _derivatives(lanes: Lanes, x, config: LMConfig):
    n = x.shape[-1]
    g = lanes.map(lambda f: make_grad(f, n, config.deriv)[0], x)
    H = lanes.map(lambda f: make_hessian(f, n, config.deriv)[0], x)
    return g, H


def init(fn, x0: torch.Tensor, config: LMConfig = LMConfig(), *, data=None) -> LMState:
    lanes = as_lanes(fn, data)
    n = x0.shape[-1]
    g, H = _derivatives(lanes, x0, config)
    i32 = torch.int32
    return LMState(
        x=x0,
        gradient=g,
        hessian=H,
        lam=lane_full(x0, config.lambda0),
        prev_f=lane_full(x0, 0.0),  # the reference starts prev at 0 (:3515)
        cur_f=lanes.values(x0),
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, 1 + grad_cost(n, config.deriv) + _hess_cost(n, config.deriv), i32),
        gfev=lane_full(x0, 1, i32),
        hfev=lane_full(x0, 1, i32),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def step(fn, state: LMState, config: LMConfig = LMConfig(), *, data=None) -> LMState:
    lanes = as_lanes(fn, data)
    n = state.x.shape[-1]
    costs = grad_cost(n, config.deriv) + _hess_cost(n, config.deriv)

    f_delta = (state.prev_f - state.cur_f).abs()
    hit_tol = f_delta < config.f_delta
    done_now = (state.iteration >= config.max_iter) | hit_tol | torch.isnan(state.prev_f)

    if config.variant == "reference":
        update = _reference_damped_solve(state.hessian, state.gradient, state.lam)
    else:
        update = damped_solve(state.hessian, state.gradient, state.lam, diagonal=config.diagonal)
    new_x = state.x - update
    new_f = lanes.values(new_x)
    new_g, new_H = _derivatives(lanes, new_x, config)
    improved = new_f < state.cur_f
    new_lam = torch.where(improved, true_div(state.lam, config.downward_mult),
                          state.lam * config.upward_mult)

    worked = LMState(
        x=new_x,
        gradient=new_g,
        hessian=new_H,
        lam=new_lam,
        prev_f=state.cur_f,
        cur_f=new_f,
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + costs,
        gfev=state.gfev + 1,
        hfev=state.hfev + 1,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    halted = state._replace(done=torch.ones_like(state.done), converged=hit_tol)
    return where_lanes(done_now, halted, worked)


# steps between two reads of done.all(): a step is a handful of launches
CHECK_EVERY = 16


def _run(lanes: Lanes, x0, config: LMConfig, _minimize: bool) -> SolverResult:
    state = init(lanes, x0, config)
    state = drive(lambda s: step(lanes, s, config), state, check_every=CHECK_EVERY)
    return finalize(lanes, state, not _minimize, function_calls=state.nfev,
                    gradient_calls=state.gfev, hessian_calls=state.hfev, f_value=state.cur_f)


def minimize_batched(fn, x0: torch.Tensor, config: LMConfig = LMConfig(),
                     bounds: Optional[Bounds] = None, *, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]``: ``jax.vmap`` of the JAX ``minimize``."""
    no_bounds("lm", bounds)
    return run_batched(_run, fn, x0, config, data, _minimize)


def minimize(fn, x0: torch.Tensor, config: LMConfig = LMConfig(),
             bounds: Optional[Bounds] = None, *, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the lane engine at B = 1, squeezed."""
    no_bounds("lm", bounds)
    return run_single(_run, fn, x0, config, data, _minimize)


def maximize(fn, x0, config: LMConfig = LMConfig(), bounds=None, *, data=None):
    return minimize(fn, x0, config, bounds, data=data, _minimize=False)
