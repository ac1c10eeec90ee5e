"""BFGS (inverse-Hessian form) with the More-Thuente line search, on lane
tensors (counterpart of ``nlsolver_tpu.solvers.bfgs``; the reference's
``BFGS``, nlsolver.h:3169-3286).

The JAX solver takes one point ``[n]`` and is batched with ``jax.vmap``
(``layout="batched"``).  Here ``init`` and ``step`` take that layout
directly: points ``x [B, n]``, inverse Hessians ``H [B, n, n]``, every
scalar a ``[B]`` vector.  ``core.drive`` freezes the lanes that are done,
as a vmapped ``lax.while_loop`` does, and the line search is
``linesearch.more_thuente_fleet`` fed ``x.T``: lane by lane the same
recurrence as a vmapped ``more_thuente``.  ``minimize`` is the case
B = 1, squeezed on the way out; ``minimize_batched`` returns every lane.

The algorithm is the JAX package's: direction d = -H g; reset H = I,
d = -g when curvature is lost (<g, d> > 0), NaN appears or the gradient
norm grew (nlsolver.h:3253-3260); More-Thuente from ``alpha``; termination
on max_iter, ||g|| < grad_eps, |delta ||g||| < grad_eps or inf
(nlsolver.h:3239-3241).  The rank-2 update is the correct BFGS formula

    H' = H - rho (s (H y)^T + (H y) s^T) + rho (1 + rho y^T H y) s s^T,

which on CUDA tensors runs as kernel K4c (``ops.rank2_update_batched``,
one call a step) at every n, in the form ``ops.rank2.batched_form`` names:
K4c-r (a thread a row in registers) up to n = 32 in float32 and 15 in
float64, K4c-w (a warp an instance in shared memory) up to 48, K4c-g (two
passes through device memory) beyond; on CPU tensors as its plain twin.
``reference_update=True`` is the reference's formula with its sign quirk
(nlsolver.h:3143-3163), a different function that runs in plain torch.
``update_plan`` names the choice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, drive, where_lanes
from ..core.lanes import Lanes, as_lanes, lane_dot, lane_norm, matvec
from ..deriv import Deriv, make_grad
from ..linesearch.more_thuente import more_thuente_fleet
from ..ops.rank2 import rank2_update_batched, rank2_update_batched_reference
from ._lane import finalize, grad_cost, lane_full, no_bounds, run_batched, run_single


@dataclass(frozen=True)
class BFGSConfig:
    """Defaults from nlsolver.h:3181-3184."""

    max_iter: int = 100
    grad_eps: float = 5e-3
    alpha: float = 1.0
    deriv: Deriv = field(default_factory=Deriv)
    reference_update: bool = False  # reproduce the reference's sign quirk


class BFGSState(NamedTuple):
    x: torch.Tensor               # [B, n]
    gradient: torch.Tensor        # [B, n]
    inv_hessian: torch.Tensor     # [B, n, n]
    prev_grad_norm: torch.Tensor  # [B]
    grad_norm: torch.Tensor       # [B]
    iteration: torch.Tensor       # [B] int32
    nfev: torch.Tensor            # [B] int32
    gfev: torch.Tensor            # [B] int32
    done: torch.Tensor            # [B] bool
    converged: torch.Tensor       # [B] bool


def init(fn, x0: torch.Tensor, config: BFGSConfig = BFGSConfig(), *, data=None) -> BFGSState:
    lanes = as_lanes(fn, data)
    B, n = x0.shape
    g_cost = grad_cost(n, config.deriv)
    g = lanes.map(lambda f: make_grad(f, n, config.deriv)[0], x0)
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    i32 = torch.int32
    return BFGSState(
        x=x0,
        gradient=g,
        inv_hessian=eye.expand(B, n, n).contiguous(),
        prev_grad_norm=lane_full(x0, 1e9),
        grad_norm=lane_full(x0, 1e8),
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, g_cost, i32),
        gfev=lane_full(x0, 1, i32),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def rank2_update(H, s, y, rho, reference_quirk: bool = False):
    """The BFGS inverse-Hessian rank-2 update of every lane in plain torch:
    H [B, n, n]; s, y [B, n]; rho [B].  ``reference_quirk`` reproduces the
    reference's arithmetic (nlsolver.h:3143-3163): denom = (yHy rho) + 1
    and all three terms subtracted."""
    if not reference_quirk:
        return rank2_update_batched_reference(H, s, y, rho)
    Hy = matvec(H, y)
    yHy = lane_dot(y, Hy)
    denom = yHy * rho + 1.0
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731
    T = (outer(Hy, s) + outer(s, Hy)) + outer(s, denom[:, None] * s)
    return H - rho[:, None, None] * T


def update_plan(n: int, dtype: torch.dtype, reference_update: bool) -> str:
    """How ``step`` applies the rank-2 update: "reference" (the quirk
    formula, plain torch) or, at every n and dtype, "kernel"
    (``ops.rank2_update_batched``: on CUDA tensors K4c in the form
    ``ops.rank2.batched_form(n, dtype)`` names, on CPU tensors its twin)."""
    return "reference" if reference_update else "kernel"


def _apply_update(H, s, y, rho, plan: str):
    if plan == "kernel":
        return rank2_update_batched(H.contiguous(), s.contiguous(), y.contiguous(),
                                    rho.contiguous())
    return rank2_update(H, s, y, rho, reference_quirk=True)


def step(fn, state: BFGSState, config: BFGSConfig = BFGSConfig(), *, data=None) -> BFGSState:
    lanes = as_lanes(fn, data)
    B, n = state.x.shape
    grad_point = lambda f: make_grad(f, n, config.deriv)[0]  # noqa: E731
    g_cost = grad_cost(n, config.deriv)

    hit_tol = state.grad_norm < config.grad_eps
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | ((state.grad_norm - state.prev_grad_norm).abs() < config.grad_eps)
        | torch.isinf(state.grad_norm)
    )

    g = state.gradient
    d = -matvec(state.inv_hessian, g)
    phi = lane_dot(g, d)
    need_reset = (phi > 0) | torch.isnan(phi) | (state.grad_norm > state.prev_grad_norm)
    eye = torch.eye(n, dtype=state.x.dtype, device=state.x.device)
    H = torch.where(need_reset[:, None, None], eye, state.inv_hessian)
    d = torch.where(need_reset[:, None], -g, d)

    f0 = lanes.values(state.x)
    ls = more_thuente_fleet(lanes.columns(), lanes.columns(grad_point), state.x.T, f0, g.T, d.T,
                            config.alpha)
    s = ls.alpha[:, None] * d
    new_x = state.x + s
    new_grad = lanes.map(grad_point, new_x)
    new_norm = lane_norm(new_grad)

    y = new_grad - g
    rho = 1.0 / lane_dot(y, s)
    new_H = _apply_update(H, s, y, rho, update_plan(n, H.dtype, config.reference_update))

    worked = BFGSState(
        x=new_x,
        gradient=new_grad,
        inv_hessian=new_H,
        prev_grad_norm=state.grad_norm,
        grad_norm=new_norm,
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + ls.nfev * (1 + g_cost) + g_cost,
        gfev=state.gfev + ls.nfev + 1,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    halted = state._replace(done=torch.ones_like(state.done), converged=hit_tol)
    return where_lanes(done_now, halted, worked)


def _finalize(lanes: Lanes, state: BFGSState, flip_sign: bool) -> SolverResult:
    return finalize(lanes, state, flip_sign, function_calls=state.nfev + 1,
                    gradient_calls=state.gfev)


def _run(lanes: Lanes, x0: torch.Tensor, config: BFGSConfig, _minimize: bool) -> SolverResult:
    state = init(lanes, x0, config)
    state = drive(lambda s: step(lanes, s, config), state, check_every=1)
    return _finalize(lanes, state, flip_sign=not _minimize)


def minimize_batched(fn, x0: torch.Tensor, config: BFGSConfig = BFGSConfig(),
                     bounds: Optional[Bounds] = None, *, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]``: ``jax.vmap`` of the JAX ``minimize``."""
    no_bounds("bfgs", bounds)
    return run_batched(_run, fn, x0, config, data, _minimize)


def minimize(fn, x0: torch.Tensor, config: BFGSConfig = BFGSConfig(),
             bounds: Optional[Bounds] = None, *, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the lane engine at B = 1, squeezed."""
    no_bounds("bfgs", bounds)
    return run_single(_run, fn, x0, config, data, _minimize)


def maximize(fn, x0, config: BFGSConfig = BFGSConfig(), bounds=None, *, data=None):
    return minimize(fn, x0, config, bounds, data=data, _minimize=False)
