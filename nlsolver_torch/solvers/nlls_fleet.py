"""Batch-minor nonlinear least-squares fleet, Levenberg-Marquardt
(counterpart of ``nlsolver_tpu.solvers.nlls_fleet``).

The fleet rides the TRAILING (lane) axis end to end: x ``[n, B]``,
residuals ``[m, B]``, Jacobians ``[m, n, B]``, normal matrices
``[n, n, B]``.  The damped LM system is solved per lane by one of:

  * ``solve="cholesky"`` (default): the damped normal equations through
    the batch-minor Cholesky solve, kernel K3 on a card
    (``ops.smallchol.solve_spd_batchminor``);
  * ``solve="qr"``: the augmented system [J; sqrt(lam) I] through the
    plain Sameh-Kuck wavefront least squares (``linalg.qr_parallel``),
    which does not square the condition number;
  * ``solve="qr_pallas"``: the same augmented system through kernel K2b
    (``ops.qr_wavefront.least_squares_wavefront_kernel``): the rotations
    thread the right-hand side and the back-substitution runs in the
    kernel.  On CPU tensors it runs the plain wavefront.

Algorithm identical to ``solvers.nlls``: a rejected step keeps x and
raises lambda; per-lane termination on cost delta, gradient norm,
max_iter, a NaN cost or the lambda ceiling; finished lanes are frozen.
``fit_fleet`` replaces the JAX package's ``lax.while_loop`` by a host loop
that reads ``done.all()`` once every ``CHECK_EVERY`` steps; the frozen
lanes make the extra steps harmless.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap
from torch.utils._pytree import tree_map

from ..core import lane_where as _lane_where
from ..core import make_result, start_points
from ..linalg.qr_parallel import least_squares_parallel
from ..ops.qr_wavefront import least_squares_wavefront_kernel
from ..ops.smallchol import solve_spd_batchminor

# host loop: steps between two reads of done.all(), as core.driver.drive
CHECK_EVERY = 16


@dataclass(frozen=True)
class NLLSFleetConfig:
    """Fields and defaults of the JAX package's ``NLLSFleetConfig``.
    ``solve="qr_pallas"`` selects kernel K2b.  ``pallas_tile`` and
    ``pallas_interpret`` tuned and tested the TPU kernel; the CUDA kernel
    needs neither, and here they do nothing."""

    lambda0: float = 10.0
    upward_mult: float = 10.0
    downward_mult: float = 10.0
    max_iter: int = 100
    f_delta: float = 1e-12
    grad_eps: float = 1e-12
    # stall ceiling: a lane whose steps are all rejected after its last
    # improvement keeps a fixed |prev_cost - cost|; every rejection
    # multiplies lam by upward_mult, so the ceiling halts the lane after
    # ~log(lambda_max/lambda0)/log(upward_mult) rejections, converged=False
    lambda_max: float = 1e12
    solve: str = "cholesky"          # cholesky | qr | qr_pallas
    pallas_tile: int = 128
    pallas_interpret: bool = False


class NLLSFleetState(NamedTuple):
    x: torch.Tensor          # [n, B]
    cost: torch.Tensor       # [B]
    prev_cost: torch.Tensor  # [B]
    lam: torch.Tensor        # [B]
    iteration: torch.Tensor  # [B] int32
    nfev: torch.Tensor       # [B] int32
    jev: torch.Tensor        # [B] int32
    done: torch.Tensor       # [B] bool
    converged: torch.Tensor  # [B] bool


def _residuals_bm(residual_fn, X, data):
    """Per-lane residuals and Jacobians in batch-minor layout.

    residual_fn(x [n], data_i) -> [m]; X [n, B]; data leaves lead with B.
    Returns r [m, B], J [m, n, B] from one vmapped forward-mode pass (the
    residual is the Jacobian pass's primal output)."""
    def with_value(*args):
        r = residual_fn(*args)
        return r, r

    jac = jacfwd(with_value, has_aux=True)
    if data is None:
        J, r = vmap(jac, in_dims=1, out_dims=(2, 1))(X)
    else:
        J, r = vmap(jac, in_dims=(1, 0), out_dims=(2, 1))(X, data)
    return r, J


def _cost_bm(residual_fn, X, data):
    if data is None:
        r = vmap(residual_fn, in_dims=1, out_dims=1)(X)
    else:
        r = vmap(residual_fn, in_dims=(1, 0), out_dims=1)(X, data)
    return (r * r).sum(dim=0)


def _augmented(r, J, lam):
    """The damped LM system as least squares: A = [J; sqrt(lam) I]
    ``[m+n, n, B]`` and y = [r; 0] ``[m+n, B]``, both contiguous."""
    m, n, B = J.shape
    eye = torch.eye(n, dtype=J.dtype, device=J.device)[:, :, None]
    A_aug = torch.cat([J, torch.sqrt(lam)[None, None, :] * eye], dim=0)
    y_aug = torch.cat([r, r.new_zeros((n, B))], dim=0)
    return A_aug.contiguous(), y_aug.contiguous()


def _delta(r, J, lam, config: NLLSFleetConfig):
    """Solve the damped LM system for every lane, [n, B] out."""
    n = J.shape[1]
    if config.solve in ("qr", "qr_pallas"):
        A_aug, y_aug = _augmented(r, J, lam)
        if config.solve == "qr_pallas":
            return least_squares_wavefront_kernel(A_aug, y_aug)
        return least_squares_parallel(A_aug, y_aug)
    if config.solve != "cholesky":
        raise ValueError(f"unknown solve {config.solve!r}; cholesky | qr | qr_pallas")
    JtJ = torch.einsum("mib,mjb->ijb", J, J)                   # [n, n, B]
    g = torch.einsum("mib,mb->ib", J, r)                       # [n, B]
    eye = torch.eye(n, dtype=J.dtype, device=J.device)[:, :, None]
    return solve_spd_batchminor((JtJ + lam[None, None, :] * eye).contiguous(), g.contiguous())


def init(residual_fn, X0, config: NLLSFleetConfig, data=None) -> NLLSFleetState:
    n, B = X0.shape

    def full(v, dtype):
        return torch.full((B,), v, dtype=dtype, device=X0.device)

    return NLLSFleetState(
        x=X0,
        cost=_cost_bm(residual_fn, X0, data),
        prev_cost=full(float("inf"), X0.dtype),
        lam=full(config.lambda0, X0.dtype),
        iteration=full(0, torch.int32),
        nfev=full(1, torch.int32),
        jev=full(0, torch.int32),
        done=full(False, torch.bool),
        converged=full(False, torch.bool),
    )


def step(residual_fn, state: NLLSFleetState, config: NLLSFleetConfig, data=None) -> NLLSFleetState:
    r, J = _residuals_bm(residual_fn, state.x, data)
    g = torch.einsum("mib,mb->ib", J, r)                       # [n, B]
    gnorm = (g * g).sum(dim=0).sqrt()

    hit_tol = ((state.prev_cost - state.cost).abs() < config.f_delta) | (
        gnorm < config.grad_eps
    )
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | torch.isnan(state.cost)
        | (state.lam > config.lambda_max)
    )
    halted = state._replace(done=torch.ones_like(state.done), converged=hit_tol)

    delta = _delta(r, J, state.lam, config)
    x_try = state.x - delta
    cost_try = _cost_bm(residual_fn, x_try, data)
    improved = cost_try < state.cost

    worked = NLLSFleetState(
        x=torch.where(improved[None, :], x_try, state.x),
        cost=torch.where(improved, cost_try, state.cost),
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
    return _lane_where(done_now, halted, worked)


def advance(residual_fn, state: NLLSFleetState, config: NLLSFleetConfig, data=None):
    """One step of the fleet with finished lanes frozen: the body of
    ``fit_fleet``'s loop."""
    return _lane_where(state.done, state, step(residual_fn, state, config, data))


def fit_fleet(
    residual_fn: Callable,
    X0: torch.Tensor,                  # [n, B] batch-minor start points
    config: NLLSFleetConfig = NLLSFleetConfig(),
    data: Optional[object] = None,     # per-instance pytree, leaves leading with B
):
    """Minimize ``||residual_fn(x_b, data_b)||^2`` for every lane b.

    ``X0`` and the leaves of ``data`` that are no ``torch.Tensor`` (numpy
    arrays, lists) go to the CUDA card, as ``minimize``'s start points do,
    and raise ``RuntimeError`` without one.  Returns a SolverResult with
    per-lane fields; ``x`` stays [n, B]."""
    X0 = start_points(X0, "X0")
    data = tree_map(lambda d: d if d is None else start_points(d, "data"), data)
    state = init(residual_fn, X0, config, data)
    while not bool(state.done.all()):
        for _ in range(CHECK_EVERY):
            state = advance(residual_fn, state, config, data)
    return make_result(
        x=state.x,
        f_value=state.cost,
        iterations=state.iteration,
        function_calls=state.nfev,
        gradient_calls=state.jev,
        converged=state.converged,
    )
