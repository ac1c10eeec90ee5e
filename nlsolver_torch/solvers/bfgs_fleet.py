"""Batch-minor BFGS fleet: B independent minimizations as one lane-parallel
program (counterpart of ``nlsolver_tpu.solvers.bfgs_fleet``).

The FLEET stays on the trailing (lane) axis end to end: points ``[n, B]``,
inverse Hessians ``[n, n, B]``, so the direction matvec, the More-Thuente
recurrence and the rank-2 update are elementwise work over the lanes for
any n, and neighbouring lanes are neighbouring words (the same layout rule
as solvers/nlls_fleet.py and ops/smallchol.py).

Algorithm parity with the reference ``BFGS`` (nlsolver.h:3169-3286), with
one loop rotation: the next search direction d' = -H'g is computed in the
same pass that applies the rank-2 update (``ops.rank2``: kernels K4a/K4b
on a card), so the O(n^2 B) tensor is read once per iteration instead of
twice.  The curvature self-heal (H=I, d=-g on <g,d> > 0 / NaN / grad-norm
increase; nlsolver.h:3253-3260) becomes a per-lane ``pending_reset`` flag
consumed inside the next update: the identity substitution costs no extra
memory pass.

Termination per lane on max_iter, ||g|| < eps, |delta ||g||| < eps, or inf
(nlsolver.h:3239-3241); finished lanes are frozen.  ``drive_fleet``
replaces the JAX package's ``lax.while_loop`` by a host loop that reads
``done.all()`` after every step: a step run after the last lane finished
would cost a whole line search (on an H100 a read every 4 steps ran the
65536-bowl fleet level to 1.4 times slower; PERF.md).  Iterations and
counters equal JAX's lane by lane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.func import grad, vmap

from ..core import lane_where, make_result
from ..linesearch.more_thuente import more_thuente_fleet
from ..linesearch.speculative import DEFAULT_GRID, speculative_fleet
from ..ops.rank2 import rank2_direction_batchminor


@dataclass(frozen=True)
class BFGSFleetConfig:
    """Fields and defaults of the JAX package's ``BFGSFleetConfig``
    (nlsolver.h:3181-3184).  ``use_pallas`` and ``pallas_tile`` chose and
    tuned the TPU kernel; here the update runs kernel K4a/K4b on every
    CUDA tensor and its plain twin on every CPU tensor, and the two fields
    select nothing."""

    max_iter: int = 100
    grad_eps: float = 5e-3
    alpha: float = 1.0
    use_pallas: bool = False
    pallas_tile: int = 512
    # "more_thuente" (reference cvsrch recurrence, depth <= 20 dependent
    # evaluations) or "speculative" (one batched K-trial grid evaluation
    # per iteration, depth 1; linesearch/speculative.py)
    linesearch: str = "more_thuente"
    ls_grid: tuple = DEFAULT_GRID


class BFGSFleetState(NamedTuple):
    x: torch.Tensor               # [n, B]
    gradient: torch.Tensor        # [n, B]
    inv_hessian: torch.Tensor     # [n, n, B]
    direction: torch.Tensor       # [n, B], the next search direction (carried)
    pending_reset: torch.Tensor   # [B] bool, substitute H=I in the next update
    prev_grad_norm: torch.Tensor  # [B]
    grad_norm: torch.Tensor       # [B]
    iteration: torch.Tensor       # [B] int32
    nfev: torch.Tensor            # [B] int32
    gfev: torch.Tensor            # [B] int32
    done: torch.Tensor            # [B] bool
    converged: torch.Tensor       # [B] bool


def colwise(fn):
    """Lift a scalar objective ``[n] -> ()`` to columns ``[n, B] -> [B]``."""
    return vmap(fn, in_dims=1, out_dims=0)


def grad_colwise(fn_cols):
    """Per-column gradients ``[n, B] -> [n, B]`` of a column objective.

    Columns are independent, so the gradient of the lane sum is the
    per-lane gradient: one reverse pass over the whole fleet.
    """
    return grad(lambda X: fn_cols(X).sum())


def init(fn_cols, X0, config: BFGSFleetConfig) -> BFGSFleetState:
    n, B = X0.shape
    dev = X0.device
    G0 = grad_colwise(fn_cols)(X0)
    eye = torch.eye(n, dtype=X0.dtype, device=dev)[:, :, None]
    return BFGSFleetState(
        x=X0,
        gradient=G0,
        inv_hessian=eye.expand(n, n, B).contiguous(),
        direction=-G0,
        pending_reset=torch.zeros(B, dtype=torch.bool, device=dev),
        prev_grad_norm=torch.full((B,), 1e9, dtype=X0.dtype, device=dev),
        grad_norm=torch.full((B,), 1e8, dtype=X0.dtype, device=dev),
        iteration=torch.zeros(B, dtype=torch.int32, device=dev),
        nfev=torch.full((B,), 2, dtype=torch.int32, device=dev),  # g0 costs 1 f + 1 g
        gfev=torch.ones(B, dtype=torch.int32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        converged=torch.zeros(B, dtype=torch.bool, device=dev),
    )


def step(fn_cols, state: BFGSFleetState, config: BFGSFleetConfig) -> BFGSFleetState:
    grad_cols = grad_colwise(fn_cols)

    hit_tol = state.grad_norm < config.grad_eps
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | ((state.grad_norm - state.prev_grad_norm).abs() < config.grad_eps)
        | torch.isinf(state.grad_norm)
    )
    halted = state._replace(done=torch.ones_like(state.done), converged=hit_tol)

    g, d = state.gradient, state.direction
    f0 = fn_cols(state.x)
    if config.linesearch == "speculative":
        ls = speculative_fleet(
            fn_cols, grad_cols, state.x, f0, g, d, config.alpha, grid=config.ls_grid
        )
    elif config.linesearch == "more_thuente":
        ls = more_thuente_fleet(fn_cols, grad_cols, state.x, f0, g, d, config.alpha)
    else:
        raise ValueError(
            f"unknown linesearch {config.linesearch!r}; 'more_thuente' or 'speculative'"
        )
    s = ls.alpha * d
    new_x = state.x + s
    new_g = grad_cols(new_x)
    new_norm = (new_g * new_g).sum(dim=0).sqrt()

    y = new_g - g
    # curvature guard: a failed line search (alpha=0 => s=y=0) or negative
    # curvature would make rho infinite and store a non-finite inv_hessian;
    # rho=0 makes the rank-2 update a no-op and the explicit reset below
    # restores steepest descent
    sy = (y * s).sum(dim=0)
    # strictly positive is not enough: a positive SUBNORMAL sy (possible
    # when alpha ~ 1e-20) still overflows 1/sy to inf; the smallest normal
    # keeps the reciprocal finite (1/tiny ~ 8.5e37 < f32 max)
    curv_ok = sy > torch.finfo(sy.dtype).tiny
    rho = torch.where(curv_ok, 1.0 / torch.where(curv_ok, sy, 1.0), 0.0)
    # an objective may hand back strided gradients; the kernels take none
    new_H, d_raw = rank2_direction_batchminor(
        state.inv_hessian, s.contiguous(), y.contiguous(), new_g.contiguous(), rho,
        state.pending_reset,
    )
    phi = (new_g * d_raw).sum(dim=0)
    need_reset = (phi > 0) | torch.isnan(phi) | (new_norm > state.grad_norm) | ~curv_ok
    d_next = torch.where(need_reset[None, :], -new_g, d_raw)

    worked = BFGSFleetState(
        x=new_x,
        gradient=new_g,
        inv_hessian=new_H,
        direction=d_next,
        pending_reset=need_reset,
        prev_grad_norm=state.grad_norm,
        grad_norm=new_norm,
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + 2 * ls.nfev + 1,  # trials cost f+g each; +f0 +g_new
        gfev=state.gfev + ls.nfev + 1,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    return lane_where(done_now, halted, worked)


def drive_fleet(step_fn, state: BFGSFleetState) -> BFGSFleetState:
    """Step until every lane is done.  ``step`` halts a finished lane by
    fields that a halted lane no longer changes, so it freezes the lane
    itself and no select pass goes around it."""
    while not bool(state.done.all()):
        state = step_fn(state)
    return state


def minimize_fleet(fn_cols, X0, config: BFGSFleetConfig = BFGSFleetConfig()):
    """Minimize B independent instances; ``fn_cols: [n, B] -> [B]``.

    ``X0`` is [n, B] (batch-minor) and the fleet runs on its device.
    Returns a SolverResult whose fields are per-lane tensors and whose
    ``x`` stays [n, B].
    """
    state = init(fn_cols, X0, config)
    state = drive_fleet(lambda s: step(fn_cols, s, config), state)
    return make_result(
        x=state.x,
        f_value=fn_cols(state.x),
        iterations=state.iteration,
        function_calls=state.nfev + 1,
        gradient_calls=state.gfev,
        converged=state.converged,
    )
