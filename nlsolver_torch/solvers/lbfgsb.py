"""L-BFGS-B, the Byrd-Lu-Nocedal-Zhu bound-constrained limited-memory BFGS,
on lane tensors (counterpart of ``nlsolver_tpu.solvers.lbfgsb``; Byrd, Lu,
Nocedal, Zhu, SIAM J. Sci. Comput. 16(5), 1995).

Each step, in every lane:
  1. the compact representation B = theta I - W M W^T of the (s, y) ring,
     with the 2m x 2m middle matrix inverted (``torch.linalg.inv``);
  2. the generalized Cauchy point along the projected steepest-descent
     path: the breakpoints sorted (``argsort``, stable), then n trips over
     them in order, each lane at its own breakpoint and frozen once it
     stops, as the JAX package's ``lax.scan`` is under ``vmap``;
  3. subspace minimization over the variables free at the Cauchy point
     (the direct primal method with the Sherman-Morrison-Woodbury inverse,
     eqs. 5.4-5.11), with masks, and a ``torch.linalg.solve``;
  4. the strong-Wolfe More-Thuente search truncated at the box
     (``more_thuente_fleet`` with each lane's ``alpha_max``).
Convergence is scipy's: the sup-norm of the projected gradient below
``pg_eps``, or the relative f-change below ``factr`` times f64's eps.  The
layout is that of ``solvers.bfgs``; the rings are ``[B, m, n]``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, drive, where_lanes
from ..core.lanes import Lanes, as_lanes, lane_dot, matvec
from ..deriv import Deriv, make_grad
from ..linesearch.more_thuente import more_thuente_fleet
from ._lane import finalize, grad_cost, lane_full, run_batched, run_single
from .lbfgs import _set_slot, _slot
from .lbfgs import box as lbfgs_box


@dataclass(frozen=True)
class LBFGSBConfig:
    memory: int = 10
    max_iter: int = 200
    pg_eps: float = 1e-8          # sup-norm of projected gradient (scipy's pgtol)
    factr: float = 1e7            # relative f-change stop, scipy semantics:
                                  # stop when df <= factr * eps64 * max(|f|, 1),
                                  # floored at one ulp of the iterate dtype;
                                  # 0.0 disables (stop only on exact stall)
    alpha: float = 1.0
    deriv: Deriv = field(default_factory=Deriv)


class LBFGSBState(NamedTuple):
    x: torch.Tensor          # [B, n]
    gradient: torch.Tensor   # [B, n]
    f_prev: torch.Tensor     # [B]
    s_hist: torch.Tensor     # [B, m, n] ring
    y_hist: torch.Tensor     # [B, m, n] ring
    valid: torch.Tensor      # [B, m] bool
    head: torch.Tensor       # [B] int32, ring insert position (monotonic)
    iteration: torch.Tensor  # [B] int32
    nfev: torch.Tensor       # [B] int32
    gfev: torch.Tensor       # [B] int32
    done: torch.Tensor       # [B] bool
    converged: torch.Tensor  # [B] bool


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _compact_rep(s_hist, y_hist, valid, head):
    """The chronologically ordered compact representation of every lane:
    (theta [B], W [B, n, 2m], Minv [B, 2m, 2m]), Minv the inverse of the
    middle matrix.  Invalid ring slots are padded to an identity block and
    their W columns zeroed, so they contribute nothing."""
    B, m, n = s_hist.shape
    dtype, dev = s_hist.dtype, s_hist.device
    lanes = torch.arange(B, device=dev)[:, None]
    order = (head.long()[:, None] + torch.arange(m, device=dev)) % m   # oldest -> newest
    S = s_hist[lanes, order]                                           # [B, m, n]
    Y = y_hist[lanes, order]
    v = valid[lanes, order].to(dtype)                                  # [B, m]

    SY = S @ _t(Y)                                                     # [B, m, m]
    d = torch.diagonal(SY, dim1=-2, dim2=-1)
    vv = v[:, :, None] * v[:, None, :]
    L = torch.tril(SY, diagonal=-1) * vv
    one = torch.ones((), dtype=dtype, device=dev)
    D = torch.where(v > 0, d, one)

    newest = (head - 1) % m
    s_new, y_new = _slot(s_hist, newest), _slot(y_hist, newest)
    ys = lane_dot(s_new, y_new)
    yy = lane_dot(y_new, y_new)
    theta = torch.where(_slot(valid, newest) & (yy > 0), yy / ys, one)

    SS = (S @ _t(S)) * vv
    SS = SS + torch.diag_embed(torch.where(v > 0, 0.0, 1.0).to(dtype))

    Mmat = torch.cat([torch.cat([-torch.diag_embed(D), _t(L)], dim=-1),
                      torch.cat([L, theta[:, None, None] * SS], dim=-1)], dim=-2)
    Minv = torch.linalg.inv(Mmat)                                      # [B, 2m, 2m]
    W = _t(torch.cat([Y * v[:, :, None], theta[:, None, None] * S * v[:, :, None]], dim=1))
    return theta, W, Minv


def _cauchy_point(x, g, lower, upper, theta, W, Minv):
    """The generalized Cauchy point of every lane (BLNZ algorithm CP,
    sec. 4): (xcp [B, n], c = W^T (xcp - x) [B, 2m], free [B, n])."""
    B, n = x.shape
    dtype, dev = x.dtype, x.device
    eps = torch.tensor(torch.finfo(dtype).tiny * 1e4, dtype=dtype, device=dev)
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    lanes = torch.arange(B, device=dev)

    d0 = -g
    bound_gap = torch.where(d0 > 0, upper - x, lower - x)               # signed gap
    nz = d0 != 0
    t_raw = torch.where(nz, bound_gap / torch.where(nz, d0, torch.ones_like(d0)), big)
    t_raw = torch.where(torch.isfinite(t_raw), t_raw, big)
    at_bound = nz & (t_raw <= 0)
    d0 = torch.where(at_bound | ~nz, zero, d0)
    t = torch.where(d0 != 0, t_raw, big)                               # breakpoints

    order = torch.argsort(t, dim=-1, stable=True)

    p = matvec(_t(W), d0)                                              # [B, 2m]
    c = torch.zeros_like(p)
    fp = -lane_dot(d0, d0)
    fpp = -theta * fp - lane_dot(p, matvec(Minv, p))
    fpp = torch.maximum(fpp, eps)

    d, t_old = d0, torch.zeros_like(fp)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    for k in range(n):
        b = order[:, k]
        t_b = t[lanes, b]
        dt = t_b - t_old
        dt_min = -fp / fpp
        # the minimizer inside the current segment, the path exhausted, or
        # already non-descent: stop before this breakpoint
        stop_here = stopped | (dt_min < dt) | (t_b >= big) | (fp >= 0)

        gb = g[lanes, b]
        zb = torch.where(d0[lanes, b] > 0, upper[lanes, b], lower[lanes, b]) - x[lanes, b]
        wb = W[lanes, b]                                               # [B, 2m]
        c_new = c + dt[:, None] * p
        Mc = matvec(Minv, c_new)
        Mp = matvec(Minv, p)
        fp_new = (fp + dt * fpp + gb * gb + theta * gb * zb - gb * lane_dot(wb, Mc))
        fpp_new = (fpp - theta * gb * gb - 2.0 * gb * lane_dot(wb, Mp)
                   - gb * gb * lane_dot(wb, matvec(Minv, wb)))
        fpp_new = torch.maximum(fpp_new, eps)
        p_new = p + gb[:, None] * wb
        d_new = d.index_put((lanes, b), zero.expand(B))

        active = ~stop_here
        d = torch.where(active[:, None], d_new, d)
        p = torch.where(active[:, None], p_new, p)
        c = torch.where(active[:, None], c_new, c)
        fp = torch.where(active, fp_new, fp)
        fpp = torch.where(active, fpp_new, fpp)
        t_old = torch.where(active, t_b, t_old)
        stopped = stop_here

    dt_min = torch.clamp(-fp / fpp, min=0.0)
    t_cp = t_old + dt_min
    xcp = x + torch.minimum(t_cp[:, None], t) * d0
    xcp = torch.clamp(xcp, lower, upper)
    c_final = c + dt_min[:, None] * p
    # free at the Cauchy point: breakpoint not yet reached and not pinned at
    # a bound with the gradient pushing outward
    free = (t > t_cp[:, None]) & ~at_bound & torch.isfinite(t_cp)[:, None]
    return xcp, c_final, free


def _subspace_step(x, g, xcp, c, free, lower, upper, theta, W, Minv):
    """Direct primal subspace minimization of every lane (BLNZ sec. 5.1,
    SMW form) over the variables free at the Cauchy point, masked; xbar is
    clipped to the box by the alpha* backtrack toward xcp."""
    dtype, dev = x.dtype, x.device
    F = free.to(dtype)
    twom = W.shape[-1]
    th = theta[:, None]

    # reduced gradient of the quadratic at xcp
    r = (g + th * (xcp - x) - matvec(W, matvec(Minv, c))) * F
    k = matvec(Minv, matvec(_t(W), r))
    WF = W * F[:, :, None]
    N = torch.eye(twom, dtype=dtype, device=dev) - (Minv @ (_t(W) @ WF)) / theta[:, None, None]
    v = torch.linalg.solve(N, k[..., None])[..., 0]
    du = -(r / th + matvec(WF, v) / th**2) * F

    # alpha*: the largest step in [0, 1] keeping xcp + alpha du in the box
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    gap = torch.where(du > 0, upper - xcp, lower - xcp)
    nz = du != 0
    ratio = torch.where(nz, gap / torch.where(nz, du, torch.ones_like(du)), inf)
    ratio = torch.where(torch.isnan(ratio), inf, ratio)
    alpha_star = torch.clamp(ratio.amin(dim=-1), 0.0, 1.0)
    return torch.clamp(xcp + alpha_star[:, None] * du, lower, upper)


def init(fn, x0: torch.Tensor, config: LBFGSBConfig = LBFGSBConfig(), *, data=None) -> LBFGSBState:
    lanes = as_lanes(fn, data)
    B, n = x0.shape
    m = config.memory
    g = lanes.map(lambda f: make_grad(f, n, config.deriv)[0], x0)
    i32 = torch.int32
    zeros = lambda *shape: torch.zeros(shape, dtype=x0.dtype, device=x0.device)  # noqa: E731
    return LBFGSBState(
        x=x0,
        gradient=g,
        f_prev=lane_full(x0, float("inf")),
        s_hist=zeros(B, m, n),
        y_hist=zeros(B, m, n),
        valid=torch.zeros((B, m), dtype=torch.bool, device=x0.device),
        head=lane_full(x0, 0, i32),
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, grad_cost(n, config.deriv), i32),
        gfev=lane_full(x0, 1, i32),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def step(fn, state: LBFGSBState, config: LBFGSBConfig, lower, upper, *,
         data=None) -> LBFGSBState:
    lanes = as_lanes(fn, data)
    n = state.x.shape[-1]
    m = config.memory
    dtype, dev = state.x.dtype, state.x.device
    grad_point = lambda f: make_grad(f, n, config.deriv)[0]  # noqa: E731
    g_cost = grad_cost(n, config.deriv)

    x, g = state.x, state.gradient
    f0 = lanes.values(x)
    # scipy's convergence: the sup-norm of the projected gradient, or the
    # relative f-change below factr times f64's eps, floored at one ulp of
    # the iterate dtype
    pg = torch.clamp(x - g, lower, upper) - x
    pg_norm = pg.abs().amax(dim=-1)
    hit_tol = pg_norm < config.pg_eps
    f_scale = torch.clamp(torch.maximum(state.f_prev.abs(), f0.abs()), min=1.0)
    if config.factr > 0:
        ftol_rel = max(config.factr * 2.220446049250313e-16, float(torch.finfo(dtype).eps))
    else:
        ftol_rel = 0.0
    hit_ftol = torch.isfinite(state.f_prev) & ((state.f_prev - f0) <= ftol_rel * f_scale)
    done_now = ((state.iteration >= config.max_iter) | hit_tol | hit_ftol
                | ~torch.isfinite(pg_norm))

    theta, W, Minv = _compact_rep(state.s_hist, state.y_hist, state.valid, state.head)
    xcp, c, free = _cauchy_point(x, g, lower, upper, theta, W, Minv)
    xbar = _subspace_step(x, g, xcp, c, free, lower, upper, theta, W, Minv)

    # fall back to the Cauchy direction, then to the projected gradient,
    # wherever the subspace step loses descent
    d = xbar - x
    dg = lane_dot(g, d)
    d = torch.where((dg < 0)[:, None], d, xcp - x)
    dg = lane_dot(g, d)
    d = torch.where((dg < 0)[:, None], d, pg)

    # the largest feasible step along d (xbar is feasible, so >= 1)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    gap = torch.where(d > 0, upper - x, lower - x)
    nz = d != 0
    ratio = torch.where(nz, gap / torch.where(nz, d, torch.ones_like(d)), inf)
    ratio = torch.where(torch.isnan(ratio), inf, ratio)
    alpha_max = torch.clamp(ratio.amin(dim=-1), 1.0, 1e10)

    ls = more_thuente_fleet(lanes.columns(), lanes.columns(grad_point), x.T, f0, g.T, d.T,
                            config.alpha, alpha_max=alpha_max)
    new_x = torch.clamp(x + ls.alpha[:, None] * d, lower, upper)
    s = new_x - x
    new_g = lanes.map(grad_point, new_x)
    y = new_g - g

    ys = lane_dot(y, s)
    yy = lane_dot(y, y)
    good_pair = ys > torch.finfo(dtype).eps * yy
    idx = (state.head % m).long()
    worked = LBFGSBState(
        x=new_x,
        gradient=new_g,
        f_prev=f0,
        s_hist=_set_slot(state.s_hist, idx, good_pair, s),
        y_hist=_set_slot(state.y_hist, idx, good_pair, y),
        valid=_set_slot(state.valid, idx, good_pair, good_pair | _slot(state.valid, idx)),
        head=torch.where(good_pair, state.head + 1, state.head),
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + ls.nfev * (1 + g_cost) + g_cost,
        gfev=state.gfev + ls.nfev + 1,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    halted = state._replace(done=torch.ones_like(state.done), converged=hit_tol | hit_ftol)
    return where_lanes(done_now, halted, worked)


def box(bounds: Optional[Bounds], x0: torch.Tensor):
    """``(lower, upper)`` broadcast to ``x0 [B, n]``; without bounds
    +-max/4 of the dtype."""
    if bounds is None:
        big = torch.finfo(x0.dtype).max / 4
        return torch.full_like(x0, -big), torch.full_like(x0, big)
    return lbfgs_box(bounds, x0)


def _run(lanes: Lanes, x0, config: LBFGSBConfig, _minimize: bool, bounds=None) -> SolverResult:
    lower, upper = box(bounds, x0)
    x0 = torch.clamp(x0, lower, upper)
    state = init(lanes, x0, config)
    state = drive(lambda s: step(lanes, s, config, lower, upper), state, check_every=1)
    return finalize(lanes, state, not _minimize, function_calls=state.nfev + 1,
                    gradient_calls=state.gfev)


def minimize_batched(fn, x0: torch.Tensor, config: LBFGSBConfig = LBFGSBConfig(),
                     bounds: Optional[Bounds] = None, *, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]``: ``jax.vmap`` of the JAX ``minimize``;
    ``bounds`` broadcast to ``[B, n]``."""
    return run_batched(_run, fn, x0, config, data, _minimize, bounds)


def minimize(fn, x0: torch.Tensor, config: LBFGSBConfig = LBFGSBConfig(),
             bounds: Optional[Bounds] = None, *, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the lane engine at B = 1, squeezed."""
    return run_single(_run, fn, x0, config, data, _minimize, bounds)


def maximize(fn, x0, config: LBFGSBConfig = LBFGSBConfig(), bounds=None, *, data=None):
    return minimize(fn, x0, config, bounds, data=data, _minimize=False)
