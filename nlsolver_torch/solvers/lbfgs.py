"""Limited-memory BFGS with an optional box projection, on lane tensors
(counterpart of ``nlsolver_tpu.solvers.lbfgs``).

The two-loop recursion over a static ring of ``memory`` (s, y) pairs with a
validity mask, More-Thuente from ``alpha``, and the simple projected-
gradient box mode (iterates clipped to the box, gradient components that
push outside an active bound zeroed).  The layout is the lane layout of
``solvers.bfgs``: ``x [B, n]``, the rings ``[B, m, n]``, every scalar a
``[B]`` vector; each lane reads its own ring slot by a gather, as the
vmapped ``lax.fori_loop`` does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, drive, where_lanes
from ..core.lanes import Lanes, as_lanes, lane_dot, lane_norm
from ..deriv import Deriv, make_grad
from ..linesearch.more_thuente import more_thuente_fleet
from ._lane import finalize, grad_cost, lane_full, run_batched, run_single


@dataclass(frozen=True)
class LBFGSConfig:
    memory: int = 10
    max_iter: int = 200
    grad_eps: float = 1e-8
    alpha: float = 1.0
    deriv: Deriv = field(default_factory=Deriv)


class LBFGSState(NamedTuple):
    x: torch.Tensor          # [B, n]
    gradient: torch.Tensor   # [B, n]
    s_hist: torch.Tensor     # [B, m, n]
    y_hist: torch.Tensor     # [B, m, n]
    rho_hist: torch.Tensor   # [B, m]
    valid: torch.Tensor      # [B, m] bool
    head: torch.Tensor       # [B] int32, ring insert position
    iteration: torch.Tensor  # [B] int32
    nfev: torch.Tensor       # [B] int32
    gfev: torch.Tensor       # [B] int32
    done: torch.Tensor       # [B] bool
    converged: torch.Tensor  # [B] bool


def _slot(ring: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each lane's entry ``idx[b]`` of ``ring [B, m, ...]``."""
    return ring[torch.arange(ring.shape[0], device=ring.device), idx.long()]


def two_loop_direction(g, s_hist, y_hist, rho_hist, valid, head):
    """Two-loop recursion d = -H g over each lane's ring-ordered, masked
    history: g [B, n], rings [B, m, n], rho_hist / valid [B, m], head [B]."""
    m = s_hist.shape[1]
    lanes = torch.arange(g.shape[0], device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    q = g
    alphas = torch.zeros(rho_hist.shape, dtype=g.dtype, device=g.device)
    # newest -> oldest: slots head-1, head-2, ...
    for i in range(m):
        idx = (head - 1 - i) % m
        alpha = torch.where(_slot(valid, idx),
                            _slot(rho_hist, idx) * lane_dot(_slot(s_hist, idx), q), zero)
        q = q - alpha[:, None] * _slot(y_hist, idx)
        alphas = alphas.index_put((lanes, idx.long()), alpha)
    # initial Hessian scaling gamma = s.y / y.y of the newest pair
    newest = (head - 1) % m
    s_new, y_new = _slot(s_hist, newest), _slot(y_hist, newest)
    ys = lane_dot(s_new, y_new)
    yy = lane_dot(y_new, y_new)
    gamma = torch.where(_slot(valid, newest) & (yy > 0), ys / yy, torch.ones_like(ys))
    r = gamma[:, None] * q
    # oldest -> newest
    for i in range(m):
        idx = (head + i) % m
        beta = torch.where(_slot(valid, idx),
                           _slot(rho_hist, idx) * lane_dot(_slot(y_hist, idx), r), zero)
        r = r + (_slot(alphas, idx) - beta)[:, None] * _slot(s_hist, idx)
    return -r


def init(fn, x0: torch.Tensor, config: LBFGSConfig = LBFGSConfig(), *, data=None) -> LBFGSState:
    lanes = as_lanes(fn, data)
    B, n = x0.shape
    m = config.memory
    g = lanes.map(lambda f: make_grad(f, n, config.deriv)[0], x0)
    i32 = torch.int32
    zeros = lambda *shape: torch.zeros(shape, dtype=x0.dtype, device=x0.device)  # noqa: E731
    return LBFGSState(
        x=x0,
        gradient=g,
        s_hist=zeros(B, m, n),
        y_hist=zeros(B, m, n),
        rho_hist=zeros(B, m),
        valid=torch.zeros((B, m), dtype=torch.bool, device=x0.device),
        head=lane_full(x0, 0, i32),
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, grad_cost(n, config.deriv), i32),
        gfev=lane_full(x0, 1, i32),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def _set_slot(ring, idx, good, value):
    """``ring`` with each lane's slot ``idx[b]`` set to ``value[b]`` where
    ``good[b]`` holds (kept where it does not)."""
    lanes = torch.arange(ring.shape[0], device=ring.device)
    old = ring[lanes, idx]
    keep = good.reshape(good.shape + (1,) * (old.ndim - 1))
    return ring.index_put((lanes, idx), torch.where(keep, value, old))


def step(fn, state: LBFGSState, config: LBFGSConfig = LBFGSConfig(), lower=None, upper=None,
         *, data=None) -> LBFGSState:
    lanes = as_lanes(fn, data)
    n = state.x.shape[-1]
    m = config.memory
    grad_point = lambda f: make_grad(f, n, config.deriv)[0]  # noqa: E731
    g_cost = grad_cost(n, config.deriv)
    bounded = lower is not None

    g = state.gradient
    if bounded:
        # projected gradient: zero the components pushing outside the active box
        at_lo = (state.x <= lower) & (g > 0)
        at_hi = (state.x >= upper) & (g < 0)
        pg = torch.where(at_lo | at_hi, torch.zeros_like(g), g)
    else:
        pg = g
    grad_norm = lane_norm(pg)

    hit_tol = grad_norm < config.grad_eps
    done_now = (state.iteration >= config.max_iter) | hit_tol | torch.isinf(grad_norm)

    d = two_loop_direction(pg, state.s_hist, state.y_hist, state.rho_hist, state.valid, state.head)
    # safeguard: steepest descent on loss of descent
    descent = lane_dot(pg, d) < 0
    d = torch.where(descent[:, None], d, -pg)

    f0 = lanes.values(state.x)
    ls = more_thuente_fleet(lanes.columns(), lanes.columns(grad_point), state.x.T, f0, g.T, d.T,
                            config.alpha)
    s = ls.alpha[:, None] * d
    new_x = state.x + s
    if bounded:
        new_x = torch.clamp(new_x, lower, upper)
        s = new_x - state.x
    new_g = lanes.map(grad_point, new_x)
    y = new_g - g

    ys = lane_dot(y, s)
    good_pair = ys > 1e-10
    idx = (state.head % m).long()
    worked = LBFGSState(
        x=new_x,
        gradient=new_g,
        s_hist=_set_slot(state.s_hist, idx, good_pair, s),
        y_hist=_set_slot(state.y_hist, idx, good_pair, y),
        rho_hist=_set_slot(state.rho_hist, idx, good_pair, 1.0 / ys),
        valid=_set_slot(state.valid, idx, good_pair, good_pair | _slot(state.valid, idx)),
        head=torch.where(good_pair, state.head + 1, state.head),
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + ls.nfev * (1 + g_cost) + g_cost,
        gfev=state.gfev + ls.nfev + 1,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    halted = state._replace(done=torch.ones_like(state.done), converged=hit_tol)
    return where_lanes(done_now, halted, worked)


def box(bounds: Optional[Bounds], x0: torch.Tensor):
    """``(lower, upper)`` broadcast to ``x0 [B, n]``, or ``(None, None)``."""
    if bounds is None:
        return None, None
    return tuple(torch.as_tensor(v, dtype=x0.dtype, device=x0.device).expand_as(x0)
                 for v in (bounds.lower, bounds.upper))


def _run(lanes: Lanes, x0, config: LBFGSConfig, _minimize: bool, bounds=None) -> SolverResult:
    lower, upper = box(bounds, x0)
    if lower is not None:
        x0 = torch.clamp(x0, lower, upper)
    state = init(lanes, x0, config)
    state = drive(lambda s: step(lanes, s, config, lower, upper), state, check_every=1)
    return finalize(lanes, state, not _minimize, function_calls=state.nfev + 1,
                    gradient_calls=state.gfev)


def minimize_batched(fn, x0: torch.Tensor, config: LBFGSConfig = LBFGSConfig(),
                     bounds: Optional[Bounds] = None, *, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]``: ``jax.vmap`` of the JAX ``minimize``;
    ``bounds`` broadcast to ``[B, n]``."""
    return run_batched(_run, fn, x0, config, data, _minimize, bounds)


def minimize(fn, x0: torch.Tensor, config: LBFGSConfig = LBFGSConfig(),
             bounds: Optional[Bounds] = None, *, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the lane engine at B = 1, squeezed."""
    return run_single(_run, fn, x0, config, data, _minimize, bounds)


def maximize(fn, x0, config: LBFGSConfig = LBFGSConfig(), bounds=None, *, data=None):
    return minimize(fn, x0, config, bounds, data=data, _minimize=False)
