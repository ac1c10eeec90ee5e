"""Nelder-Mead / PSO hybrid on lane tensors (counterpart of
``nlsolver_tpu.solvers.nmpso``; the reference's ``NelderMeadPSO``,
nlsolver.h:3546-3920).

3n+1 particles; each iteration ranks them (a stable sort, as
``jnp.argsort``), applies one Nelder-Mead update to the top n+1 (the
textbook contraction orientation, ``simplex_transform<reflect=false>``)
and a pairwise-best PSO update to the other 2n.  Implied bounds
+-|2.5 x_i| seed the PSO particles when no ``bounds`` are given and clamp
nothing (nlsolver.h:3585-3592).  The JAX solver's fixes of the reference
hold here too: velocities persist, the pair best is the better-ranked
member of each sorted pair, the stagnation counter compares with the
previous iteration's best, and given bounds clamp positions per
dimension.  Termination (nlsolver.h:3664-3669): max_iter, the best value
unchanged for ``no_change_best_iter`` iterations, or the sample std over
the simplex's values below eps.  It needs n >= 2.

The JAX solver keeps one population ``[3n+1, n]`` and is batched with
``jax.vmap``.  Here every lane runs at once: positions ``[B, 3n+1, n]``,
every scalar a ``[B]`` vector; ``core.drive`` freezes the lanes done when a
step begins.  As under ``jax.vmap``, the step computes the Nelder-Mead
branches of every lane and selects per lane (``nelder_mead.move``),
counting only the taken branch's evaluations.

Randomness is explicit: ``init`` takes ``InitDraws`` and ``step``
``StepDraws`` (the PSO uniforms r_p, r_g ``[B, 2n, n]``), or they draw from
a ``torch.Generator``; ``minimize_batched`` takes a run's draws
(``_lane.Draws``, lane b reading row ``iteration[b]``).  The state has no
key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, clamp, drive, resolve_bounds, std_err, where_lanes
from ..core.lanes import Lanes, as_lanes
from ._lane import (Draws, draws_on, gather_lanes, gather_rows, lane_full, lane_result, one_lane,
                    run_batched, run_single, step_rows, true_div)
from .nelder_mead import init_simplex, move, vertex_sum


@dataclass(frozen=True)
class NMPSOConfig:
    """Defaults from nlsolver.h:3563-3569."""

    alpha: float = 1.0
    gamma: float = 2.0
    rho: float = 0.5
    sigma: float = 0.5
    inertia: float = 0.8
    cognitive_coef: float = 1.8
    social_coef: float = 1.8
    eps: float = 1e-6
    max_iter: int = 1000
    no_change_best_iter: int = 20


class NMPSOState(NamedTuple):
    positions: torch.Tensor   # [B, 3n+1, n]
    velocities: torch.Tensor  # [B, 3n+1, n]
    values: torch.Tensor      # [B, 3n+1]
    best_value: torch.Tensor  # [B]
    iteration: torch.Tensor   # [B] int32
    nfev: torch.Tensor        # [B] int32
    no_change: torch.Tensor   # [B] int32
    done: torch.Tensor        # [B] bool
    converged: torch.Tensor   # [B] bool


class InitDraws(NamedTuple):
    u: torch.Tensor    # [B, 2n, n] uniforms of the PSO particles' positions
    uv: torch.Tensor   # [B, 2n, n] uniforms of their velocities


class StepDraws(NamedTuple):
    r_p: torch.Tensor  # [B, 2n, n] cognitive uniforms
    r_g: torch.Tensor  # [B, 2n, n] social uniforms


def _uniforms(B, n, like, generator, cls):
    if generator is None:
        raise ValueError("init and step need draws= or generator=")
    return cls(*(torch.rand((B, 2 * n, n), generator=generator, dtype=like.dtype,
                            device=like.device) for _ in range(2)))


def init(fn, x0: torch.Tensor, config: NMPSOConfig, lower: torch.Tensor, upper: torch.Tensor, *,
         generator: Optional[torch.Generator] = None, draws: Optional[InitDraws] = None,
         data=None) -> NMPSOState:
    """The Gao/Han simplex of every lane of ``x0 [B, n]`` and 2n PSO
    particles uniform in [lower, upper) (``[B, n]``)."""
    lanes = as_lanes(fn, data)
    B, n = x0.shape
    if n < 2:
        raise ValueError(
            "NelderMeadPSO requires dimension >= 2 (nlsolver.h:3627-3636); "
            "use NelderMead or PSO for 1-D problems"
        )
    if draws is None:
        draws = _uniforms(B, n, x0, generator, InitDraws)
    simplex = init_simplex(x0, -1.0)  # Gao/Han (nlsolver.h:3703-3724)
    pso_pos = lower[:, None] + (upper - lower)[:, None] * draws.u
    positions = torch.cat([simplex, pso_pos], dim=1)
    span = (upper - lower).abs()
    pso_vel = span[:, None] * (2.0 * draws.uv - 1.0)
    velocities = torch.cat([torch.zeros_like(simplex), pso_vel], dim=1)
    values = lanes.points(positions)
    i32 = torch.int32
    return NMPSOState(
        positions=positions,
        velocities=velocities,
        values=values,
        best_value=values.amin(dim=1),
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, positions.shape[1], i32),
        no_change=lane_full(x0, 0, i32),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def _put(a: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``a`` with rows ``idx [B, K]`` of each lane set to ``rows``."""
    return torch.scatter(a, 1, idx.reshape(idx.shape + (1,) * (a.ndim - 2)).expand(rows.shape),
                         rows)


def step(fn, state: NMPSOState, config: NMPSOConfig, lower: torch.Tensor, upper: torch.Tensor,
         bounded: bool, *, draws: Optional[StepDraws] = None,
         generator: Optional[torch.Generator] = None, data=None) -> NMPSOState:
    lanes = as_lanes(fn, data)
    B, P, n = state.positions.shape
    n_simplex = n + 1

    order = torch.argsort(state.values, dim=1, stable=True)
    best_now = gather_lanes(state.values, order[:, 0])
    no_change = torch.where(best_now == state.best_value, state.no_change + 1, 0)
    simplex_vals = gather_rows(state.values, order[:, :n_simplex])
    hit_tol = (no_change >= config.no_change_best_iter) | (
        std_err(simplex_vals, dim=1) < config.eps
    )
    done_now = (state.iteration >= config.max_iter) | hit_tol

    def _clamp(x):
        """``x [B, n]`` or ``[B, K, n]`` into the box when it is given."""
        if not bounded:
            return x
        return clamp(x, lower, upper) if x.ndim == 2 else clamp(x, lower[:, None], upper[:, None])

    # Nelder-Mead on the ranked top n+1 (nlsolver.h:3742-3823)
    positions, values = state.positions, state.values
    best_id, worst_id = order[:, 0], order[:, n_simplex - 1]
    f_best = gather_lanes(values, best_id)
    f_second = gather_lanes(values, order[:, n_simplex - 2])
    f_worst = gather_lanes(values, worst_id)
    x_worst = gather_lanes(positions, worst_id)
    centroid = true_div(vertex_sum(gather_rows(positions, order[:, :n_simplex - 1])), n)

    x_best = gather_lanes(positions, best_id)
    ranked_ids = order[:, 1:n_simplex]
    shrunk_pts = x_best[:, None] + config.sigma * (gather_rows(positions, ranked_ids)
                                                   - x_best[:, None])
    # textbook orientation: simplex_transform<reflect=false> computes
    # c + rho*(point - c) (nlsolver.h:3786-3796)
    m = move(lanes, config, centroid, x_worst, f_best, f_second, f_worst, shrunk_pts, _clamp,
             min_threshold=True)
    worst_only = worst_id[:, None]
    positions = torch.where(m.shrink[:, None, None], _put(positions, ranked_ids, shrunk_pts),
                            _put(positions, worst_only, m.point[:, None]))
    values = torch.where(m.shrink[:, None], _put(values, ranked_ids, m.shrunk_scores),
                         _put(values, worst_only, m.score[:, None]))

    # PSO on the other 2n ranked particles (nlsolver.h:3824-3867)
    pso_ids = order[:, n_simplex:]                                   # [B, 2n]
    offsets = torch.arange(2 * n, device=order.device)
    pair_best_ids = pso_ids[:, 2 * (offsets // 2)]                   # the better of each pair
    global_best = gather_lanes(positions, values.argmin(dim=1))
    if draws is None:
        draws = _uniforms(B, n, positions, generator, StepDraws)
    cur = gather_rows(positions, pso_ids)
    new_vel = (
        config.inertia * gather_rows(state.velocities, pso_ids)
        + config.cognitive_coef * draws.r_p * (gather_rows(positions, pair_best_ids) - cur)
        + config.social_coef * draws.r_g * (global_best[:, None] - cur)
    )
    new_pos = _clamp(cur + new_vel)
    new_vals = lanes.points(new_pos)

    worked = NMPSOState(
        positions=_put(positions, pso_ids, new_pos),
        velocities=_put(state.velocities, pso_ids, new_vel),
        values=_put(values, pso_ids, new_vals),
        best_value=best_now,
        iteration=state.iteration + 1,
        nfev=state.nfev + m.evals + 2 * n,
        no_change=no_change,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    halted = state._replace(best_value=best_now, no_change=no_change,
                            done=torch.ones_like(state.done), converged=hit_tol)
    return where_lanes(done_now, halted, worked)


def _finalize(state: NMPSOState, flip_sign: bool) -> SolverResult:
    best = state.values.argmin(dim=1)
    return lane_result(gather_lanes(state.positions, best), gather_lanes(state.values, best), state,
                       flip_sign)


# iterations between two reads of done.all()
CHECK_EVERY = 16


def _run(lanes: Lanes, x0: torch.Tensor, config: NMPSOConfig, _minimize: bool, bounds, draws,
         generator) -> SolverResult:
    if draws is None and generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    draws = draws_on(draws, x0.device)
    lower, upper, bounded = resolve_bounds(bounds, x0)
    if not bounded:
        t = (2.5 * x0).abs()   # implied bounds (nlsolver.h:3585-3592)
        lower, upper = -t, t
    state = init(lanes, x0, config, lower, upper, generator=generator,
                 draws=None if draws is None else draws.init)

    def advance(s):
        return step(lanes, s, config, lower, upper, bounded, generator=generator,
                    draws=None if draws is None else step_rows(draws.steps, s.iteration))

    state = drive(advance, state, check_every=CHECK_EVERY)
    return _finalize(state, flip_sign=not _minimize)


def minimize_batched(fn, x0: torch.Tensor, config: NMPSOConfig = NMPSOConfig(),
                     bounds: Optional[Bounds] = None, *, draws: Optional[Draws] = None,
                     generator: Optional[torch.Generator] = None, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]``: ``jax.vmap`` of the JAX ``minimize``;
    ``bounds`` broadcast against ``x0``.  The draws come from ``draws``
    (``Draws(InitDraws [B, 2n, n], StepDraws of [T, B, 2n, n])``) or from
    ``generator`` (on ``x0``'s device, seed 0 by default)."""
    return run_batched(_run, fn, x0, config, data, _minimize, bounds, draws, generator)


def minimize(fn, x0: torch.Tensor, config: NMPSOConfig = NMPSOConfig(),
             bounds: Optional[Bounds] = None, *, draws: Optional[Draws] = None,
             generator: Optional[torch.Generator] = None, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the lane engine at B = 1, squeezed; ``draws``
    without the lane axis."""
    return run_single(_run, fn, x0, config, data, _minimize, bounds, one_lane(draws), generator)


def maximize(fn, x0, config: NMPSOConfig = NMPSOConfig(), bounds=None, *, draws=None,
             generator=None, data=None):
    return minimize(fn, x0, config, bounds, draws=draws, generator=generator, data=data,
                    _minimize=False)
