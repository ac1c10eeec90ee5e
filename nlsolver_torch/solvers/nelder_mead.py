"""Nelder-Mead simplex solver on lane tensors (counterpart of
``nlsolver_tpu.solvers.nelder_mead``; the reference's ``NelderMead``,
nlsolver.h:2099-2300), the default method of ``minimize``.

The JAX solver keeps one simplex ``[n+1, n]`` and is batched with
``jax.vmap``.  Here every lane of a batch runs at once: simplices
``[B, n+1, n]``, scores ``[B, n+1]``, every scalar a ``[B]`` vector, the
layout ``jax.vmap`` gives the JAX solver.  ``core.drive`` freezes the lanes
that are done when a step begins, as a vmapped ``lax.while_loop`` does.

The step is the JAX solver's: the reference's 4-way accept / expand /
contract / shrink branch (nlsolver.h:2251-2296) and its composite stop
(max_iter, sample std of the scores below the rescaled eps, or the best
vertex unchanged for ``no_change_best_tol`` iterations).  Under
``jax.vmap`` the ``lax.switch`` and ``lax.cond`` of the branches run every
branch and select per lane; so does this step: it scores the expanded and
contracted points and the shrunk simplex of every lane in one evaluation
and selects, and counts only the taken branch's evaluations (2, 1, 2 or
1 + (n+1), as the JAX solver does).

``variant="reference"`` keeps the reference's quirks (its "second worst",
its contraction's orientation, its off-by-one initial simplex and its
cached centroid, summed vertex by vertex in index order); see
``NelderMeadConfig``.  The solver draws nothing, and takes no
``generator``.  ``move``, the branch update, is NM-PSO's too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, clamp, drive, resolve_bounds, std_err, where_lanes
from ..core.lanes import Lanes, as_lanes
from ._lane import gather_lanes, lane_full, lane_result, run_batched, run_single, true_div


@dataclass(frozen=True)
class NelderMeadConfig:
    """Hyperparameters with the reference's defaults (nlsolver.h:2110-2115)."""

    step: float = -1.0          # <0 => Gao/Han auto-initialization
    alpha: float = 1.0          # reflection
    gamma: float = 2.0          # expansion
    rho: float = 0.5            # contraction
    sigma: float = 0.5          # shrink
    eps: float = 1e-6
    max_iter: int = 500
    no_change_best_tol: int = 20
    restarts: int = 0
    # "textbook" (default): standard Nelder-Mead branch logic.
    # "reference": trajectory-level parity with the reference's quirks:
    #   * its "second worst" is the previous running-max index at the last
    #     worst-update (nlsolver.h:2217-2219);
    #   * its contraction computes c + rho*(c - point) (nlsolver.h:2266-2275);
    #   * its simplex init is off by one: vertex i perturbs dimension i for
    #     i = 1..n-1 and vertex n stays at x (nlsolver.h:1929-1931);
    #   * the centroid is recomputed only when the worst index changed or
    #     after a shrink (nlsolver.h:2240-2243), from a ZERO vector and
    #     prev_worst = 0 (nlsolver.h:2191-2197).
    variant: str = "textbook"


class NMState(NamedTuple):
    simplex: torch.Tensor         # [B, n+1, n]
    scores: torch.Tensor          # [B, n+1]
    iteration: torch.Tensor       # [B] int32
    nfev: torch.Tensor            # [B] int32
    last_best: torch.Tensor       # [B] int32
    no_change_iter: torch.Tensor  # [B] int32
    eps: torch.Tensor             # [B] rescaled tolerance (nlsolver.h:2189)
    centroid: torch.Tensor        # [B, n] cached centroid (reference variant only)
    prev_worst: torch.Tensor      # [B] int32, worst index of the previous iteration
    shrunk: torch.Tensor          # [B] bool, the previous iteration ended in a shrink
    done: torch.Tensor            # [B] bool
    converged: torch.Tensor       # [B] bool


def init_simplex(x0: torch.Tensor, step: float, variant: str = "textbook") -> torch.Tensor:
    """Gao/Han (or fixed-step) initial simplex of every point ``x0 [..., n]``:
    ``[..., n+1, n]`` (nlsolver.h:1910-1947).  The scale is
    ``clip(max |x0|, 1, 10)``; vertex 0 is ``x0 + (1 - sqrt(n+1)) / n *
    scale``.  ``variant="reference"`` reproduces the reference's off-by-one
    perturbation: vertex i spans dimension i (not i-1) and vertex n stays
    at x (nlsolver.h:1929-1931, 1941-1943)."""
    n = x0.shape[-1]
    pert = torch.zeros((n, n), dtype=x0.dtype, device=x0.device)
    if variant == "reference":
        if n > 1:
            idx = torch.arange(n - 1, device=x0.device)
            pert[idx, idx + 1] = 1.0
    else:
        pert = torch.eye(n, dtype=x0.dtype, device=x0.device)
    if step < 0:
        scale = x0.abs().amax(dim=-1).clamp(1.0, 10.0)[..., None]
        vertices = x0[..., None, :] + scale[..., None] * pert
        v0 = x0 + (1.0 - math.sqrt(n + 1.0)) / n * scale
        return torch.cat([v0[..., None, :], vertices], dim=-2)
    vertices = x0[..., None, :] + torch.tensor(step, dtype=x0.dtype, device=x0.device) * pert
    return torch.cat([x0[..., None, :], vertices], dim=-2)


def init(fn, x0: torch.Tensor, config: NelderMeadConfig = NelderMeadConfig(), *,
         data=None) -> NMState:
    lanes = as_lanes(fn, data)
    simplex = init_simplex(x0, config.step, config.variant)
    scores = lanes.points(simplex)
    # relative tolerance rescale by the first vertex's score (nlsolver.h:2189:
    # eps = eps * (scores[0] * eps)), in the JAX package's order; for
    # scores[0] < 0 it is negative and the spread test never fires
    eps = lane_full(x0, config.eps, scores.dtype)
    eps = eps * scores[:, 0] * eps
    i32 = torch.int32
    return NMState(
        simplex=simplex,
        scores=scores,
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, simplex.shape[1], i32),
        last_best=lane_full(x0, -1, i32),
        no_change_iter=lane_full(x0, 0, i32),
        eps=eps,
        centroid=torch.zeros_like(x0),
        prev_worst=lane_full(x0, 0, i32),
        shrunk=lane_full(x0, False, torch.bool),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def _second_worst_score(scores: torch.Tensor, worst: torch.Tensor) -> torch.Tensor:
    """The true second-worst score of each lane (textbook variant)."""
    idx = torch.arange(scores.shape[1], device=scores.device)
    return torch.where(idx == worst[:, None], -math.inf, scores).amax(dim=1)


def _reference_second_worst_score(scores: torch.Tensor, worst: torch.Tensor) -> torch.Tensor:
    """The reference's "second worst": its single-pass scan updates
    ``second_worst`` only when a new running maximum is found
    (nlsolver.h:2217-2219), so it ends with the max over the strict prefix
    before the (first) argmax, and scores[0] when the argmax is index 0."""
    idx = torch.arange(scores.shape[1], device=scores.device)
    prefix = torch.where(idx < worst[:, None], scores, -math.inf).amax(dim=1)
    return torch.where(worst == 0, scores[:, 0], prefix)


def vertex_sum(points: torch.Tensor) -> torch.Tensor:
    """``[B, K, n] -> [B, n]``: the K points added in index order, the
    order of the JAX package's sum on the host.  A ``.sum(dim=1)`` adds
    them in another order on the card in float32, whose last bit then
    steers the simplex: K launches of one add buy the same sums on every
    device."""
    acc = points[:, 0]
    for i in range(1, points.shape[1]):
        acc = acc + points[:, i]
    return acc


def _set_row(a: torch.Tensor, idx: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``a`` with row ``idx[b]`` of lane b set to ``row[b]`` (``a.at[idx].set``)."""
    hit = torch.arange(a.shape[1], device=a.device) == idx[:, None]
    return torch.where(hit.reshape(hit.shape + (1,) * (a.ndim - 2)), row[:, None], a)


class Move(NamedTuple):
    """One Nelder-Mead update of every lane, its branch chosen per lane."""

    point: torch.Tensor          # [B, n] the vertex that replaces the worst
    score: torch.Tensor          # [B] its score
    shrink: torch.Tensor         # [B] bool: the simplex shrinks instead
    shrunk_scores: torch.Tensor  # [B, K] the scores of the shrunk points
    evals: torch.Tensor          # [B] int32, the taken branch's evaluations


def move(lanes: Lanes, config, centroid: torch.Tensor, x_worst: torch.Tensor,
         f_best: torch.Tensor, f_second: torch.Tensor, f_worst: torch.Tensor,
         shrunk: torch.Tensor, clamp_to, *, reference: bool = False,
         min_threshold: bool = False) -> Move:
    """The branches of every lane (nlsolver.h:2251-2296): expand (the
    reflected point is the new best), accept the reflection (below the
    second worst), contract, or shrink when the contraction fails to the
    points ``shrunk [B, K, n]``.  Under ``jax.vmap`` the ``lax.switch`` and
    ``lax.cond`` of the branches run every branch and select per lane; so
    does this: the reflected point is scored, then the expanded and
    contracted points and the shrunk ones in one evaluation, and only the
    taken branch's evaluations count (2, 1, 2 or 1 + K).  ``clamp_to``
    puts a point ``[B, n]`` into the box.  ``reference`` takes the
    reference's contraction, c + rho (c - point) (nlsolver.h:2266-2275);
    ``min_threshold`` accepts a contraction below min(f_reflect, f_worst),
    as NM-PSO does, where Nelder-Mead compares it with f_reflect if the
    reflection beat the worst and with f_worst otherwise (the two differ
    only where f_reflect is NaN)."""
    alpha, gamma, rho = config.alpha, config.gamma, config.rho
    x_reflect = clamp_to(centroid + alpha * (centroid - x_worst))
    f_reflect = lanes.values(x_reflect)
    expand = f_reflect < f_best
    reflect = ~expand & (f_reflect < f_second)
    contract = ~expand & ~reflect

    x_expand = clamp_to(centroid + gamma * (x_reflect - centroid))
    reflect_better = f_reflect < f_worst
    if reference:
        x_contract = torch.where(reflect_better[:, None],
                                 centroid + rho * (centroid - x_reflect),
                                 centroid + rho * (centroid - x_worst))
    else:
        # outside contraction toward the reflected point when it improved
        # on the worst, inside toward the worst otherwise
        x_contract = torch.where(reflect_better[:, None],
                                 centroid + rho * (x_reflect - centroid),
                                 centroid + rho * (x_worst - centroid))
    x_contract = clamp_to(x_contract)
    vals = lanes.points(torch.cat([x_expand[:, None], x_contract[:, None], shrunk], dim=1))
    f_expand, f_contract = vals[:, 0], vals[:, 1]

    take_exp = f_expand < f_reflect
    threshold = (torch.minimum(f_reflect, f_worst) if min_threshold
                 else torch.where(reflect_better, f_reflect, f_worst))
    shrink = contract & ~(f_contract < threshold)
    point = torch.where(expand[:, None], torch.where(take_exp[:, None], x_expand, x_reflect),
                        torch.where(reflect[:, None], x_reflect, x_contract))
    score = torch.where(expand, torch.where(take_exp, f_expand, f_reflect),
                        torch.where(reflect, f_reflect, f_contract))
    evals = torch.where(reflect, 1, torch.where(shrink, 1 + shrunk.shape[1], 2)).to(torch.int32)
    return Move(point, score, shrink, vals[:, 2:], evals)


def step(fn, state: NMState, config: NelderMeadConfig, lower: torch.Tensor,
         upper: torch.Tensor, bounded: bool, *, data=None) -> NMState:
    lanes = as_lanes(fn, data)
    simplex, scores = state.simplex, state.scores
    B, n1, n = simplex.shape
    reference_variant = config.variant == "reference"

    best = scores.argmin(dim=1)
    worst = scores.argmax(dim=1)
    f_best = gather_lanes(scores, best)
    f_worst = gather_lanes(scores, worst)
    if reference_variant:
        f_second = _reference_second_worst_score(scores, worst)
    else:
        f_second = _second_worst_score(scores, worst)
    best, worst = best.to(torch.int32), worst.to(torch.int32)

    # stagnation tracking on the best *index* (nlsolver.h:2222-2230)
    no_change = torch.where(best == state.last_best, state.no_change_iter + 1, 0)
    hit_tol = (std_err(scores, dim=1) < state.eps) | (no_change >= config.no_change_best_tol)
    done_now = (state.iteration >= config.max_iter) | hit_tol

    def _clamp(x):
        return clamp(x, lower, upper) if bounded else x

    x_worst = gather_lanes(simplex, worst)
    if reference_variant:
        # update_centroid (nlsolver.h:1965-1984): the vertices added in
        # index order, the worst skipped by a masked add of zero, then the
        # divide; the cached centroid is reused unless the worst index
        # changed or the last iteration shrank (nlsolver.h:2240-2243)
        zero = torch.zeros_like(x_worst)
        acc = zero
        for i in range(n1):
            acc = acc + torch.where((worst == i)[:, None], zero, simplex[:, i])
        recompute = (worst != state.prev_worst) | state.shrunk
        centroid = torch.where(recompute[:, None], true_div(acc, n), state.centroid)
    else:
        centroid = true_div(vertex_sum(simplex) - x_worst, n)

    x_best = gather_lanes(simplex, best)
    shrunk_sim = _set_row(x_best[:, None] + config.sigma * (simplex - x_best[:, None]), best,
                          x_best)
    m = move(lanes, config, centroid, x_worst, f_best, f_second, f_worst, shrunk_sim, _clamp,
             reference=reference_variant)
    shrunk_sc = _set_row(m.shrunk_scores, best, f_best)   # the best is not rescored (:2288-2294)
    new_simplex = torch.where(m.shrink[:, None, None], shrunk_sim,
                              _set_row(simplex, worst, m.point))
    new_scores = torch.where(m.shrink[:, None], shrunk_sc, _set_row(scores, worst, m.score))

    worked = NMState(
        simplex=new_simplex,
        scores=new_scores,
        iteration=state.iteration + 1,
        nfev=state.nfev + m.evals,
        last_best=best,
        no_change_iter=no_change,
        eps=state.eps,
        centroid=centroid,
        prev_worst=worst,
        shrunk=m.shrink,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    halted = state._replace(no_change_iter=no_change, last_best=best,
                            done=torch.ones_like(state.done), converged=hit_tol)
    return where_lanes(done_now, halted, worked)


def _finalize(state: NMState, flip_sign: bool) -> SolverResult:
    best = state.scores.argmin(dim=1)
    return lane_result(gather_lanes(state.simplex, best), gather_lanes(state.scores, best), state,
                       flip_sign)


# steps between two reads of done.all(); a step is some 60 launches
CHECK_EVERY = 16


def _solve_once(lanes: Lanes, x0: torch.Tensor, config: NelderMeadConfig, bounds,
                flip_sign: bool) -> SolverResult:
    lower, upper, bounded = resolve_bounds(bounds, x0)
    state = init(lanes, x0, config)
    state = drive(lambda s: step(lanes, s, config, lower, upper, bounded), state,
                  check_every=CHECK_EVERY)
    return _finalize(state, flip_sign)


def _run(lanes: Lanes, x0: torch.Tensor, config: NelderMeadConfig, _minimize: bool,
         bounds) -> SolverResult:
    # restarts accumulate like nlsolver.h:2127-2134, every lane from its own x
    res = _solve_once(lanes, x0, config, bounds, not _minimize)
    for _ in range(config.restarts):
        res = res.add(_solve_once(lanes, res.x, config, bounds, not _minimize))
    return res


def minimize_batched(fn, x0: torch.Tensor, config: NelderMeadConfig = NelderMeadConfig(),
                     bounds: Optional[Bounds] = None, *, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]``: ``jax.vmap`` of the JAX ``minimize``;
    ``bounds`` broadcast against ``x0``."""
    return run_batched(_run, fn, x0, config, data, _minimize, bounds)


def minimize(fn, x0: torch.Tensor, config: NelderMeadConfig = NelderMeadConfig(),
             bounds: Optional[Bounds] = None, *, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the lane engine at B = 1, squeezed."""
    return run_single(_run, fn, x0, config, data, _minimize, bounds)


def maximize(fn, x0, config: NelderMeadConfig = NelderMeadConfig(), bounds=None, *, data=None):
    return minimize(fn, x0, config, bounds, data=data, _minimize=False)
