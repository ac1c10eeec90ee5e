"""Sequential-consumption replay of the reference NelderMead-PSO hybrid:
stochastic trajectory parity (counterpart of
``nlsolver_tpu.solvers.nmpso_reference``).

Replays ``NelderMeadPSO::solve`` (nlsolver.h:3546-3920) draw for draw on
the bit-parity reference generators (production path: ``nmpso``).  Per
iteration: the particles sort best to worst (libstdc++ insertion sort is
stable at these sizes: a stable ``argsort``, read on the host), the top
n+1 take one Nelder-Mead update (1, 2 or 2+n evaluations by branch), the
bottom 2n a PSO velocity update drawing ``r_p, r_g`` per (particle,
dimension) in rank order.

Reference quirks reproduced (each observable in the golden trajectories):

* the init off-by-one (nlsolver.h:3710-3718): vertex i perturbs dimension
  i for i = 1..n-1 and vertex n's write lands out of bounds, so vertex n
  stays at x (NelderMead's simplex init quirk, nlsolver.h:1929-1931);
* the velocity loop declares ``velocity`` and ``pairwise_best`` as COPIES
  (``std::vector<scalar_t> &particle = ..., velocity = ...``: only the
  first declarator takes the ``&``, nlsolver.h:3838-3840), so stored
  velocities keep their INITIAL values forever (zero for the n+1
  simplex-born particles, the init draws for the 2n PSO-born ones);
* ``best_val`` is read but never assigned in the solve loop
  (nlsolver.h:3651), so the no-change counter compares with particle 0's
  INITIAL value;
* the pairwise-best pattern (order_flip, nlsolver.h:3831-3845): sorted PSO
  ranks (0, 1) share rank 0's position, each later pair (2m, 2m+1) rank
  2m+1's, the WORSE member;
* the PSO phase reads ``best`` (the sorted best) and each pair's
  ``pairwise_best`` as snapshots taken at that particle's turn, so earlier
  updates of the phase are seen by later particles.

The branch taken by the Nelder-Mead update is read on the host and only
its points are scored, which gives what the JAX replay selects.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core import (Objective, SolverResult, batch_eval, c_math, drive, exact_product,
                    make_result, signed, start_points)
from ..random import reference_rngs
from ._lane import scalar, true_div
from .de_reference import no_replay_bounds
from .nelder_mead import init_simplex


@dataclass(frozen=True)
class NMPSOReferenceConfig:
    """Reference defaults (nlsolver.h:3564-3568)."""

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
    rng: str = "xorshift"


class NMPSORefState(NamedTuple):
    positions: torch.Tensor    # [n+1 + 2n, n]
    velocities: torch.Tensor   # [P, n], constant (the reference's copy bug)
    values: torch.Tensor       # [P]
    best_val0: torch.Tensor    # particle 0's INITIAL value (never updated)
    no_change: torch.Tensor
    rng: tuple
    iteration: torch.Tensor
    nfev: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor


def _sorted_order(values: torch.Tensor) -> list:
    # libstdc++ std::sort is a stable insertion sort only below 16 elements,
    # 3n+1 <= 16 particles (n <= 5); init warns past that
    return torch.argsort(values, stable=True).tolist()


def init(fn: Objective, x0: torch.Tensor, config: NMPSOReferenceConfig) -> NMPSORefState:
    n = x0.shape[-1]
    if n > 5:
        warnings.warn(
            "nmpso_reference bit-parity is only guaranteed for n <= 5 "
            "(3n+1 <= 16 particles keeps libstdc++ std::sort in its stable "
            "insertion-sort regime; larger sorts are unstable introsort and "
            "may order tied values differently)",
            stacklevel=2,
        )
    dtype, dev = x0.dtype, x0.device
    nm, npso = n + 1, 2 * n
    rng0, nxt = reference_rngs.make(config.rng, dtype=dtype, device=dev)
    upper = (2.5 * x0).abs()            # implied bounds +-|2.5 x_i| (nlsolver.h:3585-3592)
    lower = -upper
    simplex = init_simplex(x0, -1.0, "reference")
    # the PSO particles: per (i, j) a position draw, then a velocity draw
    # (nlsolver.h:3726-3734)
    us, rng = reference_rngs.sample(rng0, nxt, npso * n * 2)
    u = us.reshape(npso, n, 2)
    width = upper - lower
    temp = width.abs()
    pso_pos = lower[None, :] + exact_product(width[None, :] * u[:, :, 0])
    pso_vel = -temp[None, :] + exact_product(u[:, :, 1] * temp[None, :])
    positions = torch.cat([simplex, pso_pos])
    values = batch_eval(fn, positions)
    false = scalar(False, x0, torch.bool)
    return NMPSORefState(
        positions=positions,
        velocities=torch.cat([torch.zeros((nm, n), dtype=dtype, device=dev), pso_vel]),
        values=values, best_val0=values[0], no_change=scalar(0, x0), rng=rng,
        iteration=scalar(0, x0), nfev=scalar(nm + npso, x0), done=false, converged=false)


def report_best(state: NMPSORefState) -> torch.Tensor:
    """The index the reference would report: the sorted best, the first
    argmin (along the last axis of a trace's values)."""
    return state.values.argmin(dim=-1)


def step(fn: Objective, state: NMPSORefState, config: NMPSOReferenceConfig) -> NMPSORefState:
    P, n = state.positions.shape
    nm = n + 1
    dtype, dev = state.positions.dtype, state.positions.device
    _, nxt = reference_rngs.make(config.rng, dtype=dtype, device=dev)

    order = _sorted_order(state.values)
    # the no-change counter against particle 0's INITIAL value (the quirk)
    same = state.best_val0 == state.values[order[0]]
    no_change = torch.where(same, state.no_change + 1, torch.zeros_like(state.no_change))
    # simplex_std_err over the top n+1 sorted values, in the reference's
    # order (nlsolver.h:3898-3913)
    svals = [state.values[order[i]] for i in range(nm)]
    acc = torch.zeros((), dtype=dtype, device=dev)
    for v in svals:
        acc = acc + v
    mean = true_div(acc, nm)
    acc2 = torch.zeros((), dtype=dtype, device=dev)
    for v in svals:
        d = v - mean
        acc2 = acc2 + d * d
    serr = c_math("sqrt", true_div(acc2, nm - 1))
    hit_tol = (no_change >= config.no_change_best_iter) | (serr < config.eps)
    done_now = (state.iteration >= config.max_iter) | hit_tol
    if bool(done_now):
        return state._replace(no_change=no_change, done=torch.ones_like(state.done),
                              converged=hit_tol)

    def coef(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    alpha, gamma, rho, sigma = (coef(config.alpha), coef(config.gamma), coef(config.rho),
                                coef(config.sigma))
    rows = list(state.positions.unbind(0))
    vals = list(state.values.unbind(0))

    # ---- apply_simplex (nlsolver.h:3743-3825) ----
    best_score = vals[order[0]]
    worst_id = order[nm - 1]
    worst_val = vals[worst_id]
    cacc = torch.zeros(n, dtype=dtype, device=dev)
    for i in range(nm - 1):                # centroid over ranks 0..nm-2, in rank order
        cacc = cacc + rows[order[i]]
    centroid = true_div(cacc, nm - 1)
    x_worst = rows[worst_id]
    x_reflect = centroid + alpha * (centroid - x_worst)
    f_reflect = fn(x_reflect)
    evals = 1
    if bool((f_reflect >= best_score) & (f_reflect < vals[order[nm - 2]])):
        rows[worst_id], vals[worst_id] = x_reflect, f_reflect              # accept
    elif bool(f_reflect < best_score):                                      # expand
        x_expand = centroid + gamma * (x_reflect - centroid)
        f_expand = fn(x_expand)
        evals += 1
        better = bool(f_expand < f_reflect)
        rows[worst_id] = x_expand if better else x_reflect
        vals[worst_id] = f_expand if better else f_reflect
    else:                                                                   # contract
        contract_from = x_reflect if bool(f_reflect < worst_val) else x_worst
        x_contract = centroid + rho * (contract_from - centroid)
        f_contract = fn(x_contract)
        evals += 1
        if bool(f_contract < torch.minimum(f_reflect, worst_val)):
            rows[worst_id], vals[worst_id] = x_contract, f_contract
        else:
            # shrink: ranks 1..nm-1 move toward rank 0 and are scored again
            # (nlsolver.h:3887-3897, :3803-3816); the PSO ranks stay
            best_pos = rows[order[0]]
            moved = [best_pos + sigma * (rows[order[i]] - best_pos) for i in range(1, nm)]
            scores = batch_eval(fn, torch.stack(moved)).unbind(0)
            for i in range(1, nm):
                rows[order[i]], vals[order[i]] = moved[i - 1], scores[i - 1]
            evals += nm - 1   # the nm - 1 shrunk points, beside the contraction
            # the reference sorts again before the PSO phase (nlsolver.h:3817-3823)
            order = _sorted_order(torch.stack(vals))
    nfev = state.nfev + evals

    # ---- apply_pso (nlsolver.h:3826-3868) ----
    inertia, cog, soc = coef(config.inertia), coef(config.cognitive_coef), coef(config.social_coef)
    best = rows[order[0]]           # a snapshot; rank 0 is never a PSO rank
    rng = state.rng
    for rank in range(2 * n):
        m = rank // 2                # pairwise best: (0, 1) -> 0, (2m, 2m+1) -> 2m+1
        pid = order[nm + rank]
        pairwise_best = rows[order[nm + (0 if m == 0 else 2 * m + 1)]]
        vel = state.velocities[pid]  # the copy bug: the initial values
        part = rows[pid]
        us, rng = reference_rngs.sample(rng, nxt, 2 * n)
        r_p, r_g = us.reshape(n, 2).unbind(1)
        t = (exact_product(inertia * vel) + exact_product((cog * r_p) * (pairwise_best - part))) \
            + exact_product((soc * r_g) * (best - part))
        part = part + t
        rows[pid], vals[pid] = part, fn(part)
        nfev = nfev + 1

    return NMPSORefState(
        positions=torch.stack(rows), velocities=state.velocities, values=torch.stack(vals),
        best_val0=state.best_val0, no_change=no_change, rng=rng,
        iteration=state.iteration + 1, nfev=nfev, done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged))


def minimize(fn: Objective, x0, config: NMPSOReferenceConfig = NMPSOReferenceConfig(),
             bounds=None, *, _minimize: bool = True) -> SolverResult:
    """Replay the reference NM-PSO from ``x0 [n]``; a start point that is
    no tensor goes to the card."""
    no_replay_bounds(bounds)
    sfn = signed(fn, _minimize)
    state = init(sfn, start_points(x0), config)
    state = drive(lambda s: step(sfn, s, config), state, check_every=1)
    b = int(report_best(state))
    f = state.values[b]
    return make_result(x=state.positions[b], f_value=f if _minimize else -f,
                       iterations=state.iteration, function_calls=state.nfev,
                       converged=state.converged)


def maximize(fn, x0, config: NMPSOReferenceConfig = NMPSOReferenceConfig(), bounds=None):
    return minimize(fn, x0, config, bounds, _minimize=False)
