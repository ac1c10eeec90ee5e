"""Sequential-consumption replay of the reference ACCELERATED PSO:
stochastic trajectory parity (counterpart of
``nlsolver_tpu.solvers.pso_reference``).

Replays ``PSO<..., PSOType::Accelerated>`` (nlsolver.h:2496-2742) draw for
draw on the bit-parity reference generators (production path: ``pso``).
Consumption order: init draws one uniform per (particle, dimension),
particle-major (nlsolver.h:2648-2650; Accelerated allocates no
velocities, so the velocity draw of the Vanilla path is absent); each
iteration then draws two uniforms per (particle, dimension) through the
reference Box-Muller ``rnorm`` (left multiplicand first) for the position
update ``inertia*N(0,1) + (1-cognitive)*x + social*swarm_best``
(nlsolver.h:2694-2699), with ``inertia = pow(inertia0, iter)``.

Reference quirks reproduced: the swarm best value starts at 1e5 and the
particle bests at 1e4 (nlsolver.h:2631, :2660); the no-change counter is
keyed on ``best_index == 0``, so it also counts when the improving
particle is particle 0 (nlsolver.h:2740); the unbounded ``minimize(x)``
derives bounds as +-|x_i| (nlsolver.h:2554-2560), but the Accelerated
path never clamps to them.

Only the Accelerated variant is replayed: the VANILLA velocity update
indexes ``swarm_best_position[i]`` with the PARTICLE index
(nlsolver.h:2674), which reads past an n-sized allocation for any swarm
larger than the dimension, so the reference's own vanilla trajectories
are undefined behaviour and cannot be reproduced.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core import (Objective, SolverResult, batch_eval, drive, exact_product, make_result,
                    signed, start_points, std_err)
from ..random import reference_rngs
from ._lane import scalar
from .de_reference import no_replay_bounds
from .sann_reference import normals


@dataclass(frozen=True)
class PSOAccReferenceConfig:
    """Reference defaults (nlsolver.h:2523-2526)."""

    inertia: float = 0.8
    cognitive_coef: float = 1.8
    social_coef: float = 1.8
    n_particles: int = 10
    max_iter: int = 5000
    best_val_no_change: int = 50
    eps: float = 1e-3           # reference writes 10e-4
    rng: str = "xorshift"


class PSOAccRefState(NamedTuple):
    positions: torch.Tensor       # [n_particles, n]
    best_values: torch.Tensor     # per-particle bests [n_particles]
    swarm_best: torch.Tensor      # [n]
    swarm_best_value: torch.Tensor
    rng: tuple
    val_no_change: torch.Tensor
    iteration: torch.Tensor
    nfev: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor


def _best_update(fn, positions, best_values, swarm_best, swarm_best_value, val_no_change, nfev):
    """update_best_positions (nlsolver.h:2717-2741): a running strict-min
    scan with best_index reset to 0 each call, the particle bests as an
    elementwise min, the no-change counter keyed on best_index == 0.  NaN
    scores never displace a stored best (the scan's strict <)."""
    temps = batch_eval(fn, positions)
    tclean = torch.where(torch.isnan(temps), torch.full_like(temps, float("inf")), temps)
    tmin = tclean.amin()
    updated = tmin < swarm_best_value
    amin = tclean.argmin()
    swarm_best_value = torch.where(updated, tmin, swarm_best_value)
    swarm_best = torch.where(updated, positions[amin], swarm_best)
    best_values = torch.where(temps < best_values, temps, best_values)
    best_is_zero = ~updated | (amin == 0)
    val_no_change = torch.where(best_is_zero, val_no_change + 1, torch.zeros_like(val_no_change))
    return best_values, swarm_best, swarm_best_value, val_no_change, nfev + positions.shape[0]


def init(fn: Objective, x0: torch.Tensor, config: PSOAccReferenceConfig) -> PSOAccRefState:
    n = x0.shape[-1]
    dtype, dev = x0.dtype, x0.device
    rng0, nxt = reference_rngs.make(config.rng, dtype=dtype, device=dev)
    upper = x0.abs()                       # unbounded minimize: +-|x_i| (nlsolver.h:2554-2560)
    lower = -upper
    us, rng = reference_rngs.sample(rng0, nxt, config.n_particles * n)
    positions = lower[None, :] + (upper - lower)[None, :] * us.reshape(config.n_particles, n)

    # the update before the loop (nlsolver.h:2599)
    best_values, swarm_best, swarm_best_value, val_no_change, nfev = _best_update(
        fn, positions, torch.full((config.n_particles,), 10000.0, dtype=dtype, device=dev),
        torch.zeros_like(x0), scalar(100000.0, x0, dtype), scalar(0, x0), scalar(0, x0))
    false = scalar(False, x0, torch.bool)
    return PSOAccRefState(positions=positions, best_values=best_values, swarm_best=swarm_best,
                          swarm_best_value=swarm_best_value, rng=rng, val_no_change=val_no_change,
                          iteration=scalar(0, x0), nfev=nfev, done=false, converged=false)


def step(fn: Objective, state: PSOAccRefState, config: PSOAccReferenceConfig) -> PSOAccRefState:
    n_particles, n = state.positions.shape
    dtype, dev = state.positions.dtype, state.positions.device
    _, nxt = reference_rngs.make(config.rng, dtype=dtype, device=dev)

    hit_tol = (state.val_no_change >= config.best_val_no_change) | (
        std_err(state.best_values) < config.eps)
    done_now = (state.iteration >= config.max_iter) | hit_tol
    if bool(done_now):
        return state._replace(done=torch.ones_like(state.done), converged=hit_tol)

    # pow(inertia0, iter), the C library's (core.utils.c_math)
    inertia0 = float(torch.tensor(config.inertia, dtype=dtype))
    inertia = torch.tensor(math.pow(inertia0, float(state.iteration)), dtype=dtype, device=dev)
    disc = torch.tensor(1.0 - config.cognitive_coef, dtype=dtype, device=dev)
    soc = torch.tensor(config.social_coef, dtype=dtype, device=dev)
    # the accelerated update (nlsolver.h:2694-2699): particle-major,
    # dimension-minor, two draws a coordinate through rnorm, every product
    # rounded on its own, the sum in the reference's order
    z, rng = normals(state.rng, nxt, n_particles * n)
    positions = (exact_product(inertia * z.reshape(n_particles, n))
                 + exact_product(disc * state.positions)) + exact_product(soc * state.swarm_best)
    # the unbounded solve<.., false> clamps nothing
    best_values, swarm_best, swarm_best_value, val_no_change, nfev = _best_update(
        fn, positions, state.best_values, state.swarm_best, state.swarm_best_value,
        state.val_no_change, state.nfev)
    return PSOAccRefState(positions=positions, best_values=best_values, swarm_best=swarm_best,
                          swarm_best_value=swarm_best_value, rng=rng, val_no_change=val_no_change,
                          iteration=state.iteration + 1, nfev=nfev,
                          done=torch.zeros_like(state.done),
                          converged=torch.zeros_like(state.converged))


def minimize(fn: Objective, x0, config: PSOAccReferenceConfig = PSOAccReferenceConfig(),
             bounds=None, *, _minimize: bool = True) -> SolverResult:
    """Replay the reference accelerated PSO from ``x0 [n]``; a start point
    that is no tensor goes to the card."""
    no_replay_bounds(bounds)
    sfn = signed(fn, _minimize)
    state = init(sfn, start_points(x0), config)
    state = drive(lambda s: step(sfn, s, config), state, check_every=1)
    f = state.swarm_best_value
    return make_result(x=state.swarm_best, f_value=f if _minimize else -f,
                       iterations=state.iteration, function_calls=state.nfev,
                       converged=state.converged)


def maximize(fn, x0, config: PSOAccReferenceConfig = PSOAccReferenceConfig(), bounds=None):
    return minimize(fn, x0, config, bounds, _minimize=False)
