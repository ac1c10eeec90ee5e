"""Particle Swarm Optimization on lane tensors, batch-minor: the port's
one PSO engine (counterpart of ``nlsolver_tpu.solvers.pso_batched``, and
through ``solvers.pso``'s row-layout view of ``nlsolver_tpu.solvers.pso``;
the reference's ``PSO``, nlsolver.h:2496-2742).  ``PSOConfig`` is field for
field the JAX package's.

The fleet lives as ``[n, P, B]``: coordinates leading, particles, then the
instances on the trailing (lane) axis, the JAX engine's layout, so a state
crosses packages as a copy (``interop.pso_batch_state_from_numpy``).  The
semantics are the JAX engine's, which are those of the JAX row solver
under ``jax.vmap``: the fixed vanilla update (the cognitive term toward
the particle's best, the social term indexed by dimension, the stagnation
counter on swarm-best improvement), the accelerated update
``w N(0, 1) + (1 - cognitive) pos + social best`` with ``w =
inertia^iter``, derived +-|x_i| init bounds (clamping only when ``bounds``
are given, nlsolver.h:2553-2562, 2617-2619), the particle-best-spread
termination rule, and finished lanes frozen by the active mask folded
into every select.

The objective is one point's, scored through ``core.lanes.Lanes`` (with
``data=``, each lane's slice of it).  Randomness is explicit: ``init`` and
``step`` take optional ``draws`` and otherwise draw from a
``torch.Generator`` on the fleet's device; ``minimize_batched`` takes a
run's draws (``_lane.Draws``, lane axis leading, lane b reading row
``iteration[b]``).  The JAX engine's per-lane ``keys`` have no
counterpart.  The swarm best is an ``argmin`` and a gather over the
particle axis, where the JAX engine masks a one-hot of the ``argmin``:
both take the first minimum.

The accelerated update never reads ``velocities``: like the JAX engine's,
the state keeps the initial array there and hands it on unchanged, so the
interop stays a copy; no step reads or writes it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, resolve_bounds, std_err
from ..core.lanes import Lanes, as_lanes
from ._lane import Draws, draws_on, lane_result, reversed_axes, run_batched, step_rows

# host loop: steps between two reads of done.all() in minimize_batched
CHECK_EVERY = 16


@dataclass(frozen=True)
class PSOConfig:
    """Defaults from nlsolver.h:2522-2526."""

    inertia: float = 0.8
    cognitive_coef: float = 1.8
    social_coef: float = 1.8
    n_particles: int = 10
    max_iter: int = 5000
    best_value_no_change: int = 50
    eps: float = 1e-3
    accelerated: bool = False   # PSOType {Vanilla, Accelerated}


def _derived_bounds(x0: torch.Tensor):
    """The unbounded entry point derives per-dimension bounds +-|x_i|
    (nlsolver.h:2554-2560)."""
    t = x0.abs()
    return -t, t


class PSOBatchState(NamedTuple):
    positions: torch.Tensor            # [n, P, B]
    velocities: torch.Tensor           # [n, P, B] (the initial ones, accelerated)
    best_positions: torch.Tensor       # [n, P, B] per-particle best
    best_values: torch.Tensor          # [P, B]
    swarm_best_position: torch.Tensor  # [n, B]
    swarm_best_value: torch.Tensor     # [B]
    iteration: torch.Tensor            # [B] int32
    nfev: torch.Tensor                 # [B] int32
    val_no_change: torch.Tensor        # [B] int32
    done: torch.Tensor                 # [B] bool
    converged: torch.Tensor            # [B] bool


class PSOInitDraws(NamedTuple):
    u: torch.Tensor    # [n, P, B] uniforms of the initial positions
    uv: torch.Tensor   # [n, P, B] uniforms of the initial velocities


class PSODraws(NamedTuple):
    """One step's draws, to replay a trajectory exactly."""

    ra: torch.Tensor                   # [n, P, B] uniforms (vanilla) or normals (accelerated)
    rb: Optional[torch.Tensor] = None  # [n, P, B] uniforms (vanilla only)


def eval_columns(fn, A: torch.Tensor) -> torch.Tensor:
    """Score every particle column: ``[n, P, B] -> [P, B]``, ``fn`` on one
    point ``[n]`` (or a ``Lanes``) through ``vmap``, as the JAX engine's
    ``_eval_cols`` does (``Lanes.grid``)."""
    return as_lanes(fn).grid(A)


def _swarm_best(values: torch.Tensor, positions: torch.Tensor):
    """The first minimum over the particle axis: its value ``[B]`` and its
    position ``[n, B]``."""
    n, _, B = positions.shape
    idx = values.argmin(dim=0)
    pos = torch.gather(positions, 1, idx.view(1, 1, B).expand(n, 1, B))[:, 0, :]
    return values.amin(dim=0), pos


def init(
    fn,
    x0: torch.Tensor,                 # [B, n]
    config: PSOConfig,
    lower: torch.Tensor,              # [n, B]
    upper: torch.Tensor,              # [n, B]
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[PSOInitDraws] = None,
) -> PSOBatchState:
    """Particles uniform in [lower, upper), velocities uniform in
    (-span, span).  ``draws`` are the two uniform arrays ``[n, P, B]``;
    otherwise ``generator`` draws them."""
    B, n = x0.shape
    P = config.n_particles
    dev = x0.device
    if draws is None:
        if generator is None:
            raise ValueError("init needs draws= or generator=")
        draws = PSOInitDraws(*(torch.rand((n, P, B), generator=generator, dtype=x0.dtype,
                                          device=dev) for _ in range(2)))
    positions = lower[:, None, :] + (upper - lower)[:, None, :] * draws.u
    span = (upper - lower).abs()
    # symmetric initial velocities (the reference draws from [-span, 0),
    # nlsolver.h:2649, an asymmetry with no rationale)
    velocities = span[:, None, :] * (2.0 * draws.uv - 1.0)
    values = eval_columns(fn, positions)
    best_value, best_position = _swarm_best(values, positions)
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    no = torch.zeros((B,), dtype=torch.bool, device=dev)
    return PSOBatchState(
        positions=positions,
        velocities=velocities,
        best_positions=positions,
        best_values=values,
        swarm_best_position=best_position,
        swarm_best_value=best_value,
        iteration=zeros,
        nfev=torch.full((B,), P, dtype=torch.int32, device=dev),
        val_no_change=zeros,
        done=no,
        converged=no,
    )


def step(
    fn,
    state: PSOBatchState,
    config: PSOConfig,
    lower: Optional[torch.Tensor] = None,   # [n, B], read only when clamping
    upper: Optional[torch.Tensor] = None,
    clamp_positions: bool = False,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[PSODraws] = None,
) -> PSOBatchState:
    """One iteration for every lane; lanes that are or become done stay
    frozen.  Reads nothing back from the device."""
    n, P, B = state.positions.shape
    dtype, dev = state.positions.dtype, state.positions.device

    hit_tol = (state.val_no_change >= config.best_value_no_change) | (
        std_err(state.best_values, dim=0) < config.eps
    )
    done_now = (state.iteration >= config.max_iter) | hit_tol
    # the active-lane mask is folded into every select below, so no
    # separate freeze pass re-reads the [n, P, B] arrays
    act = ~(state.done | done_now)
    a2, a3 = act[None, :], act[None, None, :]

    if draws is None:
        if generator is None:
            raise ValueError("step needs draws= or generator=")
        shape = (n, P, B)
        if config.accelerated:
            draws = PSODraws(torch.randn(shape, generator=generator, dtype=dtype, device=dev))
        else:
            draws = PSODraws(*(torch.rand(shape, generator=generator, dtype=dtype, device=dev)
                               for _ in range(2)))

    if config.accelerated:
        # inertia = inertia0^iter, per instance (nlsolver.h:2613)
        w = torch.pow(state.iteration.new_full((), config.inertia, dtype=dtype),
                      state.iteration.to(dtype))
        cand_positions = (
            w[None, None, :] * draws.ra
            + (1.0 - config.cognitive_coef) * state.positions
            + config.social_coef * state.swarm_best_position[:, None, :]
        )
        new_velocities = state.velocities
    else:
        nv = (
            config.inertia * state.velocities
            + config.cognitive_coef * draws.ra * (state.best_positions - state.positions)
            + config.social_coef * draws.rb
            * (state.swarm_best_position[:, None, :] - state.positions)
        )
        new_velocities = torch.where(a3, nv, state.velocities)
        cand_positions = state.positions + nv

    if clamp_positions:
        # jnp.clip's order: the upper bound wins where the bounds cross
        cand_positions = torch.minimum(torch.maximum(cand_positions, lower[:, None, :]),
                                       upper[:, None, :])
    new_positions = torch.where(a3, cand_positions, state.positions)

    values = eval_columns(fn, new_positions)
    improved_particle = (values < state.best_values) & a2
    best_values = torch.where(improved_particle, values, state.best_values)
    best_positions = torch.where(improved_particle[None, :, :], new_positions,
                                 state.best_positions)

    cand_val, cand_pos = _swarm_best(values, new_positions)
    swarm_improved = (cand_val < state.swarm_best_value) & act
    act_i = act.to(torch.int32)
    return PSOBatchState(
        positions=new_positions,
        velocities=new_velocities,
        best_positions=best_positions,
        best_values=best_values,
        swarm_best_position=torch.where(swarm_improved[None, :], cand_pos,
                                        state.swarm_best_position),
        swarm_best_value=torch.where(swarm_improved, cand_val, state.swarm_best_value),
        iteration=state.iteration + act_i,
        nfev=state.nfev + P * act_i,
        val_no_change=torch.where(
            act, torch.where(swarm_improved, 0, state.val_no_change + 1), state.val_no_change
        ),
        done=state.done | done_now,
        converged=torch.where(state.done, state.converged, hit_tol),
    )


def _finalize(state, flip_sign: bool) -> SolverResult:
    return lane_result(state.swarm_best_position.T, state.swarm_best_value, state, flip_sign)


def _run(lanes: Lanes, x0: torch.Tensor, config: PSOConfig, _minimize: bool, bounds, draws,
         generator) -> SolverResult:
    if draws is None and generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    draws = draws_on(draws, x0.device)
    lower, upper, clamp = resolve_bounds(bounds, x0)
    if not clamp:
        lower, upper = _derived_bounds(x0)  # they only seed the swarm (nlsolver.h:2562)
    lower, upper = lower.T, upper.T
    state = init(lanes, x0, config, lower, upper, generator=generator,
                 draws=None if draws is None else reversed_axes(draws.init))
    while not bool(state.done.all()):
        for _ in range(CHECK_EVERY):
            rows = None if draws is None else step_rows(draws.steps, state.iteration)
            state = step(lanes, state, config, lower, upper, clamp, generator=generator,
                         draws=reversed_axes(rows))
    return _finalize(state, flip_sign=not _minimize)


def minimize_batched(fn, x0: torch.Tensor, config: PSOConfig = PSOConfig(),
                     bounds: Optional[Bounds] = None, *, draws: Optional[Draws] = None,
                     generator: Optional[torch.Generator] = None, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Run the fleet of ``x0 [B, n]`` until every lane is done: ``jax.vmap``
    of the JAX ``minimize``.

    Without ``bounds`` the particles start in +-|x0| and move freely
    (nlsolver.h:2562); with them (broadcast against ``x0``) they start in
    the box and are clamped to it.  The draws come from ``draws``
    (``Draws(PSOInitDraws [B, P, n], PSODraws of [T, B, P, n])``, lane axis
    leading as in ``solvers.pso``) or from ``generator`` (on ``x0``'s
    device, seed 0 by default), which takes the place of the JAX package's
    per-lane ``keys``.  ``done`` is read on the host once every
    ``CHECK_EVERY`` steps; the frozen lanes make the extra steps no-ops."""
    return run_batched(_run, fn, x0, config, data, _minimize, bounds, draws, generator)
