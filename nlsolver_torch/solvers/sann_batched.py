"""Simulated annealing on lane tensors, batch-minor: the port's one SANN
engine (counterpart of ``nlsolver_tpu.solvers.sann_batched``, and through
``solvers.sann``'s row-layout view of ``nlsolver_tpu.solvers.sann``; the
reference's ``SANN``, nlsolver.h:2744-2815).  ``SANNConfig`` is field for
field the JAX package's.

The chains live as ``[n, B]``, the JAX engine's layout.  The semantics are
the JAX engine's, which are those of the JAX row solver under
``jax.vmap``: Boltzmann cooling t = T_max / log(iter + e - 1), a Gaussian
kernel scaled by t / T_max, ``temperature_iter - 1`` sequential proposals
an outer iteration (the JAX row solver's inner ``lax.scan``, here a Python
loop over the lanes), Metropolis acceptance against the chain's current
value (or, with ``metropolis_vs_best``, the best value seen: the
reference's quirk), termination on ``max_iter`` only, and finished lanes
frozen.

The objective is one point's, scored through ``core.lanes.Lanes`` (with
``data=``, each lane's slice of it).  Randomness is explicit: ``step``
takes optional ``draws`` (the noise ``[n_inner, n, B]`` and the acceptance
uniforms ``[n_inner, B]``) and otherwise draws them from a
``torch.Generator`` on the fleet's device; ``minimize_batched`` takes a
run's draws (``_lane.Draws``, lane axis leading, lane b reading row
``iteration[b]``).  The JAX engine's per-lane ``keys`` have no
counterpart.

The chains are unbounded.  The JAX package's SANN, row and fleet, takes
``bounds`` and ignores them without a word; ``minimize_batched`` here
raises ``ValueError`` instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult
from ..core.lanes import Lanes, as_lanes
from ._lane import Draws, draws_on, lane_result, run_batched, step_rows, tree_map

# host loop: steps between two reads of done.all() in minimize_batched
CHECK_EVERY = 16


@dataclass(frozen=True)
class SANNConfig:
    """Defaults from nlsolver.h:2757-2759."""

    max_iter: int = 5000
    temperature_iter: int = 10
    temperature_max: float = 10.0
    # compare a proposal with the best value seen instead of the chain's
    # current value: the reference's quirk, which can freeze a chain
    metropolis_vs_best: bool = False


E_MINUS_1 = 1.7182818  # reference truncation (nlsolver.h:2779)


class SANNBatchState(NamedTuple):
    p: torch.Tensor            # [n, B] current chain points
    f_p: torch.Tensor          # [B]
    x_best: torch.Tensor       # [n, B]
    best_value: torch.Tensor   # [B]
    iteration: torch.Tensor    # [B] int32
    nfev: torch.Tensor         # [B] int32
    done: torch.Tensor         # [B] bool
    converged: torch.Tensor    # [B] bool


class SANNDraws(NamedTuple):
    """One outer iteration's draws, to replay a trajectory exactly."""

    noise: torch.Tensor   # [n_inner, n, B] standard normals
    u: torch.Tensor       # [n_inner, B] acceptance uniforms


def eval_columns(fn, X: torch.Tensor) -> torch.Tensor:
    """Score every chain point: ``[n, B] -> [B]``, ``fn`` on one point
    ``[n]`` (or a ``Lanes``) through ``vmap`` (the JAX engine's
    ``_eval_cols``)."""
    return as_lanes(fn).columns()(X)


def step_draws(config: SANNConfig, n: int, B: int, generator: torch.Generator, dtype,
               device) -> SANNDraws:
    """A ``step``'s draws from ``generator``: the noise ``[n_inner, n, B]``,
    then the acceptance uniforms ``[n_inner, B]``."""
    n_inner = config.temperature_iter - 1
    return SANNDraws(
        torch.randn((n_inner, n, B), generator=generator, dtype=dtype, device=device),
        torch.rand((n_inner, B), generator=generator, dtype=dtype, device=device),
    )


def from_rows(draws):
    """A step's draws in the lane-leading layout (``noise [B, n_inner, n]``,
    ``u [B, n_inner]``) as the fleet's."""
    if draws is None:
        return None
    return SANNDraws(draws.noise.permute(1, 2, 0), draws.u.T)


def init(fn, x0: torch.Tensor, config: SANNConfig) -> SANNBatchState:
    """x0: [B, n] start points."""
    B, _ = x0.shape
    p = x0.T.contiguous()   # [n, B] in memory too, as every array of the step
    val = eval_columns(fn, p)
    no = torch.zeros((B,), dtype=torch.bool, device=x0.device)
    return SANNBatchState(
        p=p,
        f_p=val,
        x_best=p,
        best_value=val,
        iteration=torch.zeros((B,), dtype=torch.int32, device=x0.device),
        nfev=torch.ones((B,), dtype=torch.int32, device=x0.device),
        done=no,
        converged=no,
    )


def step(
    fn,
    state: SANNBatchState,
    config: SANNConfig,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[SANNDraws] = None,
) -> SANNBatchState:
    """One outer iteration (``temperature_iter - 1`` proposals) for every
    lane; lanes that are or become done stay frozen.  Reads nothing back
    from the device."""
    n, B = state.p.shape
    dtype, dev = state.p.dtype, state.p.device
    n_inner = config.temperature_iter - 1

    done_now = state.iteration >= config.max_iter
    log_term = torch.log(state.iteration.to(dtype) + E_MINUS_1)
    # divided by 0-d tensors, as JAX divides: a Python number over a tensor
    # is its reciprocal times the number, and the card multiplies a tensor
    # by a number's reciprocal
    t_max = log_term.new_full((), config.temperature_max)
    t = t_max / log_term                        # [B]
    scale = t / t_max                           # [B]

    if draws is None:
        if generator is None:
            raise ValueError("step needs draws= or generator=")
        draws = step_draws(config, n, B, generator, dtype, dev)

    p, f_p, x_best, best_value = state.p, state.f_p, state.x_best, state.best_value
    for j in range(n_inner):
        p_try = p + scale[None, :] * draws.noise[j]
        val = eval_columns(fn, p_try)
        anchor = best_value if config.metropolis_vs_best else f_p
        diff = val - anchor
        accept = (diff <= 0.0) | (draws.u[j] < torch.exp(-diff / t))
        p = torch.where(accept[None, :], p_try, p)
        f_p = torch.where(accept, val, f_p)
        better = accept & (val <= best_value)
        x_best = torch.where(better[None, :], p_try, x_best)
        best_value = torch.where(better, val, best_value)

    act = ~(state.done | done_now)
    return SANNBatchState(
        p=torch.where(act[None, :], p, state.p),
        f_p=torch.where(act, f_p, state.f_p),
        x_best=torch.where(act[None, :], x_best, state.x_best),
        best_value=torch.where(act, best_value, state.best_value),
        iteration=state.iteration + act.to(torch.int32),
        nfev=state.nfev + n_inner * act.to(torch.int32),
        done=state.done | done_now,
        # SANN terminates only on max_iter (nlsolver.h:2787)
        converged=state.done | done_now,
    )


def _finalize(state, flip_sign: bool) -> SolverResult:
    return lane_result(state.x_best.T, state.best_value, state, flip_sign)


def _run(lanes: Lanes, x0: torch.Tensor, config: SANNConfig, _minimize: bool, draws,
         generator, shard=None) -> SolverResult:
    """The chains of ``x0`` to their end.  ``shard = (width, part)`` runs
    the lanes ``part`` of a fleet of ``width`` (``parallel.fleet_sharded``;
    by default the whole fleet): the generator's draws are made for the
    whole width and cut to ``part``, so each lane draws what it draws in
    the whole fleet."""
    if draws is None and generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    draws = draws_on(draws, x0.device)
    width, part = shard if shard is not None else (x0.shape[0], slice(None))

    def fresh():
        return tree_map(step_draws(config, x0.shape[1], width, generator, x0.dtype, x0.device),
                        lambda a: a[..., part])

    state = init(lanes, x0, config)
    while not bool(state.done.all()):
        for _ in range(CHECK_EVERY):
            rows = None if draws is None else step_rows(draws.steps, state.iteration)
            state = step(lanes, state, config,
                         draws=fresh() if draws is None else from_rows(rows))
    return _finalize(state, flip_sign=not _minimize)


def no_bounds(bounds) -> None:
    if bounds is not None:
        raise ValueError(
            "method='sann' takes no bounds=: its chains are unbounded, and the JAX package's "
            "SANN ignores bounds= without a word; use method='pso' or 'nmpso' with bounds= "
            "for a box")


def minimize_batched(fn, x0: torch.Tensor, config: SANNConfig = SANNConfig(),
                     bounds: Optional[Bounds] = None, *, draws: Optional[Draws] = None,
                     generator: Optional[torch.Generator] = None, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Run the chains of ``x0 [B, n]`` until every lane is done:
    ``jax.vmap`` of the JAX ``minimize``.  The draws come from ``draws``
    (``Draws(None, StepDraws of [T, B, ...])``, lane axis leading as in
    ``solvers.sann``) or from ``generator`` (on ``x0``'s device, seed 0 by
    default), which takes the place of the JAX package's per-lane ``keys``;
    ``done`` is read on the host once every ``CHECK_EVERY`` steps."""
    no_bounds(bounds)
    return run_batched(_run, fn, x0, config, data, _minimize, draws, generator)
