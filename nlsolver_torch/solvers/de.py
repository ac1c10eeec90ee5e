"""Differential Evolution: ``DEConfig`` (field for field the JAX
package's) and the row-layout solver on lane tensors (counterpart of
``nlsolver_tpu.solvers.de``; the reference's ``DE``,
nlsolver.h:2379-2477).  The batch-minor fleet is ``solvers.de_batched``.

The JAX solver keeps one population ``[P, n]`` and is batched with
``jax.vmap``.  Here every lane runs at once: agents ``[B, P, n]``, scores
``[B, P]``, every scalar a ``[B]`` vector; ``core.drive`` freezes the lanes
done when a step begins, as a vmapped ``lax.while_loop`` does.  The
semantics are the JAX solver's: agents start at ``(U[0,1) - 0.5) * x0``
(x0 a per-dimension width, nlsolver.h:2302-2323), each generation draws
distinct partners with the successive-shift sampler
(``random.sampling.distinct_indices``), a forced dimension and binomial
crossover, and selects greedily; the stop is max_iter, the best value
unchanged for ``best_value_no_change`` generations or the sample std of
the scores below ``eps`` (nlsolver.h:2441-2443).

Randomness is explicit.  ``init`` takes the uniforms ``[B, P, n]`` and
``step`` a ``StepDraws`` (the partners' raw draws before the shift, the
forced dimensions, the crossover uniforms), or they draw from a
``torch.Generator``; ``minimize_batched`` takes a run's draws
(``_lane.Draws``, lane b reading row ``iteration[b]``).  The state has no
key.  The JAX ``minimize`` takes ``bounds`` and ignores them; this one
refuses them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, drive, std_err, where_lanes
from ..core.lanes import Lanes, as_lanes
from ..random.sampling import distinct_indices
from ._lane import (Draws, draws_on, gather_lanes, lane_full, lane_result, one_lane, run_batched,
                    run_single, step_rows)


@dataclass(frozen=True)
class DEConfig:
    """Hyperparameters with the reference's defaults (nlsolver.h:2390-2394)."""

    crossover_prob: float = 0.9
    differential_weight: float = 0.8
    eps: float = 1e-3           # reference writes 10e-4
    pop_size: int = 50
    max_iter: int = 1000
    best_value_no_change: int = 50
    strategy: str = "random"    # RecombinationStrategy {random, best} (:2377)
    # partner sampling of the batched engine:
    #   "uniform"  - per-agent uniform distinct partners (reference
    #                semantics, nlsolver.h:2331-2355);
    #   "rotation" - agent i's partners are (i+o1, i+o2, i+o3) mod P, the
    #                three offsets drawn fresh each generation from
    #                disjoint ranges (distinct, nonzero).
    partner_sampling: str = "uniform"
    # batched engine only: run each generation as the fused CUDA kernel
    # (ops/de_fused.py): mutation, crossover, objective and greedy
    # selection in one pass.  Requires partner_sampling="rotation" and,
    # on the card, an objective from the kernel's registry.
    use_fused_kernel: bool = False


class DEState(NamedTuple):
    agents: torch.Tensor         # [B, P, n]
    scores: torch.Tensor         # [B, P]
    best_value: torch.Tensor     # [B] best score seen at the last check
    iteration: torch.Tensor      # [B] int32
    nfev: torch.Tensor           # [B] int32
    val_no_change: torch.Tensor  # [B] int32
    done: torch.Tensor           # [B] bool
    converged: torch.Tensor      # [B] bool


class StepDraws(NamedTuple):
    """One generation's draws of every lane."""

    partners: torch.Tensor  # [B, P, 3] raw draws before the shift, draw j in [0, P - 1 - j)
    fdim: torch.Tensor      # [B, P] the always-mutated dimension
    u: torch.Tensor         # [B, P, n] crossover uniforms


def init(fn, x0: torch.Tensor, config: DEConfig = DEConfig(), *,
         generator: Optional[torch.Generator] = None, draws: Optional[torch.Tensor] = None,
         data=None) -> DEState:
    """Agents ``(U[0,1) - 0.5) * x0`` for every lane of ``x0 [B, n]``;
    ``draws`` are the uniforms ``[B, P, n]``, else ``generator`` draws them."""
    lanes = as_lanes(fn, data)
    B, n = x0.shape
    P = config.pop_size
    if draws is None:
        if generator is None:
            raise ValueError("init needs draws= or generator=")
        draws = torch.rand((B, P, n), generator=generator, dtype=x0.dtype, device=x0.device)
    agents = (draws - 0.5) * x0[:, None, :]
    scores = lanes.points(agents)
    i32 = torch.int32
    return DEState(
        agents=agents,
        scores=scores,
        best_value=scores.amin(dim=1),
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, P, i32),
        val_no_change=lane_full(x0, 0, i32),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def random_draws(agents: torch.Tensor, generator: Optional[torch.Generator]) -> StepDraws:
    """A generation's draws from ``generator``."""
    if generator is None:
        raise ValueError("step needs draws= or generator=")
    B, P, n = agents.shape
    kw = {"generator": generator, "device": agents.device}
    partners = torch.stack([torch.randint(0, P - 1 - j, (B, P), **kw) for j in range(3)], dim=-1)
    return StepDraws(partners, torch.randint(0, n, (B, P), **kw),
                     torch.rand((B, P, n), dtype=agents.dtype, **kw))


def step(fn, state: DEState, config: DEConfig = DEConfig(), *,
         draws: Optional[StepDraws] = None, generator: Optional[torch.Generator] = None,
         data=None) -> DEState:
    lanes = as_lanes(fn, data)
    agents, scores = state.agents, state.scores
    B, P, n = agents.shape

    best_now = scores.amin(dim=1)
    improved = best_now < state.best_value
    val_no_change = torch.where(improved, 0, state.val_no_change + 1)
    hit_tol = (val_no_change >= config.best_value_no_change) | (
        std_err(scores, dim=1) < config.eps
    )
    done_now = (state.iteration >= config.max_iter) | hit_tol

    if draws is None:
        draws = random_draws(agents, generator)
    if config.strategy == "best":
        fixed = scores.argmin(dim=1, keepdim=True).expand(B, P)
    else:
        fixed = torch.arange(P, device=agents.device).expand(B, P)
    r = distinct_indices(None, P, fixed, k=3, raw=draws.partners)          # [B, P, 3]
    dims = torch.arange(n, device=agents.device)
    mutate = (draws.u < config.crossover_prob) | (dims == draws.fdim[..., None])

    def pick(idx):
        return torch.gather(agents, 1, idx[..., None].expand(B, P, n))

    donor = pick(r[..., 0]) + config.differential_weight * (pick(r[..., 1]) - pick(r[..., 2]))
    proposals = torch.where(mutate, donor, pick(fixed))

    prop_scores = lanes.points(proposals)
    accept = prop_scores < scores
    worked = DEState(
        agents=torch.where(accept[..., None], proposals, agents),
        scores=torch.where(accept, prop_scores, scores),
        best_value=best_now,
        iteration=state.iteration + 1,
        nfev=state.nfev + P,
        val_no_change=val_no_change,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    halted = state._replace(best_value=best_now, val_no_change=val_no_change,
                            done=torch.ones_like(state.done), converged=hit_tol)
    return where_lanes(done_now, halted, worked)


def _finalize(state: DEState, flip_sign: bool) -> SolverResult:
    best = state.scores.argmin(dim=1)
    return lane_result(gather_lanes(state.agents, best), gather_lanes(state.scores, best), state,
                       flip_sign)


# generations between two reads of done.all()
CHECK_EVERY = 16


def _run(lanes: Lanes, x0: torch.Tensor, config: DEConfig, _minimize: bool, draws,
         generator) -> SolverResult:
    if draws is None and generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    draws = draws_on(draws, x0.device)
    state = init(lanes, x0, config, generator=generator,
                 draws=None if draws is None else draws.init)

    def advance(s):
        return step(lanes, s, config, generator=generator,
                    draws=None if draws is None else step_rows(draws.steps, s.iteration))

    state = drive(advance, state, check_every=CHECK_EVERY)
    return _finalize(state, flip_sign=not _minimize)


def _no_bounds(bounds) -> None:
    if bounds is not None:
        raise ValueError(
            "method='de' takes no bounds= (the JAX package's row-layout DE ignores them without "
            "a word, and x0 is a per-dimension width); use method='pso' or 'nmpso' with bounds= "
            "for a box")


def minimize_batched(fn, x0: torch.Tensor, config: DEConfig = DEConfig(),
                     bounds: Optional[Bounds] = None, *, draws: Optional[Draws] = None,
                     generator: Optional[torch.Generator] = None, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]``: ``jax.vmap`` of the JAX ``minimize``.
    The draws come from ``draws`` (``Draws(init [B, P, n], StepDraws of
    [T, B, ...])``) or from ``generator`` (on ``x0``'s device, seed 0 by
    default)."""
    _no_bounds(bounds)
    return run_batched(_run, fn, x0, config, data, _minimize, draws, generator)


def minimize(fn, x0: torch.Tensor, config: DEConfig = DEConfig(),
             bounds: Optional[Bounds] = None, *, draws: Optional[Draws] = None,
             generator: Optional[torch.Generator] = None, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the lane engine at B = 1, squeezed; ``draws``
    without the lane axis."""
    _no_bounds(bounds)
    return run_single(_run, fn, x0, config, data, _minimize, one_lane(draws), generator)


def maximize(fn, x0, config: DEConfig = DEConfig(), bounds=None, *, draws=None, generator=None,
             data=None):
    return minimize(fn, x0, config, bounds, draws=draws, generator=generator, data=data,
                    _minimize=False)
