"""Batched Differential Evolution over a fleet of independent instances,
agents laid out ``[B, n, P]`` (counterpart of
``nlsolver_tpu.solvers.de_batched``).

Semantics follow the JAX engine: the reference's init-width quirk, greedy
selection, and the termination rule (max_iter, best value unchanged for
``best_value_no_change`` generations, or sample std of the scores below
``eps``), with finished lanes frozen.

Randomness is explicit.  ``init`` and ``step`` take an optional ``draws``
argument; without it:

  * the ring offsets come from a CPU ``torch.Generator`` seeded from the
    state's ``(seed, generation)``, so drawing them never waits on the card;
  * the fused kernel draws its crossover uniforms and forced dimensions
    from Philox keyed by ``(seed, generation)``;
  * the plain path draws them, and uniform partners, from the
    ``generator`` the caller passes.

The JAX engine's per-lane ``keys`` become the fleet-global ``generation``
counter.  The JAX engine keyed the ring offsets on lane 0, so they froze
once lane 0 finished; the port's offsets keep changing per generation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, drive, make_result, signed, std_err
from ..ops.de_fused import de_generation_fused, eval_columns
from ..random.sampling import distinct_indices
from .de import DEConfig


class DEBatchState(NamedTuple):
    agents: torch.Tensor         # [B, n, P]
    scores: torch.Tensor         # [B, P]
    best_value: torch.Tensor     # [B]
    iteration: torch.Tensor      # [B] int32
    nfev: torch.Tensor           # [B] int32
    val_no_change: torch.Tensor  # [B] int32
    done: torch.Tensor           # [B] bool
    converged: torch.Tensor      # [B] bool
    generation: int              # fleet-global step counter (host)
    seed: int                    # keys the ring offsets and the kernel's Philox


class DEDraws(NamedTuple):
    """One generation's draws, to replay a trajectory exactly."""

    u: torch.Tensor                          # [B, n, P] crossover uniforms
    fdim: torch.Tensor                       # [B, P] forced dimensions
    offs: Optional[tuple] = None             # 3 ring offsets (rotation)
    partners: Optional[torch.Tensor] = None  # [B, P, 3] (uniform)


def ring_offsets(P: int, seed: int, generation: int) -> tuple[int, int, int]:
    """Three ring offsets from disjoint ranges (distinct, nonzero, never the
    target itself), as the JAX engine draws them; from a CPU generator."""
    third = max(P // 3, 1)
    g = torch.Generator().manual_seed(((seed & 0x7FFFFFFF) << 32) | (generation & 0xFFFFFFFF))
    bounds = ((1, third + 1), (third + 1, 2 * third + 1), (2 * third + 1, P))
    return tuple(int(torch.randint(lo, hi, (1,), generator=g)) for lo, hi in bounds)


def init(
    fn,
    x0: torch.Tensor,
    config: DEConfig,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
    seed: int = 0,
) -> DEBatchState:
    """``x0 [B, n]`` are per-dimension widths: agents are
    ``(U[0,1) - 0.5) * x0`` (nlsolver.h:2302-2323).  ``draws`` are the
    uniforms ``[B, n, P]``; otherwise ``generator`` draws them."""
    B, n = x0.shape
    P = config.pop_size
    if draws is None:
        if generator is None:
            raise ValueError("init needs draws= or generator=")
        draws = torch.rand((B, n, P), generator=generator, dtype=x0.dtype, device=x0.device)
    agents = (draws - 0.5) * x0[:, :, None]
    scores = eval_columns(fn, agents)
    zeros = torch.zeros((B,), dtype=torch.int32, device=x0.device)
    no = torch.zeros((B,), dtype=torch.bool, device=x0.device)
    return DEBatchState(
        agents=agents,
        scores=scores,
        best_value=scores.amin(dim=1),
        iteration=zeros,
        nfev=torch.full((B,), P, dtype=torch.int32, device=x0.device),
        val_no_change=zeros,
        done=no,
        converged=no,
        generation=0,
        seed=seed,
    )


def _propose(state: DEBatchState, config: DEConfig, draws: DEDraws,
             rotation: bool) -> torch.Tensor:
    """Mutation and binomial crossover of the plain path: ``[B, n, P]``."""
    A = state.agents
    B, n, P = A.shape
    F = config.differential_weight
    if rotation:
        a1, a2, a3 = (torch.roll(A, -o, dims=2) for o in draws.offs)
    else:
        # index gather in place of the JAX engine's one-hot matmul, which
        # only worked around slow gathers on the TPU
        r = draws.partners.to(torch.int64)
        a1, a2, a3 = (
            torch.gather(A, 2, r[:, None, :, k].expand(B, n, P)) for k in range(3)
        )
    donor = a1 + F * (a2 - a3)
    dims = torch.arange(n, device=A.device)[None, :, None]
    mutate = (draws.u < config.crossover_prob) | (dims == draws.fdim[:, None, :])
    if config.strategy == "best":
        best_col = state.scores.argmin(dim=1)
        base = torch.gather(A, 2, best_col[:, None, None].expand(B, n, 1))
    else:
        base = A
    return torch.where(mutate, donor, base)


def _plain_draws(state: DEBatchState, config: DEConfig,
                 generator: Optional[torch.Generator], rotation: bool) -> DEDraws:
    if generator is None:
        raise ValueError("step needs draws= or generator= for the plain path")
    A = state.agents
    B, n, P = A.shape
    u = torch.rand((B, n, P), generator=generator, dtype=A.dtype, device=A.device)
    fdim = torch.randint(0, n, (B, P), generator=generator, device=A.device)
    if rotation:
        return DEDraws(u, fdim, offs=ring_offsets(P, state.seed, state.generation))
    if config.strategy == "best":
        fixed = state.scores.argmin(dim=1, keepdim=True).expand(B, P)
    else:
        fixed = torch.arange(P, device=A.device).expand(B, P)
    return DEDraws(u, fdim, partners=distinct_indices(generator, P, fixed, k=3))


def step(
    fn,
    state: DEBatchState,
    config: DEConfig,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[DEDraws] = None,
) -> DEBatchState:
    """One generation for every lane; lanes that are or become done stay
    frozen.  Reads nothing back from the device."""
    B, n, P = state.agents.shape

    best_now = state.scores.amin(dim=1)
    improved = best_now < state.best_value
    val_no_change = torch.where(improved, 0, state.val_no_change + 1)
    hit_tol = (val_no_change >= config.best_value_no_change) | (
        std_err(state.scores, dim=1) < config.eps
    )
    done_now = (state.iteration >= config.max_iter) | hit_tol
    active = ~(state.done | done_now)

    rotation = config.partner_sampling == "rotation"
    if config.use_fused_kernel:
        if not rotation:
            raise ValueError(
                "DEConfig.use_fused_kernel requires partner_sampling='rotation'"
            )
        kw = {} if draws is None else {"u": draws.u, "fdim": draws.fdim}
        offs = ring_offsets(P, state.seed, state.generation) if draws is None else draws.offs
        new_agents, new_scores = de_generation_fused(
            fn, state.agents, state.scores, offs, active,
            seed=state.seed, generation=state.generation,
            cross_prob=config.crossover_prob, diff_weight=config.differential_weight,
            **kw,
        )
    else:
        if draws is None:
            draws = _plain_draws(state, config, generator, rotation)
        proposals = _propose(state, config, draws, rotation)
        prop_scores = eval_columns(fn, proposals)
        accept = (prop_scores < state.scores) & active[:, None]
        new_agents = torch.where(accept[:, None, :], proposals, state.agents)
        new_scores = torch.where(accept, prop_scores, state.scores)

    act = active.to(torch.int32)
    return DEBatchState(
        agents=new_agents,
        scores=new_scores,
        best_value=best_now,
        iteration=state.iteration + act,
        nfev=state.nfev + P * act,
        val_no_change=val_no_change,
        done=state.done | done_now,
        converged=torch.where(state.done, state.converged, hit_tol),
        generation=state.generation + 1,
        seed=state.seed,
    )


def _finalize(state: DEBatchState, flip_sign: bool) -> SolverResult:
    best = state.scores.argmin(dim=1)
    x = torch.gather(
        state.agents, 2, best[:, None, None].expand(-1, state.agents.shape[1], 1)
    )[:, :, 0]
    f = torch.gather(state.scores, 1, best[:, None])[:, 0]
    return make_result(
        x=x,
        f_value=-f if flip_sign else f,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )


def minimize_batched(
    fn,
    x0: torch.Tensor,                  # [B, n]
    config: DEConfig = DEConfig(),
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
    check_every: int = 16,
    _minimize: bool = True,
) -> SolverResult:
    """Run the fleet until every lane is done.  The fleet is unbounded:
    ``bounds`` raises ``ValueError``.

    ``generator`` (on ``x0``'s device) draws the initial agents and the
    plain path's randomness; its initial seed keys the ring offsets and the
    kernel's Philox.  The driver looks at ``done`` on the host once every
    ``check_every`` generations, and never runs more than
    ``max_iter + 1`` generations: by then every lane has stopped."""
    if bounds is not None:
        raise ValueError(
            "the lane-axis DE engine is unbounded, as is the row-layout DE (x0 is a "
            "per-dimension width); for a box use method='pso' or 'nmpso' with bounds="
        )
    if generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    sfn = signed(fn, _minimize)
    state = init(sfn, x0, config, generator=generator, seed=generator.initial_seed())
    state = drive(
        lambda s: step(sfn, s, config, generator=generator),
        state,
        check_every=check_every,
        max_steps=config.max_iter + 1,
    )
    return _finalize(state, flip_sign=not _minimize)
