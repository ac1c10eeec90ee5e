"""Sequential-consumption replay of the reference DE: stochastic trajectory
parity (counterpart of ``nlsolver_tpu.solvers.de_reference``).

The production DE (``de``, ``de_batched``) draws from a
``torch.Generator`` and does not reproduce the reference's random stream.
This module does: it replays ``DE::solve`` (nlsolver.h:2404-2476) draw for
draw on the bit-parity reference generators (``random.reference_rngs``),
so a run lands on the same population trajectory as the reference binary
(tests/data/reference_trajectories.tsv, ``nlsolver_torch.parity``).

Consumption order, per generation, per agent ``i`` (nlsolver.h:2449-2472;
agents mutate in place, so later agents see earlier agents' accepted
proposals within the SAME generation):

1. ``generate_indices`` (nlsolver.h:2331-2355): draw ``u``, candidate =
   ``(size_t)(u * pop)``, rejected (and drawn again) while it collides with
   the fixed agent or a partner already taken: a data-dependent number of
   draws, each candidate read on the host.
2. one draw for the always-mutated dimension (nlsolver.h:2364).
3. exactly one draw per dimension for the crossover test: the reference's
   ``generator() < crossover_probability || i == dim`` (nlsolver.h:2367)
   evaluates the generator FIRST, so the draw is consumed even when
   ``i == dim`` forces mutation.

One instance: agents ``[pop, n]``, every scalar 0-d, the generator state
on ``x0``'s device.  The state machine follows the ``init`` / ``step`` /
``done`` contract, so it composes with ``core.drive`` and
``core.drive_trace``; it is sequential by design (a loop over agents with
a rejection loop inside, one host read a candidate) and slow: a parity
tool, not a production path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core import (Objective, SolverResult, batch_eval, drive, exact_product, make_result,
                    signed, start_points, std_err)
from ..random import reference_rngs
from ._lane import scalar


@dataclass(frozen=True)
class DEReferenceConfig:
    """Reference defaults (nlsolver.h:2390-2394); ``rng`` picks the
    reference generator (its default-constructed seeding quirks included)."""

    crossover_prob: float = 0.9
    differential_weight: float = 0.8
    eps: float = 1e-3           # reference writes 10e-4
    pop_size: int = 50
    max_iter: int = 1000
    best_value_no_change: int = 50
    strategy: str = "random"    # RecombinationStrategy {random, best}
    rng: str = "xorshift"       # xorshift | xoshiro | splitmix


class DERefState(NamedTuple):
    agents: torch.Tensor         # [pop, n]
    scores: torch.Tensor         # [pop]
    rng: tuple                   # the reference generator's state
    best_id: torch.Tensor        # running best index (nlsolver.h:2428, 2432-2437)
    val_no_change: torch.Tensor
    iteration: torch.Tensor
    nfev: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor


def init(fn: Objective, x0: torch.Tensor, config: DEReferenceConfig) -> DERefState:
    """``init_agents`` (nlsolver.h:2302-2323): agent-major, dimension-minor
    draws; agent[i, j] = (u - 0.5) * x0[j] (x0 is a width, not a place)."""
    n = x0.shape[-1]
    rng0, nxt = reference_rngs.make(config.rng, dtype=x0.dtype, device=x0.device)
    us, rng = reference_rngs.sample(rng0, nxt, config.pop_size * n)
    agents = (us.reshape(config.pop_size, n) - 0.5) * x0[None, :]
    false = scalar(False, x0, torch.bool)
    return DERefState(
        agents=agents,
        scores=batch_eval(fn, agents),
        rng=rng,
        best_id=scalar(0, x0),
        val_no_change=scalar(0, x0),
        iteration=scalar(0, x0),
        nfev=scalar(config.pop_size, x0),
        done=false,
        converged=false,
    )


def _best_scan(scores: torch.Tensor, best_id: torch.Tensor):
    """The reference's running best scan (nlsolver.h:2432-2437), over the
    last axis (a trace's leading axes ride along).  It ends on the first
    argmin iff some score beats the incumbent; on ties the incumbent stays
    (strict <), so this is NOT plain argmin."""
    current = scores.gather(-1, best_id.long()[..., None])[..., 0]
    updated = scores.amin(dim=-1) < current
    new_id = torch.where(updated, scores.argmin(dim=-1).to(best_id.dtype), best_id)
    return new_id, updated


def step(fn: Objective, state: DERefState, config: DEReferenceConfig) -> DERefState:
    pop, n = state.agents.shape
    dtype, dev = state.agents.dtype, state.agents.device
    _, nxt = reference_rngs.make(config.rng, dtype=dtype, device=dev)

    best_id, updated = _best_scan(state.scores, state.best_id)
    # val_no_change = not_updated * (val_no_change + 1)  (nlsolver.h:2440)
    val_no_change = torch.where(updated, torch.zeros_like(state.val_no_change),
                                state.val_no_change + 1)
    hit_tol = (val_no_change >= config.best_value_no_change) | (std_err(state.scores) < config.eps)
    done_now = (state.iteration >= config.max_iter) | hit_tol
    if bool(done_now):
        # the generation below would be discarded (tree_where in the JAX step)
        return state._replace(best_id=best_id, val_no_change=val_no_change,
                              done=torch.ones_like(state.done), converged=hit_tol)

    cp = torch.tensor(config.crossover_prob, dtype=dtype, device=dev)
    fw = torch.tensor(config.differential_weight, dtype=dtype, device=dev)
    pop_f = torch.tensor(float(pop), dtype=dtype, device=dev)
    n_f = torch.tensor(float(n), dtype=dtype, device=dev)
    dims = torch.arange(n, device=dev)
    rows = list(state.agents.unbind(0))     # agents mutate in place, row by row
    scores = list(state.scores.unbind(0))
    rng = state.rng
    best = int(best_id)
    for i in range(pop):
        fixed = best if config.strategy == "best" else i
        # generate_indices: the rejection loop over the set {fixed} + the
        # partners taken so far
        partners = []
        while len(partners) < 3:
            u, rng = nxt(rng)
            cand = int((u * pop_f).to(torch.int32))      # (size_t)(u * max)
            if cand != fixed and cand not in partners:
                partners.append(cand)
        r1, r2, r3 = partners
        # propose_new_agent (nlsolver.h:2357-2375): the forced dimension,
        # then one crossover draw per dimension
        u, rng = nxt(rng)
        forced = (u * n_f).to(torch.int32)
        us, rng = reference_rngs.sample(rng, nxt, n)
        mutate = (us < cp) | (dims == forced)
        donor = rows[r1] + exact_product(fw * (rows[r2] - rows[r3]))
        proposal = torch.where(mutate, donor, rows[fixed])
        score = fn(proposal)
        accept = score < scores[i]
        rows[i] = torch.where(accept, proposal, rows[i])
        scores[i] = torch.where(accept, score, scores[i])

    return DERefState(
        agents=torch.stack(rows),
        scores=torch.stack(scores),
        rng=rng,
        best_id=best_id,
        val_no_change=val_no_change,
        iteration=state.iteration + 1,
        nfev=state.nfev + pop,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )


def report_best(state: DERefState) -> torch.Tensor:
    """The index the reference would report if it stopped now: one more
    best scan at loop entry (nlsolver.h:2432-2443).  Idempotent on frozen
    states; a trace's states take it along their leading axis."""
    return _best_scan(state.scores, state.best_id)[0]


def _finalize(state: DERefState, flip_sign: bool) -> SolverResult:
    b = int(report_best(state))
    f_val = state.scores[b]
    return make_result(x=state.agents[b], f_value=-f_val if flip_sign else f_val,
                       iterations=state.iteration, function_calls=state.nfev,
                       converged=state.converged)


def no_replay_bounds(bounds) -> None:
    """The JAX replays take ``bounds`` and ignore them; the port's refuse
    them."""
    if bounds is not None:
        raise ValueError("the reference replays are unconstrained and take no bounds= (the "
                         "JAX package's replay ignores them without a word)")


def minimize(fn: Objective, x0, config: DEReferenceConfig = DEReferenceConfig(), bounds=None, *,
             _minimize: bool = True) -> SolverResult:
    """Replay the reference DE from ``x0 [n]``; a start point that is no
    tensor goes to the card."""
    no_replay_bounds(bounds)
    sfn = signed(fn, _minimize)
    state = init(sfn, start_points(x0), config)
    state = drive(lambda s: step(sfn, s, config), state, check_every=1)
    return _finalize(state, flip_sign=not _minimize)


def maximize(fn, x0, config: DEReferenceConfig = DEReferenceConfig(), bounds=None):
    return minimize(fn, x0, config, bounds, _minimize=False)
