"""Differential Evolution with populations sharded over a mesh (counterpart
of ``nlsolver_tpu.parallel.de_sharded``).

The JAX package's flagship distributed solver, one SPMD program a rank
over a (dp, pop) mesh:

  * ``dp``: independent problem instances, a block of them a rank;
  * ``pop``: each instance's agents, a block of them a rank;
  * once a generation the ranks of one dp block gather their agents and
    scores over the ``pop`` subgroup in ONE packed ``all_gather`` (the
    agents with the score as one more column, in the promoted dtype), pick
    global partners for their own agents, score the proposals and keep the
    better of each pair;
  * termination is read on the gathered scores (the same on every pop
    rank), and the loop ends when the count of running instances summed
    over the world (one ``all_reduce``) is 0, so every rank runs the same
    number of generations.

The draws are layout-invariant: each comes from Philox4x32-10 keyed by the
run's seed and counted by (instance, global agent id, iteration), never by
rank (the JAX package folds the same three into its keys): the initial
uniforms, the crossover uniforms, the forced dimension and the raw draws
of the three partners (``random.sampling.distinct_indices(raw=...)``).
``draws=`` injects all of them instead (``ShardedDraws``), which is how the
tests hand the port the JAX package's own.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from ..core import SolverResult, make_result, start_points, std_err
from ..ops.de_fused import philox4x32_10
from ..random.sampling import distinct_indices
from ..solvers.de import DEConfig
from .mesh import DP_AXIS, POP_AXIS, all_gather, all_sum, block, check_device, coordinate
from .mesh import gather_result

# the Philox streams, in the high byte of the first counter word
_INIT, _CROSS, _INDEX = 0, 1, 2


class ShardedDraws(NamedTuple):
    """A run's draws over the whole fleet, to replay a trajectory: lane b's
    step reads row ``iteration[b]`` of the step draws."""

    init: torch.Tensor    # [B, P, n] initial uniforms
    u: torch.Tensor       # [T, B, P, n] crossover uniforms
    fdim: torch.Tensor    # [T, B, P] forced dimensions
    raw: torch.Tensor     # [T, B, P, 3] partner draws before the shift, j-th in [0, P-1-j)


def _words(seed: int, stream: int, groups: int, inst: torch.Tensor, agents: torch.Tensor,
           iteration: torch.Tensor) -> torch.Tensor:
    """Philox words ``[b, p, 4 groups]`` counted by (stream and group,
    agent, instance, iteration) and keyed by the seed."""
    g = torch.arange(groups, dtype=torch.int64, device=inst.device)[None, None, :]
    ctr = torch.broadcast_tensors((stream << 24) | g, agents[None, :, None],
                                  inst[:, None, None], iteration[:, None, None])
    words = philox4x32_10(ctr, seed, seed >> 32)
    return torch.stack(words, dim=-1).reshape(inst.shape[0], agents.shape[0], 4 * groups)


def _uniform(words: torch.Tensor, dtype) -> torch.Tensor:
    """[0, 1) from 32-bit words: 24 bits in float32, 32 in float64."""
    if dtype == torch.float64:
        return words.to(dtype) * 2.0**-32
    return (words >> 8).to(dtype) * 2.0**-24


def _below(words: torch.Tensor, m: int) -> torch.Tensor:
    """An integer in [0, m) from each 32-bit word (multiply and shift)."""
    return (words * m) >> 32


def _init_uniforms(seed, inst, agents, n, dtype):
    return _uniform(_words(seed, _INIT, (n + 3) // 4, inst, agents, torch.zeros_like(inst))[..., :n],
                    dtype)


def _step_draws(seed, inst, agents, iteration, n, P, dtype):
    """(u [b, p, n], fdim [b, p], raw [b, p, 3]) of a generation."""
    u = _uniform(_words(seed, _CROSS, (n + 3) // 4, inst, agents, iteration)[..., :n], dtype)
    w = _words(seed, _INDEX, 1, inst, agents, iteration)
    raw = torch.stack([_below(w[..., 1 + j], P - 1 - j) for j in range(3)], dim=-1)
    return u, _below(w[..., 0], n), raw


def gather_population(agents: torch.Tensor, scores: torch.Tensor, group):
    """ONE packed gather over the pop subgroup: ``[b, p_loc, n+1]`` in the
    promoted dtype (exact for both), cast back on unpacking."""
    n = agents.shape[-1]
    pdt = torch.promote_types(agents.dtype, scores.dtype)
    packed = torch.cat([agents.to(pdt), scores[..., None].to(pdt)], dim=-1)
    g = all_gather(packed, group, dim=1)
    return g[..., :n].to(agents.dtype), g[..., n].to(scores.dtype)


def _generation(fn, state: dict, config: DEConfig, P: int, agent_ids, draws_of, group) -> dict:
    """One generation of every instance of the rank's block; instances that
    are or become done stay frozen."""
    agents_g, scores_g = gather_population(state["agents"], state["scores"], group)
    b, p_loc, n = state["agents"].shape
    best_now = scores_g.amin(dim=1)
    improved = best_now < state["best_value"]
    val_no_change = torch.where(improved, 0, state["val_no_change"] + 1)
    hit_tol = (val_no_change >= config.best_value_no_change) | (
        std_err(scores_g, dim=1) < config.eps)
    done_now = (state["iteration"] >= config.max_iter) | hit_tol

    if config.strategy == "best":
        fixed = scores_g.argmin(dim=1)[:, None].expand(b, p_loc)
    else:
        fixed = agent_ids[None, :].expand(b, p_loc)
    u, fdim, raw = draws_of(state["iteration"])
    r = distinct_indices(None, P, fixed, k=3, raw=raw)

    def pick(idx):
        return torch.gather(agents_g, 1, idx[..., None].expand(b, p_loc, n))

    donor = pick(r[..., 0]) + config.differential_weight * (pick(r[..., 1]) - pick(r[..., 2]))
    mutate = (u < config.crossover_prob) | (
        torch.arange(n, device=u.device) == fdim[..., None])
    proposals = torch.where(mutate, donor, pick(fixed))
    prop_scores = vmap(fn)(proposals.reshape(b * p_loc, n)).reshape(b, p_loc)
    accept = prop_scores < state["scores"]

    worked = dict(
        agents=torch.where(accept[..., None], proposals, state["agents"]),
        scores=torch.where(accept, prop_scores, state["scores"]),
        best_value=best_now,
        iteration=state["iteration"] + 1,
        nfev=state["nfev"] + P,
        val_no_change=val_no_change,
        done=torch.zeros_like(state["done"]),
        converged=torch.zeros_like(state["converged"]),
    )
    halted = dict(state, best_value=best_now, val_no_change=val_no_change,
                  done=torch.ones_like(state["done"]), converged=hit_tol)
    frozen = done_now | state["done"]

    def lanes(mask, like):
        return mask.reshape(mask.shape + (1,) * (like.ndim - 1))

    return {k: torch.where(lanes(frozen, worked[k]),
                           torch.where(lanes(state["done"], worked[k]), state[k], halted[k]),
                           worked[k])
            for k in worked}


def minimize_sharded(
    fn,
    x0,                         # [B, n] per-instance widths
    config: DEConfig,
    mesh,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[ShardedDraws] = None,
) -> SolverResult:
    """Solve B instances, each with a population sharded over pop.

    The draws are Philox keyed by ``generator``'s initial seed (0 without
    one), or ``draws``.  Every rank passes the same global
    inputs and returns the global result."""
    x0 = start_points(x0)
    B, n = x0.shape
    P = config.pop_size
    dp_size, pop_shards = mesh.size(0), mesh.size(1)
    if B % dp_size or P % pop_shards:
        raise ValueError(
            f"batch {B} must divide over dp={dp_size} and "
            f"pop_size {P} over pop={pop_shards}"
        )
    check_device(x0, mesh)
    seed = generator.initial_seed() if generator is not None else 0
    dev, dtype = x0.device, x0.dtype
    dp_i, pop_i = coordinate(mesh)
    inst_part, agent_part = block(B, dp_size, dp_i), block(P, pop_shards, pop_i)
    inst = torch.arange(B, dtype=torch.int64, device=dev)[inst_part]
    agent_ids = torch.arange(P, dtype=torch.int64, device=dev)[agent_part]
    x0_loc = x0[inst_part]
    b, p_loc = inst.shape[0], agent_ids.shape[0]

    if draws is None:
        u0 = _init_uniforms(seed, inst, agent_ids, n, dtype)

        def draws_of(iteration):
            return _step_draws(seed, inst, agent_ids, iteration.to(torch.int64), n, P, dtype)
    else:
        own = (slice(None), inst_part, agent_part)
        u0 = torch.as_tensor(draws.init, device=dev)[inst_part, agent_part].to(dtype)
        steps = [torch.as_tensor(a, device=dev)[own] for a in (draws.u, draws.fdim, draws.raw)]
        lane = torch.arange(b, device=dev)

        def draws_of(iteration):
            row = iteration.to(torch.int64).clamp(max=steps[0].shape[0] - 1)
            u, fdim, raw = (a[row, lane] for a in steps)
            return u.to(dtype), fdim.to(torch.int64), raw

    agents = (u0 - 0.5) * x0_loc[:, None, :]        # nlsolver.h:2302-2323
    scores = vmap(fn)(agents.reshape(b * p_loc, n)).reshape(b, p_loc)
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    no = torch.zeros((b,), dtype=torch.bool, device=dev)
    state = dict(agents=agents, scores=scores,
                 best_value=torch.full((b,), torch.inf, dtype=scores.dtype, device=dev),
                 iteration=zeros, nfev=torch.full((b,), P, dtype=torch.int32, device=dev),
                 val_no_change=zeros, done=no, converged=no)
    group = mesh.get_group(POP_AXIS)
    while all_sum((~state["done"]).sum()):
        state = _generation(fn, state, config, P, agent_ids, draws_of, group)
    agents_g, scores_g = gather_population(state["agents"], state["scores"], group)
    best = scores_g.argmin(dim=1)
    x_best = torch.gather(agents_g, 1, best[:, None, None].expand(b, 1, n))[:, 0, :]
    f_best = torch.gather(scores_g, 1, best[:, None])[:, 0]
    res = make_result(x=x_best, f_value=f_best, iterations=state["iteration"],
                      function_calls=state["nfev"], converged=state["converged"])
    return gather_result(res, mesh.get_group(DP_AXIS), x_lane_dim=0)
