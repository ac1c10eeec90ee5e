"""Island-model Differential Evolution over a mesh: island-local
generations with a ring migration (counterpart of
``nlsolver_tpu.parallel.de_island``).

Each pop rank is an island: its agents pick their partners among the
island's own (``distinct_indices`` over ``p_loc``; under ``"best"`` the
fixed agent is the island's argmin, and the base vector is always the
agent itself), and every ``migration_interval`` generations each island
sends its best member one hop around the ring (to island ``i + 1``, from
island ``i - 1``: ``ring_exchange``, one ``batch_isend_irecv`` of a packed
``[b, n + 1]`` block over the pop subgroup), where it replaces the worst
member if it is better.  This is another algorithm than the
population-sharded DE, not a sharding of it: the island count is a
hyperparameter, so a result does not depend on the dp split at a fixed
island count, but does on the island count itself.

The termination statistics (the best score and the spread over all
islands) come from ONE gather of each island's ``[3, b]`` minimum, sum and
sum of squares (``island_stats``); the partial sums are added in island
order after the gather, not by an ``all_reduce`` whose order the backend
picks, so every rank and every world with the same island count gets the
same bits.

  * the eager form runs the stats and the ring every generation (the
    migrant is taken only on a migration generation) and the world's
    count of running instances every ``sync_interval`` generations;
  * ``fused=True`` runs ``migration_interval`` generations with no
    collective at all, then exactly three: the stats gather, the ring and
    the world count.  A lane is checked only at those boundaries, and its
    stagnation counter grows by the interval there.

Both end with one gather of the islands' agents and scores for the best
member.  Draws are Philox by (instance, global agent, iteration)
(``_draws``), the partners' raw draws in ``[0, p_loc - 1 - j)``; ``draws=``
(``de_sharded.ShardedDraws``) replays a run's.  With one island the ring
is the identity and sends nothing (JAX's ``ppermute`` to itself).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.func import vmap

from ..core import SolverResult, make_result, start_points
from ..random.sampling import distinct_indices
from ..solvers.de import DEConfig
from ._draws import de_draws
from .de_sharded import ShardedDraws, best_member
from .mesh import DP_AXIS, POP_AXIS, all_gather, all_sum, block, check_device, coordinate
from .mesh import gather_result


def island_stats(scores: torch.Tensor, group, pop: int):
    """The best score ``[b]`` over every island and the sample spread of all
    ``pop`` scores ``[b]``, by ONE gather of each island's ``[3, b]``
    (min, sum, sum of squares); the sums added in island order."""
    b = scores.shape[0]
    packed = torch.stack([scores.amin(dim=1), scores.sum(dim=1), (scores ** 2).sum(dim=1)])
    g = all_gather(packed, group, dim=0).reshape(-1, 3, b)
    s1, s2 = g[0, 1], g[0, 2]
    for i in range(1, g.shape[0]):
        s1, s2 = s1 + g[i, 1], s2 + g[i, 2]
    mean = s1 / pop
    var = (s2 / pop - mean ** 2).clamp_min(0.0) * pop / max(pop - 1, 1)
    return g[:, 0].amin(dim=0), var.sqrt()


def ring_exchange(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` sent to the next rank of the pop subgroup, the previous rank's
    received (one ``batch_isend_irecv``); the identity on one rank."""
    size = dist.get_world_size(group)
    if size == 1:
        return t
    me = dist.get_group_rank(group, dist.get_rank())
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, (me + 1) % size),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - 1) % size), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _propose(fn, agents, scores, iteration, config: DEConfig, local_ids, draws_of):
    """An island-local generation's proposals ``[b, p_loc, n]`` and their
    scores ``[b, p_loc]``."""
    b, p_loc, n = agents.shape
    if config.strategy == "best":
        fixed = scores.argmin(dim=1)[:, None].expand(b, p_loc)
    else:
        fixed = local_ids[None, :].expand(b, p_loc)
    u, fdim, raw = draws_of(iteration)
    r = distinct_indices(None, p_loc, fixed, k=3, raw=raw)

    def pick(idx):
        return torch.gather(agents, 1, idx[..., None].expand(b, p_loc, n))

    donor = pick(r[..., 0]) + config.differential_weight * (pick(r[..., 1]) - pick(r[..., 2]))
    mutate = (u < config.crossover_prob) | (torch.arange(n, device=u.device) == fdim[..., None])
    proposals = torch.where(mutate, donor, agents)
    return proposals, vmap(fn)(proposals.reshape(b * p_loc, n)).reshape(b, p_loc)


def _migrate(agents, scores, group, allowed):
    """Each island's best member to the next island, where it replaces the
    worst member if better and ``allowed`` (``[b]``)."""
    b, _, n = agents.shape
    rows = torch.arange(b, device=agents.device)
    best = scores.argmin(dim=1)
    pdt = torch.promote_types(agents.dtype, scores.dtype)
    migrant = torch.cat([agents[rows, best].to(pdt), scores[rows, best][:, None].to(pdt)], dim=1)
    got = ring_exchange(migrant, group)
    im_x, im_val = got[:, :n].to(agents.dtype), got[:, n].to(scores.dtype)
    worst = scores.argmax(dim=1)
    worst_val = scores[rows, worst]
    take = allowed & (im_val < worst_val)
    agents, scores = agents.clone(), scores.clone()
    agents[rows, worst] = torch.where(take[:, None], im_x, agents[rows, worst])
    scores[rows, worst] = torch.where(take, im_val, worst_val)
    return agents, scores


def _generation(fn, state: dict, config: DEConfig, pop: int, interval: int, local_ids, draws_of,
                group) -> dict:
    """One eager generation of every instance of the rank's block; instances
    that are or become done stay frozen."""
    best_now, spread = island_stats(state["scores"], group, pop)
    improved = best_now < state["best_value"]
    val_no_change = torch.where(improved, 0, state["val_no_change"] + 1)
    hit_tol = (val_no_change >= config.best_value_no_change) | (spread < config.eps)
    done_now = (state["iteration"] >= config.max_iter) | hit_tol
    proposals, prop_scores = _propose(fn, state["agents"], state["scores"], state["iteration"],
                                      config, local_ids, draws_of)
    accept = prop_scores < state["scores"]
    agents, scores = _migrate(torch.where(accept[..., None], proposals, state["agents"]),
                              torch.where(accept, prop_scores, state["scores"]), group,
                              (state["iteration"] + 1) % interval == 0)
    worked = dict(
        agents=agents, scores=scores, best_value=best_now, iteration=state["iteration"] + 1,
        nfev=state["nfev"] + pop, val_no_change=val_no_change,
        done=torch.zeros_like(state["done"]), converged=torch.zeros_like(state["converged"]),
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


def _local_generation(fn, state: dict, config: DEConfig, pop: int, local_ids, draws_of) -> dict:
    """One island-local generation of the fused form: no collective."""
    frozen = state["done"] | (state["iteration"] >= config.max_iter)
    proposals, prop_scores = _propose(fn, state["agents"], state["scores"], state["iteration"],
                                      config, local_ids, draws_of)
    accept = (prop_scores < state["scores"]) & ~frozen[:, None]
    return dict(state,
                agents=torch.where(accept[..., None], proposals, state["agents"]),
                scores=torch.where(accept, prop_scores, state["scores"]),
                iteration=torch.where(frozen, state["iteration"], state["iteration"] + 1),
                nfev=torch.where(frozen, state["nfev"], state["nfev"] + pop))


def _boundary(state: dict, config: DEConfig, pop: int, interval: int, group) -> dict:
    """The fused form's block after an interval: the stats gather and the
    ring (the world count is the loop's)."""
    best_now, spread = island_stats(state["scores"], group, pop)
    agents, scores = _migrate(state["agents"], state["scores"], group, ~state["done"])
    improved = best_now < state["best_value"]
    val_no_change = torch.where(improved, 0, state["val_no_change"] + interval)
    hit_tol = (val_no_change >= config.best_value_no_change) | (spread < config.eps)
    newly_done = ~state["done"] & ((state["iteration"] >= config.max_iter) | hit_tol)
    return dict(state, agents=agents, scores=scores,
                best_value=torch.minimum(state["best_value"], best_now),
                val_no_change=val_no_change, done=state["done"] | newly_done,
                converged=torch.where(newly_done, hit_tol, state["converged"]))


def minimize_islands(
    fn,
    x0,                         # [B, n] per-instance widths
    config: DEConfig,
    mesh,
    migration_interval: int = 10,
    sync_interval: int = 1,
    fused: bool = False,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[ShardedDraws] = None,
) -> SolverResult:
    """Solve B instances, each with ``pop_size`` agents split into
    ``mesh.size(1)`` DE islands with ring migration.

    ``sync_interval``: generations between two reads of the world's count
    of running instances (eager form; frozen lanes make the result the
    same for any value).  ``fused=True``: ``migration_interval``
    generations with no collective, then three (see the module
    docstring); ``sync_interval`` is then unused.  The draws are Philox
    keyed by ``generator``'s initial seed (0 without one), or ``draws``.
    Every rank passes the same global inputs and returns the global
    result."""
    x0 = start_points(x0)
    B, n = x0.shape
    pop = config.pop_size
    dp_size, islands = mesh.size(0), mesh.size(1)
    if B % dp_size or pop % islands:
        raise ValueError(
            f"batch {B} must divide over dp={dp_size} and "
            f"pop_size {pop} over islands={islands}"
        )
    p_loc = pop // islands
    if p_loc < 4:
        raise ValueError("each island needs >= 4 agents for partner sampling")
    check_device(x0, mesh)
    seed = generator.initial_seed() if generator is not None else 0
    dev, dtype = x0.device, x0.dtype
    dp_i, isl_i = coordinate(mesh)
    inst_part, agent_part = block(B, dp_size, dp_i), block(pop, islands, isl_i)
    inst = torch.arange(B, dtype=torch.int64, device=dev)[inst_part]
    agent_ids = torch.arange(pop, dtype=torch.int64, device=dev)[agent_part]
    local_ids = torch.arange(p_loc, dtype=torch.int64, device=dev)
    x0_loc = x0[inst_part]
    b = inst.shape[0]

    u0, draws_of = de_draws(seed, inst, agent_ids, n, p_loc, dtype, draws, inst_part, agent_part)
    agents = (u0 - 0.5) * x0_loc[:, None, :]        # nlsolver.h:2302-2323
    scores = vmap(fn)(agents.reshape(b * p_loc, n)).reshape(b, p_loc)
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    no = torch.zeros((b,), dtype=torch.bool, device=dev)
    state = dict(agents=agents, scores=scores,
                 best_value=torch.full((b,), torch.inf, dtype=scores.dtype, device=dev),
                 iteration=zeros, nfev=torch.full((b,), pop, dtype=torch.int32, device=dev),
                 val_no_change=zeros, done=no, converged=no)
    group = mesh.get_group(POP_AXIS)
    while all_sum((~state["done"]).sum()):
        if fused:
            for _ in range(migration_interval):
                state = _local_generation(fn, state, config, pop, local_ids, draws_of)
            state = _boundary(state, config, pop, migration_interval, group)
        else:
            for _ in range(max(sync_interval, 1)):
                state = _generation(fn, state, config, pop, migration_interval, local_ids,
                                    draws_of, group)
    x_best, f_best = best_member(state["agents"], state["scores"], group)
    res = make_result(x=x_best, f_value=f_best, iterations=state["iteration"],
                      function_calls=state["nfev"], converged=state["converged"])
    return gather_result(res, mesh.get_group(DP_AXIS), x_lane_dim=0)
