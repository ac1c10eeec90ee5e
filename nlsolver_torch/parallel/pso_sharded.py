"""Particle Swarm Optimization with one swarm's particles sharded over a
mesh (counterpart of ``nlsolver_tpu.parallel.pso_sharded``).

One SPMD program a rank over a (dp, pop) mesh: the instances shard over
``dp``, each swarm's particles over ``pop``.  A particle mixes with the
swarm only through the swarm's best position, so a generation needs ONE
packed ``all_gather`` over the pop subgroup (``gather_swarm``) of a
``[b, p_loc + 1 + n]`` block in the promoted dtype: the rank's
particle-best values, its best candidate's value and that candidate's
position.  From it every pop rank rebuilds the whole particle-best vector
(its spread is the termination statistic) and takes the global candidate
as the argmin over the ranks, ties going to the lowest.  The spread is
computed at the end of the generation that produced it and carried in
the state, for the next generation's check.  The loop ends when the
count of running instances summed over the world is 0, as ``de_sharded``
ends, so every rank runs the same number of generations.

The particles start uniform in ``[-|x0|, |x0|]`` with velocities
``span (2u - 1)``; the vanilla update is the JAX engine's.  Draws are
Philox by (instance, global particle, iteration) (``_draws``), or
``draws=`` (``PSOShardedDraws``), lane b's step reading row
``iteration[b]``.  The JAX engine ignores ``PSOConfig.accelerated``; the
port refuses it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from ..core import SolverResult, make_result, start_points, std_err
from ..solvers.pso import PSOConfig
from ._draws import replay, uniforms
from .mesh import DP_AXIS, POP_AXIS, all_gather, all_sum, block, check_device, coordinate
from .mesh import gather_result

# the Philox streams
_POS, _VEL, _RP, _RG = 0, 1, 2, 3


class PSOShardedDraws(NamedTuple):
    """A run's draws over the whole fleet, to replay a trajectory."""

    init_u: torch.Tensor   # [B, P, n] uniforms of the initial positions
    init_v: torch.Tensor   # [B, P, n] uniforms of the initial velocities
    r_p: torch.Tensor      # [T, B, P, n] cognitive uniforms
    r_g: torch.Tensor      # [T, B, P, n] social uniforms


def gather_swarm(values: torch.Tensor, positions: torch.Tensor, best_values: torch.Tensor,
                 group):
    """ONE packed gather over the pop subgroup: the global candidate's value
    ``[b]`` and position ``[b, n]`` (the argmin over the ranks' own best
    candidates, ties to the lowest rank) and the spread of the whole
    particle-best vector ``[b]``."""
    b, p_loc, n = positions.shape
    idx = values.argmin(dim=1)
    loc_val = torch.gather(values, 1, idx[:, None])[:, 0]
    loc_pos = torch.gather(positions, 1, idx[:, None, None].expand(b, 1, n))[:, 0]
    vdt, xdt = best_values.dtype, positions.dtype
    pdt = torch.promote_types(vdt, xdt)
    packed = torch.cat([best_values.to(pdt), loc_val[:, None].to(pdt), loc_pos.to(pdt)], dim=1)
    g = all_gather(packed, group, dim=0).reshape(-1, b, p_loc + 1 + n)   # [shards, b, .]
    spread = std_err(g[:, :, :p_loc].transpose(0, 1).reshape(b, -1).to(vdt), dim=1)
    cand = g[:, :, p_loc].to(vdt)                                        # [shards, b]
    owner = cand.argmin(dim=0)
    pos = torch.gather(g[:, :, p_loc + 1:], 0, owner[None, :, None].expand(1, b, n))[0]
    return cand.amin(dim=0), pos.to(xdt), spread


def _generation(fn, s: dict, config: PSOConfig, P: int, draws_of, group) -> dict:
    """One generation of every instance of the rank's block; instances that
    are or become done stay frozen."""
    hit_tol = (s["val_no_change"] >= config.best_value_no_change) | (s["spread"] < config.eps)
    done_now = (s["iteration"] >= config.max_iter) | hit_tol
    r_p, r_g = draws_of(s["iteration"])
    pos = s["positions"]
    vel = (config.inertia * s["velocities"]
           + config.cognitive_coef * r_p * (s["best_positions"] - pos)
           + config.social_coef * r_g * (s["swarm_best_position"][:, None, :] - pos))
    pos = pos + vel
    b, p_loc, n = pos.shape
    vals = vmap(fn)(pos.reshape(b * p_loc, n)).reshape(b, p_loc)
    improved = vals < s["best_values"]
    best_values = torch.where(improved, vals, s["best_values"])
    best_positions = torch.where(improved[..., None], pos, s["best_positions"])
    cand_val, cand_pos, spread = gather_swarm(vals, pos, best_values, group)
    sw_improved = cand_val < s["swarm_best_value"]
    val_no_change = torch.where(sw_improved, 0, s["val_no_change"] + 1)
    worked = dict(
        positions=pos, velocities=vel, values=vals, best_positions=best_positions,
        best_values=best_values,
        swarm_best_value=torch.where(sw_improved, cand_val, s["swarm_best_value"]),
        swarm_best_position=torch.where(sw_improved[:, None], cand_pos,
                                        s["swarm_best_position"]),
        spread=spread, iteration=s["iteration"] + 1, nfev=s["nfev"] + P,
        val_no_change=val_no_change, done=torch.zeros_like(s["done"]),
        converged=torch.zeros_like(s["converged"]),
    )
    halted = dict(s, val_no_change=val_no_change, done=torch.ones_like(s["done"]),
                  converged=hit_tol)

    def lanes(mask, like):
        return mask.reshape(mask.shape + (1,) * (like.ndim - 1))

    return {k: torch.where(lanes(s["done"], worked[k]), s[k],
                           torch.where(lanes(done_now, worked[k]), halted[k], worked[k]))
            for k in worked}


def minimize_sharded(
    fn,
    x0,                         # [B, n]
    config: PSOConfig,
    mesh,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[PSOShardedDraws] = None,
) -> SolverResult:
    """Solve B instances, each with a swarm sharded over pop.

    The draws are Philox keyed by ``generator``'s initial seed (0 without
    one), or ``draws``.  Every rank passes the same global inputs and
    returns the global result."""
    x0 = start_points(x0)
    B, n = x0.shape
    P = config.n_particles
    dp_size, pop_shards = mesh.size(0), mesh.size(1)
    if B % dp_size or P % pop_shards:
        raise ValueError(
            f"batch {B} must divide over dp={dp_size} and n_particles "
            f"{P} over pop={pop_shards}"
        )
    if config.accelerated:
        raise ValueError(
            "the population-sharded PSO runs the vanilla update only; for accelerated=True "
            "use method='pso_batched' with layout='sharded'"
        )
    check_device(x0, mesh)
    seed = generator.initial_seed() if generator is not None else 0
    dev, dtype = x0.device, x0.dtype
    dp_i, pop_i = coordinate(mesh)
    inst_part, part = block(B, dp_size, dp_i), block(P, pop_shards, pop_i)
    inst = torch.arange(B, dtype=torch.int64, device=dev)[inst_part]
    pids = torch.arange(P, dtype=torch.int64, device=dev)[part]
    x0_loc = x0[inst_part]
    b, p_loc = inst.shape[0], pids.shape[0]

    if draws is None:
        zero = torch.zeros_like(inst)
        u_pos = uniforms(seed, _POS, inst, pids, zero, n, dtype)
        u_vel = uniforms(seed, _VEL, inst, pids, zero, n, dtype)

        def draws_of(iteration):
            it = iteration.to(torch.int64)
            return (uniforms(seed, _RP, inst, pids, it, n, dtype),
                    uniforms(seed, _RG, inst, pids, it, n, dtype))
    else:
        u_pos, u_vel = (torch.as_tensor(a, device=dev)[inst_part, part].to(dtype)
                        for a in (draws.init_u, draws.init_v))
        rows = replay((draws.r_p, draws.r_g), inst_part, part, dev)

        def draws_of(iteration):
            return tuple(a.to(dtype) for a in rows(iteration))

    lower, upper = -x0_loc.abs(), x0_loc.abs()
    span = (upper - lower)[:, None, :]
    positions = lower[:, None, :] + span * u_pos
    velocities = span * (2.0 * u_vel - 1.0)
    values = vmap(fn)(positions.reshape(b * p_loc, n)).reshape(b, p_loc)
    group = mesh.get_group(POP_AXIS)
    sb_val, sb_pos, spread = gather_swarm(values, positions, values, group)
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    no = torch.zeros((b,), dtype=torch.bool, device=dev)
    state = dict(positions=positions, velocities=velocities, values=values,
                 best_positions=positions, best_values=values, swarm_best_value=sb_val,
                 swarm_best_position=sb_pos, spread=spread, iteration=zeros,
                 nfev=torch.full((b,), P, dtype=torch.int32, device=dev), val_no_change=zeros,
                 done=no, converged=no)
    while all_sum((~state["done"]).sum()):
        state = _generation(fn, state, config, P, draws_of, group)
    res = make_result(x=state["swarm_best_position"], f_value=state["swarm_best_value"],
                      iterations=state["iteration"], function_calls=state["nfev"],
                      converged=state["converged"])
    return gather_result(res, mesh.get_group(DP_AXIS), x_lane_dim=0)
