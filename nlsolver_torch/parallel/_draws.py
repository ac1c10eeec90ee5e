"""The layout-invariant draws of the population engines on a mesh
(``de_sharded``, ``de_island``, ``pso_sharded``).

Each draw comes from Philox4x32-10 keyed by the run's seed and counted by
(stream, instance, global agent id, iteration), never by rank, so a result
does not depend on how the mesh splits the population (the JAX package
folds the same three ids into its keys).  ``replay`` reads injected draws
instead: a run's whole draws, lane b of a step reading row
``iteration[b]``, which is how the tests hand an engine the JAX package's
own.
"""
from __future__ import annotations

import torch

from ..ops.de_fused import philox4x32_10


def words(seed: int, stream: int, groups: int, inst: torch.Tensor, agents: torch.Tensor,
          iteration: torch.Tensor) -> torch.Tensor:
    """Philox words ``[b, p, 4 groups]`` counted by (stream and group,
    agent, instance, iteration) and keyed by the seed."""
    g = torch.arange(groups, dtype=torch.int64, device=inst.device)[None, None, :]
    ctr = torch.broadcast_tensors((stream << 24) | g, agents[None, :, None],
                                  inst[:, None, None], iteration[:, None, None])
    out = philox4x32_10(ctr, seed, seed >> 32)
    return torch.stack(out, dim=-1).reshape(inst.shape[0], agents.shape[0], 4 * groups)


def uniform(w: torch.Tensor, dtype) -> torch.Tensor:
    """[0, 1) from 32-bit words: 24 bits in float32, 32 in float64."""
    if dtype == torch.float64:
        return w.to(dtype) * 2.0**-32
    return (w >> 8).to(dtype) * 2.0**-24


def below(w: torch.Tensor, m: int) -> torch.Tensor:
    """An integer in [0, m) from each 32-bit word (multiply and shift)."""
    return (w * m) >> 32


def uniforms(seed: int, stream: int, inst, agents, iteration, n: int, dtype) -> torch.Tensor:
    """``[b, p, n]`` uniforms of one stream."""
    return uniform(words(seed, stream, (n + 3) // 4, inst, agents, iteration)[..., :n], dtype)


# the DE engines' streams
_INIT, _CROSS, _INDEX = 0, 1, 2


def _de_step_draws(seed, inst, agents, iteration, n, pool, dtype):
    """(u [b, p, n], fdim [b, p], raw [b, p, 3]) of a generation whose
    partners come from ``pool`` agents: raw draw j in [0, pool - 1 - j)."""
    u = uniforms(seed, _CROSS, inst, agents, iteration, n, dtype)
    w = words(seed, _INDEX, 1, inst, agents, iteration)
    raw = torch.stack([below(w[..., 1 + j], pool - 1 - j) for j in range(3)], dim=-1)
    return u, below(w[..., 0], n), raw


def de_draws(seed: int, inst, agents, n: int, pool: int, dtype, draws, inst_part: slice,
             agent_part: slice):
    """A DE engine's initial uniforms ``[b, p, n]`` and its generation's
    draws as a function of ``iteration [b]``: Philox keyed by ``seed``, or
    ``draws`` (``de_sharded.ShardedDraws``, the whole run's) replayed."""
    dev = inst.device
    if draws is None:
        def draws_of(iteration):
            return _de_step_draws(seed, inst, agents, iteration.to(torch.int64), n, pool, dtype)

        return uniforms(seed, _INIT, inst, agents, torch.zeros_like(inst), n, dtype), draws_of
    rows = replay((draws.u, draws.fdim, draws.raw), inst_part, agent_part, dev)

    def draws_of(iteration):
        u, fdim, raw = rows(iteration)
        return u.to(dtype), fdim.to(torch.int64), raw

    return torch.as_tensor(draws.init, device=dev)[inst_part, agent_part].to(dtype), draws_of


def replay(arrays, inst_part: slice, agent_part: slice, device):
    """A function of ``iteration [b]`` giving each ``[T, B, P, ...]`` array's
    row ``iteration[b]`` (clamped to T - 1) for this rank's instances and
    agents: ``[b, p, ...]`` each."""
    own = (slice(None), inst_part, agent_part)
    steps = [torch.as_tensor(a, device=device)[own] for a in arrays]
    lane = torch.arange(steps[0].shape[1], device=device)

    def rows(iteration):
        row = iteration.to(torch.int64).clamp(max=steps[0].shape[0] - 1)
        return [a[row, lane] for a in steps]

    return rows
