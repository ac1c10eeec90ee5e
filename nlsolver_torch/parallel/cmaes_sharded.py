"""The CMA-ES fleet sharded over a mesh (counterpart of
``nlsolver_tpu.parallel.cmaes_sharded``).

The fleet (``solvers.cmaes_fleet``) is lane-parallel: every update, the
batched Jacobi eigensolver (kernel K5 on a card) included, is elementwise
over the lanes, so each rank runs the fleet's own loop
(``cmaes_fleet._run``) on its block of lanes (over every device, dp
major, pop minor) and the global result comes back through one gather.

Two things in the fleet are fleet-global, and the sharded route keeps
them so, which makes the result the unsharded fleet's at every world
size (bit-equal where the objective scores a lane the same in a batch of
any width: ``parallel.fleet_sharded``):

  * the draws: ONE generator for the whole fleet (the JAX route's one
    fleet-global key), so every rank draws the whole width's ``z`` each
    generation and keeps its lanes;
  * the loop's two flags, whether any lane still runs and ``kicked`` (it
    forces a refresh of the eigenbasis after a lane's restart kick), ORed
    over the world by one ``all_reduce(MAX)`` a generation, where the
    unsharded fleet reads them on its own lanes; so every rank runs the
    same number of generations and refreshes at the same ones.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..core import Bounds, start_points
from ..solvers import cmaes_fleet
from .fleet_sharded import _check_width
from .mesh import check_device, gather_result, lane_block


def _anywhere(flags: torch.Tensor) -> torch.Tensor:
    """``flags`` (bool) ORed over the world: one ``all_reduce(MAX)``."""
    f = flags.to(torch.int32)
    dist.all_reduce(f, op=dist.ReduceOp.MAX)
    return f.to(torch.bool)


def minimize_fleet_sharded(fn, X0, config: cmaes_fleet.CMAESFleetConfig, mesh,
                           bounds: Optional[Bounds] = None, *,
                           generator: Optional[torch.Generator] = None):
    """B independent CMA-ES strategies, ``X0 [n, B]``, the lanes over every
    device of ``mesh``.  ``generator`` (on ``X0``'s device, seed 0 by
    default) is the fleet's one stream."""
    if mesh is None:
        raise ValueError("minimize_fleet_sharded requires a mesh")
    X0 = start_points(X0)
    _check_width(X0.shape[1], mesh)
    check_device(X0, mesh)
    res = cmaes_fleet._run(fn, X0, config, bounds, generator, lane_block(mesh, X0.shape[1]),
                           _anywhere)
    return gather_result(res, x_lane_dim=1)
