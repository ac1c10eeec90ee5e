"""Lane fleets sharded over a mesh: BFGS, NLLS, PSO, SANN (counterpart of
``nlsolver_tpu.parallel.fleet_sharded``).

These fleets have no cross-lane data flow: every update, the kernels'
included, is elementwise over the lane axis.  Sharding is pure data
parallelism over EVERY device of the mesh (dp major, pop minor): each
rank runs the unsharded fleet engine on its block of lanes, with the same
kernels (K4a/K4b for BFGS, K2b or K3 for NLLS by ``solve=``), and the
global result comes back in the caller's order through one gather.  No
collective runs inside the loop: each rank stops when its own lanes have.

Every rank passes the same global inputs.  A column objective sees the
rank's block ``[n, B / world]``; per-lane data goes through ``data=``
(NLLS, PSO, SANN), cut to match.

The PSO and SANN fleets draw from one ``torch.Generator`` for the whole
batch.  A sharded rank draws the tensors of the whole width on every
step and keeps its lanes (``solvers.pso_batched._run``'s ``shard``), so
each lane draws what it draws in the unsharded fleet, at the price of
every rank making the whole width's draws.  The result is then bit-equal
to the unsharded fleet's wherever the objective scores a lane the same
in a batch of any width: a ``sum`` over a strided axis under ``vmap``
(a column objective's) may add in another order when the batch narrows
(PyTorch's CPU kernel at 16 against 32 columns of 100-D Rastrigin:
1e-7 relative in float32).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import Bounds, start_points
from ..core.lanes import Lanes
from ..solvers import bfgs_fleet, nlls_fleet, pso_batched, sann_batched
from ..solvers._lane import draws_on, tree_map
from ..solvers.pso import PSOConfig
from ..solvers.sann import SANNConfig
from .mesh import check_device, gather_result, lane_block


def _check_width(B: int, mesh) -> None:
    n_dev = mesh.size()
    if B % n_dev:
        raise ValueError(f"fleet width {B} must divide over {n_dev} devices")


def _rows(data, part: slice):
    """Per-lane data (a tensor, or a tuple, list or dict of them, lane axis
    leading) cut to the lanes ``part``."""
    if data is None:
        return None
    if isinstance(data, dict):
        return {k: _rows(v, part) for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(_rows(d, part) for d in data)
    return start_points(data, "data")[part]


def _bound_rows(bounds, B: int, part: slice):
    """Bounds broadcast against ``x0 [B, n]``: a per-lane ``[B, n]`` bound
    is cut to the lanes ``part``, any other shape broadcasts as it is."""
    if bounds is None:
        return None

    def cut(v):
        t = torch.as_tensor(v)
        return t[part] if t.ndim == 2 and t.shape[0] == B else v

    return Bounds(cut(bounds.lower), cut(bounds.upper))


def _lane_draws(draws, part: slice):
    """A run's injected draws (``_lane.Draws``, lane axis leading: axis 0 of
    ``init``, axis 1 of ``steps``) cut to the lanes ``part``."""
    if draws is None:
        return None
    return type(draws)(tree_map(draws.init, lambda a: torch.as_tensor(a)[part]),
                       tree_map(draws.steps, lambda a: torch.as_tensor(a)[:, part]))


def minimize_fleet_sharded(fn_cols, X0, config: Optional[bfgs_fleet.BFGSFleetConfig] = None,
                           mesh=None):
    """B independent BFGS minimizations, ``X0 [n, B]``, the lanes over
    every device of ``mesh``.  ``fn_cols: [n, B_local] -> [B_local]`` must
    be column-wise (``bfgs_fleet.colwise`` lifts a one-point objective)."""
    if mesh is None:
        raise ValueError("minimize_fleet_sharded requires a mesh")
    X0 = start_points(X0)
    _check_width(X0.shape[1], mesh)
    check_device(X0, mesh)
    cfg = config if config is not None else bfgs_fleet.BFGSFleetConfig()
    part = lane_block(mesh, X0.shape[1])
    res = bfgs_fleet.minimize_fleet(fn_cols, X0[:, part].contiguous(), cfg)
    return gather_result(res, x_lane_dim=1)


def minimize_pso_fleet_sharded(fn, x0, config: Optional[PSOConfig] = None, mesh=None, *,
                               generator: Optional[torch.Generator] = None, draws=None,
                               bounds=None, data=None, _minimize: bool = True):
    """B independent PSO swarms (``solvers.pso_batched``, ``x0 [B, n]``),
    the instances over every device.  The draws come from ``generator`` (on
    ``x0``'s device, seed 0 by default), the whole width's on every rank,
    or from ``draws`` (``_lane.Draws``, lane axis leading), cut to the
    rank's lanes."""
    if mesh is None:
        raise ValueError("minimize_pso_fleet_sharded requires a mesh")
    x0 = start_points(x0)
    B = x0.shape[0]
    _check_width(B, mesh)
    check_device(x0, mesh)
    cfg = config if config is not None else PSOConfig()
    part = lane_block(mesh, B)
    if draws is None and generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    res = pso_batched._run(Lanes(fn, _rows(data, part), _minimize), x0[part].contiguous(), cfg,
                           _minimize, _bound_rows(bounds, B, part),
                           _lane_draws(draws_on(draws, x0.device), part), generator,
                           shard=(B, part))
    return gather_result(res, x_lane_dim=0)


def minimize_sann_fleet_sharded(fn, x0, config: Optional[SANNConfig] = None, mesh=None, *,
                                generator: Optional[torch.Generator] = None, draws=None,
                                data=None, _minimize: bool = True):
    """B independent SANN chains (``solvers.sann_batched``, ``x0 [B, n]``),
    the instances over every device; draws as in
    :func:`minimize_pso_fleet_sharded`."""
    if mesh is None:
        raise ValueError("minimize_sann_fleet_sharded requires a mesh")
    x0 = start_points(x0)
    B = x0.shape[0]
    _check_width(B, mesh)
    check_device(x0, mesh)
    cfg = config if config is not None else SANNConfig()
    part = lane_block(mesh, B)
    if draws is None and generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    res = sann_batched._run(Lanes(fn, _rows(data, part), _minimize), x0[part].contiguous(), cfg,
                            _minimize, _lane_draws(draws_on(draws, x0.device), part), generator,
                            shard=(B, part))
    return gather_result(res, x_lane_dim=0)


def fit_fleet_sharded(residual_fn, X0, config: Optional[nlls_fleet.NLLSFleetConfig] = None,
                      mesh=None, data=None):
    """B independent least-squares fits (``solvers.nlls_fleet``, ``X0 [n,
    B]``), the lanes over every device; per-instance ``data`` (lane axis
    leading) is cut to match."""
    if mesh is None:
        raise ValueError("fit_fleet_sharded requires a mesh")
    X0 = start_points(X0)
    _check_width(X0.shape[1], mesh)
    check_device(X0, mesh)
    cfg = config if config is not None else nlls_fleet.NLLSFleetConfig()
    part = lane_block(mesh, X0.shape[1])
    res = nlls_fleet.fit_fleet(residual_fn, X0[:, part].contiguous(), cfg,
                               data=_rows(data, part))
    return gather_result(res, x_lane_dim=1)
