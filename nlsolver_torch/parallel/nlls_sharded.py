"""Batched nonlinear least squares sharded over a mesh's dp axis
(counterpart of ``nlsolver_tpu.parallel.nlls_sharded``; BASELINE.json
config #5).

Each rank runs the lane ``nlls.step`` (a ``vmap`` over its fits, as
``fit_batched`` does) on its dp block of the fits, per-instance ``data``
cut to match; the ranks of one dp block along pop compute the same block.
The only traffic inside the loop is the termination count: one
``all_reduce(SUM)`` of the unfinished fits over the world, read every
``CHECK_EVERY`` steps as ``core.drive`` reads ``done``, so every rank runs
the same number of steps (frozen fits make the extra ones no-ops).  The
result comes back in the caller's order through one gather over dp.
"""
from __future__ import annotations

from typing import Callable

from ..core import SolverResult, start_points, where_lanes
from ..solvers import nlls
from .fleet_sharded import _rows
from .mesh import DP_AXIS, all_sum, block, check_device, coordinate, gather_result

# host loop: steps between two reads of the world's unfinished count
CHECK_EVERY = 16


def fit_sharded(
    residual_fn: Callable,
    x0s,                        # [B, n]
    config: nlls.NLLSConfig,
    mesh,
    data=None,                  # per-instance tensor or tuple, leading dim B
) -> SolverResult:
    x0s = start_points(x0s)
    B = x0s.shape[0]
    dp_size = mesh.size(0)
    if B % dp_size:
        raise ValueError(f"batch {B} must divide over dp={dp_size}")
    check_device(x0s, mesh)
    part = block(B, dp_size, coordinate(mesh)[0])
    state, batch_step = nlls.batch(residual_fn, x0s[part].contiguous(), config,
                                   _rows(data, part))
    while all_sum((~state.done).sum()):
        for _ in range(CHECK_EVERY):
            state = where_lanes(state.done, state, batch_step(state))
    return gather_result(nlls._finalize(state), mesh.get_group(DP_AXIS), x_lane_dim=0)
