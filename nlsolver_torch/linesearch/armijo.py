"""Armijo backtracking line search on lane tensors (counterpart of
``nlsolver_tpu.linesearch.armijo``; the reference's armijo_search,
nlsolver.h:1805-1865, c = 0.2, rho = 0.9).

One search per lane: ``x``, ``g0`` and ``direction`` are ``[B, n]``,
``f0`` and the result ``[B]``.  The JAX search is a ``lax.while_loop``
bounded at ``MAX_BACKTRACKS`` trips (0.9^200 ~ 7e-10 leaves alpha
effectively zero), batched with ``vmap`` by the solvers; here it is a host
loop over every lane that freezes the lanes whose condition holds, as the
batched loop does, and reads ``any`` of the still-running lanes after
every trip.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

C = 0.2
RHO = 0.9
MAX_BACKTRACKS = 200


class ArmijoResult(NamedTuple):
    alpha: torch.Tensor   # [B]
    nfev: torch.Tensor    # [B] int32


def armijo(values, x, f0, g0, direction, alpha0) -> ArmijoResult:
    """Backtrack alpha in each lane until f(x + alpha d) <= f0 + alpha c <g0, d>.

    ``values`` scores lanes ``[B, n] -> [B]`` (``core.lanes.Lanes.values``);
    ``alpha0`` is a scalar or ``[B]``."""
    limit = (g0 * direction).sum(dim=-1) * C
    alpha = torch.as_tensor(alpha0, dtype=x.dtype, device=x.device).expand(f0.shape).clone()
    val = values(x + alpha[:, None] * direction)
    k = torch.zeros(f0.shape, dtype=torch.int32, device=x.device)
    while True:
        going = (val > f0 + alpha * limit) & (k < MAX_BACKTRACKS)
        if not bool(going.any()):
            break
        alpha = torch.where(going, alpha * RHO, alpha)
        val = torch.where(going, values(x + alpha[:, None] * direction), val)
        k = k + going.to(torch.int32)
    return ArmijoResult(alpha=alpha, nfev=k + 1)
