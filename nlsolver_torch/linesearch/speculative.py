"""Speculative (grid) line search for lane fleets (counterpart of
``nlsolver_tpu.linesearch.speculative``).

The More-Thuente search is a SEQUENTIAL recurrence: up to maxfev=20
dependent trials, each a full objective and gradient evaluation, and on a
card each trial is also a few hundred small launches the host must make
in turn.  This search evaluates a STATIC geometric grid of K trial steps
for every lane in ONE batched objective/gradient call (K times the
lane-parallel work, depth 1) and selects per lane:

  1. the best (lowest-f) trial satisfying strong Wolfe
     (ftol/gtol constants identical to cvsrch, nlsolver.h:1682-1688);
  2. else the best trial satisfying the Armijo decrease alone;
  3. else the best strictly-improving trial;
  4. else alpha = 0 (no acceptable step: the caller's reset machinery
     treats the zero step exactly like a failed line search; BFGS's
     curvature guard fires and the next direction is -g).

It trades evaluation COUNT (always K per iteration) for DEPTH.  More
iterations may be needed than with the adaptive search (the grid is not
refined), which is why it is a config option, not the default.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from .more_thuente import FTOL, GTOL, MTResult

#: default trial-step multipliers: three decades down, one octave ladder up
DEFAULT_GRID = (0.001, 0.01, 0.1, 0.3, 0.5, 1.0, 2.0, 4.0)


def speculative_fleet(fn_cols, grad_cols, X, f0, G0, D, alpha0, grid=DEFAULT_GRID) -> MTResult:
    """Grid line search on a batch-minor fleet (drop-in for
    :func:`more_thuente_fleet`).

    fn_cols ``[n, B] -> [B]``; grad_cols ``[n, B] -> [n, B]``;
    X ``[n, B]``; f0 ``[B]``; G0/D ``[n, B]``; alpha0 scalar or ``[B]``;
    ``grid`` a tuple of K multipliers of alpha0.

    Returns an :class:`MTResult` whose ``nfev`` counts K trials (each one
    f and one gradient evaluation, like the MT accounting) and whose
    ``info`` reports the acceptance tier: 1 strong Wolfe, 2 Armijo-only,
    3 improvement-only, 6 no acceptable step (alpha = 0), -1 non-descent
    direction (reference bail-out semantics, nlsolver.h:1693-1695).
    """
    n, B = X.shape
    K = len(grid)
    dtype, dev = X.dtype, X.device
    alpha0 = torch.as_tensor(alpha0, dtype=dtype, device=dev).expand(B)
    g = torch.tensor(grid, dtype=dtype, device=dev)
    alphas = g[:, None] * alpha0[None, :]                    # [K, B]

    Xt = X[:, None, :] + alphas[None, :, :] * D[:, None, :]  # [n, K, B]
    # vmap over the K axis (NOT a [n, K*B] reshape): every inner call sees
    # a lane-aligned [n, B] fleet, so objectives that close over per-lane
    # data (centers, observations, ...) keep their lane correspondence
    fv = vmap(fn_cols, in_dims=1, out_dims=0)(Xt)            # [K, B]
    Gv = vmap(grad_cols, in_dims=1, out_dims=1)(Xt)          # [n, K, B]
    dg = (Gv * D[:, None, :]).sum(dim=0)                     # [K, B]

    dginit = (G0 * D).sum(dim=0)                             # [B]
    armijo = fv <= f0[None, :] + FTOL * alphas * dginit[None, :]
    curv = dg.abs() <= GTOL * (-dginit)[None, :]
    wolfe = armijo & curv
    improve = fv < f0[None, :]

    def best_of(mask):
        """(index, any) of the lowest f among mask-satisfying trials; of
        equal values ``argmin`` takes the first, as ``jnp.argmin`` does."""
        masked = torch.where(mask, fv, float("inf"))
        return masked.argmin(dim=0), mask.any(dim=0)

    i_w, has_w = best_of(wolfe)
    i_a, has_a = best_of(armijo)
    i_i, has_i = best_of(improve)

    idx = torch.where(has_w, i_w, torch.where(has_a, i_a, i_i))  # [B]
    alpha_pick = torch.gather(alphas, 0, idx[None, :])[0]
    any_ok = has_w | has_a | has_i
    alpha = torch.where(any_ok, alpha_pick, torch.zeros_like(alpha_pick))

    info = torch.where(has_w, 1, torch.where(has_a, 2, torch.where(has_i, 3, 6))).to(torch.int32)
    bad = dginit >= 0.0
    return MTResult(
        alpha=torch.where(bad, alpha0, alpha),
        nfev=torch.where(bad, 0, K).to(torch.int32),
        info=torch.where(bad, -1, info),
    )
