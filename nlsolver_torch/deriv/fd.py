"""Finite-difference derivatives with the reference's stencils (counterpart
of ``nlsolver_tpu.deriv.fd``; ``nlsolver::finite_difference``,
nlsolver.h:1383-1518).

Each function takes one point ``x [n]`` and a single-point objective, as
the JAX package's do: every stencil point is built as one perturbation
batch and scored with one ``torch.func.vmap`` of ``fn``.  The solvers run
them on lane tensors under a further ``vmap``.

Gradient accuracy a in {0,1,2,3} uses the 2/4/6/8-point central stencils
with the coefficient tables of nlsolver.h:1390-1398 and
eps = machine_eps * 1e8 (nlsolver.h:1389).  Hessian accuracy 0 is the
4-eval cross stencil (nlsolver.h:1422-1446); accuracy >= 1 is the 16-eval
high-order stencil with the /(600 eps^2) denominator (nlsolver.h:1447-1516);
eps = machine_eps^0.25 (nlsolver.h:1417-1419).  The points, the order of
the weighted sums and the final true divide are the JAX package's, so both
packages round alike.  The divisor is a 0-d tensor on ``x``'s device: a
Python number there would let the card multiply by its reciprocal.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import vmap

# central-difference stencils per accuracy level (nlsolver.h:1390-1395):
# (weights, offsets in units of eps, denominator multiple of eps)
_GRAD_STENCILS = {
    0: ((1.0, -1.0), (1.0, -1.0), 2.0),
    1: ((1.0, -8.0, 8.0, -1.0), (-2.0, -1.0, 1.0, 2.0), 12.0),
    2: ((-1.0, 9.0, -45.0, 45.0, -9.0, 1.0), (-3.0, -2.0, -1.0, 1.0, 2.0, 3.0), 60.0),
    3: (
        (3.0, -32.0, 168.0, -672.0, 672.0, -168.0, 32.0, -3.0),
        (-4.0, -3.0, -2.0, -1.0, 1.0, 2.0, 3.0, 4.0),
        840.0,
    ),
}

# The reference's Hessian perturbs x in place with chained +=/-= increments
# (nlsolver.h:1455-1511), so each evaluation point is a sequence of IEEE
# adds, not a clean x + k*eps: entry k, (i-increment, j-increment), is
# applied before evaluation k.  16-eval stencil (accuracy >= 1), groups of
# 4 sharing a weight; 4-eval cross stencil (accuracy 0, nlsolver.h:1427-1445)
_HESS_OPS_HI = (
    (1, -2), (1, 1), (-4, 2), (1, 1),
    (0, -4), (-1, 1), (3, 3), (1, -1),
    (0, -3), (-4, 4), (0, -4), (4, 4),
    (-3, -3), (2, 2), (0, -2), (-2, 2),
)
_HESS_OPS_LO = ((0, 0), (1, 1), (0, -1), (-1, 1))


@dataclass(frozen=True)
class FDConfig:
    accuracy: int = 1  # the solvers' fin_diff adapters use accuracy=1 (:2848-2863)


def _grad_eps(dtype) -> float:
    return float(torch.finfo(dtype).eps) * 1e8


def _hess_eps(dtype) -> float:
    return float(torch.finfo(dtype).eps) ** 0.25


def fd_gradient_cost(n: int, accuracy: int = 1) -> int:
    """Objective evaluations one gradient costs (for counter parity)."""
    return n * 2 * (accuracy + 1)


def fd_hessian_cost(n: int, accuracy: int = 1) -> int:
    return n * n * (4 if accuracy == 0 else 16)


def _true_divide(a: torch.Tensor, denom: float) -> torch.Tensor:
    return a / torch.tensor(denom, dtype=a.dtype, device=a.device)


def fd_gradient(fn, x: torch.Tensor, accuracy: int = 1) -> torch.Tensor:
    """Central-difference gradient of ``fn`` at one point ``x [n]``, one
    batched evaluation of the ``[n, s, n]`` stencil points."""
    coeffs, offsets, dd = _GRAD_STENCILS[accuracy]
    n = x.shape[-1]
    eps = torch.tensor(_grad_eps(x.dtype), dtype=x.dtype, device=x.device)
    offs = torch.tensor(offsets, dtype=x.dtype, device=x.device) * eps   # [s]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    pts = x[None, None, :] + offs[None, :, None] * eye[:, None, :]       # [n, s, n]
    vals = vmap(vmap(fn))(pts)                                           # [n, s]
    acc = vals[:, 0] * coeffs[0]
    for s in range(1, len(coeffs)):
        acc = acc + vals[:, s] * coeffs[s]
    return _true_divide(acc, dd * _grad_eps(x.dtype))


def fd_hessian(fn, x: torch.Tensor, accuracy: int = 1) -> torch.Tensor:
    """Finite-difference Hessian of ``fn`` at one point ``x [n]``, one
    batched evaluation of all ``[n, n, K]`` stencil points.  The points
    replay the reference's chained increments (including the aliased
    i == j case, where both land on one coordinate), and the grouped sums
    keep its order."""
    n = x.shape[-1]
    eps = _hess_eps(x.dtype)
    epsa = torch.tensor(eps, dtype=x.dtype, device=x.device)
    ops = _HESS_OPS_LO if accuracy == 0 else _HESS_OPS_HI
    # chained coordinate values: vi / vj for the off-diagonal roles, vd for
    # the aliased diagonal (i == j) where both increments hit one coordinate
    vi = vj = vd = x
    ci, cj, cd = [], [], []
    for oi, oj in ops:
        if oi:
            vi = vi + oi * epsa
            vd = vd + oi * epsa
        if oj:
            vj = vj + oj * epsa
            vd = vd + oj * epsa
        ci.append(vi)
        cj.append(vj)
        cd.append(vd)
    ci = torch.stack(ci)[None, None]           # [1, 1, K, n]
    cj = torch.stack(cj)[None, None]
    cd = torch.stack(cd)[None, None]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    mi = eye[:, None, None, :]                 # [n, 1, 1, n]
    mj = eye[None, :, None, :]                 # [1, n, 1, n]
    # [n, n, K, n]: coordinate i takes the i-role chain, j the j-role chain,
    # the diagonal (i == j) the aliased chain, every other stays at x
    pts = torch.where(mi & mj, cd, torch.where(mi, ci, torch.where(mj, cj, x)))
    vals = vmap(vmap(vmap(fn)))(pts)           # [n, n, K]
    v = [vals[..., k] for k in range(len(ops))]
    if accuracy == 0:
        result = ((v[0] + v[1]) - v[2]) - v[3]
        denom = eps * eps
    else:
        g1 = ((v[0] + v[1]) + v[2]) + v[3]
        g2 = ((v[4] + v[5]) + v[6]) + v[7]
        g3 = ((v[8] + v[9]) - v[10]) - v[11]
        g4 = ((v[12] + v[13]) - v[14]) - v[15]
        result = (((0.0 - 63.0 * g1) + 63.0 * g2) + 44.0 * g3) + 74.0 * g4
        denom = (600.0 * eps) * eps            # nlsolver.h:1448 constant order
    return _true_divide(result, denom)
