"""Triangular / Cholesky / least-squares solves (counterpart of
``nlsolver_tpu.linalg.solve``).

Re-creation of the reference's dense-solve helpers:
  * ``cholesky`` + ``forwardsolve``/``backsolve`` (nlsolver.h:252-294);
  * ``damped_solve``, LM's damped-normal-equation solve with a diagonal
    fast path (``get_update_with_hessian``, nlsolver.h:310-330);
  * tinyqr's ``back_solve`` / ``lm`` least squares (tinyqr.h:437-470).

All functions act on single matrices (or leading batch dims) and batch
with ``torch.func.vmap``.
"""
from __future__ import annotations

import torch


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor (nlsolver.h:252-270).  Like the JAX
    package's, a matrix that is not positive definite gives NaN, not an
    error."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def _as_matrix_rhs(b: torch.Tensor, A: torch.Tensor):
    vector = b.ndim == A.ndim - 1
    return (b.unsqueeze(-1) if vector else b), vector


def forwardsolve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    rhs, vector = _as_matrix_rhs(b, L)
    x = torch.linalg.solve_triangular(L, rhs, upper=False)
    return x.squeeze(-1) if vector else x


def backsolve(U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    rhs, vector = _as_matrix_rhs(b, U)
    x = torch.linalg.solve_triangular(U, rhs, upper=True)
    return x.squeeze(-1) if vector else x


def solve_cholesky(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD A x = b via Cholesky (the reference's LM solve path,
    nlsolver.h:326-329)."""
    rhs, vector = _as_matrix_rhs(b, A)
    x = torch.cholesky_solve(rhs, cholesky(A))
    return x.squeeze(-1) if vector else x


# Up to this order the SPD solve is unrolled into scalar ops, which batch
# under vmap into elementwise ops over the fleet (the JAX package's
# threshold).
_UNROLL_N = 8


def _solve_spd_unrolled(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve fully unrolled over the static order n: Cholesky-
    Banachiewicz, then forward and back substitution.  A [n, n, *batch],
    b [n, *batch] -> x [n, *batch]: indexing touches only the two matrix
    axes, so over a trailing batch (the batch-minor fleets) or under
    ``vmap`` every operation is elementwise over the batch.  It is also
    the plain twin of kernel K3 (``ops.smallchol``), which rounds each
    operation as it does, in its order."""
    n = A.shape[0]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = A[i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(acc)
            else:
                L[i][j] = acc / L[j][j]
    # forward solve L z = b
    z = [None] * n
    for i in range(n):
        acc = b[i]
        for k in range(i):
            acc = acc - L[i][k] * z[k]
        z[i] = acc / L[i][i]
    # back solve L^T x = z
    x = [None] * n
    for i in reversed(range(n)):
        acc = z[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return torch.stack(x, dim=0)


def is_diagonal(H: torch.Tensor) -> torch.Tensor:
    """Runtime diagonality test (nlsolver.h:296-307): every off-diagonal
    entry at most ``2.22e-16 * 1e12`` in absolute value, the reference's
    double-precision constant for every dtype.  (The reference compares the
    signed entry; the JAX package and this port compare |H[i, j]|.)"""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    return (H.abs() * (1.0 - eye)).max() <= 2.220446049250313e-16 * 1e12


def damped_solve(H: torch.Tensor, g: torch.Tensor, lam, *, diagonal=None) -> torch.Tensor:
    """(H + lam I) u = g (get_update_with_hessian + H += lam I,
    nlsolver.h:3529-3533).

    ``diagonal``: ``True`` divides elementwise by the damped diagonal,
    ``False`` always factorizes, ``None`` (default) selects per instance
    with ``is_diagonal``.  The selection computes both branches and picks
    one with ``torch.where``, as the JAX package's ``lax.cond`` does under
    ``vmap``."""
    n = g.shape[-1]
    Hd = H + lam * torch.eye(n, dtype=H.dtype, device=H.device)
    diag = torch.diagonal(Hd, dim1=-2, dim2=-1)
    if diagonal is True:
        return g / diag
    dense_solve = _solve_spd_unrolled if n <= _UNROLL_N else solve_cholesky
    if diagonal is False:
        return dense_solve(Hd, g)
    return torch.where(is_diagonal(Hd), g / diag, dense_solve(Hd, g))


def least_squares(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Minimize ||A x - y||_2 via QR (tinyqr's ``lm``, tinyqr.h:460-470)."""
    q, r = torch.linalg.qr(A)
    return backsolve(r, q.T @ y)
