"""Batched parallel-order Givens QR, Sameh-Kuck schedule (counterpart of
``nlsolver_tpu.linalg.qr_parallel``).

Entry (i, j), i > j, is annihilated at stage ``k = m - 1 - i + 2 j`` by a
rotation of rows (i-1, i).  Within a stage the row pairs are disjoint, so
a stage is a handful of whole-row tensor ops over the batch.  Arrays carry
trailing batch dims ([m, n, *batch], the fleets' batch-minor layout);
plain [m, n] matrices and ``torch.func.vmap`` work unchanged.

These are the plain twins of the CUDA kernels in ``ops.qr_wavefront``:
each rotation is ``(c * x) + (s * y)`` with ``-s`` on row q, rounded op by
op, which the kernels reproduce.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .givens import QR, givens_rotation


@lru_cache(maxsize=None)
def sameh_kuck_schedule(m: int, n: int):
    """Static wavefront schedule: tuple of stages, each (ps, qs, js, perm)
    int arrays — rotate rows (p, q) = (i-1, i) to zero entry (q, js) — with
    all pairs in a stage row-disjoint."""
    stages = {}
    for j in range(n):
        for i in range(m - 1, j, -1):
            k = (m - 1 - i) + 2 * j
            stages.setdefault(k, []).append((i - 1, i, j))
    out = []
    for k in sorted(stages):
        ps = np.asarray([t[0] for t in stages[k]], np.int32)
        qs = np.asarray([t[1] for t in stages[k]], np.int32)
        js = np.asarray([t[2] for t in stages[k]], np.int32)
        perm = np.arange(m, dtype=np.int32)
        perm[ps], perm[qs] = qs, ps
        out.append((ps, qs, js, perm))
    return tuple(out)


@lru_cache(maxsize=None)
def _stage_tables(m: int, n: int, device: torch.device):
    """The schedule as index tensors on ``device``.  Besides (ps, qs, js,
    perm), ``cidx`` and ``sidx`` pick each row's coefficient from
    ``[c, 1]`` and ``[s, -s, 0]``: a gather in place of JAX's scatter, so
    that ``vmap`` batches it."""
    out = []
    for ps, qs, js, perm in sameh_kuck_schedule(m, n):
        k = len(ps)
        cidx = np.full(m, k, np.int64)
        sidx = np.full(m, 2 * k, np.int64)
        cidx[ps] = cidx[qs] = np.arange(k)
        sidx[ps], sidx[qs] = np.arange(k), k + np.arange(k)
        out.append(tuple(
            torch.as_tensor(a.astype(np.int64), device=device)
            for a in (ps, qs, js, perm, cidx, sidx)
        ))
    return tuple(out)


def _apply_stages(m: int, n: int, R, carried):
    """Run the full schedule on R, applying the identical row rotations to
    every array in ``carried`` (Q^T accumulator, right-hand sides, ...)."""
    for ps, qs, js, perm, cidx, sidx in _stage_tables(m, n, R.device):
        c, s = givens_rotation(R[ps, js], R[qs, js])    # [k, *batch]
        Cv = torch.cat([c, torch.ones_like(c[:1])])[cidx]           # [m, *batch]
        Sv = torch.cat([s, -s, torch.zeros_like(s[:1])])[sidx]
        Crow, Srow = Cv.unsqueeze(1), Sv.unsqueeze(1)
        R = Crow * R + Srow * R[perm]
        # matrices ([m, k, *batch]) broadcast via the row shape; vectors
        # ([m, *batch], e.g. right-hand sides) use the coefficients directly
        carried = [
            (Crow * X + Srow * X[perm]) if X.ndim == R.ndim
            else (Cv * X + Sv * X[perm])
            for X in carried
        ]
    return R, carried


def qr_parallel(A: torch.Tensor, compute_q: bool = True) -> QR:
    """QR of ``A`` = [m, n, *batch] (m >= n) by parallel-order Givens.

    Returns ``Q`` [m, m, *batch] (or ``None`` when ``compute_q=False``)
    and ``R`` [m, n, *batch] upper-triangular, matching
    ``torch.linalg.qr(mode="complete")`` up to column signs.
    """
    m, n = A.shape[0], A.shape[1]
    if m < n:
        raise ValueError(f"need m >= n, got {tuple(A.shape)}")
    bshape = A.shape[2:]
    carried = []
    if compute_q:
        eye = torch.eye(m, dtype=A.dtype, device=A.device)
        carried.append(eye.reshape((m, m) + (1,) * len(bshape)).expand((m, m) + bshape))
    R, carried = _apply_stages(m, n, A, carried)
    Q = carried[0].transpose(0, 1) if compute_q else None
    return QR(Q=Q, R=R)


def backsolve_bm(R: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve R x = b for upper-triangular R [n, n, *batch], b [n, *batch]
    by unrolled back-substitution on the trailing-batch layout.  Row i's
    products R[i, j] x[j] come from one multiply, each rounded on its own;
    the subtractions then take them one at a time by ascending j."""
    n = R.shape[0]
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = b[i]
        if i + 1 < n:
            for term in R[i, i + 1:] * torch.stack(xs[i + 1:]):
                acc = acc - term
        xs[i] = acc / R[i, i]
    return torch.stack(xs, dim=0)


def least_squares_parallel(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """min_x ||A x - y||_2 for A [m, n, *batch], y [m, *batch]: the
    rotations are applied to y directly (implicit Q^T y, no Q
    materialized), then R[:n, :n] x = (Q^T y)[:n] back-substitutes."""
    m, n = A.shape[0], A.shape[1]
    R, (qty,) = _apply_stages(m, n, A, [y])
    return backsolve_bm(R[:n, :n], qty[:n])
