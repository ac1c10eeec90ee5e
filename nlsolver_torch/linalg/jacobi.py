"""Parallel-order cyclic Jacobi symmetric eigensolver (counterpart of
``nlsolver_tpu.linalg.jacobi``).

The fleet shape is thousands of small [n, n] covariance matrices per
generation (the CMA-ES fleet); a library ``eigh`` is built for one large
matrix.  Cyclic Jacobi on a *round-robin tournament schedule* gives n-1
rounds (n for odd n) of n/2 disjoint rotations per sweep, so every round
updates the whole matrix with a handful of row and column operations that
are elementwise over the batch.  ``sweeps=10`` reaches f64 machine
precision for n <= 32.

Arrays carry arbitrary *trailing* batch dimensions (the batch-minor fleet
layout [n, n, B]); a plain [n, n] matrix and ``torch.func.vmap`` over a
leading axis work unchanged.

``eigh_jacobi`` is also the plain twin of the CUDA kernel in
``ops.eigh_jacobi`` (``csrc/eigh_jacobi.cu``): each entry of a round is
``(c * x) + (s * y)``, rounded op by op, and the rotation is formed by the
operations of ``_rotation`` in their order, which the kernel reproduces.
The kernel reads the schedule from ``schedule_tables``, built from the
same ``round_robin_schedule``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .eigh_qr import Eigh


@lru_cache(maxsize=None)
def round_robin_schedule(n: int):
    """Tournament schedule: tuple of rounds, each a (p_idx, q_idx, perm,
    in_pair) quadruple of numpy int arrays; p/q are the k disjoint pairs of
    the round, perm[r] is row r's partner (self if bye), in_pair[r] is 0.0
    for a bye row else 1.0."""
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        ps, qs = [], []
        perm = np.arange(n)
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                lo, hi = (a, b) if a < b else (b, a)
                ps.append(lo)
                qs.append(hi)
                perm[lo], perm[hi] = hi, lo
        in_pair = np.zeros(n)
        in_pair[np.asarray(ps, dtype=np.int64)] = 1.0
        in_pair[np.asarray(qs, dtype=np.int64)] = 1.0
        rounds.append(
            (
                np.asarray(ps, dtype=np.int32),
                np.asarray(qs, dtype=np.int32),
                perm.astype(np.int32),
                in_pair,
            )
        )
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


@lru_cache(maxsize=None)
def schedule_tables(n: int) -> np.ndarray:
    """The schedule as the kernel reads it: int32 ``[rounds, ceil(n/2), 2]``,
    entry (p, q) for each pair of a round and (r, r) for the bye row of an
    odd n."""
    rounds = round_robin_schedule(n)
    units = np.zeros((len(rounds), (n + 1) // 2, 2), np.int32)
    for r, (ps, qs, perm, _) in enumerate(rounds):
        bye = [i for i in range(n) if perm[i] == i]
        units[r, :, 0] = list(ps) + bye
        units[r, :, 1] = list(qs) + bye
    return units


@lru_cache(maxsize=None)
def _round_tables(n: int, device: torch.device):
    """The schedule as index tensors on ``device``.  Besides (ps, qs,
    perm), ``cidx`` and ``sidx`` pick each row's coefficient from ``[c, 1]``
    and ``[-s, s, 0]`` (bye rows take 1 and 0): a gather in place of JAX's
    scatter, so that ``vmap`` batches it."""
    out = []
    for ps, qs, perm, _ in round_robin_schedule(n):
        k = len(ps)
        cidx = np.full(n, k, np.int64)
        sidx = np.full(n, 2 * k, np.int64)
        cidx[ps] = cidx[qs] = np.arange(k)
        sidx[ps], sidx[qs] = np.arange(k), k + np.arange(k)
        out.append(tuple(
            torch.as_tensor(np.asarray(a, np.int64), device=device)
            for a in (ps, qs, perm, cidx, sidx)
        ))
    return tuple(out)


def _rotation(app, aqq, apq):
    """Stable symmetric-Schur rotation (c, s) zeroing apq; elementwise over
    any batch shape.  ``apq == 0`` gives the identity rotation."""
    zero = apq == 0
    theta = (aqq - app) / torch.where(zero, torch.ones_like(apq), 2.0 * apq)
    sign = torch.where(theta >= 0, torch.ones_like(theta), -torch.ones_like(theta))
    t = sign / (theta.abs() + torch.sqrt(theta * theta + 1.0))
    c = torch.reciprocal(torch.sqrt(t * t + 1.0))
    s = t * c
    c = torch.where(zero, torch.ones_like(c), c)
    s = torch.where(zero, torch.zeros_like(s), s)
    return c, s


def _sweep(A, V, n: int):
    """One full Jacobi sweep: the tournament's rounds, each applying its
    n/2 disjoint rotations as whole-matrix row and column updates."""
    for ps, qs, perm, cidx, sidx in _round_tables(n, A.device):
        c, s = _rotation(A[ps, ps], A[qs, qs], A[ps, qs])          # [k, *b]
        Cv = torch.cat([c, torch.ones_like(A[0, :1])])[cidx]       # [n, *b]
        Sv = torch.cat([-s, s, torch.zeros_like(A[0, :1])])[sidx]
        Crow, Srow = Cv.unsqueeze(1), Sv.unsqueeze(1)
        Ccol, Scol = Cv.unsqueeze(0), Sv.unsqueeze(0)
        A = Crow * A + Srow * A[perm]                 # J^T A (rows)
        A = Ccol * A + Scol * A[:, perm]              # (J^T A) J (columns)
        V = Ccol * V + Scol * V[:, perm]              # V <- V J
    return A, V


def eigh_jacobi(A: torch.Tensor, sweeps: int = 10, sort: bool = True) -> Eigh:
    """Symmetric eigendecomposition by parallel-order cyclic Jacobi.

    ``A`` is ``[n, n, *batch]``: trailing batch dims (the batch-minor
    fleet layout); a plain ``[n, n]`` matrix works unchanged, and the
    function is ``vmap``-compatible for leading batch axes too.

    Returns eigenvalues ``[n, *batch]`` ascending (when ``sort``) and
    eigenvectors ``[n, n, *batch]`` with column k (axis 1) the k-th
    eigenvector, matching ``torch.linalg.eigh``'s convention.
    """
    n = A.shape[0]
    if A.ndim < 2 or A.shape[1] != n:
        raise ValueError(f"expected [n, n, *batch], got {tuple(A.shape)}")
    bshape = A.shape[2:]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    V = eye.reshape((n, n) + (1,) * len(bshape)).expand((n, n) + tuple(bshape))
    # enforce symmetry once; Jacobi preserves it by construction
    A = (A + A.transpose(0, 1)) / 2
    for _ in range(sweeps):
        A, V = _sweep(A, V, n)
    d = torch.diagonal(A, dim1=0, dim2=1).movedim(-1, 0)          # [n, *b]
    return sort_spectrum(d, V) if sort else Eigh(eigenvalues=d, eigenvectors=V)


def sort_spectrum(d: torch.Tensor, V: torch.Tensor) -> Eigh:
    """Eigenvalues ascending along axis 0 and the eigenvector columns
    (axis 1) in the same order; stable, as ``jnp.argsort`` is."""
    order = torch.argsort(d, dim=0, stable=True)
    d = torch.take_along_dim(d, order, dim=0)
    V = torch.take_along_dim(V, order.unsqueeze(0), dim=1)
    return Eigh(eigenvalues=d, eigenvectors=V)
