"""Symmetric eigendecomposition by the iterated-QR algorithm, and the
``eigh`` dispatcher (counterpart of ``nlsolver_tpu.linalg.eigh_qr``).

Re-creation of tinyqr's ``qr_algorithm`` / ``QRSolver`` (tinyqr.h:317-434):
A_{k+1} = R_k Q_k with eigenvector accumulation, default 25 iterations and
the same tolerance-based early stop on the off-diagonal norm.  ``eigh``
dispatches to ``torch.linalg.eigh`` by default; the fleet engines are the
parallel-order Jacobi (``linalg.jacobi``) and its CUDA kernel
(``ops.eigh_jacobi``); the QR-algorithm path exists for parity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .givens import qr_givens


# matrices per ``torch.linalg.eigh`` call: cuSOLVER's batched symmetric
# eigensolver refused 32768 matrices of 16 x 16 and took 16384 (torch 2.11
# with CUDA 12.8 on an H100), so a larger batch goes in pieces
LIBRARY_EIGH_MAX_BATCH = 16384


class Eigh(NamedTuple):
    eigenvalues: torch.Tensor   # [n]
    eigenvectors: torch.Tensor  # [n, n], columns


def eigh_qr(A: torch.Tensor, max_iter: int = 25, tol: float = 1e-12) -> Eigh:
    """Iterated-QR eigendecomposition (tinyqr.h:317-367 semantics).  The
    JAX package's ``lax.while_loop`` is a host loop here: the off-diagonal
    norm is read once per iteration."""
    n = A.shape[-1]
    Ak, V = A, torch.eye(n, dtype=A.dtype, device=A.device)
    for _ in range(max_iter):
        off = torch.sqrt(torch.sum((Ak - torch.diag(torch.diagonal(Ak))) ** 2))
        if not bool(off > tol):
            break
        q, r = qr_givens(Ak)
        Ak, V = r @ q, V @ q
    return Eigh(eigenvalues=torch.diagonal(Ak), eigenvectors=V)


def eigh_library_batched(A: torch.Tensor) -> Eigh:
    """``torch.linalg.eigh`` over a leading batch ``[B, n, n]``, in pieces
    of ``LIBRARY_EIGH_MAX_BATCH`` matrices."""
    parts = [torch.linalg.eigh(a) for a in A.split(LIBRARY_EIGH_MAX_BATCH)]
    if len(parts) == 1:
        return Eigh(*parts[0])
    return Eigh(torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def eigh(A: torch.Tensor, method: str = "xla", **kwargs) -> Eigh:
    """Symmetric eigendecomposition.

    * ``"xla"`` keeps the JAX package's name for the library call, here
      ``torch.linalg.eigh`` (best for one large matrix);
    * ``"jacobi"``: parallel-order cyclic Jacobi (``linalg.jacobi``), the
      fleet engine for many small matrices, batch-minor or vmapped;
    * ``"pallas"`` keeps the JAX package's name for the kernel with the
      same schedule (``ops.eigh_jacobi``), ``[n, n, B]`` batch-minor: the
      CUDA kernel on CUDA tensors, the Jacobi twin on CPU tensors;
    * ``"qr"``: tinyqr's iterated-QR semantics (parity path).
    """
    if method == "qr":
        return eigh_qr(A, **kwargs)
    if method == "jacobi":
        from .jacobi import eigh_jacobi

        return eigh_jacobi(A, **kwargs)
    if method == "pallas":
        from ..ops.eigh_jacobi import eigh_jacobi_pallas

        return eigh_jacobi_pallas(A, **kwargs)
    if method != "xla":
        raise ValueError(
            f"unknown eigh method {method!r}; one of xla, jacobi, pallas, qr"
        )
    w, v = torch.linalg.eigh(A)
    return Eigh(eigenvalues=w, eigenvectors=v)
