"""Givens-rotation QR decomposition (counterpart of
``nlsolver_tpu.linalg.givens``).

Re-creation of tinyqr's core (tinyqr.h:86-139 ``givens_rotation`` /
``rotate_matrix``, :253-310 ``qr_impl``): a static rotation schedule, each
rotation a two-row tensor op, written so that ``torch.func.vmap`` batches
it.  ``qr`` dispatches between ``torch.linalg.qr`` (Householder, the
default), the sequential Givens QR, the Sameh-Kuck wavefront
(``linalg.qr_parallel``) and its CUDA kernel (``ops.qr_wavefront``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def givens_rotation(a: torch.Tensor, b: torch.Tensor):
    """Stable Givens coefficients (c, s) zeroing b against a
    (tinyqr.h:86-97).  Both branches are computed and one is selected, as
    in the JAX package; the CUDA kernels compute the selected one alone,
    with the same operations in the same order."""
    abs_a, abs_b = a.abs(), b.abs()
    big_a = abs_a >= abs_b
    # guard both divisions; select the stable branch
    safe_a = torch.where(abs_a == 0.0, torch.ones_like(a), a)
    safe_b = torch.where(abs_b == 0.0, torch.ones_like(b), b)
    zero = torch.zeros_like(a)
    t_ba = torch.where(big_a, b / safe_a, zero)
    t_ab = torch.where(big_a, zero, a / safe_b)
    u_a = torch.sign(a) * torch.sqrt(1.0 + t_ba * t_ba)
    u_b = torch.sign(b) * torch.sqrt(1.0 + t_ab * t_ab)
    c = torch.where(big_a, torch.reciprocal(u_a), t_ab / u_b)
    s = torch.where(big_a, t_ba / u_a, torch.reciprocal(u_b))
    both_zero = (abs_a == 0.0) & (abs_b == 0.0)
    c = torch.where(both_zero, torch.ones_like(c), c)
    s = torch.where(both_zero, torch.zeros_like(s), s)
    return c, s


class QR(NamedTuple):
    Q: Optional[torch.Tensor]
    R: torch.Tensor


def qr_givens(A: torch.Tensor) -> QR:
    """QR of a square matrix by sequential Givens rotations (static
    schedule)."""
    n = A.shape[-1]
    Q = list(torch.eye(n, dtype=A.dtype, device=A.device).unbind(0))
    R = list(A.unbind(0))
    for j in range(n):
        for i in range(j + 1, n):
            c, s = givens_rotation(R[j][j], R[i][j])
            R[j], R[i] = c * R[j] + s * R[i], -s * R[j] + c * R[i]
            Q[j], Q[i] = c * Q[j] + s * Q[i], -s * Q[j] + c * Q[i]
    return QR(Q=torch.stack(Q).T, R=torch.stack(R))


def qr(A: torch.Tensor, method: str = "householder", **kwargs) -> QR:
    """QR with selectable backend: Householder (``torch.linalg.qr``, the
    default), sequential Givens (the reference algorithm), the batched
    Sameh-Kuck wavefront (``method="parallel"``, [m, n, *batch]), or its
    CUDA kernel (``method="pallas"``, [m, n, B] batch-minor; on a CPU
    tensor it runs the wavefront).  ``tile=`` and ``interpret=`` are taken
    on ``method="pallas"`` for signature parity with the JAX package and
    do nothing here."""
    if method != "pallas" and kwargs:
        raise TypeError(
            f"qr(method={method!r}) takes no extra kwargs, got "
            f"{sorted(kwargs)}; tile=/interpret= apply to method='pallas'"
        )
    if method == "givens":
        return qr_givens(A)
    if method == "parallel":
        from .qr_parallel import qr_parallel

        return qr_parallel(A)
    if method == "pallas":
        from ..ops.qr_wavefront import qr_wavefront_kernel

        unknown = sorted(set(kwargs) - {"tile", "interpret"})
        if unknown:
            raise TypeError(f"qr(method='pallas') got unexpected kwargs {unknown}")
        if A.ndim != 3:
            raise ValueError(
                f"method='pallas' needs a batch-minor [m, n, B] fleet, "
                f"got {tuple(A.shape)}"
            )
        R, Qm = qr_wavefront_kernel(A.contiguous(), compute_q=True)
        return QR(Q=Qm, R=R)
    if method != "householder":
        raise ValueError(
            f"unknown qr method {method!r}; one of householder, givens, "
            f"parallel, pallas"
        )
    q, r = torch.linalg.qr(A)
    return QR(Q=q, R=r)


def validate_qr(qr_result: QR, A: torch.Tensor) -> torch.Tensor:
    """Max reconstruction error |QR - A| (tinyqr's validate_qr,
    tinyqr.h:218-252, returned instead of printed)."""
    return (qr_result.Q @ qr_result.R - A).abs().max()
