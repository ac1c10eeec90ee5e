"""Batched Givens QR and least squares on the Sameh-Kuck wavefront as CUDA
kernels (``csrc/qr_wavefront.cu``), with their plain PyTorch twins.

Counterpart of ``nlsolver_tpu.ops.qr_wavefront``: ``qr_wavefront_kernel``
replaces ``qr_wavefront_pallas`` (K2a) and ``least_squares_wavefront_kernel``
replaces ``least_squares_wavefront_pallas`` (K2b).  Layout batch-minor,
A ``[m, n, B]``.  CPU tensors run the twins (``linalg.qr_parallel``); CUDA
tensors launch the kernel (float32 or float64, contiguous) or raise.  The
JAX kernels' fallback to the jnp wavefront when VMEM is short, and their
padding lanes, have no counterpart: the kernel takes every m >= n and B.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..linalg.qr_parallel import least_squares_parallel, qr_parallel
from . import _build

def qr_wavefront_reference(A: torch.Tensor, compute_q: bool = False):
    """Plain twin of K2a: ``(R [m, n, B], Q [m, m, B] | None)``."""
    out = qr_parallel(A, compute_q=compute_q)
    return out.R, out.Q


def least_squares_wavefront_reference(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2b: ``x [n, B]`` minimizing ``||A x - y||`` per lane."""
    return least_squares_parallel(A, y)


@functools.lru_cache(maxsize=None)
def _launcher(suffix: str):
    fn = getattr(_build.load_library(), f"qr_wavefront_{suffix}")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [ci, ci, ctypes.c_int64, ci, ci, vp]
    fn.restype = ci
    return fn


def _launch(A, y, R, Qt, qty, x, compute_q: bool, solve: bool) -> None:
    m, n, B = A.shape
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _launcher(_build.DTYPE_SUFFIX[A.dtype])(
            *(None if t is None else t.data_ptr() for t in (A, y, R, Qt, qty, x)),
            m, n, B, int(compute_q), int(solve), stream,
        )
    if err != 0:
        raise RuntimeError(f"qr_wavefront: CUDA launch failed (cudaError {err})")


def _check_shape(A: torch.Tensor, name: str) -> None:
    if A.ndim != 3:
        raise ValueError(f"{name}: A must be batch-minor [m, n, B], got {tuple(A.shape)}")
    if A.shape[0] < A.shape[1]:
        raise ValueError(f"need m >= n, got {tuple(A.shape)}")


def qr_wavefront_kernel(A: torch.Tensor, compute_q: bool = False):
    """Batched QR of ``A [m, n, B]``: ``(R [m, n, B], Q [m, m, B] | None)``,
    the schedule and rotations of ``linalg.qr_parallel``.  CUDA tensors run
    kernel K2a; CPU tensors its twin."""
    _check_shape(A, "qr_wavefront_kernel")
    if A.device.type == "cpu":
        return qr_wavefront_reference(A, compute_q)
    _build.check_cuda_inputs("qr_wavefront_kernel", {"A": A})
    m, n, B = A.shape
    R = torch.empty_like(A)
    Qt = A.new_empty((m, m, B)) if compute_q else None
    _launch(A, None, R, Qt, None, None, compute_q, False)
    qr_wavefront_kernel.launches += 1
    return R, (Qt.transpose(0, 1) if compute_q else None)


def least_squares_wavefront_kernel(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``min_x ||A x - y||`` per lane for ``A [m, n, B]``, ``y [m, B]``:
    the rotations thread y (implicit Q^T y) and the back-substitution runs
    in the kernel; only ``x [n, B]`` is written.  CUDA tensors run kernel
    K2b; CPU tensors its twin."""
    _check_shape(A, "least_squares_wavefront_kernel")
    m, n, B = A.shape
    if tuple(y.shape) != (m, B):
        raise ValueError(f"rhs must be [m, B]={m, B}, got {tuple(y.shape)}")
    if A.device.type == "cpu" and y.device.type == "cpu":
        return least_squares_wavefront_reference(A, y)
    _build.check_cuda_inputs("least_squares_wavefront_kernel", {"A": A, "y": y})
    R, qty, x = torch.empty_like(A), torch.empty_like(y), A.new_empty((n, B))
    _launch(A, y, R, None, qty, x, False, True)
    least_squares_wavefront_kernel.launches += 1
    return x


qr_wavefront_kernel.launches = 0
least_squares_wavefront_kernel.launches = 0
