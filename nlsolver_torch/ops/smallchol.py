"""Batched small-matrix SPD solves, batch-minor layout, with the Cholesky
solve as a CUDA kernel (``csrc/smallchol.cu``).

Counterpart of ``nlsolver_tpu.ops.smallchol``.  The NLLS fleet solves one
tiny SPD system per lane and step; with the batch on the trailing axis the
unrolled Cholesky-Banachiewicz factorization and the two substitutions
are elementwise work over the fleet.

* ``solve_spd_batchminor(A [n, n, B], b [n, B])`` is the fleet's call site:
  on CUDA tensors it launches the kernel (K3, the counterpart of
  ``solve_spd_batched_pallas``), on CPU tensors it runs the plain twin
  ``_chol_solve_batchminor`` (``linalg.solve._solve_spd_unrolled``, which
  takes the batch on trailing axes);
* ``solve_spd_batched_kernel(A [B, n, n], b [B, n])`` moves the batch to
  the trailing axis and calls it;
* ``solve_spd_batched`` is the standard-layout path through
  ``torch.linalg.cholesky`` and ``torch.cholesky_solve``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..linalg.solve import _solve_spd_unrolled as _chol_solve_batchminor
from . import _build


@functools.lru_cache(maxsize=None)
def _launcher(suffix: str):
    fn = getattr(_build.load_library(), f"chol_solve_batchminor_{suffix}")
    vp = ctypes.c_void_p
    fn.argtypes = [vp] * 4 + [ctypes.c_int, ctypes.c_int64, vp]
    fn.restype = ctypes.c_int
    return fn


def solve_spd_batchminor(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Layout-native entry: A [n, n, B], b [n, B] -> x [n, B].  CUDA
    tensors (float32 or float64, contiguous) run kernel K3; CPU tensors
    its twin."""
    if A.ndim != 3 or A.shape[0] != A.shape[1] or A.shape[0] < 1:
        raise ValueError(f"solve_spd_batchminor: A must be [n, n, B], got {tuple(A.shape)}")
    n, _, B = A.shape
    if tuple(b.shape) != (n, B):
        raise ValueError(f"solve_spd_batchminor: b must be [n, B]={n, B}, got {tuple(b.shape)}")
    if A.device.type == "cpu" and b.device.type == "cpu":
        return _chol_solve_batchminor(A, b)
    _build.check_cuda_inputs("solve_spd_batchminor", {"A": A, "b": b})
    L = A.new_empty((n * (n + 1) // 2, B))
    x = torch.empty_like(b)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _launcher(_build.DTYPE_SUFFIX[A.dtype])(
            A.data_ptr(), b.data_ptr(), L.data_ptr(), x.data_ptr(), n, B, stream
        )
    if err != 0:
        raise RuntimeError(f"solve_spd_batchminor: CUDA launch failed (cudaError {err})")
    solve_spd_batchminor.launches += 1
    return x


solve_spd_batchminor.launches = 0


def solve_spd_batched(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve B small SPD systems: A [B, n, n], b [B, n] -> [B, n], through
    ``torch.linalg.cholesky`` and ``torch.cholesky_solve``."""
    return torch.cholesky_solve(b.unsqueeze(-1), torch.linalg.cholesky(A)).squeeze(-1)


def solve_spd_batched_kernel(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Counterpart of ``solve_spd_batched_pallas``: A [B, n, n], b [B, n] ->
    [B, n] through ``solve_spd_batchminor`` on the batch-minor copies."""
    if A.ndim != 3 or b.ndim != 2:
        raise ValueError(
            f"solve_spd_batched_kernel: need A [B, n, n] and b [B, n], got "
            f"{tuple(A.shape)} and {tuple(b.shape)}"
        )
    Am = torch.movedim(A, 0, -1).contiguous()
    bm = torch.movedim(b, 0, -1).contiguous()
    return torch.movedim(solve_spd_batchminor(Am, bm), -1, 0)
