"""Batched small-matrix SPD solves, batch-minor layout, with the Cholesky
solve as CUDA kernels (``csrc/smallchol.cu``).

Counterpart of ``nlsolver_tpu.ops.smallchol``.  The NLLS fleet solves one
tiny SPD system per lane and step; with the batch on the trailing axis the
unrolled Cholesky factorization and the two substitutions are elementwise
work over the fleet.

* ``solve_spd_batchminor(A [n, n, B], b [n, B])`` is the fleet's call site
  (K3, the counterpart of ``solve_spd_batched_pallas``): on CUDA tensors it
  launches the form that ``plan(n, dtype)`` names, on CPU tensors it
  runs the plain twin ``_chol_solve_batchminor``
  (``linalg.solve._solve_spd_unrolled``, which takes the batch on trailing
  axes).  The forms, each with its own ``launches`` count and bit-equal to
  the twin:

  - ``solve_spd_registers`` (K3-r): a thread a lane, everything in
    registers, one kernel per n and dtype (``registers_fit``: n <= 19 in
    float32, 13 in float64);
  - ``solve_spd_warp`` (K3-w): a warp a lane, the lane's packed lower
    triangle and right-hand side in shared memory, factored right-looking
    with the forward solve as one more row (``warp_fits``: n <= 337 in
    float32, 238 in float64);
  - ``solve_spd_batchminor_global`` (K3-g): a thread a lane, L in a scratch
    in device memory, any n.

  A failed build or launch, or a shape that no form takes, raises; nothing
  falls back to another form or to the twin.
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
from ._build import MAX_DYNAMIC_SMEM

# K3-r: the most n it is built for (csrc/smallchol.cu's kRegisterMaxN32 /
# kRegisterMaxN64)
REGISTER_MAX_N = {torch.float32: 19, torch.float64: 13}
# K3-w: the most lanes (warps) a block; fewer where their triangles do not
# fit a block's shared memory (``warp_lanes``).  On an H100 at [30, 30,
# 4096] 1, 2, 4, 8, 16 and 32 took 80.7, 69.6, 51.8, 47.3, 44.6 and 42.5 us
WARP_LANES = 32
# K3-w's table of (r, c) for a triangle's first 32 rows (csrc/smallchol.cu's
# kTableEntries, 2 bytes an entry)
WARP_TABLE_BYTES = 32 * 33 // 2 * 2


def registers_fit(n: int, dtype: torch.dtype) -> bool:
    """Whether K3-r takes n in ``dtype``."""
    return 1 <= n <= REGISTER_MAX_N.get(dtype, 0)


def warp_bytes(n: int, dtype: torch.dtype) -> int:
    """Shared memory of one warp (one lane) of K3-w: the packed rows 0 .. n
    of its triangle (b in row n) and a column of n + 1 words, in an odd
    number of words."""
    return ((n * (n + 1) // 2 + 2 * n + 1) | 1) * torch.empty((), dtype=dtype).element_size()


def warp_block_bytes(n: int, dtype: torch.dtype, lanes: int) -> int:
    """Shared memory of a block of K3-w: its lanes' triangles and the
    block's table of the first 32 rows' (r, c)."""
    return lanes * warp_bytes(n, dtype) + WARP_TABLE_BYTES


def warp_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K3-w takes n in ``dtype``: one warp's triangle fits a block's
    shared memory, n <= 337 in float32 and 238 in float64."""
    return (dtype in _build.DTYPE_SUFFIX and n >= 1
            and warp_block_bytes(n, dtype, 1) <= MAX_DYNAMIC_SMEM)


def warp_lanes(n: int, dtype: torch.dtype, most: int = WARP_LANES) -> int:
    """Lanes (warps) a block of K3-w: ``most`` (a power of two), halved
    until their triangles fit a block's shared memory."""
    lanes = most
    while lanes > 1 and warp_block_bytes(n, dtype, lanes) > MAX_DYNAMIC_SMEM:
        lanes //= 2
    return lanes


def plan(n: int, dtype: torch.dtype) -> str:
    """The form of K3 that the dispatcher gives order n in ``dtype``, the
    first that takes it: "registers" (K3-r), "warp" (K3-w), "global" (K3-g).
    On an H100 K3-r is the fastest form wherever it fits, and K3-w past it
    at every B of ``benches.sweep_spd_solve`` but one point, [20, 20,
    262144] in float32, which no path runs.  Raises ``ValueError`` where
    no form takes the order (n < 1, a dtype other than float32 and
    float64)."""
    if dtype not in _build.DTYPE_SUFFIX:
        raise ValueError(f"solve_spd_batchminor: A must be float32 or float64, got {dtype}")
    if n < 1:
        raise ValueError(f"solve_spd_batchminor: no form takes n={n}")
    if registers_fit(n, dtype):
        return "registers"
    return "warp" if warp_fits(n, dtype) else "global"


@functools.lru_cache(maxsize=None)
def _launcher(entry: str, suffix: str):
    """The C entry point: ``chol_solve_registers``, ``chol_solve_warp`` or
    ``chol_solve_batchminor`` (K3-g)."""
    fn = getattr(_build.load_library(), f"{entry}_{suffix}")
    vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = {"chol_solve_registers": [vp] * 3 + [ci, i64, vp],
                   "chol_solve_warp": [vp] * 3 + [ci, i64, ci, vp],
                   "chol_solve_batchminor": [vp] * 4 + [ci, i64, vp]}[entry]
    fn.restype = ci
    return fn


def _check(name: str, A: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    if A.ndim != 3 or A.shape[0] != A.shape[1] or A.shape[0] < 1:
        raise ValueError(f"{name}: A must be [n, n, B], got {tuple(A.shape)}")
    n, _, B = A.shape
    if tuple(b.shape) != (n, B):
        raise ValueError(f"{name}: b must be [n, B]={n, B}, got {tuple(b.shape)}")
    return n, B


def _launch(name: str, entry: str, A: torch.Tensor, b: torch.Tensor, *extra) -> torch.Tensor:
    """One launch of ``entry`` on CUDA tensors ``A``, ``b``: ``x [n, B]``;
    ``extra`` goes between B and the stream (K3-g's scratch goes first)."""
    n, _, B = A.shape
    x = torch.empty_like(b)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        suffix = _build.DTYPE_SUFFIX[A.dtype]
        if entry == "chol_solve_batchminor":
            err = _launcher(entry, suffix)(A.data_ptr(), b.data_ptr(), extra[0].data_ptr(),
                                           x.data_ptr(), n, B, stream)
        else:
            err = _launcher(entry, suffix)(A.data_ptr(), b.data_ptr(), x.data_ptr(), n, B,
                                           *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    return x


def solve_spd_registers(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3-r: A [n, n, B], b [n, B] -> x [n, B], a thread a lane, L, z and x in
    registers; A's lower triangle and b are read once, x written once.  CPU
    tensors run the twin; on a card it raises where n does not fit
    (``registers_fit``)."""
    name = "solve_spd_registers"
    n, B = _check(name, A, b)
    if A.device.type == "cpu" and b.device.type == "cpu":
        return _chol_solve_batchminor(A, b)
    _build.check_cuda_inputs(name, {"A": A, "b": b})
    if not registers_fit(n, A.dtype):
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit a thread's registers; "
                         "solve_spd_warp takes it")
    if B == 0:
        return torch.empty_like(b)
    x = _launch(name, "chol_solve_registers", A, b)
    solve_spd_registers.launches += 1
    return x


def solve_spd_warp(A: torch.Tensor, b: torch.Tensor, lanes: int | None = None) -> torch.Tensor:
    """K3-w: A [n, n, B], b [n, B] -> x [n, B], a warp a lane with its packed
    lower triangle and b in shared memory, factored right-looking with the
    forward solve as one more row, the back solve row by row; a block's
    ``lanes`` warps (``warp_lanes`` by default) fetch their triangles and
    store x together.  CPU tensors run the twin; on a card it raises where
    one warp's triangle does not fit a block (``warp_fits``)."""
    name = "solve_spd_warp"
    n, B = _check(name, A, b)
    if A.device.type == "cpu" and b.device.type == "cpu":
        return _chol_solve_batchminor(A, b)
    _build.check_cuda_inputs(name, {"A": A, "b": b})
    if not warp_fits(n, A.dtype):
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit a block's shared memory; "
                         "solve_spd_batchminor_global takes it")
    if B == 0:
        return torch.empty_like(b)
    x = _launch(name, "chol_solve_warp", A, b, lanes or warp_lanes(n, A.dtype))
    solve_spd_warp.launches += 1
    return x


def solve_spd_batchminor_global(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3-g: A [n, n, B], b [n, B] -> x [n, B], a thread a lane with L in a
    scratch of n (n + 1) / 2 rows in device memory, allocated for this
    launch; any n (the dispatcher's past K3-w's range).  CPU tensors run
    the twin."""
    name = "solve_spd_batchminor_global"
    n, B = _check(name, A, b)
    if A.device.type == "cpu" and b.device.type == "cpu":
        return _chol_solve_batchminor(A, b)
    _build.check_cuda_inputs(name, {"A": A, "b": b})
    if B == 0:
        return torch.empty_like(b)
    x = _launch(name, "chol_solve_batchminor", A, b, A.new_empty((n * (n + 1) // 2, B)))
    solve_spd_batchminor_global.launches += 1
    return x


def solve_spd_batchminor(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Layout-native entry: A [n, n, B], b [n, B] -> x [n, B].  CUDA tensors
    (float32 or float64, contiguous) run the form of K3 that ``plan``
    names; CPU tensors its twin."""
    n, _ = _check("solve_spd_batchminor", A, b)
    if A.device.type == "cpu" and b.device.type == "cpu":
        return _chol_solve_batchminor(A, b)
    _build.check_cuda_inputs("solve_spd_batchminor", {"A": A, "b": b})
    forms = {"registers": solve_spd_registers, "warp": solve_spd_warp,
             "global": solve_spd_batchminor_global}
    return forms[plan(n, A.dtype)](A, b)


solve_spd_registers.launches = 0
solve_spd_warp.launches = 0
solve_spd_batchminor_global.launches = 0


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
