"""Batched symmetric eigensolver, parallel-order cyclic Jacobi, as a CUDA
kernel (``csrc/eigh_jacobi.cu``) with its plain twin.

Counterpart of ``nlsolver_tpu.ops.eigh_jacobi``.  Layout and schedule
follow ``linalg.jacobi``: batch-minor ``[n, n, B]``, a round-robin
tournament of n/2 disjoint rotations per round.  The consumer is the CMA-ES
fleet, which needs thousands of small eigendecompositions per generation.

* ``eigh_jacobi_pallas(A_bm, sweeps, tile, sort, interpret)`` keeps the JAX
  package's name and signature: the kernel on CUDA tensors, the plain twin
  ``linalg.jacobi.eigh_jacobi`` on CPU tensors.  ``tile`` and ``interpret``
  tuned and emulated the TPU kernel; they are taken and do nothing here.
* ``eigh_jacobi_kernel`` is the kernel on CUDA tensors (float32 or
  float64, contiguous), in two forms.  K5a, ``eigh_jacobi_resident``: A and
  V of a tile of lanes stay in shared memory for all sweeps, one read of A
  and one write of w and V; it takes n <= 59 (``resident_fits``).  K5b,
  ``eigh_jacobi_global``: the same code on a working copy in device memory,
  any n.  The kernel form has no pad lanes, no rule on B and no fallback to
  the twin: a shape that neither form takes raises.

Both forms compute through round-to-nearest intrinsics in the twin's order
of operations, and a Jacobi round has no sum longer than two terms, so on
a card they equal the twin, and each other, bit for bit.  The ascending
sort, where asked for, is ``torch.argsort`` outside the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..linalg.eigh_qr import Eigh
from ..linalg.jacobi import eigh_jacobi, schedule_tables, sort_spectrum
from . import _build
from ._build import MAX_DYNAMIC_SMEM

# a block's thread limit, and the bytes of one device-memory sector (the
# narrowest tile of lanes)
MAX_THREADS = 1024
SECTOR_BYTES = 32


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _slab_bytes(n: int, lanes: int, itemsize: int) -> int:
    """K5a's shared memory: A and V [n, n] and the coefficients c, s [n]."""
    return (2 * n * n + 2 * n) * lanes * itemsize


def block_shape(n: int, lanes: int) -> tuple[int, int, int]:
    """The block (lanes, RJ, RU): RU threads over a round's pairs first (on
    an H100 a thread that walks more columns of its pair ran [16, 16, 65536]
    in 3.4 ms where the opposite split took 5.2), then RJ over the columns
    (or rows) of a lane's matrix, at most ``MAX_THREADS``."""
    ru = max(1, min((n + 1) // 2, MAX_THREADS // lanes, 64))
    rj = max(1, min(n, MAX_THREADS // (lanes * ru)))
    return lanes, rj, ru


def resident_tile(n: int, dtype: torch.dtype) -> int:
    """Lanes of one block of K5a: 32, halved down to one sector of lanes
    until A, V, c and s fit a block's shared memory (0: they never do), and
    doubled for a small n until a block has 256 threads."""
    itemsize = _itemsize(dtype)
    lanes, least = 32, SECTOR_BYTES // itemsize
    while lanes > least and _slab_bytes(n, lanes, itemsize) > MAX_DYNAMIC_SMEM:
        lanes //= 2
    if _slab_bytes(n, lanes, itemsize) > MAX_DYNAMIC_SMEM:
        return 0
    while (lanes < 256 and lanes * block_shape(n, lanes)[1] * block_shape(n, lanes)[2] < 256
           and _slab_bytes(n, 2 * lanes, itemsize) <= MAX_DYNAMIC_SMEM):
        lanes *= 2
    return lanes


def resident_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K5a takes n: n <= 59 in float32 (32 lanes a block up to
    n = 29, 16 to 42, 8 beyond) and in float64 (32 lanes up to n = 20, 16
    to 29, 8 to 42, 4 beyond)."""
    return resident_tile(n, dtype) > 0


@functools.lru_cache(maxsize=None)
def _launcher(suffix: str):
    fn = getattr(_build.load_library(), f"eigh_jacobi_{suffix}")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [ci, ci, ci, ctypes.c_int64, ci, ci, ci, ci, vp]
    fn.restype = ci
    return fn


@functools.lru_cache(maxsize=None)
def _units(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(schedule_tables(n), device=device).contiguous()


def _check(name: str, A: torch.Tensor, sweeps: int) -> tuple[int, int]:
    if A.ndim != 3 or A.shape[0] != A.shape[1] or A.shape[0] < 1:
        raise ValueError(f"{name}: expected [n, n, B], got {tuple(A.shape)}")
    if sweeps < 0:
        raise ValueError(f"{name}: sweeps must be >= 0, got {sweeps}")
    return A.shape[0], A.shape[2]


def _launch(name, A, work, coef, block, resident: bool, sweeps: int):
    n, B = A.shape[0], A.shape[2]
    w, V = A.new_empty((n, B)), torch.empty_like(A)
    if B == 0:
        return w, V
    units = _units(n, A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _launcher(_build.DTYPE_SUFFIX[A.dtype])(
            *(None if t is None else t.data_ptr() for t in (A, work, coef, w, V, units)),
            n, units.shape[0], sweeps, B, *block, int(resident), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    return w, V


def eigh_jacobi_resident(A: torch.Tensor, sweeps: int = 10):
    """Kernel K5a on a CUDA tensor ``A [n, n, B]``: ``(w [n, B], V [n, n, B])``,
    unsorted.  Raises where the slabs do not fit (``resident_fits``)."""
    name = "eigh_jacobi_resident"
    n, _ = _check(name, A, sweeps)
    _build.check_cuda_inputs(name, {"A": A})
    lanes = resident_tile(n, A.dtype)
    if lanes == 0:
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit the shared memory of a block; "
                         "eigh_jacobi_global takes it")
    out = _launch(name, A, None, None, block_shape(n, lanes), True, sweeps)
    eigh_jacobi_resident.launches += 1
    return out


eigh_jacobi_resident.launches = 0


def eigh_jacobi_global(A: torch.Tensor, sweeps: int = 10):
    """Kernel K5b on a CUDA tensor ``A [n, n, B]``, any n: the working copy
    of A ``[n, n, B]`` and the coefficients ``[2, n, B]`` are scratch in
    device memory and V is built in its output.  A block takes one sector
    of lanes: its working copy stays small, so more rounds hit L2 (on an
    H100 [56, 56, 4096] took 48 ms so and 66 ms with 32 lanes a block)."""
    name = "eigh_jacobi_global"
    n, B = _check(name, A, sweeps)
    _build.check_cuda_inputs(name, {"A": A})
    lanes = SECTOR_BYTES // _itemsize(A.dtype)
    work, coef = torch.empty_like(A), A.new_empty((2, n, B))
    out = _launch(name, A, work, coef, block_shape(n, lanes), False, sweeps)
    eigh_jacobi_global.launches += 1
    return out


eigh_jacobi_global.launches = 0


def eigh_jacobi_kernel(A: torch.Tensor, sweeps: int = 10, sort: bool = True) -> Eigh:
    """The kernel on a CUDA tensor: K5a where its slabs fit a block's
    shared memory, else K5b; the sort outside it."""
    if A.ndim == 3 and resident_fits(A.shape[0], A.dtype):
        w, V = eigh_jacobi_resident(A, sweeps)
    else:
        w, V = eigh_jacobi_global(A, sweeps)
    return sort_spectrum(w, V) if sort else Eigh(eigenvalues=w, eigenvectors=V)


def eigh_jacobi_pallas(
    A_bm: torch.Tensor,
    sweeps: int = 10,
    tile: int = 128,
    sort: bool = True,
    interpret: bool = False,
) -> Eigh:
    """Batched eigendecomposition of ``A_bm``: ``[n, n, B]`` batch-minor.

    Returns eigenvalues ``[n, B]`` and eigenvectors ``[n, n, B]`` (column k
    on axis 1).  ``sort=False`` skips the ascending sort: the CMA-ES fleet
    does not need ordered spectra.  A CUDA tensor runs the kernel, a CPU
    tensor the plain twin; ``tile`` and ``interpret`` do nothing.
    """
    _check("eigh_jacobi_pallas", A_bm, sweeps)
    if A_bm.device.type == "cpu":
        return eigh_jacobi(A_bm, sweeps=sweeps, sort=sort)
    return eigh_jacobi_kernel(A_bm, sweeps=sweeps, sort=sort)
