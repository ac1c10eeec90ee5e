"""Batched BFGS rank-2 inverse-Hessian update, with the update as CUDA
kernels (``csrc/rank2.cu``).

Counterpart of ``nlsolver_tpu.ops.rank2``.  For B instances at once

    H'_b = H_b - rho_b (s_b (H_b y_b)^T + (H_b y_b) s_b^T)
               + rho_b (1 + rho_b y_b^T H_b y_b) s_b s_b^T

* ``rank2_direction_batchminor(H [n, n, B], s, y, g [n, B], rho [B],
  reset [B] bool)`` is the BFGS fleet's call site: it returns ``(H', d' =
  -H' g)`` with the identity in place of H on ``reset`` lanes.  On CUDA
  tensors it launches a kernel, on CPU tensors it runs the plain twin
  ``rank2_direction_batchminor_reference``.  The kernel is K4a
  (``rank2_direction_batchminor_resident``: one launch, H read once, its
  slab staged in shared memory) for every n whose slab fits a block
  (``resident_fits``: n <= 40 in float32, 28 in float64), K4b-c
  (``rank2_direction_batchminor_cluster``: the slab split by rows over a
  thread-block cluster, Hy gathered through distributed shared memory, H
  read once) for every n whose rows fit a cluster (``cluster_fits``: n <=
  224 in float32, 152 in float64), K4b-t
  (``rank2_direction_batchminor_streamed``: a cluster of 16 CTAs whose
  rows are streamed twice through shared memory, the first read marked to
  stay in L2 for the second) where it measured faster than K4b
  (``streamed_fits``: n up to ``streamed_last(dtype, B)``, which falls as
  B grows), and K4b (``rank2_direction_batchminor_rowsplit``: Hy and the
  coefficient in a first pass, then a row-local pass, H read twice)
  beyond; ``rank2_direction_batchminor_kernel`` picks by n, dtype and B
  (``direction_form``).
* ``rank2_update_batched(H [B, n, n], s, y [B, n], rho [B])`` is the
  leading-batch update alone, the single-instance BFGS's: kernel K4c on
  CUDA tensors, the twin ``rank2_update_batched_reference`` on CPU
  tensors.  ``rank2_update_batched_kernel`` gives every n in float32 and
  float64 one of three forms (``batched_form``, its limits from
  ``benches.sweep_rank2_batched``): K4c-r (``rank2_update_batched_rows``: a
  thread a row in registers, floor(32 / n) instances a warp, H read once)
  up to ``ROWS_LAST`` (n <= 32 in float32, 15 in float64), K4c-w
  (``rank2_update_batched_warp``: a warp an instance staged in shared
  memory, H read once; it takes n while one instance fits a block,
  ``batched_fits``: n <= 239 in float32, 168 in float64) up to
  ``WARP_LAST`` (48), and K4c-g (``rank2_update_batched_global``: Hy in a
  first pass, then H' in a second, H read twice) beyond.
* ``rank2_update_reference`` is the single-instance formulation.

The kernels sum in ascending index order with every operation rounded on
its own, which is not ``torch.sum``'s order: they agree with the twins to a
few ulp times n relative to max|H'| and max|d'| (``KERNEL_TOL_ULPS``), and
bit for bit where n <= 2.  K4b-c and K4b-t take K4b's steps and equal it
bit for bit; K4c-r, K4c-w and K4c-g take the same sums in the same order
and equal each other bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from ._build import MAX_DYNAMIC_SMEM

# K4a's tile of lanes
RESIDENT_TILE = 32
# K4b-c: lanes a cluster takes (8 float32 lanes of an entry are one 32-byte
# sector) and CTAs a cluster
CLUSTER_LANES = 8
CLUSTER_SIZE = 8
# K4b-c's most threads a CTA (csrc/rank2.cu's kClusterThreads)
CLUSTER_THREADS = 256
# K4b-t (csrc/rank2.cu's kRing and kStreamThreads): CTAs a cluster, chunks
# of a streamed row's columns in flight, the most threads a CTA, and the
# columns of a chunk of the default plan
STREAMED_SIZE = 16
STREAMED_RING = 2
STREAMED_THREADS = 512
STREAMED_CHUNK = 32
# the last n the dispatcher gives K4b-t, by dtype: (most lanes, last n)
# for B up to each bound in turn, none past the last bound.  On an H100 K4b
# measured faster at the next n of the sweep (a step of 32) for B at each
# bound; beyond the last, from the first n past K4b-c's range
# (``benches.sweep_rank2_streamed``)
STREAMED_LAST = {torch.float32: ((64, 1024), (256, 512), (1024, 320), (16384, 225)),
                 torch.float64: ((16, 1415), (64, 992), (256, 352), (1024, 192))}
# K4c-r's largest n: an instance's rows are the lanes of one warp
# (csrc/rank2.cu's kRowsMost)
ROWS_MOST = 32
# The dispatcher's limits by dtype, from benches.sweep_rank2_batched on an
# H100 at B = 256 and 10000: K4c-r up to ROWS_LAST (in float64 K4c-w was
# faster from n = 16 at B = 10000), K4c-w up to WARP_LAST (K4c-g was faster
# from n = 64 at B = 10000, from n = 40 at B = 256), K4c-g beyond
ROWS_LAST = {torch.float32: 32, torch.float64: 15}
WARP_LAST = {torch.float32: 48, torch.float64: 48}
# the n at which K4c-r stages a warp's instances through shared memory, by
# dtype: (most lanes, those n) for B up to each bound in turn, the last
# entry's n for every B beyond.  Staging measured faster at those n on an
# H100 at B = 256, 10000 and 65536 (``benches.sweep_rank2_batched`` over
# ``ROWS_SWEEP``); at every other n the rows come straight from device
# memory, 16 bytes an access where they allow
ROWS_STAGED = {
    torch.float32: ((256, frozenset({10, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26, 27, 29, 30,
                                     31})),
                    (10000, frozenset(range(5, 33)) - {8, 12, 20, 24}),
                    (65536, frozenset(range(5, 33)) - {8, 12, 16, 20, 24, 28})),
    torch.float64: ((256, frozenset({8, 13, 15, 16, 17, 19, 21, 23, 24, 25, 27, 28, 29, 30, 31,
                                     32})),
                    (10000, frozenset(range(5, 33)) - {18, 20, 22}),
                    (65536, frozenset(range(5, 33)) - {6, 8, 10, 12, 18, 20, 22, 24})),
}
# kernel against twin: |diff| <= KERNEL_TOL_ULPS * n * eps * max|twin|
KERNEL_TOL_ULPS = 2


def rank2_update_reference(H, s, y, rho):
    """Single-instance update: H [n, n]; s, y [n]; rho scalar."""
    Hy = H @ y
    yHy = torch.dot(y, Hy)
    coef = rho * (1.0 + rho * yHy)
    sym = torch.outer(s, Hy) + torch.outer(Hy, s)
    return H - rho * sym + coef * torch.outer(s, s)


def rank2_update_batched_reference(H, s, y, rho):
    """Plain twin of K4c: [B, n, n], [B, n], [B, n], [B] -> [B, n, n]."""
    Hy = (H * y[:, None, :]).sum(dim=2)                     # [B, n]
    yHy = (y * Hy).sum(dim=1)                               # [B]
    coef = rho * (1.0 + rho * yHy)
    sym = s[:, :, None] * Hy[:, None, :] + Hy[:, :, None] * s[:, None, :]
    return H - rho[:, None, None] * sym + coef[:, None, None] * (s[:, :, None] * s[:, None, :])


def rank2_direction_batchminor_reference(H, s, y, g, rho, reset):
    """Plain twin of K4a and K4b: returns (H', d' = -H' g).

    H [n, n, B]; s, y, g [n, B]; rho [B]; reset [B] bool (use the identity
    in place of H before updating)."""
    n = H.shape[0]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)[:, :, None]
    Heff = torch.where(reset[None, None, :], eye, H)
    Hy = (Heff * y[None, :, :]).sum(dim=1)                  # [n, B]
    yHy = (y * Hy).sum(dim=0)                               # [B]
    coef = rho * (1.0 + rho * yHy)
    sym = s[:, None, :] * Hy[None, :, :] + Hy[:, None, :] * s[None, :, :]
    Hn = Heff - rho[None, None, :] * sym + coef[None, None, :] * (s[:, None, :] * s[None, :, :])
    d = -(Hn * g[None, :, :]).sum(dim=1)                    # [n, B]
    return Hn, d


def resident_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K4a's slab, [n, n] of H plus s, y, g and Hy for a tile of
    ``RESIDENT_TILE`` lanes, fits a block's shared memory: n <= 40 in
    float32, n <= 28 in float64."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (n * n + 4 * n) * RESIDENT_TILE * itemsize <= MAX_DYNAMIC_SMEM


def cluster_bytes(n: int, dtype: torch.dtype, size: int = CLUSTER_SIZE,
                  lanes: int = CLUSTER_LANES) -> int:
    """Dynamic shared memory of a CTA of K4b-c: its ceil(n / ``size``) rows
    of H, each n | 1 entries long (odd, against bank conflicts), and s, y,
    g and Hy [n], for ``lanes`` lanes."""
    rows = -(-n // size)
    return (rows * (n | 1) + 4 * n) * lanes * torch.empty((), dtype=dtype).element_size()


def cluster_takes(n: int, dtype: torch.dtype, size: int, lanes: int) -> bool:
    """Whether a cluster of ``size`` CTAs and a tile of ``lanes`` lanes (a
    power of two, 16 bytes or more, up to 32) takes n in ``dtype``: a CTA's
    rows fit its shared memory and, a thread a row and lane,
    ``CLUSTER_THREADS`` threads."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (dtype in _build.DTYPE_SUFFIX and n >= 1 and 1 <= size <= 16
            and 16 // itemsize <= lanes <= 32 and lanes & (lanes - 1) == 0
            and cluster_bytes(n, dtype, size, lanes) <= MAX_DYNAMIC_SMEM
            and -(-n // size) * lanes <= CLUSTER_THREADS)


def cluster_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K4b-c takes n in ``dtype`` at ``CLUSTER_SIZE`` CTAs and
    ``CLUSTER_LANES`` lanes: n <= 224 in float32 and n <= 152 in float64."""
    return cluster_takes(n, dtype, CLUSTER_SIZE, CLUSTER_LANES)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def streamed_lanes(dtype: torch.dtype) -> int:
    """K4b-t's tile of lanes: one 32-byte sector of an entry, 8 float32 or
    4 float64 lanes."""
    return 32 // _itemsize(dtype)


def streamed_bytes(n: int, dtype: torch.dtype, size: int, lanes: int, chunk: int) -> int:
    """Dynamic shared memory of a CTA of K4b-t: a ring of ``STREAMED_RING``
    chunks of its ceil(n / ``size``) rows, ``chunk`` | 1 columns each, s,
    y, g and Hy [n] and the lanes' coefficients, for ``lanes`` lanes."""
    rows = -(-n // size)
    return (STREAMED_RING * rows * (chunk | 1) + 4 * n + 1) * lanes * _itemsize(dtype)


def _streamed_threads(n: int, size: int, lanes: int) -> int:
    """Threads a CTA of K4b-t: a row and lane each, in whole warps."""
    rows, step = -(-n // size), max(1, 32 // lanes)
    return -(-rows // step) * step * lanes


def streamed_plan(n: int, dtype: torch.dtype, size: int = STREAMED_SIZE,
                  lanes: Optional[int] = None, chunk: Optional[int] = None) -> Optional[int]:
    """The columns of a chunk of K4b-t for n in ``dtype`` on clusters of
    ``size`` CTAs and tiles of ``lanes`` lanes (``streamed_lanes`` by
    default): ``STREAMED_CHUNK`` or as many as the shared memory leaves,
    down to a quarter of that; a ``chunk`` given is taken as it is.  None
    where nothing fits: a CTA's threads (a row and lane each) or its shared
    memory."""
    lanes = lanes or streamed_lanes(dtype)
    itemsize = _itemsize(dtype)
    if not (dtype in _build.DTYPE_SUFFIX and n >= 1 and 1 <= size <= 16
            and 16 // itemsize <= lanes <= 32 and lanes & (lanes - 1) == 0
            and _streamed_threads(n, size, lanes) <= STREAMED_THREADS):
        return None
    if chunk is None:
        # the widest odd row of a ring slot that fits, at most STREAMED_CHUNK
        room = MAX_DYNAMIC_SMEM // (lanes * itemsize) - 4 * n - 1
        most = room // (STREAMED_RING * -(-n // size))
        chunk = min(n, STREAMED_CHUNK, most if most % 2 else most - 1)
        if chunk < min(n, STREAMED_CHUNK // 4):  # too narrow to stream through
            return None
    fits = streamed_bytes(n, dtype, size, lanes, chunk) <= MAX_DYNAMIC_SMEM
    return chunk if 1 <= chunk <= n and fits else None


def streamed_last(dtype: torch.dtype, B: int) -> int:
    """The last n the dispatcher gives K4b-t for B lanes in ``dtype``
    (``STREAMED_LAST``): 0 past its largest B."""
    return next((last for most, last in STREAMED_LAST[dtype] if B <= most), 0)


def streamed_fits(n: int, dtype: torch.dtype, B: int) -> bool:
    """Whether the dispatcher gives n in ``dtype`` on B lanes to K4b-t:
    its default plan fits and n is at most ``streamed_last(dtype, B)``."""
    return dtype in STREAMED_LAST and n <= streamed_last(dtype, B) and \
        streamed_plan(n, dtype) is not None


def direction_form(n: int, dtype: torch.dtype, B: int) -> str:
    """The kernel the dispatcher gives n in ``dtype`` on B lanes:
    "resident" (K4a), "cluster" (K4b-c), "streamed" (K4b-t) or "rowsplit"
    (K4b), the first that takes it."""
    if resident_fits(n, dtype):
        return "resident"
    if cluster_fits(n, dtype):
        return "cluster"
    return "streamed" if streamed_fits(n, dtype, B) else "rowsplit"


def batched_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether one instance of K4c-w (H with padded rows, s, y, Hy) fits a
    block's shared memory: n <= 239 in float32, n <= 168 in float64."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (n * (n + 1) + 3 * n) * itemsize <= MAX_DYNAMIC_SMEM


def rows_staged(n: int, dtype: torch.dtype, B: int) -> bool:
    """Whether K4c-r passes n in ``dtype`` on B lanes through shared memory
    (``ROWS_STAGED``) rather than straight from device memory."""
    table = ROWS_STAGED.get(dtype, ((0, frozenset()),))
    return n in next((ns for most, ns in table if B <= most), table[-1][1])


def rows_takes(n: int) -> bool:
    """Whether K4c-r takes n: an instance's n rows are lanes of one warp."""
    return 1 <= n <= ROWS_MOST


def batched_form(n: int, dtype: torch.dtype) -> str:
    """The form of K4c the dispatcher gives n in ``dtype``: "rows" (K4c-r)
    up to ``ROWS_LAST[dtype]``, "warp" (K4c-w) up to ``WARP_LAST[dtype]``,
    "global" (K4c-g) beyond: n <= 32, 33-48 and 49 on in float32; n <= 15,
    16-48 and 49 on in float64."""
    if rows_takes(n) and n <= ROWS_LAST.get(dtype, 0):
        return "rows"
    return "warp" if n <= WARP_LAST.get(dtype, 0) and batched_fits(n, dtype) else "global"


@functools.lru_cache(maxsize=None)
def _launcher(name: str, n_pointers: int, n_options: int = 0):
    """An entry point taking pointers, n, B, ``n_options`` ints and the stream."""
    fn = getattr(_build.load_library(), name)
    ci = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ci, ctypes.c_int64] + [ci] * n_options
                   + [ctypes.c_void_p])
    fn.restype = ci
    return fn


@functools.lru_cache(maxsize=None)
def _cluster_launcher(suffix: str):
    fn = getattr(_build.load_library(), f"rank2_cluster_{suffix}")
    ci = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ci, ctypes.c_int64, ci, ci, ctypes.c_void_p]
    fn.restype = ci
    return fn


def _launch(name, tensors, n, B, *options):
    first = tensors[0]
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        err = _launcher(f"{name}_{_build.DTYPE_SUFFIX[first.dtype]}", len(tensors), len(options))(
            *(t.data_ptr() for t in tensors), n, B, *options, stream
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _check_batchminor(name, H, s, y, g, rho, reset):
    if H.ndim != 3 or H.shape[0] != H.shape[1] or H.shape[0] < 1:
        raise ValueError(f"{name}: H must be [n, n, B], got {tuple(H.shape)}")
    n, _, B = H.shape
    for what, v in (("s", s), ("y", y), ("g", g)):
        if tuple(v.shape) != (n, B):
            raise ValueError(f"{name}: {what} must be [n, B]={n, B}, got {tuple(v.shape)}")
    for what, v in (("rho", rho), ("reset", reset)):
        if tuple(v.shape) != (B,):
            raise ValueError(f"{name}: {what} must be [B]={(B,)}, got {tuple(v.shape)}")
    if reset.dtype != torch.bool:
        raise ValueError(f"{name}: reset must be bool, got {reset.dtype}")
    return n, B


def _check_cuda_batchminor(name, H, s, y, g, rho, reset):
    n, B = _check_batchminor(name, H, s, y, g, rho, reset)
    _build.check_cuda_inputs(name, {"H": H, "s": s, "y": y, "g": g, "rho": rho})
    if reset.device != H.device:
        raise ValueError(f"{name}: reset is on {reset.device}, expected {H.device}")
    if not reset.is_contiguous():
        raise ValueError(f"{name}: reset must be contiguous")
    return n, B


def rank2_direction_batchminor_resident(H, s, y, g, rho, reset):
    """Kernel K4a on CUDA tensors (float32 or float64, contiguous): one
    launch, H read once.  Raises where the slab does not fit
    (``resident_fits``)."""
    name = "rank2_direction_batchminor_resident"
    n, B = _check_cuda_batchminor(name, H, s, y, g, rho, reset)
    if not resident_fits(n, H.dtype):
        raise ValueError(f"{name}: n={n} in {H.dtype} does not fit the shared memory of a block; "
                         "rank2_direction_batchminor_rowsplit takes it")
    Hn, d = torch.empty_like(H), torch.empty_like(g)
    _launch("rank2_resident", (H, s, y, g, rho, reset, Hn, d), n, B)
    rank2_direction_batchminor_resident.launches += 1
    return Hn, d


rank2_direction_batchminor_resident.launches = 0


def rank2_direction_batchminor_cluster(H, s, y, g, rho, reset, size=CLUSTER_SIZE,
                                       lanes=CLUSTER_LANES):
    """Kernel K4b-c on CUDA tensors (float32 or float64, contiguous): a
    cluster of ``size`` CTAs a tile of ``lanes`` lanes, each CTA holding
    ceil(n / ``size``) rows of H in its shared memory; one launch, H read
    once.  Raises where the rows do not fit (``cluster_bytes``)."""
    name = "rank2_direction_batchminor_cluster"
    n, B = _check_cuda_batchminor(name, H, s, y, g, rho, reset)
    if not cluster_takes(n, H.dtype, size, lanes):
        raise ValueError(f"{name}: n={n} in {H.dtype} does not fit the shared memory or threads "
                         f"of a CTA of a cluster of {size} with {lanes} lanes; "
                         "rank2_direction_batchminor_rowsplit takes it")
    Hn, d = torch.empty_like(H), torch.empty_like(g)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = _cluster_launcher(_build.DTYPE_SUFFIX[H.dtype])(
            *(t.data_ptr() for t in (H, s, y, g, rho, reset, Hn, d)), n, B, size, lanes, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    rank2_direction_batchminor_cluster.launches += 1
    return Hn, d


rank2_direction_batchminor_cluster.launches = 0


@functools.lru_cache(maxsize=None)
def _streamed_launcher(suffix: str):
    fn = getattr(_build.load_library(), f"rank2_streamed_{suffix}")
    ci = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ci, ctypes.c_int64] + [ci] * 4 + [ctypes.c_void_p]
    fn.restype = ci
    return fn


def rank2_direction_batchminor_streamed(H, s, y, g, rho, reset, size=STREAMED_SIZE, lanes=None,
                                        chunk=None, _mode=0):
    """Kernel K4b-t on CUDA tensors (float32 or float64, contiguous): a
    cluster of ``size`` CTAs a tile of ``lanes`` lanes (``streamed_lanes``
    by default), each CTA streaming its ceil(n / ``size``) rows of H twice
    through its shared memory in chunks of ``chunk`` columns
    (``streamed_plan`` by default), the first read marked to stay in L2 for
    the second; one launch.  Raises where the plan does not fit.  ``_mode``
    (for tests and probes): 1 leaves out the arithmetic (the copies,
    barriers and stores alone, H' then H), 2 reads H without the L2
    hints."""
    name = "rank2_direction_batchminor_streamed"
    n, B = _check_cuda_batchminor(name, H, s, y, g, rho, reset)
    lanes = lanes or streamed_lanes(H.dtype)
    plan = streamed_plan(n, H.dtype, size, lanes, chunk)
    if plan is None:
        raise ValueError(f"{name}: n={n} in {H.dtype} with chunk={chunk} does not fit the shared "
                         f"memory or threads of a CTA of a cluster of {size} with {lanes} lanes; "
                         f"rank2_direction_batchminor_rowsplit takes it")
    Hn, d = torch.empty_like(H), torch.empty_like(g)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = _streamed_launcher(_build.DTYPE_SUFFIX[H.dtype])(
            *(t.data_ptr() for t in (H, s, y, g, rho, reset, Hn, d)), n, B, size, lanes, plan,
            _mode, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    rank2_direction_batchminor_streamed.launches += 1
    return Hn, d


rank2_direction_batchminor_streamed.launches = 0


def rank2_direction_batchminor_rowsplit(H, s, y, g, rho, reset):
    """Kernel K4b on CUDA tensors (float32 or float64, contiguous), any n:
    Hy [n, B] and the coefficient [B] into scratch, then the row-local
    update; three launches on the current stream, counted as one."""
    name = "rank2_direction_batchminor_rowsplit"
    n, B = _check_cuda_batchminor(name, H, s, y, g, rho, reset)
    Hn, d = torch.empty_like(H), torch.empty_like(g)
    Hy, coef = torch.empty_like(y), torch.empty_like(rho)
    _launch("rank2_rowsplit", (H, s, y, g, rho, reset, Hy, coef, Hn, d), n, B)
    rank2_direction_batchminor_rowsplit.launches += 1
    return Hn, d


rank2_direction_batchminor_rowsplit.launches = 0


def rank2_direction_batchminor_kernel(H, s, y, g, rho, reset):
    """K4a where its slab fits a block's shared memory, else K4b-c where
    its rows fit a cluster's, else K4b-t where it measured faster than K4b,
    else K4b (``direction_form``)."""
    form = direction_form(H.shape[0], H.dtype, H.shape[2]) if H.ndim == 3 else "rowsplit"
    return {"resident": rank2_direction_batchminor_resident,
            "cluster": rank2_direction_batchminor_cluster,
            "streamed": rank2_direction_batchminor_streamed,
            "rowsplit": rank2_direction_batchminor_rowsplit}[form](H, s, y, g, rho, reset)


def rank2_direction_batchminor(H, s, y, g, rho, reset):
    """(H', d' = -H' g) on the batch-minor layout: a kernel on CUDA
    tensors, the plain twin on CPU tensors."""
    tensors = (H, s, y, g, rho, reset)
    if all(t.device.type == "cpu" for t in tensors):
        _check_batchminor("rank2_direction_batchminor", *tensors)
        return rank2_direction_batchminor_reference(*tensors)
    return rank2_direction_batchminor_kernel(*tensors)


def _check_cuda_batched(name, H, s, y, rho):
    B, n = _check_batched(name, H, s, y, rho)
    _build.check_cuda_inputs(name, {"H": H, "s": s, "y": y, "rho": rho})
    return B, n


def rank2_update_batched_rows(H, s, y, rho, _staged=None):
    """Kernel K4c-r on CUDA tensors (float32 or float64, contiguous):
    thread i of an instance holds row i of H in registers, floor(32 / n)
    instances a warp; H read once.  Where ``rows_staged(n, dtype, B)`` a
    warp's instances pass through its slab of shared memory by coalesced
    one-word accesses, else each row comes straight from device memory, 16
    bytes an access where the rows allow; ``_staged`` (for tests and
    sweeps) takes one way or the other.  Raises past n = ``ROWS_MOST``."""
    name = "rank2_update_batched_rows"
    B, n = _check_cuda_batched(name, H, s, y, rho)
    if not rows_takes(n):
        raise ValueError(f"{name}: n={n} passes the {ROWS_MOST} rows of a warp; "
                         "rank2_update_batched_warp or rank2_update_batched_global takes it")
    staged = rows_staged(n, H.dtype, B) if _staged is None else _staged
    Hn = torch.empty_like(H)
    _launch("rank2_batched_rows", (H, s, y, rho, Hn), n, B, int(bool(staged)))
    rank2_update_batched_rows.launches += 1
    return Hn


rank2_update_batched_rows.launches = 0


def rank2_update_batched_warp(H, s, y, rho):
    """Kernel K4c-w on CUDA tensors (float32 or float64, contiguous): a
    warp an instance, H, s, y and Hy in shared memory; H read once.
    Raises where one instance does not fit a block (``batched_fits``)."""
    name = "rank2_update_batched_warp"
    B, n = _check_cuda_batched(name, H, s, y, rho)
    if not batched_fits(n, H.dtype):
        raise ValueError(f"{name}: n={n} in {H.dtype} does not fit the shared memory of a block; "
                         "rank2_update_batched_global takes it")
    Hn = torch.empty_like(H)
    _launch("rank2_batched_warp", (H, s, y, rho, Hn), n, B)
    rank2_update_batched_warp.launches += 1
    return Hn


rank2_update_batched_warp.launches = 0


def rank2_update_batched_global(H, s, y, rho, _mode=0):
    """Kernel K4c-g on CUDA tensors (float32 or float64, contiguous), any
    n: Hy [B, n] and the coefficient [B] into scratch, then H'; three
    launches on the current stream, counted as one.  ``_mode`` (for
    probes): 1 runs the first pass and the coefficient alone, H' unwritten,
    2 the first pass alone."""
    name = "rank2_update_batched_global"
    B, n = _check_cuda_batched(name, H, s, y, rho)
    Hn, Hy, coef = torch.empty_like(H), torch.empty_like(y), torch.empty_like(rho)
    _launch("rank2_batched_global", (H, s, y, rho, Hy, coef, Hn), n, B, _mode)
    rank2_update_batched_global.launches += 1
    return Hn


rank2_update_batched_global.launches = 0

# K4c's forms by the names ``batched_form`` gives them
BATCHED_FORMS = {"rows": rank2_update_batched_rows, "warp": rank2_update_batched_warp,
                 "global": rank2_update_batched_global}


def rank2_update_batched_kernel(H, s, y, rho):
    """Kernel K4c on CUDA tensors (float32 or float64, contiguous):
    H [B, n, n]; s, y [B, n]; rho [B] -> H' [B, n, n] through the form
    ``batched_form`` names.  ``launches`` counts its calls; each form
    counts its own."""
    B, n = _check_batched("rank2_update_batched_kernel", H, s, y, rho)
    Hn = BATCHED_FORMS[batched_form(n, H.dtype)](H, s, y, rho)
    rank2_update_batched_kernel.launches += 1
    return Hn


rank2_update_batched_kernel.launches = 0


def _check_batched(name, H, s, y, rho):
    if H.ndim != 3 or H.shape[1] != H.shape[2] or H.shape[1] < 1:
        raise ValueError(f"{name}: H must be [B, n, n], got {tuple(H.shape)}")
    B, n, _ = H.shape
    for what, v in (("s", s), ("y", y)):
        if tuple(v.shape) != (B, n):
            raise ValueError(f"{name}: {what} must be [B, n]={B, n}, got {tuple(v.shape)}")
    if tuple(rho.shape) != (B,):
        raise ValueError(f"{name}: rho must be [B]={(B,)}, got {tuple(rho.shape)}")
    return B, n


def rank2_update_batched(H, s, y, rho):
    """The leading-batch update: kernel K4c on CUDA tensors, the plain twin
    on CPU tensors."""
    tensors = (H, s, y, rho)
    if all(t.device.type == "cpu" for t in tensors):
        _check_batched("rank2_update_batched", *tensors)
        return rank2_update_batched_reference(*tensors)
    return rank2_update_batched_kernel(*tensors)
