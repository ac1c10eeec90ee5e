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
  the twin but K3-b, the dispatcher's past K3-c's range:

  - ``solve_spd_registers`` (K3-r): a thread a lane, everything in
    registers, one kernel per n and dtype (``registers_fit``: n <= 19 in
    float32, 13 in float64);
  - ``solve_spd_warp`` (K3-w): a warp a lane, the lane's packed lower
    triangle and right-hand side in shared memory, factored right-looking
    with the forward solve as one more row (``warp_fits``: n <= 337 in
    float32, 238 in float64);
  - ``solve_spd_cluster`` (K3-c): a lane a thread-block cluster of 2, 4 or 8
    CTAs, K3-w's packed rows split over their shared memory, row i in CTA i
    % C (``cluster_fits``: n <= 927 in float32, 645 in float64);
  - ``solve_spd_blocked`` (K3-b): a lane over P CTAs of the whole card, its
    triangle packed in device memory, factored by panels with one barrier
    in device memory a panel, the back solve by columns (``blocked_fits``:
    every n; the dispatcher's for every n past K3-c's range, from 928 in
    float32 and 646 in float64).  L and z are the twin's; x takes its back
    solve's terms in descending k, as its plain version
    ``solve_spd_blocked_reference`` does, bit for bit.  So up to K3-c's
    range the dispatcher's x is the twin's bit for bit, and past it K3-b's
    plain version's, within n eps kappa_2(A) of the twin's;
  - ``solve_spd_distributed`` (K3-d): a lane over P CTAs of the whole card,
    K3-c's rows over their shared memory, the columns of L through device
    memory, one barrier in device memory a step, one cooperative launch
    (``distributed_fits``: n <= 3599 in float32, 2457 in float64), by a
    direct call: its back solve, in the twin's order, is one chain of n (n
    - 1) / 2 dependent subtractions, which K3-b outruns across this range;
  - ``solve_spd_batchminor_global`` (K3-g): a thread a lane, L in a scratch
    in device memory, any n, by a direct call.

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
from ._build import MAX_DYNAMIC_SMEM, SMS

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
# K3-c: the cluster sizes it takes (CTAs a lane), and threads a CTA.  On an
# H100, 256 and 512 threads took 0.696 and 0.679 ms at [240, 240, 16] f64
# with clusters of 8, and 2.50 and 3.54 ms at [239, 239, 256] with clusters
# of 4 (the plan's there; 3.53 and 3.08 with 2, 3.72 and 5.98 with 8)
CLUSTER_SIZES = (2, 4, 8)
CLUSTER_THREADS = 256
# K3-d: threads a CTA.  On an H100, 128, 256 and 512 took 2.85, 2.58 and
# 2.51 ms at [646, 646, 2] f64 with 66 CTAs a lane, 25.9, 19.9 and 17.5 at
# [700, 700, 64] with 9
DISTRIBUTED_THREADS = 512
# K3-b: threads a CTA (csrc/smallchol.cu's kBlockedThreads, which sizes the
# warps' slabs), the columns of a panel, built into the main path's kernel
# and the most a probe's takes (kBlockedNb), rows a block of the back solve
# (kBackRows)
BLOCKED_THREADS = 512
BLOCKED_NB = 8
BACK_ROWS = 32
# K3-b: the fewest CTAs a lane its plan gives many lanes.  On an H100 at 64
# lanes 4 CTAs a lane took 8-32 % less time than 2 at every n of
# benches.sweep_spd_past_cluster (n = 646-2457 f64, 928-3599 f32), where 2
# leave half the card's SMs to the first CTA's chain of panels; 8 took 7 %
# less than 4 at n = 3599 f32 and 15 % more at 646 f64
BLOCKED_LEAST = 4


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


def cluster_words(n: int, size: int) -> int:
    """Words of packed rows that the fullest CTA of K3-c holds with ``size``
    CTAs a lane: rows r, r + size, .. <= n of CTA r, row i < n of i + 1
    words, row n (b) of n."""
    return max(sum(i + 1 if i < n else n for i in range(r, n + 1, size))
               for r in range(min(size, n + 1)))


def cluster_bytes(n: int, dtype: torch.dtype, size: int) -> int:
    """Shared memory of one CTA of K3-c with ``size`` CTAs a lane: its
    packed rows, the diagonal of all n rows, and three column rows of n + 1
    words."""
    return (cluster_words(n, size) + 4 * n + 3) * torch.empty((), dtype=dtype).element_size()


def cluster_lanes(n: int, dtype: torch.dtype, size: int, sms: int = SMS) -> int:
    """Lanes of K3-c with ``size`` CTAs a lane that a card of ``sms`` H100
    SMs runs at once: the CTAs an SM holds by shared memory and by threads
    (``CLUSTER_THREADS``), over size."""
    return _build.lanes_at_once(size, cluster_bytes(n, dtype, size), CLUSTER_THREADS, sms)


def cluster_plan(n: int, dtype: torch.dtype, lanes: int | None = None, sms: int = SMS) -> int:
    """K3-c's cluster size for n in ``dtype``: C of ``CLUSTER_SIZES`` whose
    CTAs hold the packed rows and that runs the most of ``lanes`` lanes at
    once (``cluster_lanes``; the least such C), doubled (to at most 8) while
    ``lanes`` clusters of twice as many CTAs still find an SM each; 0 where 8
    CTAs do not hold them.  The sizes that hold the rows: 2 up to n = 472 in
    float32, 4 to 663, 8 to 927; in float64 2 to 331, 4 to 463, 8 to 645."""
    if dtype not in _build.DTYPE_SUFFIX or n < 1:
        return 0
    return _build.cluster_size(CLUSTER_SIZES, lambda c: cluster_bytes(n, dtype, c),
                               lambda c: CLUSTER_THREADS, lanes, sms)


def cluster_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K3-c takes n in ``dtype``: n <= 927 in float32, 645 in
    float64."""
    return cluster_plan(n, dtype) > 0


def distributed_bytes(n: int, dtype: torch.dtype, size: int) -> int:
    """Shared memory of one CTA of K3-d with ``size`` CTAs a lane: its
    packed rows (K3-c's layout, ``cluster_words``), the diagonal of all n
    rows and a column of n + 1 words; at least the 3 n + 2 words of the back
    solve, which reuses the first CTA's rows."""
    words = max(cluster_words(n, size) + 2 * n + 1, 3 * n + 2)
    return words * torch.empty((), dtype=dtype).element_size()


def distributed_least(n: int, dtype: torch.dtype, sms: int = SMS) -> int:
    """The fewest CTAs, at most ``sms``, whose slices of K3-d hold the
    packed rows of order n in ``dtype`` within a block's shared memory
    (``distributed_bytes``); 0 where ``sms`` CTAs do not hold them."""
    if dtype not in _build.DTYPE_SUFFIX or n < 1:
        return 0
    cap = MAX_DYNAMIC_SMEM // torch.empty((), dtype=dtype).element_size() - (2 * n + 1)
    if cap < 1:
        return 0
    # no CTA holds less than its share of the n (n + 3) / 2 words
    for size in range(max(1, -(-(n * (n + 3) // 2) // cap)), sms + 1):
        if distributed_bytes(n, dtype, size) <= MAX_DYNAMIC_SMEM:
            return size
    return 0


def distributed_fits(n: int, dtype: torch.dtype, sms: int = SMS) -> bool:
    """Whether K3-d takes n in ``dtype`` on a card of ``sms`` SMs: n <= 3599
    in float32, 2457 in float64 on an H100's 132."""
    return distributed_least(n, dtype, sms) > 0


def distributed_plan(n: int, dtype: torch.dtype, lanes: int | None = None,
                     sms: int = SMS) -> int:
    """K3-d's CTAs a lane, P, for order n in ``dtype`` and ``lanes`` lanes:
    the fewest whose slices hold the rows (``distributed_least``), spread to
    ``sms // lanes`` (at most n + 1, a row each) where few lanes leave SMs
    idle; 0 where ``sms`` CTAs do not hold the rows."""
    least = distributed_least(n, dtype, sms)
    if not least or not lanes:
        return least
    return max(least, min(n + 1, sms // lanes))


def blocked_store_words(n: int) -> int:
    """Words of K3-b's store a team: the lower triangle and b packed by
    columns (column j, rows j .. n), n (n + 3) / 2, then acc's n."""
    return n * (n + 3) // 2 + n


def blocked_bytes(n: int, dtype: torch.dtype, nb: int = BLOCKED_NB, spill: bool = False) -> int:
    """Shared memory of one CTA of K3-b: a panel's diagonal block of nb x nb,
    the back solve's diagonal block of 32 x 33 and its x, then the panel
    itself, nb columns of n + 1 words (unless it spills to device memory),
    or the warps' slabs of 32 x 33 words (``BLOCKED_THREADS`` / 32 of them),
    whichever is larger."""
    slabs = BLOCKED_THREADS // 32 * 32 * 33
    rest = max(0 if spill else nb * (n + 1), slabs)
    words = nb * nb + BACK_ROWS * (BACK_ROWS + 2) + rest
    return words * torch.empty((), dtype=dtype).element_size()


def blocked_spills(n: int, dtype: torch.dtype, nb: int = BLOCKED_NB) -> bool:
    """Whether K3-b keeps its panel in device memory, the panel of nb
    columns of n + 1 words no longer fitting a block's shared memory beside
    the rest: with nb = 8, past n = 7119 in float32 and 3487 in float64."""
    return blocked_bytes(n, dtype, nb) > MAX_DYNAMIC_SMEM


def blocked_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K3-b takes order n in ``dtype``: every n >= 1 in float32 and
    float64 (its triangle lies in device memory)."""
    return dtype in _build.DTYPE_SUFFIX and n >= 1


def blocked_plan(n: int, dtype: torch.dtype, lanes: int | None = None, sms: int = SMS) -> int:
    """K3-b's CTAs a lane, P, for order n in ``dtype`` and ``lanes`` lanes:
    the card's ``sms`` SMs shared out over the lanes, at least
    ``BLOCKED_LEAST`` (the first CTA factors the panels, the others take the
    trailing work); 0 where K3-b does not take n."""
    if not blocked_fits(n, dtype):
        return 0
    return max(BLOCKED_LEAST, sms // (lanes or 1))


@functools.lru_cache(maxsize=None)
def plan(n: int, dtype: torch.dtype) -> str:
    """The form of K3 that the dispatcher gives order n in ``dtype``, the
    first that takes it: "registers" (K3-r), "warp" (K3-w), "cluster"
    (K3-c), "blocked" (K3-b, every n past K3-c's); "distributed" (K3-d)
    and "global" (K3-g) are direct calls' alone.  On an H100 K3-r is the
    fastest form wherever it fits, and K3-w past it at every B of
    ``benches.sweep_spd_solve`` but one point, [20, 20, 262144] in float32,
    which no path runs; past K3-c's range K3-b is faster than K3-d, whose
    back solve in the twin's order is one chain of n (n - 1) / 2 dependent
    subtractions, at every point of ``benches.sweep_spd_past_cluster``.
    Raises ``ValueError`` where no form takes the order (n < 1, a dtype
    other than float32 and float64).  Cached by (n, dtype): the range tests
    walk the packed rows of K3-c's layout, host time of the order of K3-b's
    own time on the card at these n."""
    if dtype not in _build.DTYPE_SUFFIX:
        raise ValueError(f"solve_spd_batchminor: A must be float32 or float64, got {dtype}")
    if n < 1:
        raise ValueError(f"solve_spd_batchminor: no form takes n={n}")
    if registers_fit(n, dtype):
        return "registers"
    if warp_fits(n, dtype):
        return "warp"
    return "cluster" if cluster_fits(n, dtype) else "blocked"


def _blocked_factor(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The twin's L and z as K3-b forms them: right-looking, as whole
    trailing blocks on A's device, b as row n (each entry's products
    subtracted in ascending k, then its square root or quotient).  Returns
    S [n + 1, n + 1, B] whose lower triangle holds L, z in row n."""
    n, _, B = A.shape
    S = A.new_zeros((n + 1, n + 1, B))
    S[:n, :n] = A
    S[n, :n] = b
    for j in range(n):
        d = torch.sqrt(S[j, j])
        S[j + 1:, j] = S[j + 1:, j] / d
        S[j, j] = d
        col = S[j + 1:, j]
        S[j + 1:, j + 1:].sub_(col[:, None] * col[None, :])
    return S


def chol_solve_right_looking(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The twin's solve with each entry's operations in the twin's order,
    arranged as K3-w and K3-c arrange them: factored right-looking as whole
    trailing blocks on A's device (n steps of a few tensor ops, where the
    twin takes some n^3 / 6 scalar ones), b as row n, then the back solve,
    one chain a lane in the twin's order, on the host (a multiply, a
    subtraction and a division round there as on the card).  Bit-equal to
    the twin; a reference for orders too large for the twin's eager ops.
    A [n, n, B], b [n, B] -> x [n, B] on A's device."""
    import numpy as np

    n, _, B = A.shape
    L = _blocked_factor(A, b)[:, :n].cpu().numpy()
    x = np.empty((n, B), L.dtype)
    for i in reversed(range(n)):
        acc = L[n, i]
        for k in range(i + 1, n):
            acc = acc - L[k, i] * x[k]
        x[i] = acc / L[i, i]
    return torch.from_numpy(x).to(A.device)


def solve_spd_blocked_reference(A: torch.Tensor, b: torch.Tensor, _factors: bool = False):
    """Plain version of K3-b: the twin's factor (``_blocked_factor``), then
    the back solve by columns, descending: x[k] = acc[k] / L[k][k], then
    acc[:k] less L[k][:k] x[k], a multiply and a subtraction each rounded,
    as n tensor steps.  acc starts as z, so each x[i] takes its terms in
    descending k, where the twin's takes them ascending: the one place the
    port leaves the twin's rounding (tests/test_torch_smallchol.py holds x
    to the JAX function within n eps kappa(A)).  A [n, n, B], b [n, B] -> x
    [n, B] on A's device; ``_factors`` (for the tests) returns (L [n, n, B]
    lower-triangular, z [n, B]) instead."""
    S = _blocked_factor(A, b)
    n = A.shape[0]
    if _factors:
        return torch.tril(S[:n, :n].movedim(-1, 0)).movedim(0, -1), S[n, :n].clone()
    acc = S[n, :n].clone()
    x = torch.empty_like(acc)
    for k in reversed(range(n)):
        x[k] = acc[k] / S[k, k]
        acc[:k] = acc[:k] - S[k, :k] * x[k]
    return x


@functools.lru_cache(maxsize=None)
def _launcher(entry: str, suffix: str):
    """The C entry point: ``chol_solve_registers``, ``chol_solve_warp``,
    ``chol_solve_cluster``, ``chol_solve_distributed`` (and its
    ``_occupancy``), ``chol_solve_blocked`` (and its ``_occupancy``) or
    ``chol_solve_batchminor`` (K3-g)."""
    fn = getattr(_build.load_library(), f"{entry}_{suffix}")
    vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = {"chol_solve_registers": [vp] * 3 + [ci, i64, vp],
                   "chol_solve_warp": [vp] * 3 + [ci, i64, ci, vp],
                   "chol_solve_cluster": [vp] * 3 + [ci, i64, ci, ci, ci, vp],
                   "chol_solve_distributed": [vp] * 5 + [ci, i64, ci, ci, ci, ci, vp],
                   "chol_solve_distributed_occupancy": [ci, ci, ci, ctypes.POINTER(ci)],
                   "chol_solve_blocked": [vp] * 6 + [ci, i64, ci, ci, ci, ci, vp],
                   "chol_solve_blocked_occupancy": [ci] * 4 + [ctypes.POINTER(ci)],
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


def solve_spd_cluster(A: torch.Tensor, b: torch.Tensor, size: int | None = None,
                      _threads: int | None = None, _mode: int = 0) -> torch.Tensor:
    """K3-c: A [n, n, B], b [n, B] -> x [n, B], a lane a thread-block cluster
    of ``size`` CTAs (``cluster_plan`` for B lanes and the card's SMs by
    default) of ``CLUSTER_THREADS`` threads, row i of the packed triangle (b
    as row n) in CTA i % size's shared memory, factored right-looking with
    each column formed a step ahead and one cluster barrier a step, the back
    solve in CTA 0.  CPU tensors run the twin; on a card it raises where
    ``size`` CTAs do not hold the rows (``cluster_fits``).  ``_threads``
    (another count of threads a CTA, at least 64) and ``_mode`` (1: no back
    solve, x left unwritten; 2: the cluster barriers alone; either runs the
    kernel's probe instantiation) are for the tests and probes only."""
    name = "solve_spd_cluster"
    n, B = _check(name, A, b)
    if A.device.type == "cpu" and b.device.type == "cpu":
        return _chol_solve_batchminor(A, b)
    _build.check_cuda_inputs(name, {"A": A, "b": b})
    if size is None:
        sms = torch.cuda.get_device_properties(A.device).multi_processor_count
        size = cluster_plan(n, A.dtype, B, sms)
    if size not in CLUSTER_SIZES or cluster_bytes(n, A.dtype, size) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit a cluster of {size or 8} "
                         "CTAs' shared memory; solve_spd_batchminor_global takes it")
    if B == 0:
        return torch.empty_like(b)
    x = _launch(name, "chol_solve_cluster", A, b, size, _threads or CLUSTER_THREADS, _mode)
    solve_spd_cluster.launches += 1
    return x


def distributed_occupancy(dtype: torch.dtype, n: int, size: int,
                          threads: int = DISTRIBUTED_THREADS) -> int:
    """CTAs of K3-d (``size`` CTAs a lane, ``threads`` threads each) that an
    SM of the current card holds at once, from the CUDA occupancy query."""
    found = ctypes.c_int(0)
    err = _launcher("chol_solve_distributed_occupancy", _build.DTYPE_SUFFIX[dtype])(
        n, size, threads, ctypes.byref(found))
    if err != 0:
        raise RuntimeError(f"solve_spd_distributed: occupancy query failed (cudaError {err})")
    return found.value


def solve_spd_distributed(A: torch.Tensor, b: torch.Tensor, size: int | None = None,
                          _threads: int | None = None, _mode: int = 0) -> torch.Tensor:
    """K3-d: A [n, n, B], b [n, B] -> x [n, B], a lane over ``size`` CTAs
    (``distributed_plan`` for B lanes and the card's SMs by default) of
    ``DISTRIBUTED_THREADS`` threads, row i of the packed triangle (b as row
    n) in CTA i % size's shared memory, each column of L formed a step ahead
    into a store in device memory, one barrier in device memory a step, the
    back solve in the lane's first CTA; one cooperative launch of as many
    teams of ``size`` CTAs as the card holds at once (at most B), each team
    walking its share of the lanes.  CPU tensors run the twin; on a card it
    raises where ``size`` CTAs do not hold the rows
    (``distributed_fits``) or the card cannot hold them at once.
    ``_threads`` (at least 64) and ``_mode`` (1: no back solve, x left
    unwritten; 2: the barriers alone) are for the tests and probes only."""
    name = "solve_spd_distributed"
    n, B = _check(name, A, b)
    if A.device.type == "cpu" and b.device.type == "cpu":
        return _chol_solve_batchminor(A, b)
    _build.check_cuda_inputs(name, {"A": A, "b": b})
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    if size is None:
        size = distributed_plan(n, A.dtype, B, sms)
    if size < 1 or distributed_bytes(n, A.dtype, size) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit {size or sms} CTAs' shared "
                         "memory; solve_spd_blocked takes it")
    if B == 0:
        return torch.empty_like(b)
    threads = _threads or DISTRIBUTED_THREADS
    x = torch.empty_like(b)
    with torch.cuda.device(A.device):
        teams = min(B, distributed_occupancy(A.dtype, n, size, threads) * sms // size)
        if teams < 1:
            raise ValueError(f"{name}: the card does not hold {size} CTAs of {threads} threads "
                             f"at once for n={n} in {A.dtype}")
        store = A.new_empty((teams, n * (n + 3) // 2))
        counts = torch.zeros(teams, dtype=torch.int32, device=A.device)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _launcher("chol_solve_distributed", _build.DTYPE_SUFFIX[A.dtype])(
            A.data_ptr(), b.data_ptr(), x.data_ptr(), store.data_ptr(), counts.data_ptr(), n, B,
            size, teams, threads, _mode, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    solve_spd_distributed.launches += 1
    return x


def blocked_occupancy(dtype: torch.dtype, n: int, nb: int, spill: bool, probe: bool) -> int:
    """CTAs of K3-b (panels of ``nb`` columns, in device memory where
    ``spill``; the probes' instantiation where ``probe``) that an SM of the
    current card holds at once, from the CUDA occupancy query."""
    found = ctypes.c_int(0)
    err = _launcher("chol_solve_blocked_occupancy", _build.DTYPE_SUFFIX[dtype])(
        n, nb, int(spill), int(probe), ctypes.byref(found))
    if err != 0:
        raise RuntimeError(f"solve_spd_blocked: occupancy query failed (cudaError {err})")
    return found.value


def solve_spd_blocked(A: torch.Tensor, b: torch.Tensor, size: int | None = None,
                      _nb: int | None = None, _mode: int = 0) -> torch.Tensor:
    """K3-b: A [n, n, B], b [n, B] -> x [n, B], a lane over ``size`` CTAs
    (``blocked_plan`` for B lanes and the card's SMs by default, at least 2)
    of ``BLOCKED_THREADS`` threads: the lane's lower triangle and b copied
    into a packed store in device memory, factored right-looking by panels
    of ``BLOCKED_NB`` columns with one barrier in device memory a panel (the
    first CTA updates and factors the next panel while the others update
    the trailing columns), then the back solve by columns in blocks of 32
    rows, one barrier a block; one cooperative launch of as many teams of
    ``size`` CTAs as the card holds at once (at most B), each team walking
    its share of the lanes.  x is ``solve_spd_blocked_reference``'s bit for
    bit (L and z are the twin's; the back solve's order is not).  CPU
    tensors run that plain version; on a card it raises where the card
    cannot hold ``size`` CTAs at once.  ``_nb`` (1 to ``BLOCKED_NB`` columns
    a panel) and ``_mode`` (1: no back solve, x left unwritten; 2: the
    barriers alone; 3: no trailing update; 4: no update and factorization of
    the next panel; 5: no factorization of it; 6: no update of it; x then
    holds no solution) are for the tests and probes only: any but the
    defaults run the kernel's probe instantiation."""
    name = "solve_spd_blocked"
    n, B = _check(name, A, b)
    if A.device.type == "cpu" and b.device.type == "cpu":
        return solve_spd_blocked_reference(A, b)
    _build.check_cuda_inputs(name, {"A": A, "b": b})
    nb = _nb or BLOCKED_NB
    if not 1 <= nb <= BLOCKED_NB:
        raise ValueError(f"{name}: panels of {nb} columns; it is built for 1 to {BLOCKED_NB}")
    if B == 0:
        return torch.empty_like(b)
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    size = size or blocked_plan(n, A.dtype, B, sms)
    if not 2 <= size <= sms:
        raise ValueError(f"{name}: {size} CTAs a lane; it takes 2 to {sms}")
    spill = blocked_spills(n, A.dtype, nb)
    x = torch.empty_like(b)
    with torch.cuda.device(A.device):
        probe = nb != BLOCKED_NB or _mode != 0
        teams = min(B, blocked_occupancy(A.dtype, n, nb, spill, probe) * sms // size)
        if teams < 1:
            raise ValueError(f"{name}: the card does not hold {size} CTAs at once for n={n} in "
                             f"{A.dtype}")
        store = A.new_empty((teams, blocked_store_words(n)))
        panel = A.new_empty((teams, nb * (n + 1))) if spill else None
        counts = torch.zeros(teams, dtype=torch.int32, device=A.device)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _launcher("chol_solve_blocked", _build.DTYPE_SUFFIX[A.dtype])(
            A.data_ptr(), b.data_ptr(), x.data_ptr(), store.data_ptr(),
            None if panel is None else panel.data_ptr(), counts.data_ptr(), n, B, size, teams,
            nb, _mode, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    solve_spd_blocked.launches += 1
    return x


def solve_spd_batchminor_global(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3-g: A [n, n, B], b [n, B] -> x [n, B], a thread a lane with L in a
    scratch of n (n + 1) / 2 rows in device memory, allocated for this
    launch; any n, by a direct call (the dispatcher's past K3-d's range
    until K3-b took it).  CPU tensors run the twin."""
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
             "cluster": solve_spd_cluster, "blocked": solve_spd_blocked}
    return forms[plan(n, A.dtype)](A, b)


solve_spd_registers.launches = 0
solve_spd_warp.launches = 0
solve_spd_cluster.launches = 0
solve_spd_distributed.launches = 0
solve_spd_blocked.launches = 0
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
