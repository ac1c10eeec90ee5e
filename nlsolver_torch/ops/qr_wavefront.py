"""Batched Givens QR and least squares on the Sameh-Kuck wavefront as CUDA
kernels (``csrc/qr_wavefront.cu``), with their plain PyTorch twins.

Counterpart of ``nlsolver_tpu.ops.qr_wavefront``: ``qr_wavefront_kernel``
replaces ``qr_wavefront_pallas`` (K2a) and ``least_squares_wavefront_kernel``
replaces ``least_squares_wavefront_pallas`` (K2b).  Layout batch-minor,
A ``[m, n, B]``.  CPU tensors run the twins (``linalg.qr_parallel``); CUDA
tensors launch a kernel (float32 or float64, contiguous) or raise.  The
JAX kernels' fallback to the jnp wavefront when VMEM is short, and their
padding lanes, have no counterpart: K2a and K2b take every m >= n and B.

K2a comes in five forms, chosen by (m, n), dtype and whether Q is formed
(``qr_form``): ``qr_wavefront_warp`` (K2a-w) gives a lane a warp and keeps
its ``[R | Q^T]`` in shared memory (``qr_warp_fits``: m = n <= 169 in
float32 and 120 in float64 with Q, 240 and 169 without);
``qr_wavefront_cluster`` (K2a-c) gives a lane a thread-block cluster of 2,
4 or 8 CTAs, the array's columns split over their shared memory
(``qr_cluster_fits``: m = n <= 472 in float32 and 332 in float64 with Q,
664 and 464 without); ``qr_wavefront_distributed`` (K2a-d) spreads a lane
over P CTAs of the whole card, a stage's rotations through device memory,
in one cooperative launch (``qr_distributed_fits``: m = n <= 1874 in
float32 and 1320 in float64 with Q, 2640 and 1816 without);
``qr_wavefront_panel`` (K2a-p) forms R over the whole card with every
rotation appended to a log in device memory, in panels of columns past
m = n = 2641 in float32 and 1848 in float64, then rebuilds Q^T from the log
(``qr_panel_fits``: every shape past the distributed form's to m = n =
29055 in float32, 14527 in float64); ``qr_wavefront_global`` (K2a-g) works
in device memory, a thread a lane, any shape, the dispatcher's only past
K2a-p's range.  All five are bit-equal to the twin; a failed build or
launch, or a shape that a form does not take, raises.

K2b comes in seven forms (``least_squares_wavefront_kernel``,
``least_squares_form``).  The first five keep only the 2 n rows of the
system that a stage of the wavefront touches, a window that slides down
one row a stage, and are chosen by n and dtype alone:
``least_squares_wavefront_registers`` holds the window in a thread's
registers (n <= 8 in float32, 5 in float64: ``registers_fit``);
``least_squares_wavefront_shared`` holds it in shared memory, 32 lanes a
block (n <= 29 in float32, 20 in float64: ``shared_fits``);
``least_squares_wavefront_warp`` gives a lane a warp, the window's columns
over its threads, in shared memory (n <= 169 in float32, 119 in float64:
``warp_fits``; the dispatcher's from n = 30 and 21);
``least_squares_wavefront_cluster`` gives a lane a thread-block cluster of
2, 4 or 8 CTAs, the window's columns split over their shared memory (n <=
471 in float32, 329 in float64: ``cluster_fits``; the dispatcher's from n
= 170 and 120); ``least_squares_wavefront_distributed`` spreads a lane
over P CTAs of the whole card, the window's columns over their shared
memory and a stage's rotations through device memory, in one cooperative
launch (n <= 1847 in float32, 1262 in float64: ``distributed_fits``; the
dispatcher's from n = 472 and 330).  They read A and y once and write
only x.  Past them, ``least_squares_wavefront_panel`` (K2b-p) forms R over
the whole card as K2a-p does, y carried as one more column of the last
panel, then back-substitutes a CTA a lane (K2a-p's ``qr_panel_fits``: [m,
n] whose column of m words fits a CTA beside a stage's coefficients, m = n
<= 29055 in float32, 14527 in float64; the dispatcher's from n = 1848 and
1263); ``least_squares_wavefront_global`` works on a copy of the system in
device memory, any shape, the dispatcher's only past K2b-p's range.  All
seven are bit-equal to the twin; a failed build or launch, or a shape that
a form does not take, raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..linalg.qr_parallel import least_squares_parallel, qr_parallel
from . import _build
from ._build import MAX_DYNAMIC_SMEM, SMS

# K2b's register form: the most n it is built for (csrc/qr_wavefront.cu's
# kRegisterMaxN32 / kRegisterMaxN64); its window is 2 n (n + 1) words a thread
REGISTER_MAX_N = {torch.float32: 8, torch.float64: 5}
# K2b's shared-memory form: lanes (threads) a block
SHARED_LANES = 32
# K2b's warp form: the most lanes (warps) a block; fewer where their rings
# do not fit a block's shared memory (``warp_lanes``).  On an H100 at [78,
# 30, 4096] 1, 2, 4 and 8 took 0.511, 0.503, 0.502 and 0.498 ms
WARP_LANES = 8
# K2a's warp form: the most lanes (warps) a block; fewer where their arrays
# do not fit a block's shared memory (``qr_warp_lanes``)
QR_WARP_LANES = 8
# K2b's cluster form: the cluster sizes it takes (CTAs a lane), and the
# groups of a CTA's threads that share out a stage's rotations.  On an H100
# at [248, 120, 256] f64 groups of 2, 4 and 8 took 3.23, 2.84 and 2.80 ms
# with clusters of 4 (2: 3.82, 3.34, 3.32; 8: 4.10, 3.75, 4.99)
CLUSTER_SIZES = (2, 4, 8)
CLUSTER_GROUPS = 4
# K2b's distributed form: threads a CTA, about (its columns times the
# groups that share out a stage's rotations)
DISTRIBUTED_THREADS = 256
# K2a's cluster form: the groups of a CTA's threads that share out a stage's
# rotations (a CTA's columns need at most 256 column threads wherever a
# cluster holds the array, so 1024 threads at most).  On an H100 at [170,
# 170, 32] f32 with Q and clusters of 4 CTAs, 1, 2, 4 and 8 groups took
# 0.878, 0.734, 0.638 and 0.720 ms
QR_CLUSTER_GROUPS = 4
# K2a's distributed form: threads a CTA, about (its columns times the groups)
QR_DISTRIBUTED_THREADS = 256
# K2a's panel form, its first phase: the most threads a CTA (its columns
# times the groups that share out a stage's rotations)
QR_PANEL_THREADS = 1024


def qr_wavefront_reference(A: torch.Tensor, compute_q: bool = False):
    """Plain twin of K2a: ``(R [m, n, B], Q [m, m, B] | None)``."""
    out = qr_parallel(A, compute_q=compute_q)
    return out.R, out.Q


def least_squares_wavefront_reference(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2b: ``x [n, B]`` minimizing ``||A x - y||`` per lane."""
    return least_squares_parallel(A, y)


def registers_fit(n: int, dtype: torch.dtype) -> bool:
    """Whether K2b's register form takes n in ``dtype``."""
    return 1 <= n <= REGISTER_MAX_N.get(dtype, 0)


def shared_bytes(n: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a block of K2b's shared-memory form: a ring
    of 2 n + 1 rows of n + 1 words for each of its lanes."""
    return (2 * n + 1) * (n + 1) * SHARED_LANES * torch.empty((), dtype=dtype).element_size()


def shared_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K2b's shared-memory form takes n in ``dtype``."""
    return dtype in _build.DTYPE_SUFFIX and n >= 1 and shared_bytes(n, dtype) <= MAX_DYNAMIC_SMEM


def warp_bytes(n: int, dtype: torch.dtype) -> int:
    """Shared memory of one warp (one lane) of K2b's warp form: a ring of
    2 n + 1 rows of n + 1 words, and (c, s) of a stage's n pivots."""
    return ((2 * n + 1) * (n + 1) + 2 * n) * torch.empty((), dtype=dtype).element_size()


def warp_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K2b's warp form takes n in ``dtype``: one warp's ring fits
    a block's shared memory, n <= 169 in float32 and 119 in float64."""
    return dtype in _build.DTYPE_SUFFIX and n >= 1 and warp_bytes(n, dtype) <= MAX_DYNAMIC_SMEM


def warp_lanes(n: int, dtype: torch.dtype, most: int = WARP_LANES) -> int:
    """Lanes (warps) a block of K2b's warp form: ``most`` (a power of
    two), halved until their rings fit a block's shared memory."""
    lanes = most
    while lanes > 1 and lanes * warp_bytes(n, dtype) > MAX_DYNAMIC_SMEM:
        lanes //= 2
    return lanes


def cluster_bytes(n: int, dtype: torch.dtype, size: int) -> int:
    """Shared memory of one CTA of K2b's cluster form with ``size`` CTAs a
    lane: its columns of the ring, 2 n + 1 rows of ceil((n + 1) / size)
    words (CTA 0 holds the most), and two rows of 2 n coefficients and two
    words (the back-substitution's two gathered rows and x take 3 n + 2)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return ((2 * n + 1) * -(-(n + 1) // size) + 4 * n + 2) * itemsize


def cluster_columns(n: int, size: int) -> int:
    """Column threads a CTA of K2b's cluster form: the least multiple of 32
    that covers CTA 0's ceil((n + 1) / size) columns."""
    return 32 * -(-(-(-(n + 1) // size)) // 32)


def cluster_lanes(n: int, dtype: torch.dtype, size: int, sms: int = SMS) -> int:
    """Lanes of K2b's cluster form with ``size`` CTAs a lane that a card of
    ``sms`` H100 SMs runs at once: the CTAs an SM holds by shared memory and
    by threads (``CLUSTER_GROUPS`` groups of column threads), over size."""
    return _build.lanes_at_once(size, cluster_bytes(n, dtype, size),
                                cluster_columns(n, size) * CLUSTER_GROUPS, sms)


def cluster_plan(n: int, dtype: torch.dtype, lanes: int | None = None,
                 sms: int = SMS) -> tuple[int, int]:
    """K2b's cluster form for n in ``dtype``: ``(C, T)``, C of
    ``CLUSTER_SIZES`` whose CTA's slice of the ring fits a block's shared
    memory and that runs the most of ``lanes`` lanes at once (``cluster_lanes``;
    the least such C), doubled (to at most 8) while ``lanes`` clusters of
    twice as many CTAs still find an SM each, and T = ``cluster_columns(n,
    C)`` column threads a CTA; ``(0, 0)`` where 8 CTAs do not hold the ring
    (n > 471 in float32, 329 in float64).  On an H100 at [248, 120, 256] f64
    clusters of 2, 4 and 8 took 3.34, 2.84 and 3.75 ms (66, 99 and 99 lanes
    at once); the least C that fits, 2, was the slowest."""
    if dtype not in _build.DTYPE_SUFFIX or n < 1:
        return 0, 0
    size = _build.cluster_size(CLUSTER_SIZES, lambda c: cluster_bytes(n, dtype, c),
                               lambda c: cluster_columns(n, c) * CLUSTER_GROUPS, lanes, sms)
    return (size, cluster_columns(n, size)) if size else (0, 0)


def cluster_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K2b's cluster form takes n in ``dtype``: n <= 471 in float32,
    329 in float64."""
    return cluster_plan(n, dtype)[0] > 0


def distributed_bytes(n: int, dtype: torch.dtype, size: int) -> int:
    """Shared memory of one CTA of K2b's distributed form with ``size`` CTAs
    a lane: its columns of the ring, 2 n + 1 rows of ceil((n + 1) / size)
    words (CTA 0 holds the most), and 3 n + 2 words, a stage's 2 n
    coefficients or the back-substitution's x and two rows."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return ((2 * n + 1) * -(-(n + 1) // size) + 3 * n + 2) * itemsize


def distributed_least(n: int, dtype: torch.dtype, sms: int = SMS) -> int:
    """The fewest CTAs, at most ``sms``, whose slices of K2b's distributed
    form hold the ring of n columns in ``dtype`` within a block's shared
    memory (``distributed_bytes``); 0 where ``sms`` CTAs do not hold it."""
    if dtype not in _build.DTYPE_SUFFIX or n < 1:
        return 0
    cap = MAX_DYNAMIC_SMEM // torch.empty((), dtype=dtype).element_size() - (3 * n + 2)
    if cap < 2 * n + 1:
        return 0
    # ceil((n + 1) / size) local columns of 2 n + 1 words must fit cap
    size = -(-(n + 1) // (cap // (2 * n + 1)))
    return size if size <= sms else 0


def distributed_fits(n: int, dtype: torch.dtype, sms: int = SMS) -> bool:
    """Whether K2b's distributed form takes n in ``dtype`` on a card of
    ``sms`` SMs: n <= 1847 in float32, 1262 in float64 on an H100's 132."""
    return distributed_least(n, dtype, sms) > 0


def distributed_plan(n: int, dtype: torch.dtype, lanes: int | None = None,
                     sms: int = SMS) -> int:
    """K2b's distributed form's CTAs a lane, P, for n in ``dtype`` and
    ``lanes`` lanes: the fewest whose slices hold the ring
    (``distributed_least``), spread to ``sms // lanes`` (at most n + 1, a
    column each) where few lanes leave SMs idle; 0 where ``sms`` CTAs do not
    hold the ring."""
    least = distributed_least(n, dtype, sms)
    if not least or not lanes:
        return least
    return max(least, min(n + 1, sms // lanes))


def distributed_groups(n: int, size: int) -> int:
    """Groups of threads a CTA of K2b's distributed form, G, that share out a
    stage's rotations, each of one thread a local column: about
    ``DISTRIBUTED_THREADS`` threads, at least two warps (the
    back-substitution takes two), at most 1024."""
    columns = -(-(n + 1) // size)
    return min(1024 // columns, max(-(-64 // columns), DISTRIBUTED_THREADS // columns))


def least_squares_form(m: int, n: int, dtype: torch.dtype) -> str:
    """The form of K2b that the dispatcher gives [m, n] in ``dtype``: the
    first of "registers", "shared", "warp", "cluster" and "distributed" that
    takes n, else "panel" where it takes [m, n] (``qr_panel_fits``: K2a-p's
    range, its back solve's two rows of n + 1 words then fit a CTA too),
    else "global"."""
    for form, fits in (("registers", registers_fit), ("shared", shared_fits), ("warp", warp_fits),
                       ("cluster", cluster_fits), ("distributed", distributed_fits)):
        if fits(n, dtype):
            return form
    return "panel" if qr_panel_fits(m, n, dtype, False) else "global"


def qr_warp_bytes(m: int, n: int, dtype: torch.dtype, compute_q: bool) -> int:
    """Shared memory of one warp (one lane) of K2a's warp form: its m x (n +
    m) array [R | Q^T] (m x n without Q) and (c, s) of a stage's n pivots,
    in an odd number of words."""
    cols = n + m if compute_q else n
    return ((m * cols + 2 * n) | 1) * torch.empty((), dtype=dtype).element_size()


def qr_warp_fits(m: int, n: int, dtype: torch.dtype, compute_q: bool) -> bool:
    """Whether K2a's warp form takes [m, n] in ``dtype``: one warp's array
    fits a block's shared memory."""
    return (dtype in _build.DTYPE_SUFFIX and 1 <= n <= m
            and qr_warp_bytes(m, n, dtype, compute_q) <= MAX_DYNAMIC_SMEM)


def qr_warp_lanes(m: int, n: int, dtype: torch.dtype, compute_q: bool) -> int:
    """Lanes (warps) a block of K2a's warp form: ``QR_WARP_LANES``, halved
    until their arrays fit a block's shared memory."""
    lanes = QR_WARP_LANES
    while lanes > 1 and lanes * qr_warp_bytes(m, n, dtype, compute_q) > MAX_DYNAMIC_SMEM:
        lanes //= 2
    return lanes


def qr_columns(m: int, n: int, compute_q: bool) -> int:
    """Columns of a lane's array in K2a: [R | Q^T], n + m, or R alone, n."""
    return n + m if compute_q else n


def qr_cluster_bytes(m: int, n: int, dtype: torch.dtype, compute_q: bool, size: int) -> int:
    """Shared memory of one CTA of K2a's cluster form with ``size`` CTAs a
    lane: its columns of the m x (n + m) array [R | Q^T] (m x n without Q),
    m rows of ceil(cols / size) words (CTA 0 holds the most), and two rows
    of 2 n coefficients."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (m * -(-qr_columns(m, n, compute_q) // size) + 4 * n) * itemsize


def qr_cluster_columns(m: int, n: int, compute_q: bool, size: int) -> int:
    """Column threads a CTA of K2a's cluster form: the least multiple of 32
    that covers CTA 0's ceil(cols / size) columns."""
    return 32 * -(-(-(-qr_columns(m, n, compute_q) // size)) // 32)


def qr_cluster_plan(m: int, n: int, dtype: torch.dtype, compute_q: bool,
                    lanes: int | None = None, sms: int = SMS) -> tuple[int, int]:
    """K2a's cluster form for [m, n] in ``dtype``: ``(C, T)``, C of
    ``CLUSTER_SIZES`` whose CTA's slice of the array fits a block's shared
    memory and that runs the most of ``lanes`` lanes at once on ``sms`` SMs
    (the least such C), doubled (to at most 8) while ``lanes`` clusters of
    twice as many CTAs still find an SM each, and T =
    ``qr_cluster_columns`` column threads a CTA; ``(0, 0)`` where 8 CTAs do
    not hold the array (m = n > 472 in float32, 332 in float64 with Q)."""
    if dtype not in _build.DTYPE_SUFFIX or not 1 <= n <= m:
        return 0, 0
    size = _build.cluster_size(
        CLUSTER_SIZES, lambda c: qr_cluster_bytes(m, n, dtype, compute_q, c),
        lambda c: qr_cluster_columns(m, n, compute_q, c) * QR_CLUSTER_GROUPS,
        lanes, sms)
    return (size, qr_cluster_columns(m, n, compute_q, size)) if size else (0, 0)


def qr_cluster_fits(m: int, n: int, dtype: torch.dtype, compute_q: bool) -> bool:
    """Whether K2a's cluster form takes [m, n] in ``dtype``: 8 CTAs hold
    the array, m = n <= 472 in float32 and 332 in float64 with Q, 664 and
    464 without."""
    return qr_cluster_plan(m, n, dtype, compute_q)[0] > 0


def qr_distributed_bytes(m: int, n: int, dtype: torch.dtype, compute_q: bool, size: int) -> int:
    """Shared memory of one CTA of K2a's distributed form with ``size`` CTAs
    a lane: its columns of the array, m rows of ceil(cols / size) words
    (CTA 0 holds the most), and a stage's 2 n coefficients."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (m * -(-qr_columns(m, n, compute_q) // size) + 2 * n) * itemsize


def qr_distributed_least(m: int, n: int, dtype: torch.dtype, compute_q: bool,
                         sms: int = SMS) -> int:
    """The fewest CTAs, at most ``sms``, whose slices of K2a's distributed
    form hold the array of [m, n] in ``dtype`` within a block's shared
    memory (``qr_distributed_bytes``); 0 where ``sms`` CTAs do not hold it."""
    if dtype not in _build.DTYPE_SUFFIX or not 1 <= n <= m:
        return 0
    cap = MAX_DYNAMIC_SMEM // torch.empty((), dtype=dtype).element_size() - 2 * n
    if cap < m:
        return 0
    # ceil(cols / size) local columns of m words must fit cap
    size = -(-qr_columns(m, n, compute_q) // (cap // m))
    return size if size <= sms else 0


def qr_distributed_fits(m: int, n: int, dtype: torch.dtype, compute_q: bool,
                        sms: int = SMS) -> bool:
    """Whether K2a's distributed form takes [m, n] in ``dtype`` on a card of
    ``sms`` SMs: m = n <= 1874 in float32 and 1320 in float64 with Q, 2640
    and 1816 without, on an H100's 132."""
    return qr_distributed_least(m, n, dtype, compute_q, sms) > 0


def qr_distributed_plan(m: int, n: int, dtype: torch.dtype, compute_q: bool,
                        lanes: int | None = None, sms: int = SMS) -> int:
    """K2a's distributed form's CTAs a lane, P, for [m, n] in ``dtype`` and
    ``lanes`` lanes: the fewest whose slices hold the array
    (``qr_distributed_least``), spread to ``sms // lanes`` (at most a column
    each) where few lanes leave SMs idle; 0 where ``sms`` CTAs do not hold
    it."""
    least = qr_distributed_least(m, n, dtype, compute_q, sms)
    if not least or not lanes:
        return least
    return max(least, min(qr_columns(m, n, compute_q), sms // lanes))


def qr_distributed_groups(m: int, n: int, compute_q: bool, size: int) -> int:
    """Groups of threads a CTA of K2a's distributed form, G, that share out
    a stage's rotations, each of one thread a local column: about
    ``QR_DISTRIBUTED_THREADS`` threads, one group where a CTA holds more
    columns (at most 341 wherever ``size`` CTAs hold the array)."""
    return max(1, QR_DISTRIBUTED_THREADS // -(-qr_columns(m, n, compute_q) // size))


def qr_log_offset(k: int, m: int, n: int) -> int:
    """The pairs of K2a-p's rotation log before stage k's (csrc's
    log_offset): stage k' turns pivots max(0, k' - m + 2) .. min(n - 1, k' /
    2); stage k's pivot j lies at pair ``qr_log_offset(k) + j - j_lo``."""
    a, r = divmod(min(k, 2 * n), 2)
    below = (a + 1) * (a + r) + max(0, k - 2 * n) * n
    t = k - (m - 2)
    return below - (t * (t - 1) // 2 if t > 0 else 0)


def qr_log_pairs(m: int, n: int) -> int:
    """Pairs (c, s) in a lane's rotation log of K2a-p: every rotation of the
    m + n - 2 stages, n (m - 1) - n (n - 1) / 2 for m >= n."""
    return qr_log_offset(m + n - 2, m, n)


def qr_stage_most(m: int, n: int) -> int:
    """A bound on the pivots of one stage of the wavefront on [m, n]:
    min(n, m / 2 + 1)."""
    return min(n, m // 2 + 1)


def qr_panel_columns(m: int, n: int, dtype: torch.dtype) -> int:
    """Columns of R that one CTA of K2a-p's first phase holds: m words each
    beside a stage's coefficients, 2 ``qr_stage_most`` words, in a block's
    shared memory; 0 where not one."""
    if dtype not in _build.DTYPE_SUFFIX or not 1 <= n <= m:
        return 0
    itemsize = torch.empty((), dtype=dtype).element_size()
    return max(0, (MAX_DYNAMIC_SMEM // itemsize - 2 * qr_stage_most(m, n)) // m)


def qr_panel_fits(m: int, n: int, dtype: torch.dtype, compute_q: bool) -> bool:
    """Whether K2a-p takes [m, n] in ``dtype``, with or without Q: a CTA
    holds a column of R beside a stage's coefficients (and the second phase
    a column of Q^T): m = n <= 29055 in float32, 14527 in float64."""
    return qr_panel_columns(m, n, dtype) > 0


def qr_panel_bounds(n: int, width: int) -> list[tuple[int, int]]:
    """R's n columns as K2a-p's panels ``(j0, j1)``, left to right: as few
    as hold at most ``width`` columns each, of widths that differ by one at
    most."""
    count = -(-n // width)
    base, extra = divmod(n, count)
    bounds, j0 = [], 0
    for p in range(count):
        j1 = j0 + base + (p < extra)
        bounds.append((j0, j1))
        j0 = j1
    return bounds


def qr_panel_plan(m: int, n: int, dtype: torch.dtype, lanes: int | None = None,
                  sms: int = SMS, width: int | None = None) -> list[tuple[int, int, int]]:
    """K2a-p's panels for [m, n] in ``dtype`` on a card of ``sms`` SMs:
    ``(j0, j1, P)`` each, the fewest panels whose columns ``sms`` CTAs hold
    (``qr_panel_columns`` a CTA; at most ``width`` columns a panel where
    given), and P CTAs a lane: the card's SMs shared out over the lanes that
    it holds at once, as many teams of the fewest CTAs that hold the panel
    (at most 1024 columns a CTA) as fit, at most ``lanes`` (at most a column
    a CTA).  On an H100 at [1321, 1321, 2] in float64, where two teams of 67
    do not fit, one lane after the other over 132 CTAs took 19.07 ms
    against 21.65 over 67; at [1875, 1875, 2] in float32 two lanes at once
    over 66 each 21.48 against 27.97 over 132 (PERF.md).  One panel up to m
    = n = 2641 in float32 and 1848 in float64 on 132 SMs, two from there.
    [] where K2a-p does not take [m, n]."""
    return _panel_plan(m, n, n, dtype, lanes, sms, width)


def _panel_plan(m: int, n: int, cols: int, dtype: torch.dtype, lanes: int | None, sms: int,
                width: int | None) -> list[tuple[int, int, int]]:
    """``qr_panel_plan`` over ``cols`` columns of a CTA's ``qr_panel_columns(m,
    n)``: R's n (K2a-p) or [A | y]'s n + 1 (K2b-p)."""
    per = min(qr_panel_columns(m, n, dtype), 1024)
    if not per:
        return []
    most = sms * per if width is None else min(sms * per, width)
    out = []
    for j0, j1 in qr_panel_bounds(cols, most):
        least = -(-(j1 - j0) // per)
        teams = max(1, min(lanes, sms // least)) if lanes else 1
        out.append((j0, j1, least if not lanes else max(least, min(j1 - j0, sms // teams))))
    return out


def qr_panel_launches(m: int, n: int, dtype: torch.dtype, compute_q: bool, sms: int = SMS,
                      width: int | None = None) -> int:
    """Kernels that one call of K2a-p launches on a lane or more, each
    counted in its ``launches``: one a panel of ``qr_panel_plan``, one
    replay of the log a panel but the last (its columns of R take the later
    pivots' rotations) and, where ``compute_q``, one that rebuilds Q^T.  On
    132 SMs with Q: 2 to m = n = 2641 in float32 and 1848 in float64, 4 from
    there."""
    panels = len(qr_panel_plan(m, n, dtype, None, sms, width))
    return 2 * panels - 1 + int(compute_q) if panels else 0


def lstsq_panel_plan(m: int, n: int, dtype: torch.dtype, lanes: int | None = None,
                     sms: int = SMS, width: int | None = None) -> list[tuple[int, int, int]]:
    """K2b-p's panels for [m, n] in ``dtype``: ``qr_panel_plan``'s over the n
    + 1 columns of [A | y], y the last column of the last panel; [] where
    K2b-p does not take [m, n].  One panel up to m = n = 2641 in float32 and
    1847 in float64 on 132 SMs, two from there."""
    return _panel_plan(m, n, n + 1, dtype, lanes, sms, width)


def lstsq_panel_launches(m: int, n: int, dtype: torch.dtype, sms: int = SMS,
                         width: int | None = None) -> int:
    """Kernels that one call of K2b-p launches on a lane or more, each
    counted in its ``launches``: one a panel of ``lstsq_panel_plan`` and the
    back solve; 2 on 132 SMs to m = n = 2641 in float32 and 1847 in float64,
    3 from there."""
    panels = len(lstsq_panel_plan(m, n, dtype, None, sms, width))
    return panels + 1 if panels else 0


def qr_panel_bytes(m: int, n: int, dtype: torch.dtype, width: int, size: int) -> int:
    """Shared memory of one CTA of K2a-p's first phase with ``size`` CTAs on
    a panel of ``width`` columns: m rows of ceil(width / size) words (CTA 0
    holds the most) and the (c, s) of a stage's pivots, 2
    ``qr_stage_most`` words."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (m * -(-width // size) + 2 * qr_stage_most(m, n)) * itemsize


def qr_panel_groups(width: int, size: int) -> int:
    """Groups of threads a CTA of K2a-p's first phase, each of one thread a
    local column, that share out a stage's rotations: as many as
    ``QR_PANEL_THREADS`` threads hold."""
    return max(1, QR_PANEL_THREADS // -(-width // size))


def qr_replay_width(m: int, cols: int, dtype: torch.dtype, lanes: int, sms: int = SMS) -> int:
    """Columns a CTA of K2a-p's second phase takes of the ``cols`` columns a
    lane that it rebuilds: enough that ``lanes`` lanes' tiles about fill
    ``sms`` SMs, at most what a block's shared memory holds (m + 1 words a
    column)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    most = MAX_DYNAMIC_SMEM // (2 * ((m + 1) // 2) * itemsize)
    return max(1, min(most, -(-lanes * cols // sms)))


def qr_form(m: int, n: int, dtype: torch.dtype, compute_q: bool) -> str:
    """The form of K2a that the dispatcher gives [m, n] in ``dtype``: the
    first of "warp", "cluster", "distributed" and "panel" that takes it,
    else "global" (m = n past 29055 in float32, 14527 in float64)."""
    for form, fits in (("warp", qr_warp_fits), ("cluster", qr_cluster_fits),
                       ("distributed", qr_distributed_fits), ("panel", qr_panel_fits)):
        if fits(m, n, dtype, compute_q):
            return form
    return "global"


@functools.lru_cache(maxsize=None)
def _launcher(entry: str, suffix: str):
    """The C entry point: ``qr_wavefront`` (K2a's and K2b's device-memory
    forms), ``qr_wavefront_warp``, ``qr_wavefront_cluster``,
    ``qr_wavefront_distributed`` (and its ``_occupancy``),
    ``qr_wavefront_panel`` (and its ``_occupancy``), ``qr_wavefront_replay``,
    ``least_squares_registers``,
    ``least_squares_shared``, ``least_squares_warp``,
    ``least_squares_cluster``, ``least_squares_distributed`` or
    ``least_squares_panel`` (each with its ``_occupancy``), or
    ``least_squares_backsolve``."""
    fn = getattr(_build.load_library(), f"{entry}_{suffix}")
    vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = {"qr_wavefront": [vp] * 6 + [ci, ci, i64, ci, ci, vp],
                   "qr_wavefront_panel": [vp] * 4 + [ci, ci, i64] + [ci] * 5 + [i64, vp],
                   "qr_wavefront_panel_occupancy": [ci] * 5 + [ctypes.POINTER(ci)],
                   "qr_wavefront_replay": [vp] * 2 + [ci] * 8 + [i64, i64, vp],
                   "qr_wavefront_warp": [vp] * 3 + [ci, ci, i64, ci, ci, vp],
                   "qr_wavefront_cluster": [vp] * 3 + [ci, ci, i64] + [ci] * 5 + [vp],
                   "qr_wavefront_distributed": [vp] * 5 + [ci, ci, i64] + [ci] * 5 + [vp],
                   "qr_wavefront_distributed_occupancy": [ci] * 5 + [ctypes.POINTER(ci)],
                   "least_squares_registers": [vp] * 3 + [ci, ci, i64, vp],
                   "least_squares_shared": [vp] * 3 + [ci, ci, i64, ci, ci, vp],
                   "least_squares_warp": [vp] * 3 + [ci, ci, i64, ci, vp],
                   "least_squares_cluster": [vp] * 3 + [ci, ci, i64, ci, ci, ci, vp],
                   "least_squares_distributed": [vp] * 6 + [ci, ci, i64, ci, ci, ci, ci, vp],
                   "least_squares_distributed_occupancy": [ci, ci, ci, ctypes.POINTER(ci)],
                   "least_squares_panel": [vp] * 5 + [ci, ci, i64] + [ci] * 5 + [i64, vp],
                   "least_squares_panel_occupancy": [ci] * 5 + [ctypes.POINTER(ci)],
                   "least_squares_backsolve": [vp, vp, ci, i64, vp],
                   }[entry]
    fn.restype = ci
    return fn


def _launch(A, y, R, Qt, qty, x, compute_q: bool, solve: bool) -> None:
    m, n, B = A.shape
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _launcher("qr_wavefront", _build.DTYPE_SUFFIX[A.dtype])(
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


def qr_wavefront_warp(A: torch.Tensor, compute_q: bool = False):
    """K2a's warp form: a warp a lane, thread t holding columns t, t + 32,
    .. of the lane's [R | Q^T] in shared memory, each stage's rotations
    formed at once; a block's warps (``qr_warp_lanes``) fetch A and store R
    and Q^T together.  Returns ``(R [m, n, B],
    Q [m, m, B] | None)``.  CPU tensors run the twin; on a card it raises
    where one warp's array does not fit a block (``qr_warp_fits``)."""
    name = "qr_wavefront_warp"
    _check_shape(A, name)
    if A.device.type == "cpu":
        return qr_wavefront_reference(A, compute_q)
    _build.check_cuda_inputs(name, {"A": A})
    m, n, B = A.shape
    if not qr_warp_fits(m, n, A.dtype, compute_q):
        raise ValueError(f"{name}: [{m}, {n}] in {A.dtype} does not fit a block's shared memory; "
                         "qr_wavefront_global takes it")
    R = torch.empty_like(A)
    Qt = A.new_empty((m, m, B)) if compute_q else None
    if B:
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = _launcher("qr_wavefront_warp", _build.DTYPE_SUFFIX[A.dtype])(
                A.data_ptr(), R.data_ptr(), None if Qt is None else Qt.data_ptr(), m, n, B,
                int(compute_q), qr_warp_lanes(m, n, A.dtype, compute_q), stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
        qr_wavefront_warp.launches += 1
    return R, (Qt.transpose(0, 1) if compute_q else None)


def qr_wavefront_cluster(A: torch.Tensor, compute_q: bool = False, size: int | None = None,
                         _groups: int | None = None, _mode: int = 0):
    """K2a's cluster form: a lane a thread-block cluster of ``size`` CTAs
    (``qr_cluster_plan`` for B lanes and the card's SMs by default), column c
    of the lane's [R | Q^T] in CTA c % size's shared memory; each stage's
    rotations formed at once by the pivot columns' owners and stored into
    every CTA, one cluster barrier a stage, each CTA's groups of threads
    (``QR_CLUSTER_GROUPS``) sharing out the rotations over its columns.
    Returns ``(R [m, n, B], Q [m, m, B] | None)``.  CPU tensors run the
    twin; on a card it raises where ``size`` CTAs do not hold the array
    (``qr_cluster_fits``).  ``_groups`` and ``_mode`` (1: no rotations, 2: the
    cluster barriers alone; R and Q then hold no factorization) are for the
    tests and probes only."""
    name = "qr_wavefront_cluster"
    _check_shape(A, name)
    if A.device.type == "cpu":
        return qr_wavefront_reference(A, compute_q)
    _build.check_cuda_inputs(name, {"A": A})
    m, n, B = A.shape
    if size is None:
        sms = torch.cuda.get_device_properties(A.device).multi_processor_count
        size = qr_cluster_plan(m, n, A.dtype, compute_q, B, sms)[0]
    if size not in CLUSTER_SIZES or qr_cluster_bytes(m, n, A.dtype, compute_q,
                                                     size) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: [{m}, {n}] in {A.dtype} does not fit a cluster of {size or 8} "
                         "CTAs' shared memory; qr_wavefront_distributed takes it")
    R = torch.empty_like(A)
    Qt = A.new_empty((m, m, B)) if compute_q else None
    if B:
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = _launcher("qr_wavefront_cluster", _build.DTYPE_SUFFIX[A.dtype])(
                A.data_ptr(), R.data_ptr(), None if Qt is None else Qt.data_ptr(), m, n, B,
                int(compute_q), size, qr_cluster_columns(m, n, compute_q, size),
                _groups or QR_CLUSTER_GROUPS, _mode, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
        qr_wavefront_cluster.launches += 1
    return R, (Qt.transpose(0, 1) if compute_q else None)


def qr_distributed_occupancy(dtype: torch.dtype, m: int, n: int, compute_q: bool, size: int,
                             groups: int) -> int:
    """CTAs of K2a's distributed form (``size`` CTAs a lane, ``groups``
    groups of threads) that an SM of the current card holds at once, from
    the CUDA occupancy query."""
    found = ctypes.c_int(0)
    err = _launcher("qr_wavefront_distributed_occupancy", _build.DTYPE_SUFFIX[dtype])(
        m, n, int(compute_q), size, groups, ctypes.byref(found))
    if err != 0:
        raise RuntimeError(f"qr_wavefront_distributed: occupancy query failed (cudaError {err})")
    return found.value


def qr_wavefront_distributed(A: torch.Tensor, compute_q: bool = False, size: int | None = None,
                             _groups: int | None = None, _mode: int = 0):
    """K2a's distributed form: a lane over ``size`` CTAs
    (``qr_distributed_plan`` for B lanes and the card's SMs by default),
    column c of the lane's [R | Q^T] in CTA c % size's shared memory; each
    stage's rotations formed by the pivot columns' owners into device
    memory, one barrier in device memory a stage, each CTA's
    ``qr_distributed_groups`` groups of threads sharing out the rotations;
    one cooperative launch of as many teams of ``size`` CTAs as the card
    holds at once (at most B), each team walking its share of the lanes.
    Returns ``(R [m, n, B], Q [m, m, B] | None)``.  CPU tensors run the
    twin; on a card it raises where ``size`` CTAs do not hold the array
    (``qr_distributed_fits``) or the card cannot hold them at once.
    ``_groups`` and ``_mode`` (1: no rotations, 2: the barriers alone; R and
    Q then hold no factorization) are for the tests and probes only."""
    name = "qr_wavefront_distributed"
    _check_shape(A, name)
    if A.device.type == "cpu":
        return qr_wavefront_reference(A, compute_q)
    _build.check_cuda_inputs(name, {"A": A})
    m, n, B = A.shape
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    if size is None:
        size = qr_distributed_plan(m, n, A.dtype, compute_q, B, sms)
    if size < 1 or qr_distributed_bytes(m, n, A.dtype, compute_q, size) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: [{m}, {n}] in {A.dtype} does not fit {size or sms} CTAs' "
                         "shared memory; qr_wavefront_panel takes it")
    R = torch.empty_like(A)
    Qt = A.new_empty((m, m, B)) if compute_q else None
    if B:
        groups = _groups or qr_distributed_groups(m, n, compute_q, size)
        with torch.cuda.device(A.device):
            teams = min(B, qr_distributed_occupancy(A.dtype, m, n, compute_q, size, groups)
                        * sms // size)
            if teams < 1:
                raise ValueError(f"{name}: the card does not hold {size} CTAs of {groups} groups "
                                 f"at once for [{m}, {n}] in {A.dtype}")
            coef = A.new_empty((teams, 4 * n))
            counts = torch.zeros(teams, dtype=torch.int32, device=A.device)
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = _launcher("qr_wavefront_distributed", _build.DTYPE_SUFFIX[A.dtype])(
                A.data_ptr(), R.data_ptr(), None if Qt is None else Qt.data_ptr(),
                coef.data_ptr(), counts.data_ptr(), m, n, B, int(compute_q), size, teams, groups,
                _mode, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
        qr_wavefront_distributed.launches += 1
    return R, (Qt.transpose(0, 1) if compute_q else None)


def _launch_panel(name: str, entry: str, ptrs: tuple, A: torch.Tensor, j0: int, j1: int,
                  size: int, groups: int | None, pairs: int, stream: int) -> None:
    """One cooperative launch of the first phase of K2a-p (``entry``
    "qr_wavefront_panel") or K2b-p ("least_squares_panel") on the panel of
    columns j0 .. j1 - 1, over ``size`` CTAs a lane of ``groups`` groups of
    threads (``qr_panel_groups`` by default), as many teams as the card
    holds at once (at most B); ``ptrs`` are the kernel's pointers ahead of
    its counters.  Raises where the panel does not fit ``size`` CTAs'
    shared memory or the card cannot hold them at once."""
    m, n, B = A.shape
    width = j1 - j0
    if size < 1 or qr_panel_bytes(m, n, A.dtype, width, size) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: a panel of {width} columns of [{m}, {n}] in {A.dtype} does "
                         f"not fit {size} CTAs' shared memory")
    groups = groups or qr_panel_groups(width, size)
    suffix = _build.DTYPE_SUFFIX[A.dtype]
    found = ctypes.c_int(0)
    err = _launcher(f"{entry}_occupancy", suffix)(m, n, width, size, groups, ctypes.byref(found))
    if err != 0:
        raise RuntimeError(f"{name}: occupancy query failed (cudaError {err})")
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    teams = min(B, found.value * sms // size)
    if teams < 1:
        raise ValueError(f"{name}: the card does not hold {size} CTAs of {groups} groups at once "
                         f"for [{m}, {n}] in {A.dtype}")
    counts = torch.zeros(teams, dtype=torch.int32, device=A.device)
    err = _launcher(entry, suffix)(*ptrs, counts.data_ptr(), m, n, B, j0, j1, size, teams, groups,
                                   pairs, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def qr_wavefront_panel(A: torch.Tensor, compute_q: bool = False, size: int | None = None,
                       _width: int | None = None, _groups: int | None = None):
    """K2a's panel form (K2a-p), the dispatcher's past the distributed
    form's range.  First R, panel by panel (``qr_panel_plan``): a panel's
    columns over ``size`` CTAs' shared memory (the plan's P by default), each
    stage's rotations formed by the pivots' owners and appended to the
    lane's rotation log in device memory, one barrier in device memory a
    stage with a pivot in the panel, the stages before the panel's first
    pivot replayed from the log; one cooperative launch a panel.  Then one
    launch rebuilds Q^T from the identity and gives the earlier panels'
    columns of R the later pivots' rotations, tiles of columns in shared
    memory (``qr_replay_width``), the log streamed in stage order.  Returns
    ``(R [m, n, B], Q [m, m, B] | None)``, bit-equal to the twin; its
    ``launches`` count grows by one a kernel launched (``qr_panel_launches``
    a call).  CPU tensors run the twin; on a
    card it raises where a CTA does not hold one column (``qr_panel_fits``)
    or the card cannot hold a panel's CTAs at once.  ``_width`` (the most
    columns a panel) and ``_groups`` are for the tests and probes only."""
    name = "qr_wavefront_panel"
    _check_shape(A, name)
    if A.device.type == "cpu":
        return qr_wavefront_reference(A, compute_q)
    _build.check_cuda_inputs(name, {"A": A})
    m, n, B = A.shape
    if not qr_panel_fits(m, n, A.dtype, compute_q):
        raise ValueError(f"{name}: a column of [{m}, {n}] in {A.dtype} does not fit a block's "
                         "shared memory; qr_wavefront_global takes it")
    R = torch.empty_like(A)
    Qt = A.new_empty((m, m, B)) if compute_q else None
    if B:
        sms = torch.cuda.get_device_properties(A.device).multi_processor_count
        panels = qr_panel_plan(m, n, A.dtype, B, sms, _width)
        pairs = qr_log_pairs(m, n)
        suffix = _build.DTYPE_SUFFIX[A.dtype]
        with torch.cuda.device(A.device):
            rlog = A.new_empty((B, 2 * pairs))
            stream = torch.cuda.current_stream(A.device).cuda_stream
            for j0, j1, P in panels:
                _launch_panel(name, "qr_wavefront_panel",
                              (A.data_ptr(), R.data_ptr(), rlog.data_ptr()), A, j0, j1, size or P,
                              _groups, pairs, stream)
                qr_wavefront_panel.launches += 1
            # the earlier panels' columns of R take the later pivots' rotations;
            # Q^T takes every rotation
            replays = [(R, n, j0, j1 - j0, j1, 0) for j0, j1, _ in panels[:-1]]
            if compute_q:
                replays.append((Qt, m, 0, m, 0, 1))
            for X, ld, c0, cols, jfrom, identity in replays:
                err = _launcher("qr_wavefront_replay", suffix)(
                    X.data_ptr(), rlog.data_ptr(), m, n, ld, c0, cols,
                    qr_replay_width(m, cols, A.dtype, B, sms), jfrom, identity, B, pairs, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
                qr_wavefront_panel.launches += 1
    return R, (Qt.transpose(0, 1) if compute_q else None)


def qr_wavefront_global(A: torch.Tensor, compute_q: bool = False):
    """K2a's device-memory form (K2a-g), any shape: a thread a lane works on
    R and Q^T in device memory.  The dispatcher's only past K2a-p's range;
    elsewhere a direct call.  Returns ``(R [m, n, B], Q [m, m, B] |
    None)``.  CPU tensors run the twin."""
    _check_shape(A, "qr_wavefront_global")
    if A.device.type == "cpu":
        return qr_wavefront_reference(A, compute_q)
    _build.check_cuda_inputs("qr_wavefront_global", {"A": A})
    m, n, B = A.shape
    R = torch.empty_like(A)
    Qt = A.new_empty((m, m, B)) if compute_q else None
    _launch(A, None, R, Qt, None, None, compute_q, False)
    qr_wavefront_global.launches += 1
    return R, (Qt.transpose(0, 1) if compute_q else None)


def qr_wavefront_kernel(A: torch.Tensor, compute_q: bool = False):
    """Batched QR of ``A [m, n, B]``: ``(R [m, n, B], Q [m, m, B] | None)``,
    the schedule and rotations of ``linalg.qr_parallel``.  CUDA tensors run
    K2a in its warp form where [m, n] fits it, else its cluster form, else
    its distributed form, else its panel form, else in device memory
    (``qr_form``); CPU tensors its twin."""
    _check_shape(A, "qr_wavefront_kernel")
    if A.device.type == "cpu":
        return qr_wavefront_reference(A, compute_q)
    m, n, _ = A.shape
    form = {"warp": qr_wavefront_warp, "cluster": qr_wavefront_cluster,
            "distributed": qr_wavefront_distributed, "panel": qr_wavefront_panel,
            "global": qr_wavefront_global}
    return form[qr_form(m, n, A.dtype, compute_q)](A, compute_q)


def _check_lstsq(name: str, A: torch.Tensor, y: torch.Tensor) -> tuple[int, int, int]:
    _check_shape(A, name)
    m, n, B = A.shape
    if tuple(y.shape) != (m, B):
        raise ValueError(f"rhs must be [m, B]={m, B}, got {tuple(y.shape)}")
    return m, n, B


def _launch_window(name: str, entry: str, A, y, *extra) -> torch.Tensor:
    """K2b's register, shared-memory or warp form on ``A``, ``y``: ``x
    [n, B]``."""
    m, n, B = A.shape
    x = A.new_empty((n, B))
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _launcher(entry, _build.DTYPE_SUFFIX[A.dtype])(
            A.data_ptr(), y.data_ptr(), x.data_ptr(), m, n, B, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    return x


def least_squares_wavefront_registers(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K2b's register form: ``min_x ||A x - y||`` per lane for ``A [m, n,
    B]``, ``y [m, B]``, one thread a lane holding the wavefront's window of
    2 n rows in its registers; only ``x [n, B]`` is written.  CPU tensors run
    the twin; on a card it raises where n does not fit (``registers_fit``)."""
    name = "least_squares_wavefront_registers"
    m, n, B = _check_lstsq(name, A, y)
    if A.device.type == "cpu" and y.device.type == "cpu":
        return least_squares_wavefront_reference(A, y)
    _build.check_cuda_inputs(name, {"A": A, "y": y})
    if not registers_fit(n, A.dtype):
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit a thread's registers; "
                         "least_squares_wavefront_shared takes it")
    if B == 0:
        return A.new_empty((n, 0))
    x = _launch_window(name, "least_squares_registers", A, y)
    least_squares_wavefront_registers.launches += 1
    return x


def least_squares_wavefront_shared(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K2b's shared-memory form: the window of the register form as a ring
    of 2 n + 1 rows in shared memory, ``SHARED_LANES`` lanes a block; only
    ``x [n, B]`` is written.  CPU tensors run the twin; on a card it raises
    where a block's ring does not fit (``shared_fits``)."""
    name = "least_squares_wavefront_shared"
    m, n, B = _check_lstsq(name, A, y)
    if A.device.type == "cpu" and y.device.type == "cpu":
        return least_squares_wavefront_reference(A, y)
    _build.check_cuda_inputs(name, {"A": A, "y": y})
    if not shared_fits(n, A.dtype):
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit a block's shared memory; "
                         "least_squares_wavefront_warp takes it")
    if B == 0:
        return A.new_empty((n, 0))
    x = _launch_window(name, "least_squares_shared", A, y, SHARED_LANES, shared_bytes(n, A.dtype))
    least_squares_wavefront_shared.launches += 1
    return x


def least_squares_wavefront_warp(A: torch.Tensor, y: torch.Tensor, lanes: int | None = None
                                 ) -> torch.Tensor:
    """K2b's warp form: a warp a lane, thread t holding columns t, t + 32,
    .. of the window's ring of 2 n + 1 rows in shared memory, each stage's
    rotations formed at once and read from shared memory; a block's ``lanes``
    warps (``warp_lanes`` by default) fetch their lanes' rows together; only
    ``x [n, B]`` is written.  CPU tensors run the twin; on a card it raises
    where one warp's ring does not fit a block (``warp_fits``)."""
    name = "least_squares_wavefront_warp"
    m, n, B = _check_lstsq(name, A, y)
    if A.device.type == "cpu" and y.device.type == "cpu":
        return least_squares_wavefront_reference(A, y)
    _build.check_cuda_inputs(name, {"A": A, "y": y})
    if not warp_fits(n, A.dtype):
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit a block's shared memory; "
                         "least_squares_wavefront_global takes it")
    if B == 0:
        return A.new_empty((n, 0))
    x = _launch_window(name, "least_squares_warp", A, y, lanes or warp_lanes(n, A.dtype))
    least_squares_wavefront_warp.launches += 1
    return x


def least_squares_wavefront_cluster(A: torch.Tensor, y: torch.Tensor, size: int | None = None,
                                    _groups: int | None = None) -> torch.Tensor:
    """K2b's cluster form: a lane a thread-block cluster of ``size`` CTAs
    (``cluster_plan`` for B lanes and the card's SMs by default), column c
    of the window's ring of 2 n + 1 rows in CTA c % size's shared memory;
    each stage's rotations formed at once by the pivot columns' owners and
    stored into every CTA, one cluster barrier a stage, each CTA's
    ``CLUSTER_GROUPS`` groups of threads sharing out the rotations; only
    ``x [n, B]`` is written.  ``_groups`` sets another count of groups (a
    CTA needs two warps or more) for the tests and probes only.  CPU tensors run the twin; on a card it raises
    where ``size`` CTAs do not hold the ring (``cluster_fits``)."""
    name = "least_squares_wavefront_cluster"
    m, n, B = _check_lstsq(name, A, y)
    if A.device.type == "cpu" and y.device.type == "cpu":
        return least_squares_wavefront_reference(A, y)
    _build.check_cuda_inputs(name, {"A": A, "y": y})
    if size is None:
        sms = torch.cuda.get_device_properties(A.device).multi_processor_count
        size = cluster_plan(n, A.dtype, B, sms)[0]
    if size not in CLUSTER_SIZES or cluster_bytes(n, A.dtype, size) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit a cluster of {size or 8} "
                         "CTAs' shared memory; least_squares_wavefront_global takes it")
    if B == 0:
        return A.new_empty((n, 0))
    x = _launch_window(name, "least_squares_cluster", A, y, size, cluster_columns(n, size),
                       _groups or CLUSTER_GROUPS)
    least_squares_wavefront_cluster.launches += 1
    return x


def distributed_occupancy(dtype: torch.dtype, n: int, size: int, groups: int) -> int:
    """CTAs of K2b's distributed form (``size`` CTAs a lane, ``groups``
    groups of threads) that an SM of the current card holds at once, from
    the CUDA occupancy query."""
    found = ctypes.c_int(0)
    err = _launcher("least_squares_distributed_occupancy", _build.DTYPE_SUFFIX[dtype])(
        n, size, groups, ctypes.byref(found))
    if err != 0:
        raise RuntimeError("least_squares_wavefront_distributed: occupancy query failed "
                           f"(cudaError {err})")
    return found.value


def least_squares_wavefront_distributed(A: torch.Tensor, y: torch.Tensor,
                                        size: int | None = None, _groups: int | None = None,
                                        _mode: int = 0) -> torch.Tensor:
    """K2b's distributed form: a lane over ``size`` CTAs (``distributed_plan``
    for B lanes and the card's SMs by default), column c of the window's
    ring of 2 n + 1 rows in CTA c % size's shared memory; each stage's
    rotations formed by the pivot columns' owners into device memory, one
    barrier in device memory a stage, each CTA's ``distributed_groups``
    groups of threads sharing out the rotations; the back-substitution in
    the lane's first CTA; one cooperative launch of as many teams of
    ``size`` CTAs as the card holds at once (at most B), each team walking
    its share of the lanes; only ``x [n, B]`` is written.  CPU tensors run
    the twin; on a card it raises where ``size`` CTAs do not hold the ring
    (``distributed_fits``) or the card cannot hold them at once.
    ``_groups`` (a CTA needs two warps or more) and ``_mode`` (1: no
    back-substitution, x left unwritten; 2: the barriers alone) are for the
    tests and probes only."""
    name = "least_squares_wavefront_distributed"
    m, n, B = _check_lstsq(name, A, y)
    if A.device.type == "cpu" and y.device.type == "cpu":
        return least_squares_wavefront_reference(A, y)
    _build.check_cuda_inputs(name, {"A": A, "y": y})
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    if size is None:
        size = distributed_plan(n, A.dtype, B, sms)
    if size < 1 or distributed_bytes(n, A.dtype, size) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit {size or sms} CTAs' shared "
                         "memory; least_squares_wavefront_global takes it")
    if B == 0:
        return A.new_empty((n, 0))
    groups = _groups or distributed_groups(n, size)
    x = A.new_empty((n, B))
    with torch.cuda.device(A.device):
        teams = min(B, distributed_occupancy(A.dtype, n, size, groups) * sms // size)
        if teams < 1:
            raise ValueError(f"{name}: the card does not hold {size} CTAs of {groups} groups at "
                             f"once for n={n} in {A.dtype}")
        coef = A.new_empty((teams, 4 * n))
        store = A.new_empty((teams, n * (n + 3) // 2))
        counts = torch.zeros(teams, dtype=torch.int32, device=A.device)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _launcher("least_squares_distributed", _build.DTYPE_SUFFIX[A.dtype])(
            A.data_ptr(), y.data_ptr(), x.data_ptr(), coef.data_ptr(), store.data_ptr(),
            counts.data_ptr(), m, n, B, size, teams, groups, _mode, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    least_squares_wavefront_distributed.launches += 1
    return x


def least_squares_wavefront_panel(A: torch.Tensor, y: torch.Tensor, size: int | None = None,
                                  _width: int | None = None) -> torch.Tensor:
    """K2b's panel form (K2b-p), the dispatcher's past the distributed
    form's range.  R forms as K2a-p's first phase forms it, on the columns
    of [A | y], panel by panel (``lstsq_panel_plan``): a panel's columns
    over ``size`` CTAs' shared memory (the plan's P by default), each
    stage's rotations formed by the pivots' owners and appended to the
    lane's rotation log in device memory, one barrier in device memory a
    stage, one cooperative launch a panel; y, the last panel's last column,
    takes every rotation and forms none.  Each panel stores its columns'
    entries on and above R's diagonal; then one launch back-substitutes, a
    CTA a lane, in the twin's order.  Returns ``x [n, B]``, bit-equal to
    the twin; its ``launches`` count grows by one a kernel launched
    (``lstsq_panel_launches`` a call).  CPU tensors run the twin; on a card
    it raises where [m, n] is past its range (``qr_panel_fits``) or the
    card cannot hold a panel's CTAs at once.  ``_width`` (the most columns a
    panel) is for the tests only."""
    name = "least_squares_wavefront_panel"
    m, n, B = _check_lstsq(name, A, y)
    if A.device.type == "cpu" and y.device.type == "cpu":
        return least_squares_wavefront_reference(A, y)
    _build.check_cuda_inputs(name, {"A": A, "y": y})
    if not qr_panel_fits(m, n, A.dtype, False):
        raise ValueError(f"{name}: a column of [{m}, {n}] in {A.dtype} does not fit a block's "
                         "shared memory; least_squares_wavefront_global takes it")
    if B == 0:
        return A.new_empty((n, 0))
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    panels = lstsq_panel_plan(m, n, A.dtype, B, sms, _width)
    pairs = qr_log_pairs(m, n)
    suffix = _build.DTYPE_SUFFIX[A.dtype]
    x = A.new_empty((n, B))
    with torch.cuda.device(A.device):
        rlog = A.new_empty((B, 2 * pairs))
        store = A.new_empty((B, n * (n + 3) // 2))
        stream = torch.cuda.current_stream(A.device).cuda_stream
        for j0, j1, P in panels:
            _launch_panel(name, "least_squares_panel",
                          (A.data_ptr(), y.data_ptr(), store.data_ptr(), rlog.data_ptr()), A, j0,
                          j1, size or P, None, pairs, stream)
            least_squares_wavefront_panel.launches += 1
        err = _launcher("least_squares_backsolve", suffix)(
            store.data_ptr(), x.data_ptr(), n, B, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
        least_squares_wavefront_panel.launches += 1
    return x


def least_squares_wavefront_global(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K2b's device-memory form, any shape (the dispatcher's past K2b-p's
    range, elsewhere a direct call): the rotations run on a working copy of
    A and y (scratch ``R``, ``qty``) in device memory.  CPU tensors run the
    twin."""
    name = "least_squares_wavefront_global"
    m, n, B = _check_lstsq(name, A, y)
    if A.device.type == "cpu" and y.device.type == "cpu":
        return least_squares_wavefront_reference(A, y)
    _build.check_cuda_inputs(name, {"A": A, "y": y})
    if B == 0:
        return A.new_empty((n, 0))
    R, qty, x = torch.empty_like(A), torch.empty_like(y), A.new_empty((n, B))
    _launch(A, y, R, None, qty, x, False, True)
    least_squares_wavefront_global.launches += 1
    return x


def least_squares_wavefront_kernel(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``min_x ||A x - y||`` per lane for ``A [m, n, B]``, ``y [m, B]``: the
    rotations thread y (implicit Q^T y) and the back-substitution runs in
    the kernel; only ``x [n, B]`` is written.  CUDA tensors run K2b in the
    register form where n fits it, else the shared-memory form, else the
    warp form, else the cluster form, else the distributed form, else the
    panel form where [m, n] fits it, else the device-memory form
    (``least_squares_form``); CPU tensors its twin."""
    m, n, B = _check_lstsq("least_squares_wavefront_kernel", A, y)
    if A.device.type == "cpu" and y.device.type == "cpu":
        return least_squares_wavefront_reference(A, y)
    forms = {"registers": least_squares_wavefront_registers,
             "shared": least_squares_wavefront_shared,
             "warp": least_squares_wavefront_warp, "cluster": least_squares_wavefront_cluster,
             "distributed": least_squares_wavefront_distributed,
             "panel": least_squares_wavefront_panel,
             "global": least_squares_wavefront_global}
    return forms[least_squares_form(m, n, A.dtype)](A, y)


qr_wavefront_warp.launches = 0
qr_wavefront_cluster.launches = 0
qr_wavefront_distributed.launches = 0
qr_wavefront_panel.launches = 0
qr_wavefront_global.launches = 0
least_squares_wavefront_registers.launches = 0
least_squares_wavefront_shared.launches = 0
least_squares_wavefront_warp.launches = 0
least_squares_wavefront_cluster.launches = 0
least_squares_wavefront_distributed.launches = 0
least_squares_wavefront_panel.launches = 0
least_squares_wavefront_global.launches = 0
