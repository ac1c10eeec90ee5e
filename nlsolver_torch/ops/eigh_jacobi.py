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
  float64, contiguous), in four forms, chosen by n and dtype alone.
  ``eigh_jacobi_registers``: a lane's A and V stay in the registers of a
  few threads of one warp, the players of the tournament move between them
  by warp shuffles, no barrier and no shared memory; n <= 32 in float32,
  n <= 16 in float64 (``registers_fit``).  K5a, ``eigh_jacobi_resident``:
  A and V of a tile of lanes stay in shared memory for all sweeps, one
  read of A and one write of w and V; n <= 169 in float32, n <= 119 in
  float64 (``resident_fits``).  K5c, ``eigh_jacobi_cluster``: one lane's
  A and V split by rows over the shared memory of a thread-block cluster
  of 2, 4 or 8 CTAs; n <= 472 in float32, n <= 329 in float64
  (``cluster_fits``), taken where K5a refuses n.  K5b,
  ``eigh_jacobi_global``: a working copy of A in device memory, any n, each
  round's three phases spread over every SM of the card with a grid-wide
  barrier between them (``global_plan``).  No form has pad lanes, a rule
  on B or a fallback to the twin or to another form: a shape that none
  takes raises, and so does a failed build or launch.

All forms compute through round-to-nearest intrinsics in the twin's order
of operations, and a Jacobi round has no sum longer than two terms, so on
a card they equal the twin, and each other, bit for bit.  The ascending
sort, where asked for, is ``torch.argsort`` outside the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..linalg.eigh_qr import Eigh
from ..linalg.jacobi import eigh_jacobi, schedule_tables, sort_spectrum
from . import _build
from ._build import MAX_DYNAMIC_SMEM

# a block's thread limit and a warp's threads (and shared-memory banks)
MAX_THREADS = 1024
WARP = 32
# K5b: threads a block, and its barriers: one cooperative launch with a
# grid-wide barrier between phases (True), or one launch a phase.  On an
# H100 at [473, 473, 16] with 2 sweeps the cooperative launch was the
# faster at 256, 512 and 1024 threads a block, and 512 the fastest of them
GLOBAL_THREADS = 512
GLOBAL_COOPERATIVE = True
# the register form: the most players (n, or n + 1 for odd n) it is built for
REGISTER_MAX_PLAYERS = {torch.float32: 32, torch.float64: 16}
# K5c: the CTAs a cluster may have (8 is the portable most).  The dispatcher
# gives K5c only the n that K5a refuses: K5a was faster wherever both take n
# (on an H100 at B = 4096, 8 sweeps, ms, K5a / K5c: float32 n = 120 97.9 /
# 273.8, 150 184.6 / 479.6, 169 261.1 / 583.6; float64 n = 100 92.8 /
# 246.8, 119 135.1 / 324.2)
CLUSTER_SIZES = (2, 4, 8)
# K5c's block (1, 32, 32): a warp turns 32 columns of a unit's two rows, or
# 32 rows of a unit's two columns; on an H100 8 or 16 warps a CTA, with more
# CTAs an SM, were slower at every n and C measured (PERF.md)
CLUSTER_BLOCK = (1, 32, 32)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def leading_dim(n: int, lanes: int) -> int:
    """Leading dimension of K5a's [n, n] slabs: n while a warp is 32 lanes
    of one row; odd (``n | 1``) where a block has fewer lanes and a warp
    spans several rows of the column pass, ``ld * lanes`` words apart,
    which an odd ld puts on different banks."""
    return n if lanes >= WARP else n | 1


def _slab_bytes(n: int, lanes: int, itemsize: int) -> int:
    """K5a's shared memory: A and V [n, ld] and the coefficients c, s [n]."""
    return (2 * n * leading_dim(n, lanes) + 2 * n) * lanes * itemsize


def block_shape(n: int, lanes: int) -> tuple[int, int, int]:
    """The block (lanes, RJ, RU): RU threads over a round's pairs first (on
    an H100 a thread that walks more columns of its pair ran [16, 16, 65536]
    in 3.4 ms where the opposite split took 5.2), then RJ over the columns
    (or rows) of a lane's matrix, at most ``MAX_THREADS``.  With fewer than
    32 lanes RJ is a multiple of ``32 / lanes``, so that a warp is whole
    rows of one pair."""
    span = max(1, WARP // lanes)
    ru = max(1, min((n + 1) // 2, MAX_THREADS // (lanes * span), 64))
    rj = max(1, min(n, MAX_THREADS // (lanes * ru)))
    if rj > span:
        rj -= rj % span
    return lanes, rj, ru


def resident_tile(n: int, dtype: torch.dtype) -> int:
    """Lanes of one block of K5a: 32, halved down to one lane until A, V,
    c and s fit a block's shared memory (0: they never do), and doubled
    for a small n until a block has 256 threads."""
    itemsize = _itemsize(dtype)
    lanes = WARP
    while lanes > 1 and _slab_bytes(n, lanes, itemsize) > MAX_DYNAMIC_SMEM:
        lanes //= 2
    if _slab_bytes(n, lanes, itemsize) > MAX_DYNAMIC_SMEM:
        return 0
    while (lanes < 256 and lanes * block_shape(n, lanes)[1] * block_shape(n, lanes)[2] < 256
           and _slab_bytes(n, 2 * lanes, itemsize) <= MAX_DYNAMIC_SMEM):
        lanes *= 2
    return lanes


def resident_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K5a takes n: n <= 169 in float32 (32 lanes a block up to
    n = 29, 16 to 41, 8 to 59, 4 to 84, 2 to 119, 1 beyond) and n <= 119
    in float64 (32 lanes up to n = 20, 16 to 29, 8 to 41, 4 to 59, 2 to
    84, 1 beyond)."""
    return resident_tile(n, dtype) > 0


def _cluster_bytes(n: int, rows: int, itemsize: int) -> int:
    """K5c's shared memory a CTA: its ``rows`` of A and V [rows, n | 1],
    and 4 n words beside them (c and s of every player take 2 n)."""
    return (2 * rows * (n | 1) + 4 * n) * itemsize


def cluster_plan(n: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """K5c's cluster for n: ``(C, R, ld)``, the least C of ``CLUSTER_SIZES``
    whose CTAs hold R = ceil(n / C) rows each of A and V, leading dimension
    ld = n | 1 (odd, so that the column pass's threads fall on different
    banks), in a block's shared memory; ``(0, 0, 0)`` where 8 do not.  C = 2
    up to n = 238 in float32, 4 to 336, 8 to 472; in float64 2 to 167, 4 to
    236, 8 to 329."""
    itemsize = _itemsize(dtype)
    for C in CLUSTER_SIZES:
        rows = -(-n // C)
        if _cluster_bytes(n, rows, itemsize) <= MAX_DYNAMIC_SMEM:
            return C, rows, n | 1
    return 0, 0, 0


def cluster_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether K5c takes n: n <= 472 in float32, n <= 329 in float64."""
    return cluster_plan(n, dtype)[0] > 0


@functools.lru_cache(maxsize=None)
def cluster_schedule(n: int, C: int) -> tuple[np.ndarray, np.ndarray]:
    """Who rotates what in K5c, a cluster of C CTAs with R = ceil(n / C)
    rows each (row i is CTA i // R's local row i % R): ``units`` int32
    ``[rounds, ceil(n/2), 2]``, each round of ``schedule_tables(n)`` sorted
    by the CTA that forms and rotates the unit, and ``starts`` int32
    ``[rounds, C + 1]``, CTA k's units being ``starts[r, k]:starts[r, k +
    1]``.  A unit whose two rows share an owner goes to it; the others, in
    the table's order, to whichever of their two owners has fewer units so
    far (the lower rank on a tie)."""
    R = -(-n // C)
    table = schedule_tables(n)
    units, starts = np.empty_like(table), np.zeros((len(table), C + 1), np.int32)
    for r, pairs in enumerate(table):
        owners = pairs // R
        who = np.where(owners[:, 0] == owners[:, 1], owners[:, 0], -1)
        load = np.bincount(who[who >= 0], minlength=C)
        for u in np.flatnonzero(who < 0):
            lo, hi = owners[u]
            who[u] = lo if load[lo] <= load[hi] else hi
            load[who[u]] += 1
        units[r] = pairs[np.argsort(who, kind="stable")]
        starts[r, 1:] = np.cumsum(load)
    return units, starts


class GlobalPlan(NamedTuple):
    """K5b's launch: ``blocks`` of ``threads``; a phase's items are walked
    by thread g = block * threads + t as g, g + blocks * threads, .."""
    blocks: int
    threads: int


def global_items(n: int, B: int) -> dict:
    """Items of each kind of K5b's phases, ``(outer, mid)``: item f = (u *
    mid + j) * B + b for u < outer, j < mid, b < B.  "init": entry (i, j)
    of every lane; "coef": (unit, lane); "rows": (unit, column, lane);
    "cols": (unit, row, lane); "w": (i, lane)."""
    nu = (n + 1) // 2
    return {"init": (n, n), "coef": (nu, 1), "rows": (nu, n), "cols": (nu, n), "w": (n, 1)}


def global_plan(n: int, B: int, sms: int, per_sm: int, threads: int = GLOBAL_THREADS
                ) -> GlobalPlan:
    """K5b's grid for n and B on a card of ``sms`` SMs that holds
    ``per_sm`` blocks of ``threads`` each at once: every block resident (a
    cooperative launch needs it), no more blocks than the largest phase has
    items for."""
    most = max(outer * mid * B for outer, mid in global_items(n, B).values())
    return GlobalPlan(max(1, min(sms * per_sm, -(-most // threads))), threads)


def global_walk(plan: GlobalPlan, n: int, B: int, kind: str) -> np.ndarray:
    """The items of a phase of ``kind`` as K5b's threads walk them: int64
    ``[steps, G]`` (G = blocks * threads), entry [s, g] the item f that
    thread g takes at its step s, -1 where it has none left."""
    outer, mid = global_items(n, B)[kind]
    total, G = outer * mid * B, plan.blocks * plan.threads
    f = np.arange(max(1, -(-total // G)))[:, None] * G + np.arange(G)[None, :]
    return np.where(f < total, f, -1)


def register_seating(n: int) -> np.ndarray:
    """Who sits where in the register form: int ``[rounds, m / 2, 2]``, the
    players on top and at the bottom of every slot in every round, for m =
    n players (n + 1 for odd n, the dummy player being n).  Slots stay
    paired as positions (i, m - 1 - i); after a round the data of the
    players moves as ``linalg.jacobi.round_robin_schedule`` rotates them:
    slot 0's top stays, slot 1's top takes slot 0's bottom, every other top
    takes its left neighbour's, every bottom its right neighbour's, and the
    last slot's bottom takes that slot's top."""
    m = n + n % 2
    h = m // 2
    top, bottom = list(range(h)), list(range(m - 1, h - 1, -1))
    seats = np.zeros((m - 1, h, 2), np.int64)
    for r in range(m - 1):
        seats[r, :, 0], seats[r, :, 1] = top, bottom
        if h > 1:
            top, bottom = [top[0], bottom[0]] + top[1:-1], bottom[1:] + [top[-1]]
    return seats


@functools.lru_cache(maxsize=None)
def register_masks(n: int) -> np.ndarray:
    """The seating as the kernel reads it, one uint32 a round: bit j where
    slot j's top player is the lower index of its pair (the lower takes
    -s), bit 16 + j where slot j holds the bye of an odd n (its real player
    then counts as the lower)."""
    seats = register_seating(n)
    if seats.shape[1] > 16:
        raise ValueError(f"register_masks: n={n} has more than 16 slots")
    masks = np.zeros(seats.shape[0], np.uint32)
    for r, slots in enumerate(seats):
        for j, (t, b) in enumerate(slots):
            masks[r] |= np.uint32(int(t < b) << j | int(max(t, b) >= n) << (16 + j))
    return masks


def registers_fit(n: int, dtype: torch.dtype) -> bool:
    """Whether the register form takes n: n <= 32 in float32, n <= 16 in
    float64 (a thread's 4 (n + n % 2) entries fill 128 registers there)."""
    return n + n % 2 <= REGISTER_MAX_PLAYERS.get(dtype, 0)


@functools.lru_cache(maxsize=None)
def _launcher(suffix: str, registers: bool = False, cluster: str = "", glob: str = ""):
    """The C entry point: K5a, the register form, K5c's ``cluster`` entry
    ("launch", "barriers": the benches' probe, or "occupancy"), or K5b's
    ``glob`` entry ("launch" or "occupancy")."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if glob == "launch":
        fn = getattr(_build.load_library(), f"eigh_jacobi_global_{suffix}")
        fn.argtypes = [vp] * 6 + [ci, ci, ci, ctypes.c_int64, ci, ci, ci, vp]
    elif glob == "occupancy":
        fn = getattr(_build.load_library(), f"eigh_jacobi_global_occupancy_{suffix}")
        fn.argtypes = [ci, ctypes.POINTER(ci)]
    elif cluster in ("launch", "barriers"):
        entry = "" if cluster == "launch" else "_barriers"
        fn = getattr(_build.load_library(), f"eigh_jacobi_cluster{entry}_{suffix}")
        fn.argtypes = [vp] * 5 + [ci] * 6 + [ctypes.c_int64, ci, ci, vp]
    elif cluster == "occupancy":
        fn = getattr(_build.load_library(), f"eigh_jacobi_cluster_occupancy_{suffix}")
        fn.argtypes = [ci] * 6 + [ctypes.POINTER(ci)]
    elif registers:
        fn = getattr(_build.load_library(), f"eigh_jacobi_registers_{suffix}")
        fn.argtypes = [vp] * 4 + [ci, ci, ctypes.c_int64, vp]
    else:
        fn = getattr(_build.load_library(), f"eigh_jacobi_{suffix}")
        fn.argtypes = [vp] * 4 + [ci, ci, ci, ci, ctypes.c_int64, ci, ci, ci, vp]
    fn.restype = ci
    return fn


@functools.lru_cache(maxsize=None)
def _units(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(schedule_tables(n), device=device).contiguous()


@functools.lru_cache(maxsize=None)
def _masks(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(register_masks(n).view(np.int32), device=device).contiguous()


@functools.lru_cache(maxsize=None)
def _cluster_tables(n: int, C: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(t, device=device).contiguous() for t in cluster_schedule(n, C))


def _check(name: str, A: torch.Tensor, sweeps: int) -> tuple[int, int]:
    if A.ndim != 3 or A.shape[0] != A.shape[1] or A.shape[0] < 1:
        raise ValueError(f"{name}: expected [n, n, B], got {tuple(A.shape)}")
    if sweeps < 0:
        raise ValueError(f"{name}: sweeps must be >= 0, got {sweeps}")
    return A.shape[0], A.shape[2]


def _launch(name, A, block, sweeps: int, ldn=None):
    """K5a on ``A`` with the block ``(lanes, RJ, RU)``; ``ldn`` overrides its
    leading dimension (the benches' probe)."""
    n, B = A.shape[0], A.shape[2]
    w, V = A.new_empty((n, B)), torch.empty_like(A)
    if B == 0:
        return w, V
    units = _units(n, A.device)
    if ldn is None:
        ldn = leading_dim(n, block[0])
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _launcher(_build.DTYPE_SUFFIX[A.dtype])(
            A.data_ptr(), w.data_ptr(), V.data_ptr(), units.data_ptr(),
            n, ldn, units.shape[0], sweeps, B, *block, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    return w, V


def eigh_jacobi_registers(A: torch.Tensor, sweeps: int = 10):
    """The register form on a CUDA tensor ``A [n, n, B]``: ``(w [n, B],
    V [n, n, B])``, unsorted.  Raises where a lane does not fit the
    registers of its threads (``registers_fit``)."""
    name = "eigh_jacobi_registers"
    n, B = _check(name, A, sweeps)
    _build.check_cuda_inputs(name, {"A": A})
    if not registers_fit(n, A.dtype):
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit the registers of a warp's "
                         "threads; eigh_jacobi_resident takes it")
    w, V = A.new_empty((n, B)), torch.empty_like(A)
    if B > 0:
        masks = _masks(n, A.device)
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = _launcher(_build.DTYPE_SUFFIX[A.dtype], registers=True)(
                A.data_ptr(), w.data_ptr(), V.data_ptr(), masks.data_ptr(), n, sweeps, B, stream,
            )
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    eigh_jacobi_registers.launches += 1
    return w, V


eigh_jacobi_registers.launches = 0


def eigh_jacobi_resident(A: torch.Tensor, sweeps: int = 10):
    """Kernel K5a on a CUDA tensor ``A [n, n, B]``: ``(w [n, B], V [n, n, B])``,
    unsorted.  Raises where the slabs do not fit (``resident_fits``)."""
    name = "eigh_jacobi_resident"
    n, _ = _check(name, A, sweeps)
    _build.check_cuda_inputs(name, {"A": A})
    lanes = resident_tile(n, A.dtype)
    if lanes == 0:
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit the shared memory of a block; "
                         "eigh_jacobi_cluster takes it")
    out = _launch(name, A, block_shape(n, lanes), sweeps)
    eigh_jacobi_resident.launches += 1
    return out


eigh_jacobi_resident.launches = 0


# the clusters the card held at once, by (dtype, C, bytes a CTA), as
# cudaOccupancyMaxActiveClusters reported before the first such launch
CLUSTER_OCCUPANCY: dict = {}


def cluster_occupancy(dtype: torch.dtype, n: int, C: int) -> int:
    """K5c's clusters of C CTAs that the current card holds at once for n
    (``cudaOccupancyMaxActiveClusters``), asked once per plan and kept in
    ``CLUSTER_OCCUPANCY``; raises where it is 0 or the query fails."""
    rows = -(-n // C)
    key = (str(dtype)[6:], C, _cluster_bytes(n, rows, _itemsize(dtype)))
    if key not in CLUSTER_OCCUPANCY:
        found = ctypes.c_int(0)
        err = _launcher(_build.DTYPE_SUFFIX[dtype], cluster="occupancy")(
            n, rows, n | 1, C, CLUSTER_BLOCK[1], CLUSTER_BLOCK[2], ctypes.byref(found))
        if err != 0 or found.value < 1:
            raise RuntimeError(f"eigh_jacobi_cluster: the card holds no cluster of {C} CTAs "
                               f"with {key[2]} bytes of shared memory each (cudaError {err}, "
                               f"{found.value} clusters)")
        CLUSTER_OCCUPANCY[key] = found.value
    return CLUSTER_OCCUPANCY[key]


def _launch_cluster(name, A, sweeps: int, C: int, barriers: bool = False):
    """K5c on ``A`` with a cluster of C CTAs; the benches' probe may ask
    for more than ``cluster_plan``'s, and for the kernel that runs its
    ``barriers`` alone (its w and V are garbage)."""
    n, B = A.shape[0], A.shape[2]
    w, V = A.new_empty((n, B)), torch.empty_like(A)
    if B == 0:
        return w, V
    rows = -(-n // C)
    cluster_occupancy(A.dtype, n, C)
    units, starts = _cluster_tables(n, C, A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        entry = "barriers" if barriers else "launch"
        err = _launcher(_build.DTYPE_SUFFIX[A.dtype], cluster=entry)(
            A.data_ptr(), w.data_ptr(), V.data_ptr(), units.data_ptr(), starts.data_ptr(),
            n, rows, n | 1, C, units.shape[0], sweeps, B, *CLUSTER_BLOCK[1:], stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    return w, V


def eigh_jacobi_cluster(A: torch.Tensor, sweeps: int = 10):
    """Kernel K5c on a CUDA tensor ``A [n, n, B]``: ``(w [n, B], V [n, n,
    B])``, unsorted; one lane a cluster of ``cluster_plan(n)`` CTAs, each
    holding its rows of A and V in shared memory for all sweeps.  Raises
    where 8 CTAs cannot hold a lane (``cluster_fits``)."""
    name = "eigh_jacobi_cluster"
    n, _ = _check(name, A, sweeps)
    if A.dtype in _build.DTYPE_SUFFIX and not cluster_fits(n, A.dtype):
        raise ValueError(f"{name}: n={n} in {A.dtype} does not fit the shared memory of a "
                         "cluster of 8 CTAs; eigh_jacobi_global takes it")
    _build.check_cuda_inputs(name, {"A": A})
    out = _launch_cluster(name, A, sweeps, cluster_plan(n, A.dtype)[0])
    eigh_jacobi_cluster.launches += 1
    return out


eigh_jacobi_cluster.launches = 0


# blocks of a K5b block's threads that an SM of the current card holds at
# once, by (dtype, threads), as cudaOccupancyMaxActiveBlocksPerMultiprocessor
# reported before the first such launch
GLOBAL_OCCUPANCY: dict = {}


def global_occupancy(dtype: torch.dtype, threads: int) -> int:
    """K5b's blocks of ``threads`` that an SM holds at once, asked once and
    kept in ``GLOBAL_OCCUPANCY``; raises where it is 0 or the query fails."""
    key = (str(dtype)[6:], threads)
    if key not in GLOBAL_OCCUPANCY:
        found = ctypes.c_int(0)
        err = _launcher(_build.DTYPE_SUFFIX[dtype], glob="occupancy")(threads, ctypes.byref(found))
        if err != 0 or found.value < 1:
            raise RuntimeError(f"eigh_jacobi_global: an SM holds no block of {threads} threads "
                               f"(cudaError {err}, {found.value} blocks)")
        GLOBAL_OCCUPANCY[key] = found.value
    return GLOBAL_OCCUPANCY[key]


def _launch_global(name, A, sweeps: int, threads: int = GLOBAL_THREADS,
                   cooperative: bool = GLOBAL_COOPERATIVE):
    """K5b on ``A`` with ``global_plan``'s grid of blocks of ``threads``, as
    one cooperative launch or as one launch a phase (the benches' probe
    times both)."""
    n, B = A.shape[0], A.shape[2]
    w, V = A.new_empty((n, B)), torch.empty_like(A)
    if B == 0:
        return w, V
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    with torch.cuda.device(A.device):
        plan = global_plan(n, B, sms, global_occupancy(A.dtype, threads), threads)
        work, coef = torch.empty_like(A), A.new_empty((2, n, B))
        units = _units(n, A.device)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = _launcher(_build.DTYPE_SUFFIX[A.dtype], glob="launch")(
            A.data_ptr(), work.data_ptr(), coef.data_ptr(), w.data_ptr(), V.data_ptr(),
            units.data_ptr(), n, units.shape[0], sweeps, B, plan.blocks, plan.threads,
            int(cooperative), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    return w, V


def eigh_jacobi_global(A: torch.Tensor, sweeps: int = 10):
    """Kernel K5b on a CUDA tensor ``A [n, n, B]``, any n: the working copy
    of A ``[n, n, B]`` and the coefficients ``[2, n, B]`` are scratch in
    device memory and V is built in its output; each round's phases are
    spread over every SM of the card (``global_plan``), a grid-wide barrier
    between them, all in one cooperative launch."""
    name = "eigh_jacobi_global"
    _check(name, A, sweeps)
    _build.check_cuda_inputs(name, {"A": A})
    out = _launch_global(name, A, sweeps)
    eigh_jacobi_global.launches += 1
    return out


eigh_jacobi_global.launches = 0


def eigh_jacobi_kernel(A: torch.Tensor, sweeps: int = 10, sort: bool = True) -> Eigh:
    """The kernel on a CUDA tensor: the register form where a lane fits the
    registers of its threads, K5a where its slabs fit a block's shared
    memory, K5c where they fit a cluster's, else K5b; the sort outside it."""
    n, _ = _check("eigh_jacobi_kernel", A, sweeps)
    if registers_fit(n, A.dtype):
        w, V = eigh_jacobi_registers(A, sweeps)
    elif resident_fits(n, A.dtype):
        w, V = eigh_jacobi_resident(A, sweeps)
    elif cluster_fits(n, A.dtype):
        w, V = eigh_jacobi_cluster(A, sweeps)
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
