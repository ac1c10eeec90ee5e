// Batched Givens QR and least squares on the Sameh-Kuck wavefront, for
// Hopper (sm_90a), batch-minor layout.
//
// Replaces nlsolver_tpu/ops/qr_wavefront.py: qr_wavefront_pallas (K2a, R
// and optionally Q of A [m, n, B]) and least_squares_wavefront_pallas (K2b,
// x = argmin ||A x - y|| for A [m, n, B], y [m, B]; the rotations thread y
// and the back-substitution runs in the kernel, so only x is written).
//
// Layout: one thread per lane b.  Element (i, j) of lane b lies at
// (i * cols + j) * B + b, so neighbouring threads touch neighbouring
// addresses and every load and store coalesces without a transpose.  Entry
// (i, j), i > j, is zeroed at stage k = m - 1 - i + 2 j by rotating rows
// (i - 1, i); for stage k the columns are j = max(0, k - m + 2) .. min(n -
// 1, k / 2), in closed form, so no schedule table is passed.  The row pairs
// of a stage are disjoint, so one thread doing them one after another
// computes what the twin's whole-stage tensor ops compute.
//
// K2b, the sliding window.  At stage k the rotation of column j acts on rows
// (m - 2 - k + 2 j, m - 1 - k + 2 j): rows (2 j, 2 j + 1) of a window whose
// row 0 is row m - 2 - k of the system.  A row enters the window at stage k
// as row m - 2 - k and is finished once it has left window row 2 n - 1, so
// only 2 n rows of n + 1 words (R's columns, then Q^T y) are live at a
// stage, and A and y are read once, row by row, one stage ahead, and only x
// is written: 109 MB at [34, 2, 262144] in f32, some 33 us at 3.35 TB/s.
// Seven forms, chosen by n and dtype (and m, for K2b-p) in
// ops/qr_wavefront.py:
//   * least_squares_registers_kernel<T, N>: the window in the thread's
//     registers.  Every index is a compile-time constant (a register array
//     takes no runtime index), so the window shifts by one row a stage by
//     register moves; the active columns of a stage are a uniform branch.
//   * least_squares_shared_kernel<T>: the same window as a ring of 2 n + 1
//     rows in shared memory, laid out [row][word][lane] with lanes the
//     fastest index, so a warp's accesses fall in distinct banks; the spare
//     row takes the next stage's row by cp.async while this stage rotates.
//   * least_squares_warp_kernel<T, Q>: one warp a lane, the window as a
//     ring of 2 n + 1 rows in shared memory, one ring a warp (below);
//     n <= 169 in f32, 119 in f64 (Q = ceil((n + 1) / 32) words a thread
//     a row; a warp's ring and 2 n coefficients fit 232448 bytes).
//   * least_squares_cluster_kernel<T>: one lane a thread-block cluster of
//     2, 4 or 8 CTAs, the ring's columns split over them (below); n <= 471
//     in f32, 329 in f64, past the warp form's.
//   * least_squares_distributed_kernel<T>: one lane over P CTAs of the
//     whole card, the ring's columns split over them, a stage's
//     coefficients through device memory, one barrier in device memory a
//     stage, one cooperative launch (below); past the cluster form's n, as
//     far as 132 CTAs hold the ring (ops/qr_wavefront.py's
//     distributed_fits).
//   * lstsq_panel_kernel<T> and lstsq_backsolve_kernel<T> (K2b-p): R over
//     the whole card as K2a-p's first phase forms it, y carried as one more
//     column, then a CTA a lane back-substitutes (below); past the
//     distributed form's n, as far as a CTA holds a column of m words;
//   * qr_wavefront_kernel<T, false, true>: a working copy of [A | y] in
//     device memory (the scratch R and qty the wrapper allocates), read and
//     written some 330 times a lane at [34, 2]; every n, the dispatcher's
//     past K2b-p's range, elsewhere a direct call.
// K2a comes in five forms, chosen by (m, n), dtype and Q in
// ops/qr_wavefront.py: qr_warp_kernel<T, kQ, Q> (K2a-w, below) gives a
// lane a warp and keeps its [R | Q^T] in shared memory; past its range
// qr_cluster_kernel<T> (K2a-c) splits the array's columns over the shared
// memory of a thread-block cluster of 2, 4 or 8 CTAs, and past that
// qr_distributed_kernel<T> (K2a-d) over P CTAs of the whole card, as far as
// 132 CTAs hold it; beyond, qr_panel_kernel and qr_replay_kernel (K2a-p,
// below) form R over the whole card with each rotation logged, then
// rebuild Q^T from the log.  qr_wavefront_kernel (no kSolve, K2a-g) writes
// all of R and, with Q, Q^T [m, m, B] in device memory, a thread a lane,
// bound by each thread's chain of dependent rotations through L2: the
// dispatcher's only where one column of m words and a stage's coefficients
// no longer fit a CTA (m = n past 29055 in f32, 14527 in f64).
//
// Arithmetic: each step is rounded as the plain PyTorch twin
// (nlsolver_torch/linalg/qr_parallel.py) rounds it: the Givens
// coefficients as givens.py computes its selected branch, a rotation as
// (c * x) + (s * y) with -s on row q, the back-substitution in the twin's
// order, through the _rn intrinsics so that no FMA contraction creeps in.
// Every kernel is then bit-equal to the twin.  K2a rotates all n columns of
// a row pair, as the twin does, so that R is bit-equal below the diagonal
// too; K2b rotates columns j .. n - 1 only, since the columns left of j
// hold zeroed entries that x never reads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cuda_pipeline.h>

#include <cstdint>

#include "lane_barrier.cuh"
#include "rn_math.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
__device__ inline void givens(T a, T b, T& c, T& s) {
  const T aa = rn::abs(a), ab = rn::abs(b);
  if (aa >= ab) {
    const T t = rn::div(b, a);
    const T u = rn::mul(rn::sign(a), rn::sqrt(rn::add(T(1), rn::mul(t, t))));
    c = rn::div(T(1), u);
    s = rn::div(t, u);
  } else {
    const T t = rn::div(a, b);
    const T u = rn::mul(rn::sign(b), rn::sqrt(rn::add(T(1), rn::mul(t, t))));
    c = rn::div(t, u);
    s = rn::div(T(1), u);
  }
  // a = b = 0 (the branch above then made NaNs): the identity, a select
  if (aa == T(0) && ab == T(0)) {
    c = T(1);
    s = T(0);
  }
}

// rows p and q of a batch-minor array, columns c0 .. cols - 1
template <typename T>
__device__ inline void rotate_rows(T* X, int cols, int c0, int p, int q,
                                   T c, T s, int64_t B, int64_t b) {
  T* xp = X + static_cast<int64_t>(p) * cols * B + b;
  T* xq = X + static_cast<int64_t>(q) * cols * B + b;
  for (int col = c0; col < cols; ++col) {
    const int64_t o = static_cast<int64_t>(col) * B;
    const T vp = xp[o], vq = xq[o];
    xp[o] = rn::add(rn::mul(c, vp), rn::mul(s, vq));
    xq[o] = rn::add(rn::mul(c, vq), rn::mul(-s, vp));
  }
}

template <typename T, bool kQ, bool kSolve>
__global__ void qr_wavefront_kernel(const T* __restrict__ A,
                                    const T* __restrict__ y, T* R, T* Qt,
                                    T* qty, T* x, int m, int n, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t mn = static_cast<int64_t>(m) * n;
  for (int64_t e = 0; e < mn; ++e) R[e * B + b] = A[e * B + b];
  if (kQ) {
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < m; ++j)
        Qt[(static_cast<int64_t>(i) * m + j) * B + b] = i == j ? T(1) : T(0);
  }
  if (kSolve) {
    for (int i = 0; i < m; ++i) qty[i * B + b] = y[i * B + b];
  }

  for (int k = 0; k <= m + n - 3; ++k) {
    const int j_hi = min(n - 1, k / 2);
    for (int j = max(0, k - m + 2); j <= j_hi; ++j) {
      const int q = m - 1 + 2 * j - k, p = q - 1;
      T c, s;
      givens(R[(static_cast<int64_t>(p) * n + j) * B + b],
             R[(static_cast<int64_t>(q) * n + j) * B + b], c, s);
      rotate_rows(R, n, kSolve ? j : 0, p, q, c, s, B, b);
      if (kQ) rotate_rows(Qt, m, 0, p, q, c, s, B, b);
      if (kSolve) rotate_rows(qty, 1, 0, p, q, c, s, B, b);
    }
  }

  if (kSolve) {
    // R[:n, :n] x = (Q^T y)[:n], in the twin's order
    for (int i = n - 1; i >= 0; --i) {
      T acc = qty[i * B + b];
      for (int j = i + 1; j < n; ++j) {
        acc = rn::sub(acc, rn::mul(R[(static_cast<int64_t>(i) * n + j) * B + b],
                                   x[j * B + b]));
      }
      x[i * B + b] = rn::div(acc, R[(static_cast<int64_t>(i) * n + i) * B + b]);
    }
  }
}

constexpr int kThreads = 256;

// The register form's most n, by word size (ops/qr_wavefront.py's
// REGISTER_MAX_N): the window is 2 n (n + 1) words a thread
constexpr int kRegisterMaxN32 = 8, kRegisterMaxN64 = 5;

// row r of [A | y] of lane b into a window row
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ A, const T* __restrict__ y,
                                         int r, int64_t B, int64_t b, T (&row)[N + 1]) {
#pragma unroll
  for (int c = 0; c < N; ++c) row[c] = A[(static_cast<int64_t>(r) * N + c) * B + b];
  row[N] = y[static_cast<int64_t>(r) * B + b];
}

// Stage k of the register window: shift row m - 2 - k in (fetched a stage
// ahead into ``next``), fetch the next stage's row, rotate.  kEvery: every
// column j is active (2 N - 2 <= k <= m - 2), so no column is guarded.
template <typename T, int N, bool kEvery>
__device__ __forceinline__ void window_stage(const T* __restrict__ A, const T* __restrict__ y,
                                             int m, int k, int64_t B, int64_t b,
                                             T (&win)[2 * N][N + 1], T (&next)[N + 1]) {
#pragma unroll
  for (int w = 2 * N - 1; w > 0; --w)
#pragma unroll
    for (int c = 0; c <= N; ++c) win[w][c] = win[w - 1][c];
#pragma unroll
  for (int c = 0; c <= N; ++c) win[0][c] = next[c];
  if (k <= m - 3) load_row<T, N>(A, y, m - 3 - k, B, b, next);  // in flight
  const int j_lo = max(0, k - m + 2), j_hi = min(N - 1, k / 2);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (kEvery || (j >= j_lo && j <= j_hi)) {
      T c, s;
      givens(win[2 * j][j], win[2 * j + 1][j], c, s);
#pragma unroll
      for (int col = j; col <= N; ++col) {
        const T vp = win[2 * j][col], vq = win[2 * j + 1][col];
        win[2 * j][col] = rn::add(rn::mul(c, vp), rn::mul(s, vq));
        win[2 * j + 1][col] = rn::add(rn::mul(c, vq), rn::mul(-s, vp));
      }
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
    least_squares_registers_kernel(const T* __restrict__ A,
                                   const T* __restrict__ y,
                                   T* __restrict__ x, int m, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // window rows 0 .. 2 N - 1; word N of a row is (Q^T y)
  T win[2 * N][N + 1], next[N + 1];
#pragma unroll
  for (int c = 0; c <= N; ++c) {
    next[c] = T(0);
#pragma unroll
    for (int w = 0; w < 2 * N; ++w) win[w][c] = T(0);
  }
  // before stage 0 window row 0 is row m - 1; every stage shifts one in
  load_row<T, N>(A, y, m - 1, B, b, win[0]);
  if (m >= 2) load_row<T, N>(A, y, m - 2, B, b, next);
  // the ramp where some columns wait, the stages where every column
  // rotates, the ramp where the first columns are done
  const int stages = m + N - 2, s0 = min(2 * N - 2, stages), s1 = max(s0, min(m - 1, stages));
  int k = 0;
#pragma unroll 1
  for (; k < s0; ++k) window_stage<T, N, false>(A, y, m, k, B, b, win, next);
#pragma unroll 1
  for (; k < s1; ++k) window_stage<T, N, true>(A, y, m, k, B, b, win, next);
#pragma unroll 1
  for (; k < stages; ++k) window_stage<T, N, false>(A, y, m, k, B, b, win, next);
  // after the last stage row i of the system is window row N - 1 + i:
  // R[:N, :N] x = (Q^T y)[:N], in the twin's order
  T xs[N];
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T acc = win[N - 1 + i][N];
#pragma unroll
    for (int j = i + 1; j < N; ++j) acc = rn::sub(acc, rn::mul(win[N - 1 + i][j], xs[j]));
    xs[i] = rn::div(acc, win[N - 1 + i][i]);
    x[static_cast<int64_t>(i) * B + b] = xs[i];
  }
}

template <typename T>
__device__ inline void fetch_row(T* ring, const T* A, const T* y, int r, int n,
                                 int slot, int lanes, int t, int64_t B,
                                 int64_t b) {
  T* row = ring + static_cast<int64_t>(slot) * (n + 1) * lanes + t;
  for (int c = 0; c < n; ++c)
    __pipeline_memcpy_async(row + c * lanes, A + (static_cast<int64_t>(r) * n + c) * B + b,
                            sizeof(T));
  __pipeline_memcpy_async(row + n * lanes, y + static_cast<int64_t>(r) * B + b, sizeof(T));
  __pipeline_commit();
}

// One thread per lane; a block's lanes share the dynamic shared memory, a
// ring of 2 n + 1 rows of n + 1 words each, [row][word][lane].  Row r of the
// system lives in ring row r % (2 n + 1); a thread touches only its own
// words, so no barrier is needed.
template <typename T>
__global__ void least_squares_shared_kernel(const T* __restrict__ A,
                                            const T* __restrict__ y,
                                            T* __restrict__ x, int m, int n,
                                            int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int lanes = blockDim.x, t = threadIdx.x, slots = 2 * n + 1;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * lanes + t;
  if (b >= B) return;
  auto at = [&](int r, int c) -> T& {
    return ring[(static_cast<int64_t>(r % slots) * (n + 1) + c) * lanes + t];
  };
  fetch_row(ring, A, y, m - 1, n, (m - 1) % slots, lanes, t, B, b);
  if (m >= 2) fetch_row(ring, A, y, m - 2, n, (m - 2) % slots, lanes, t, B, b);
  __pipeline_wait_prior(0);
  for (int k = 0; k <= m + n - 3; ++k) {
    // the next stage's row goes to the ring row that the row leaving the
    // window this stage held
    if (k <= m - 3) fetch_row(ring, A, y, m - 3 - k, n, (m - 3 - k) % slots, lanes, t, B, b);
    const int j_hi = min(n - 1, k / 2);
    for (int j = max(0, k - m + 2); j <= j_hi; ++j) {
      const int p = m - 2 - k + 2 * j;
      T c, s;
      givens(at(p, j), at(p + 1, j), c, s);
      for (int col = j; col <= n; ++col) {
        const T vp = at(p, col), vq = at(p + 1, col);
        at(p, col) = rn::add(rn::mul(c, vp), rn::mul(s, vq));
        at(p + 1, col) = rn::add(rn::mul(c, vq), rn::mul(-s, vp));
      }
    }
    __pipeline_wait_prior(0);
  }
  // rows 0 .. n - 1 sit in ring rows 0 .. n - 1; x[j] replaces (Q^T y)[j]
  // once found, in the twin's order
  for (int i = n - 1; i >= 0; --i) {
    T acc = at(i, n);
    for (int j = i + 1; j < n; ++j) acc = rn::sub(acc, rn::mul(at(i, j), at(j, n)));
    at(i, n) = rn::div(acc, at(i, i));
    x[static_cast<int64_t>(i) * B + b] = at(i, n);
  }
}

// K2b-w, one warp a lane.  Replaces least_squares_wavefront_pallas
// (nlsolver_tpu/ops/qr_wavefront.py:168) for n past the shared form's.
// What bounds it: the latency of each lane's chain of dependent stages (a
// stage reads the pivots the one before wrote), and, with one thread a
// lane, the few threads that chain leaves an SM: 4096 lanes are one warp
// an SM, each lane some 1900 zeroings in a row at [78, 30].  A warp a lane
// spreads a stage over 32 threads, so a lane's chain is its stages, not
// its zeroings:
//   * thread t owns columns t, t + 32, .. (Q of them) of the window, and
//     column n, Q^T y; the window is the sliding one of the shared form, a
//     ring of 2 n + 1 rows of n + 1 words, one ring a warp, the column
//     index fastest, so a warp's accesses fall in distinct banks;
//   * the row pairs of a stage are disjoint, so each thread that owns an
//     active pivot column j forms givens(win[2 j][j], win[2 j + 1][j])
//     from the pivots before the stage, all at once, into the warp's row
//     of 2 n coefficients in shared memory, and after a warp barrier every
//     thread turns its own columns col >= j by the stage's rotations in
//     ascending j, each (c, s) read by all threads at one address (faster
//     on an H100 than passing (c, s) by shuffle from the thread that owns
//     column j).  A thread writes only its own columns, so no other
//     barrier orders the stage within the warp;
//   * entry (i, c) of lane b lies at (i n + c) B + b, so a warp that read
//     its own lane's row alone would touch n + 1 sectors for as many
//     words.  A block holds W consecutive lanes, one warp each, and its
//     threads fetch the next row of all W lanes together, a stage ahead,
//     by cp.async into the warps' rings: W lanes of a column are W
//     neighbouring words.  One block barrier a stage makes the row
//     visible and keeps a fetch off a ring row still in use;
//   * the back-substitution runs in the twin's order in the warp's first
//     thread, and the block writes x of its W lanes together.
// What bounds it then is the rotation loop's issue: some 30 instructions a
// thread a rotation (ring indices, the guard), of which the turn is 10.
// Every value goes through the twin's operations in its order, so the
// result is bit-equal to the twin's.
template <typename T, int Q>
__global__ void least_squares_warp_kernel(const T* __restrict__ A, const T* __restrict__ y,
                                          T* __restrict__ x, int m, int n, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, shift = __ffs(W) - 1;  // lanes a block, a power of two
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int cols = n + 1, slots = 2 * n + 1;
  const int ring_words = slots * cols;
  T* rings = reinterpret_cast<T*>(smem);
  T* ring = rings + warp * ring_words;
  // (c, s) of the stage's pivot columns, one pair a column, after the rings
  T* coef = rings + W * ring_words + warp * 2 * n;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * W;
  const bool live = b0 + warp < B;

  // row r of [A | y] of the block's lanes into their rings, ring row r % slots
  auto fetch = [&](int r) {
    T* row = rings + (r % slots) * cols;
    for (int e = threadIdx.x; e < (cols << shift); e += blockDim.x) {
      const int c = e >> shift, w = e & (W - 1);
      const int64_t b = b0 + w;
      if (b < B) {
        const T* src = c < n ? A + (static_cast<int64_t>(r) * n + c) * B + b
                             : y + static_cast<int64_t>(r) * B + b;
        __pipeline_memcpy_async(row + w * ring_words + c, src, sizeof(T));
      }
    }
    __pipeline_commit();
  };

  fetch(m - 1);
  if (m >= 2) fetch(m - 2);
  __pipeline_wait_prior(0);
  __syncthreads();
#pragma unroll 1
  for (int k = 0; k <= m + n - 3; ++k) {
    // the next stage's row, into the ring row of the row that left the
    // window after the last stage
    if (k <= m - 3) fetch(m - 3 - k);
    if (live) {
      const int j_lo = max(0, k - m + 2), j_hi = min(n - 1, k / 2);
      // ring row of window row 0, system row m - 2 - k (> -slots)
      int s0 = (m - 2 - k) % slots;
      if (s0 < 0) s0 += slots;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int j = t + 32 * q;
        if (j >= j_lo && j <= j_hi) {
          int rp = s0 + 2 * j;
          if (rp >= slots) rp -= slots;
          const int rq = rp + 1 == slots ? 0 : rp + 1;
          givens(ring[rp * cols + j], ring[rq * cols + j], coef[2 * j], coef[2 * j + 1]);
        }
      }
      __syncwarp();
      int rp = s0 + 2 * j_lo;
      if (rp >= slots) rp -= slots;
#pragma unroll 1
      for (int j = j_lo; j <= j_hi; ++j) {
        const int rq = rp + 1 == slots ? 0 : rp + 1;
        const T c = coef[2 * j], s = coef[2 * j + 1];
        T* xp = ring + rp * cols;
        T* xq = ring + rq * cols;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int col = t + 32 * q;
          if (col >= j && col <= n) {
            const T vp = xp[col], vq = xq[col];
            xp[col] = rn::add(rn::mul(c, vp), rn::mul(s, vq));
            xq[col] = rn::add(rn::mul(c, vq), rn::mul(-s, vp));
          }
        }
        rp = rq + 1 == slots ? 0 : rq + 1;
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  // rows 0 .. n - 1 sit in ring rows 0 .. n - 1; x[i] replaces (Q^T y)[i]
  // once found, in the twin's order
  if (live && t == 0) {
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {
      const T* row = ring + i * cols;
      T acc = row[n];
      for (int j = i + 1; j < n; ++j) acc = rn::sub(acc, rn::mul(row[j], ring[j * cols + n]));
      ring[i * cols + n] = rn::div(acc, row[i]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (n << shift); e += blockDim.x) {
    const int i = e >> shift, w = e & (W - 1);
    if (b0 + w < B) x[static_cast<int64_t>(i) * B + b0 + w] = rings[w * ring_words + i * cols + n];
  }
}

// K2b-w's words a thread a row, Q, by word size: (2 n + 1)(n + 1) + 2 n
// words of one warp's ring and coefficients fit 232448 bytes up to n = 169
// in f32 and 119 in f64
constexpr int kWarpMaxQ32 = 6, kWarpMaxQ64 = 4;
constexpr int kMaxDynamicSmem = 232448;

template <typename T, int Q>
int launch_warp(const T* A, const T* y, T* x, int m, int n, int64_t B, int lanes,
                cudaStream_t s) {
  if constexpr (Q > 1) {
    if (n + 1 <= 32 * (Q - 1)) return launch_warp<T, Q - 1>(A, y, x, m, n, B, lanes, s);
  }
  const int64_t smem = static_cast<int64_t>(lanes) * ((2 * n + 1) * (n + 1) + 2 * n) * sizeof(T);
  if (n < 1 || m < n || n + 1 > 32 * Q || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      least_squares_warp_kernel<T, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + lanes - 1) / lanes);
  least_squares_warp_kernel<T, Q><<<blocks, 32 * lanes, smem, s>>>(A, y, x, m, n, B);
  return static_cast<int>(cudaGetLastError());
}

// K2b-c, one lane a thread-block cluster.  Replaces
// least_squares_wavefront_pallas (nlsolver_tpu/ops/qr_wavefront.py:168) for
// n past K2b-w's, where one lane's ring of (2 n + 1)(n + 1) words no longer
// fits an SM (233 KB at n = 120 in f64).  What bounds the device-memory
// form there: one thread carries a lane's whole chain of some m n
// rotations, each a round trip of two rows through L2, and 256 lanes are
// 256 threads on 132 SMs (408998 us at [248, 120, 256] f64, 21x lstsq).
// K2b-w's scheme with the ring's columns split over the C CTAs of a
// cluster:
//   * column c of the ring (c = n is Q^T y) lives in CTA c % C at local
//     column c / C, so as the pivot j moves right every CTA keeps about
//     as many active columns as the others; thread (tc, g) of a CTA holds
//     local column tc, and of each stage's rotations the g-th, (g + G)-th,
//     .. of G groups (the row pairs of a stage are disjoint, so any thread
//     may turn any pair);
//   * at each stage the owner of pivot column j (group 0) forms (c, s) from
//     its own ring and stores the pair into the coefficient row of every
//     CTA of the cluster (distributed shared memory); one cluster barrier
//     follows, then every CTA turns its own columns col >= j by the stage's
//     rotations.  The coefficient rows alternate by the stage's parity, so
//     one barrier a stage is enough: a CTA writes row (k + 1) & 1 only past
//     barrier k, when every CTA has read it for stage k - 1.  Only the
//     coefficients cross SMs in the rotation loop;
//   * each CTA fetches its own columns of the next row of [A | y], a stage
//     ahead, by cp.async into the ring row that left the window, as K2b-w;
//   * after the last stage rows 0 .. n - 1 of R sit in ring rows 0 .. n -
//     1, spread over the cluster.  The back-substitution runs in the twin's
//     order in CTA 0, from the last row: its second warp gathers row i - 1's
//     finished entries from every CTA (one remote load a thread, all in
//     flight at once) into the dead coefficient rows while its first warp
//     forms row i's products with x there and its first thread subtracts
//     them in the twin's order; the other CTAs wait at a last barrier.
// Every value goes through the twin's operations in its order, so x is the
// twin's bit for bit.
template <typename T>
__global__ void __launch_bounds__(1024)
    least_squares_cluster_kernel(const T* __restrict__ A, const T* __restrict__ y,
                                 T* __restrict__ x, int m, int n, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = blockDim.y, g = threadIdx.y, tc = threadIdx.x;
  const int slots = 2 * n + 1, Lc = (n + C) / C;  // local columns of CTA 0, the most
  const int64_t b = blockIdx.x / C;
  T* ring = reinterpret_cast<T*>(smem);  // [slots][Lc]
  T* coef = ring + slots * Lc;           // [2][2 n] (and 2): (c, s) of pivot j at 2 j, 2 j + 1
  const int c = rank + C * tc;           // this thread's column of the system
  const bool owns = tc < Lc && c <= n;
  T* mine = ring + tc;

  // row r of [A | y] into ring row r % slots, this thread's column (group 0)
  auto fetch = [&](int r) {
    if (owns && g == 0) {
      const T* src = c < n ? A + (static_cast<int64_t>(r) * n + c) * B + b
                           : y + static_cast<int64_t>(r) * B + b;
      __pipeline_memcpy_async(mine + (r % slots) * Lc, src, sizeof(T));
    }
    __pipeline_commit();
  };

  fetch(m - 1);
  if (m >= 2) fetch(m - 2);
  __pipeline_wait_prior(0);
  // every CTA runs before any writes into another's shared memory
  cluster.sync();
#pragma unroll 1
  for (int k = 0; k <= m + n - 3; ++k) {
    if (k <= m - 3) fetch(m - 3 - k);
    const int j_lo = max(0, k - m + 2), j_hi = min(n - 1, k / 2);
    // ring row of window row 0, system row m - 2 - k (> -slots)
    int s0 = (m - 2 - k) % slots;
    if (s0 < 0) s0 += slots;
    T* buf = coef + (k & 1) * 2 * n;
    if (owns && g == 0 && c >= j_lo && c <= j_hi) {
      int rp = s0 + 2 * c;
      if (rp >= slots) rp -= slots;
      const int rq = rp + 1 == slots ? 0 : rp + 1;
      T cc, ss;
      givens(mine[rp * Lc], mine[rq * Lc], cc, ss);
      for (int r = 0; r < C; ++r) {
        T* dst = cluster.map_shared_rank(buf, r);
        dst[2 * c] = cc;
        dst[2 * c + 1] = ss;
      }
    }
    cluster.sync();  // the stage's coefficients in every CTA
    if (owns) {
      // this thread's rotations: j_lo + g, j_lo + g + G, .. up to its column,
      // two at a time (their row pairs are disjoint), loads before stores
      const int j_end = min(j_hi, c);
      int j = j_lo + g;
#pragma unroll 1
      for (; j + G <= j_end; j += 2 * G) {
        const int j2 = j + G;
        int p1 = s0 + 2 * j, p2 = s0 + 2 * j2;
        if (p1 >= slots) p1 -= slots;
        if (p2 >= slots) p2 -= slots;
        const int q1 = p1 + 1 == slots ? 0 : p1 + 1, q2 = p2 + 1 == slots ? 0 : p2 + 1;
        const T c1 = buf[2 * j], s1 = buf[2 * j + 1], c2 = buf[2 * j2], s2 = buf[2 * j2 + 1];
        const T vp1 = mine[p1 * Lc], vq1 = mine[q1 * Lc];
        const T vp2 = mine[p2 * Lc], vq2 = mine[q2 * Lc];
        mine[p1 * Lc] = rn::add(rn::mul(c1, vp1), rn::mul(s1, vq1));
        mine[q1 * Lc] = rn::add(rn::mul(c1, vq1), rn::mul(-s1, vp1));
        mine[p2 * Lc] = rn::add(rn::mul(c2, vp2), rn::mul(s2, vq2));
        mine[q2 * Lc] = rn::add(rn::mul(c2, vq2), rn::mul(-s2, vp2));
      }
      if (j <= j_end) {
        int p = s0 + 2 * j;
        if (p >= slots) p -= slots;
        const int q = p + 1 == slots ? 0 : p + 1;
        const T cj = buf[2 * j], sj = buf[2 * j + 1];
        const T vp = mine[p * Lc], vq = mine[q * Lc];
        mine[p * Lc] = rn::add(rn::mul(cj, vp), rn::mul(sj, vq));
        mine[q * Lc] = rn::add(rn::mul(cj, vq), rn::mul(-sj, vp));
      }
    }
    // the next row landed; the next stage's pivots and rows are turned
    // (by any group of this CTA)
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  // R final in every CTA; R[:n, :n] x = (Q^T y)[:n] in CTA 0, in the twin's
  // order: x in coef[0, n); row i's entries i .. n (R[i][i], R[i][col], (Q^T
  // y)[i]) gathered by the second warp into coef[n + (i & 1) (n + 1) + col]
  // while the first turns row i + 1's into the products R[i + 1][col] x[col]
  // in place and its first thread subtracts them in ascending col
  cluster.sync();
  const int lin = g * blockDim.x + tc, warp = lin >> 5, lane = lin & 31;
  if (rank == 0 && warp < 2) {
    T* xs = coef;
    auto gather = [&](int i) {
      T* row = coef + n + (i & 1) * (n + 1);
      for (int col = i + lane; col <= n; col += 32)
        row[col] = cluster.map_shared_rank(ring, col % C)[i * Lc + col / C];
    };
    if (warp == 1) gather(n - 1);
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {
      // row i gathered; the first warp done with row i + 1
      asm volatile("bar.sync 1, 64;\n" ::: "memory");
      if (warp == 1) {
        if (i > 0) gather(i - 1);
      } else {
        T* row = coef + n + (i & 1) * (n + 1);
        for (int col = i + 1 + lane; col < n; col += 32) row[col] = rn::mul(row[col], xs[col]);
        __syncwarp();
        if (lane == 0) {
          T acc = row[n];
          for (int col = i + 1; col < n; ++col) acc = rn::sub(acc, row[col]);
          xs[i] = rn::div(acc, row[i]);
          x[static_cast<int64_t>(i) * B + b] = xs[i];
        }
        __syncwarp();
      }
    }
  }
  cluster.sync();  // no CTA leaves while CTA 0 reads its ring
}

// K2b-c's launch: C CTAs a lane (2, 4 or 8), threads (columns, groups) a
// CTA, the column threads a multiple of 32 that covers CTA 0's columns, at
// least two warps (the back-substitution takes two)
template <typename T>
int launch_cluster(const T* A, const T* y, T* x, int m, int n, int64_t B, int C, int columns,
                   int groups, cudaStream_t st) {
  const int Lc = (n + C) / C;
  const int64_t smem = (static_cast<int64_t>(2 * n + 1) * Lc + 4 * n + 2) * sizeof(T);
  if (n < 1 || m < n || B < 1 || (C != 2 && C != 4 && C != 8) || columns < Lc ||
      columns % 32 || groups < 1 || columns * groups < 64 || columns * groups > 1024 ||
      smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = least_squares_cluster_kernel<T>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * C));
  cfg.blockDim = dim3(columns, groups);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, A, y, x, m, n, B);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K2b-d, one lane over P CTAs of the whole card.  Replaces
// least_squares_wavefront_pallas (nlsolver_tpu/ops/qr_wavefront.py:168) for
// n past K2b-c's, where 8 CTAs' shared memory no longer holds one lane's
// ring (1.75 MB at n = 330 in f64).  What bounds the device-memory form
// there: one thread carries a lane's chain of some m n rotations, each a
// round trip of two rows through L2, and 2 lanes are 2 threads on 132 SMs
// (1.28 s at [330, 330, 2] f64).  K2b-c's scheme over any number P of CTAs,
// with device memory in place of distributed shared memory:
//   * column c of the ring (c = n is Q^T y) lives in CTA c % P at local
//     column c / P; thread (tc, g) of a CTA holds local column tc and takes
//     the g-th, (g + G)-th, .. of a stage's rotations, as in K2b-c;
//   * at each stage the owner of pivot column j forms (c, s) from its own
//     ring and stores the pair into the team's coefficient row of the
//     stage's parity in device memory; one barrier in device memory
//     (lane_barrier.cuh) follows, then every CTA copies the stage's
//     coefficients from L2 into its shared memory and turns its own columns
//     col >= j by the stage's rotations.  A CTA writes row (k + 1) & 1 only
//     past barrier k, when every CTA has copied it for stage k - 1, so two
//     rows and one barrier a stage are enough;
//   * each CTA fetches its own columns of the next row of [A | y], a stage
//     ahead, by cp.async into the ring row that left the window;
//   * after the last stage each CTA stores its columns of R's rows 0 .. n -
//     1 and of Q^T y into the team's store in device memory (row i's
//     columns i .. n at i (n + 1) - i (i - 1) / 2), and past one more
//     barrier CTA 0 runs the back-substitution from it in the twin's order:
//     its warps past the first fetch row i - 1 from L2, and form its
//     products R[i - 1][col] x[col] but the first, while its first thread
//     runs row i's chain.  The team's next lane writes the store only past
//     its own last stage, which CTA 0 reaches after this solve;
//   * every CTA of a team is resident by one cooperative launch, and a
//     grid of ``teams`` teams walks the lanes, team g taking lanes g, g +
//     teams, ..
// ``mode`` 1 skips the back-substitution and 2 runs the barriers alone
// (the benches' probe of what each costs).  Every value goes through the
// twin's operations in its order, so x is the twin's bit for bit.
template <typename T>
__global__ void __launch_bounds__(1024)
    least_squares_distributed_kernel(const T* __restrict__ A, const T* __restrict__ y,
                                     T* __restrict__ x, T* coef, T* Rstore, unsigned* counts,
                                     int m, int n, int P, int64_t B, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.y, g = threadIdx.y, tc = threadIdx.x;
  const int lin = g * blockDim.x + tc, NT = blockDim.x * G, warp = lin >> 5, lane = lin & 31;
  const int teams = static_cast<int>(gridDim.x) / P, team = blockIdx.x / P;
  const int rank = blockIdx.x % P;
  const int slots = 2 * n + 1, Lc = (n + P) / P;  // local columns of CTA 0, the most
  T* ring = reinterpret_cast<T*>(smem);  // [slots][Lc]
  T* cs = ring + slots * Lc;             // the stage's (c, s) of pivot j at 2 j, 2 j + 1
  T* tcoef = coef + static_cast<int64_t>(team) * 4 * n;  // [2][2 n], by the stage's parity
  T* Rg = Rstore + static_cast<int64_t>(team) * (static_cast<int64_t>(n) * (n + 3) / 2);
  unsigned* count = counts + team;
  unsigned epoch = 0;
  const int c = rank + P * tc;  // this thread's column of the system
  const bool owns = tc < Lc && c <= n;
  T* mine = ring + tc;
  // R[i][col] of the store at row(i)[col], col = i .. n (col = n: Q^T y)
  auto row = [&](int i) {
    return Rg + static_cast<int64_t>(i) * (n + 1) - static_cast<int64_t>(i) * (i - 1) / 2 - i;
  };
  auto barrier = [&]() {
    lane::arrive(count);
    lane::wait(count, ++epoch * static_cast<unsigned>(P));
  };

#pragma unroll 1
  for (int64_t b = team; b < B; b += teams) {
    if (mode == 2) {
#pragma unroll 1
      for (int k = 0; k < m + n - 1; ++k) barrier();
      continue;
    }
    // row r of [A | y] into ring row r % slots, this thread's column (group 0)
    auto fetch = [&](int r) {
      if (owns && g == 0) {
        const T* src = c < n ? A + (static_cast<int64_t>(r) * n + c) * B + b
                             : y + static_cast<int64_t>(r) * B + b;
        __pipeline_memcpy_async(mine + (r % slots) * Lc, src, sizeof(T));
      }
      __pipeline_commit();
    };

    fetch(m - 1);
    if (m >= 2) fetch(m - 2);
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k <= m + n - 3; ++k) {
      if (k <= m - 3) fetch(m - 3 - k);
      const int j_lo = max(0, k - m + 2), j_hi = min(n - 1, k / 2);
      // ring row of window row 0, system row m - 2 - k (> -slots)
      int s0 = (m - 2 - k) % slots;
      if (s0 < 0) s0 += slots;
      T* gk = tcoef + (k & 1) * 2 * n;
      if (owns && g == 0 && c >= j_lo && c <= j_hi) {
        int rp = s0 + 2 * c;
        if (rp >= slots) rp -= slots;
        const int rq = rp + 1 == slots ? 0 : rp + 1;
        T cc, ss;
        givens(mine[rp * Lc], mine[rq * Lc], cc, ss);
        __stcg(gk + 2 * c, cc);
        __stcg(gk + 2 * c + 1, ss);
      }
      barrier();  // the stage's coefficients in the store
      for (int e = 2 * j_lo + lin; e <= 2 * j_hi + 1; e += NT) cs[e] = __ldcg(gk + e);
      __syncthreads();
      if (owns) {
        // this thread's rotations: j_lo + g, j_lo + g + G, .. up to its
        // column, two at a time (their row pairs are disjoint), loads
        // before stores
        const int j_end = min(j_hi, c);
        int j = j_lo + g;
#pragma unroll 1
        for (; j + G <= j_end; j += 2 * G) {
          const int j2 = j + G;
          int p1 = s0 + 2 * j, p2 = s0 + 2 * j2;
          if (p1 >= slots) p1 -= slots;
          if (p2 >= slots) p2 -= slots;
          const int q1 = p1 + 1 == slots ? 0 : p1 + 1, q2 = p2 + 1 == slots ? 0 : p2 + 1;
          const T c1 = cs[2 * j], s1 = cs[2 * j + 1], c2 = cs[2 * j2], s2 = cs[2 * j2 + 1];
          const T vp1 = mine[p1 * Lc], vq1 = mine[q1 * Lc];
          const T vp2 = mine[p2 * Lc], vq2 = mine[q2 * Lc];
          mine[p1 * Lc] = rn::add(rn::mul(c1, vp1), rn::mul(s1, vq1));
          mine[q1 * Lc] = rn::add(rn::mul(c1, vq1), rn::mul(-s1, vp1));
          mine[p2 * Lc] = rn::add(rn::mul(c2, vp2), rn::mul(s2, vq2));
          mine[q2 * Lc] = rn::add(rn::mul(c2, vq2), rn::mul(-s2, vp2));
        }
        if (j <= j_end) {
          int p = s0 + 2 * j;
          if (p >= slots) p -= slots;
          const int q = p + 1 == slots ? 0 : p + 1;
          const T cj = cs[2 * j], sj = cs[2 * j + 1];
          const T vp = mine[p * Lc], vq = mine[q * Lc];
          mine[p * Lc] = rn::add(rn::mul(cj, vp), rn::mul(sj, vq));
          mine[q * Lc] = rn::add(rn::mul(cj, vq), rn::mul(-sj, vp));
        }
      }
      // the next row landed; the next stage's pivots and rows are turned
      // (by any group of this CTA)
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    // R's rows 0 .. n - 1 sit in ring rows 0 .. n - 1: this CTA's columns
    // of them into the store
    if (owns)
      for (int i = g; i < n && i <= c; i += G) __stcg(row(i) + c, mine[i * Lc]);
    barrier();
    // R[:n, :n] x = (Q^T y)[:n] in CTA 0, in the twin's order: x in cs[0,
    // n), row i gathered into r = cs[n + (i & 1) (n + 1) ..] by the warps
    // past the first while the first thread runs row i + 1's chain: r[i] =
    // R[i][i], r[i + 1] = R[i][i + 1], r[col] = R[i][col] x[col] for col > i
    // + 1 (those x known by then), r[n] = (Q^T y)[i].  The chain forms only
    // R[i][i + 1] x[i + 1] itself
    if (mode == 0 && rank == 0) {
      T* xs = cs;
      auto gather = [&](int i) {
        T* r = cs + n + (i & 1) * (n + 1);
        const T* gi = row(i);
        for (int col = i + lin - 32; col <= n; col += NT - 32) {
          const T v = __ldcg(gi + col);
          r[col] = col > i + 1 && col < n ? rn::mul(v, xs[col]) : v;
        }
      };
      if (warp > 0) gather(n - 1);
#pragma unroll 1
      for (int i = n - 1; i >= 0; --i) {
        __syncthreads();  // row i gathered, x[i + 1] in place
        if (warp > 0) {
          if (i > 0) gather(i - 1);
        } else if (lane == 0) {
          const T* r = cs + n + (i & 1) * (n + 1);
          T acc = r[n];
          if (i + 1 < n) acc = rn::sub(acc, rn::mul(r[i + 1], xs[i + 1]));
          xs[i] = rn::div(rn::sub_each(acc, r, i + 2, n), r[i]);
          x[static_cast<int64_t>(i) * B + b] = xs[i];
        }
      }
    }
  }
}

// K2b-d's shared memory a CTA with P CTAs a lane: its columns of the ring,
// 2 n + 1 rows of ceil((n + 1) / P) words (CTA 0 holds the most), and 3 n +
// 2 words, a stage's 2 n coefficients or the back-substitution's x and two
// rows (ops/qr_wavefront.py's distributed_bytes)
template <typename T>
int64_t lsq_distributed_smem(int n, int P) {
  return (static_cast<int64_t>(2 * n + 1) * ((n + P) / P) + 3 * n + 2) * sizeof(T);
}

// K2b-d: blocks of (ceil((n + 1) / P), groups) threads an SM holds at once
// with P CTAs a lane, into ``blocks``
template <typename T>
int lsq_distributed_occupancy(int n, int P, int groups, int* blocks) {
  const int64_t smem = lsq_distributed_smem<T>(n, P);
  const int columns = (n + P) / P;
  if (n < 1 || P < 1 || groups < 1 || columns * groups < 64 || columns * groups > 1024 ||
      !blocks || smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = least_squares_distributed_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, columns * groups,
                                                      static_cast<size_t>(smem));
  return static_cast<int>(err);
}

// K2b-d's launch: ``teams`` teams of P CTAs of (ceil((n + 1) / P), groups)
// threads in one cooperative launch; coef 4 n words a team, R its store of
// n (n + 3) / 2 words a team, counts one zeroed counter a team
template <typename T>
int launch_distributed(const T* A, const T* y, T* x, T* coef, T* R, unsigned* counts, int m,
                       int n, int64_t B, int P, int teams, int groups, int mode,
                       cudaStream_t st) {
  const int64_t smem = lsq_distributed_smem<T>(n, P);
  const int columns = (n + P) / P;
  if (n < 1 || m < n || B < 1 || P < 1 || teams < 1 || groups < 1 || columns * groups < 64 ||
      columns * groups > 1024 || mode < 0 || mode > 2 || smem > kMaxDynamicSmem ||
      static_cast<int64_t>(teams) * P > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = least_squares_distributed_kernel<T>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  void* args[] = {&A, &y, &x, &coef, &R, &counts, &m, &n, &P, &B, &mode};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(teams * P)),
      dim3(columns, groups), args, static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K2a-w, one warp a lane.  Replaces qr_wavefront_pallas
// (nlsolver_tpu/ops/qr_wavefront.py:114) where a lane's [R | Q^T] fits a
// block's shared memory.  What bounds K2a with a thread a lane: each
// lane's chain of some m n rotations, every one a round trip of two rows
// of R and of Q^T through L2, with 4096 lanes on 16 of the 132 SMs.  K2b-w's
// scheme applied to the QR:
//   * a lane's [R | Q^T] is one m x (n + m) array (m x n without Q), in
//     the warp's shared memory, [row][column]; thread t owns columns t,
//     t + 32, .., so a warp's accesses fall in distinct banks;
//   * at each of the m + n - 2 stages the threads owning the stage's pivot
//     columns j form every (c, s) at once from R[p, j] and R[q, j], into a
//     row of 2 n coefficients; after a warp barrier every thread turns its
//     own columns of every row pair of the stage, all n columns of R, as
//     the twin does, so that R is bit-equal below the diagonal too, and all
//     m columns of Q^T.  A second warp barrier keeps the next stage's
//     coefficients off the row until every thread has read it; a thread
//     forms a pivot only from columns it turned itself;
//   * a block's W lanes (one warp each) fetch A entry by entry together, W
//     neighbouring words an entry, by cp.async, and store R and Q^T the
//     same way; a warp's words are odd in number, so the W words of an
//     entry fall in distinct banks.
// A warp needs m (n + m) + 2 n words (m n + 2 n without Q): m = n <= 169 in
// f32 and 120 in f64 with Q.  One kernel per Q = ceil(columns / 32), the
// words a thread a row, so a thread's columns unroll.  Every value goes
// through the twin's operations in its order, so R and Q equal the twin's
// bit for bit.
template <typename T, bool kQ, int Q>
__global__ void qr_warp_kernel(const T* __restrict__ A, T* __restrict__ R, T* __restrict__ Qt,
                               int m, int n, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, shift = __ffs(W) - 1;  // lanes a block, a power of two
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int cols = kQ ? n + m : n;
  const int words = (m * cols + 2 * n) | 1;
  T* all = reinterpret_cast<T*>(smem);
  T* X = all + warp * words;
  T* coef = X + m * cols;  // (c, s) of pivot column j at 2 j, 2 j + 1
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * W;
  const bool live = b0 + warp < B;

  for (int e = threadIdx.x; e < (m * n) << shift; e += blockDim.x) {
    const int at = e >> shift, w = e & (W - 1);
    if (b0 + w < B) {
      const int i = at / n, c = at - i * n;
      __pipeline_memcpy_async(all + w * words + i * cols + c,
                              A + static_cast<int64_t>(at) * B + b0 + w, sizeof(T));
    }
  }
  __pipeline_commit();
  if (kQ)
    for (int e = t; e < m * m; e += 32) {
      const int i = e / m, j = e - i * m;
      X[i * cols + n + j] = T(i == j);
    }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (live) {
#pragma unroll 1
    for (int k = 0; k <= m + n - 3; ++k) {
      const int j_lo = max(0, k - m + 2), j_hi = min(n - 1, k / 2);
      // the rotation of column j turns rows (p, p + 1), p = m - 2 - k + 2 j
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int j = t + 32 * q;
        if (j >= j_lo && j <= j_hi) {
          const T* xp = X + (m - 2 - k + 2 * j) * cols;
          givens(xp[j], xp[cols + j], coef[2 * j], coef[2 * j + 1]);
        }
      }
      __syncwarp();
#pragma unroll 1
      for (int j = j_lo; j <= j_hi; ++j) {
        const T c = coef[2 * j], s = coef[2 * j + 1];
        T* xp = X + (m - 2 - k + 2 * j) * cols;
        T* xq = xp + cols;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int col = t + 32 * q;
          if (col < cols) {
            const T vp = xp[col], vq = xq[col];
            xp[col] = rn::add(rn::mul(c, vp), rn::mul(s, vq));
            xq[col] = rn::add(rn::mul(c, vq), rn::mul(-s, vp));
          }
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (m * n) << shift; e += blockDim.x) {
    const int at = e >> shift, w = e & (W - 1);
    if (b0 + w < B) {
      const int i = at / n, c = at - i * n;
      R[static_cast<int64_t>(at) * B + b0 + w] = all[w * words + i * cols + c];
    }
  }
  if (kQ)
    for (int e = threadIdx.x; e < (m * m) << shift; e += blockDim.x) {
      const int at = e >> shift, w = e & (W - 1);
      if (b0 + w < B) {
        const int i = at / m, j = at - i * m;
        Qt[static_cast<int64_t>(at) * B + b0 + w] = all[w * words + i * cols + n + j];
      }
    }
}

// K2a-w's words a thread a row, Q = ceil(cols / 32), by word size and by
// whether Q^T is formed: the widest arrays that fit 232448 bytes, m = n =
// 169 with Q in f32 (338 columns) and 120 in f64 (240), n = 240 and 169
// without
constexpr int kQrWarpMaxQ32 = 11, kQrWarpMaxQ64 = 8, kQrWarpMaxR32 = 8, kQrWarpMaxR64 = 6;

template <typename T, bool kQ, int Q>
int launch_qr_warp(const T* A, T* R, T* Qt, int m, int n, int64_t B, int lanes, cudaStream_t s) {
  const int cols = kQ ? n + m : n;
  if constexpr (Q > 1) {
    if (cols <= 32 * (Q - 1)) return launch_qr_warp<T, kQ, Q - 1>(A, R, Qt, m, n, B, lanes, s);
  }
  const int64_t smem = static_cast<int64_t>(lanes) * ((m * cols + 2 * n) | 1) * sizeof(T);
  if (n < 1 || m < n || B < 1 || cols > 32 * Q || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(qr_warp_kernel<T, kQ, Q>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + lanes - 1) / lanes);
  qr_warp_kernel<T, kQ, Q><<<blocks, 32 * lanes, smem, s>>>(A, R, Qt, m, n, B);
  return static_cast<int>(cudaGetLastError());
}

// a CTA's share of a stage of K2a-c and K2a-d: rotations j0, j0 + G, .. up
// to j_hi of the stage whose pivot pair j turns rows (p0 + 2 j, p0 + 2 j +
// 1), on the local column ``mine`` of a [m][Lc] array, two at a time (their
// row pairs are disjoint), loads before stores; (c, s) of pivot j at cs[2
// j], cs[2 j + 1]
template <typename T>
__device__ __forceinline__ void turn_column(T* mine, const T* cs, int Lc, int p0, int j0, int j_hi,
                                            int G) {
  int j = j0;
#pragma unroll 1
  for (; j + G <= j_hi; j += 2 * G) {
    const int j2 = j + G;
    T* x1 = mine + (p0 + 2 * j) * Lc;
    T* x2 = mine + (p0 + 2 * j2) * Lc;
    const T c1 = cs[2 * j], s1 = cs[2 * j + 1], c2 = cs[2 * j2], s2 = cs[2 * j2 + 1];
    const T vp1 = x1[0], vq1 = x1[Lc], vp2 = x2[0], vq2 = x2[Lc];
    x1[0] = rn::add(rn::mul(c1, vp1), rn::mul(s1, vq1));
    x1[Lc] = rn::add(rn::mul(c1, vq1), rn::mul(-s1, vp1));
    x2[0] = rn::add(rn::mul(c2, vp2), rn::mul(s2, vq2));
    x2[Lc] = rn::add(rn::mul(c2, vq2), rn::mul(-s2, vp2));
  }
  if (j <= j_hi) {
    T* x = mine + (p0 + 2 * j) * Lc;
    const T c = cs[2 * j], s = cs[2 * j + 1];
    const T vp = x[0], vq = x[Lc];
    x[0] = rn::add(rn::mul(c, vp), rn::mul(s, vq));
    x[Lc] = rn::add(rn::mul(c, vq), rn::mul(-s, vp));
  }
}

// column c of a lane's [A | I] (c < n: A's column c, by cp.async; else Q^T's
// identity column c - n) into the local column ``mine`` of a [m][Lc] array,
// rows g, g + G, ..
template <typename T>
__device__ __forceinline__ void load_column(T* mine, const T* __restrict__ A, int m, int n, int c,
                                            int Lc, int g, int G, int64_t B, int64_t b) {
  if (c < n) {
    for (int i = g; i < m; i += G)
      __pipeline_memcpy_async(mine + i * Lc, A + (static_cast<int64_t>(i) * n + c) * B + b,
                              sizeof(T));
  } else {
    for (int i = g; i < m; i += G) mine[i * Lc] = T(i == c - n);
  }
  __pipeline_commit();
}

// column c of a lane's finished [R | Q^T] from the local column ``mine``
// into R [m, n, B] (c < n) or Q^T [m, m, B], rows g, g + G, ..
template <typename T>
__device__ __forceinline__ void store_column(const T* mine, T* __restrict__ R, T* __restrict__ Qt,
                                             int m, int n, int c, int Lc, int g, int G, int64_t B,
                                             int64_t b) {
  for (int i = g; i < m; i += G) {
    const T v = mine[i * Lc];
    if (c < n)
      R[(static_cast<int64_t>(i) * n + c) * B + b] = v;
    else
      Qt[(static_cast<int64_t>(i) * m + c - n) * B + b] = v;
  }
}

// K2a-c, one lane a thread-block cluster.  Replaces qr_wavefront_pallas
// (nlsolver_tpu/ops/qr_wavefront.py:114) past K2a-w's range, where one
// lane's [R | Q^T] no longer fits an SM (232564 bytes at [170, 170] in f32
// with Q).  What bounds the device-memory form there: one thread carries a
// lane's chain of some m n rotations, each a round trip of two rows of n +
// m words through L2, and 32 lanes are 32 threads on 132 SMs (809 ms at
// [170, 170, 32] f32 with Q, 46x torch.linalg.qr).  K2b-c's scheme on
// K2a-w's resident array:
//   * column c of the lane's m x (n + m) array [R | Q^T] (m x n without Q)
//     lives in CTA c % C at local column c / C, [row][local column], so
//     every CTA holds about as many columns as the others; A's columns are
//     fetched once by cp.async and Q^T's identity is formed in place;
//   * at each of the m + n - 2 stages the owner of pivot column j (group
//     0) forms (c, s) from its own column and stores the pair into the
//     coefficient row of the stage's parity of every CTA of the cluster
//     (distributed shared memory); one cluster barrier follows, then each
//     CTA's G groups of threads share out the stage's row pairs (g takes
//     j_lo + g, j_lo + g + G, ..) over its local columns, all n columns of
//     R, as the twin does, so that R is bit-equal below the diagonal too,
//     and all m columns of Q^T.  A CTA writes row (k + 1) & 1 only past
//     barrier k, when every CTA has read it for stage k - 1, so one barrier
//     a stage is enough; a block barrier ends the stage, so that the next
//     pivots see every group's turns;
//   * each CTA stores its columns of R and Q^T at the end.
// ``mode`` 1 skips the rotations and 2 runs the cluster barriers alone (the
// benches' probe of what a stage costs).  Every value goes through the
// twin's operations in its order, so R and Q equal the twin's bit for bit.
template <typename T>
__global__ void __launch_bounds__(1024)
    qr_cluster_kernel(const T* __restrict__ A, T* __restrict__ R, T* __restrict__ Qt, int m,
                      int n, int64_t B, int compute_q, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = blockDim.y, g = threadIdx.y, tc = threadIdx.x;
  const int cols = compute_q ? n + m : n, Lc = (cols + C - 1) / C;  // CTA 0's columns, the most
  const int64_t b = blockIdx.x / C;
  T* X = reinterpret_cast<T*>(smem);  // [m][Lc]
  T* coef = X + m * Lc;               // [2][2 n]: (c, s) of pivot j at 2 j, 2 j + 1
  const int c = rank + C * tc;        // this thread's column of [R | Q^T]
  const bool owns = tc < Lc && c < cols;
  T* mine = X + tc;

  if (owns && mode != 2) load_column(mine, A, m, n, c, Lc, g, G, B, b);
  __pipeline_wait_prior(0);
  // the lane's array in place; every CTA runs before any writes into another's
  cluster.sync();
#pragma unroll 1
  for (int k = 0; k <= m + n - 3; ++k) {
    if (mode == 2) {
      cluster.sync();
      continue;
    }
    const int j_lo = max(0, k - m + 2), j_hi = min(n - 1, k / 2);
    const int p0 = m - 2 - k;  // pivot j turns rows (p0 + 2 j, p0 + 2 j + 1)
    T* buf = coef + (k & 1) * 2 * n;
    if (owns && g == 0 && c >= j_lo && c <= j_hi) {
      T cc, ss;
      givens(mine[(p0 + 2 * c) * Lc], mine[(p0 + 2 * c + 1) * Lc], cc, ss);
      for (int r = 0; r < C; ++r) {
        T* dst = cluster.map_shared_rank(buf, r);
        dst[2 * c] = cc;
        dst[2 * c + 1] = ss;
      }
    }
    cluster.sync();  // the stage's coefficients in every CTA
    if (owns && mode == 0) turn_column(mine, buf, Lc, p0, j_lo + g, j_hi, G);
    __syncthreads();
  }
  if (owns && mode != 2) store_column(mine, R, Qt, m, n, c, Lc, g, G, B, b);
}

// K2a-c's launch: C CTAs a lane (2, 4 or 8), threads (columns, groups) a
// CTA, the column threads a multiple of 32 that covers CTA 0's columns
template <typename T>
int launch_qr_cluster(const T* A, T* R, T* Qt, int m, int n, int64_t B, int compute_q, int C,
                      int columns, int groups, int mode, cudaStream_t st) {
  const int cols = compute_q ? n + m : n, Lc = (cols + C - 1) / C;
  const int64_t smem = (static_cast<int64_t>(m) * Lc + 4 * n) * sizeof(T);
  if (n < 1 || m < n || B < 1 || (C != 2 && C != 4 && C != 8) || columns < Lc ||
      columns % 32 || groups < 1 || columns * groups > 1024 || mode < 0 || mode > 2 ||
      smem > kMaxDynamicSmem || B * C > (int64_t{1} << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = qr_cluster_kernel<T>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * C));
  cfg.blockDim = dim3(columns, groups);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, A, R, Qt, m, n, B, compute_q, mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K2a-d, one lane over P CTAs of the whole card.  Replaces
// qr_wavefront_pallas (nlsolver_tpu/ops/qr_wavefront.py:114) past K2a-c's
// range, where 8 CTAs' shared memory no longer holds one lane's [R | Q^T]
// (1.78 MB at [333, 333] in f64 with Q).  What bounds the device-memory
// form there: one thread carries a lane's chain of some m n rotations,
// each a round trip of two rows through L2, and 2 lanes are 2 threads on
// 132 SMs.  K2a-c's scheme over any number P of CTAs, with device memory in
// place of distributed shared memory, as K2b-d without its
// back-substitution:
//   * column c of [R | Q^T] lives in CTA c % P at local column c / P;
//     thread (tc, g) of a CTA holds local column tc and takes the g-th,
//     (g + G)-th, .. of a stage's rotations;
//   * at each stage the owner of pivot column j forms (c, s) from its own
//     column and stores the pair into the team's coefficient row in device
//     memory; one barrier in device memory (lane_barrier.cuh) follows, then
//     every CTA copies the stage's coefficients from L2 into its shared
//     memory and turns its own columns by them.  The row is chosen by the
//     parity of the barriers the team has passed, which runs on from one
//     lane to the next: a CTA writes a row only past the barrier after
//     every CTA copied it, so two rows and one barrier a stage are enough,
//     and no barrier sits between two lanes;
//   * each CTA stores its columns of R and Q^T at the end of a lane;
//   * every CTA of a team is resident by one cooperative launch, and a grid
//     of ``teams`` teams walks the lanes, team g taking lanes g, g + teams,
//     ..
// ``mode`` 1 skips the rotations and 2 runs the barriers alone (the
// benches' probe of what a stage costs).  Every value goes through the
// twin's operations in its order, so R and Q equal the twin's bit for bit.
// (With __launch_bounds__(1024) alone ptxas held the float kernel to 32
// registers and spilled; a minimum of one block an SM lifts that.)
template <typename T>
__global__ void __launch_bounds__(1024, 1)
    qr_distributed_kernel(const T* __restrict__ A, T* __restrict__ R, T* __restrict__ Qt,
                          T* coef, unsigned* counts, int m, int n, int P, int64_t B,
                          int compute_q, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.y, g = threadIdx.y, tc = threadIdx.x;
  const int lin = g * blockDim.x + tc, NT = blockDim.x * G;
  const int teams = static_cast<int>(gridDim.x) / P, team = blockIdx.x / P;
  const int rank = blockIdx.x % P;
  const int cols = compute_q ? n + m : n, Lc = (cols + P - 1) / P;  // CTA 0's columns, the most
  T* X = reinterpret_cast<T*>(smem);  // [m][Lc]
  T* cs = X + m * Lc;                 // the stage's (c, s) of pivot j at 2 j, 2 j + 1
  T* tcoef = coef + static_cast<int64_t>(team) * 4 * n;  // [2][2 n], by the barriers' parity
  unsigned* count = counts + team;
  unsigned epoch = 0;
  const int c = rank + P * tc;  // this thread's column of [R | Q^T]
  const bool owns = tc < Lc && c < cols;
  T* mine = X + tc;
  auto barrier = [&]() {
    lane::arrive(count);
    lane::wait(count, ++epoch * static_cast<unsigned>(P));
  };

#pragma unroll 1
  for (int64_t b = team; b < B; b += teams) {
    if (mode == 2) {
#pragma unroll 1
      for (int k = 0; k <= m + n - 3; ++k) barrier();
      continue;
    }
    if (owns) load_column(mine, A, m, n, c, Lc, g, G, B, b);
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k <= m + n - 3; ++k) {
      const int j_lo = max(0, k - m + 2), j_hi = min(n - 1, k / 2);
      const int p0 = m - 2 - k;  // pivot j turns rows (p0 + 2 j, p0 + 2 j + 1)
      T* gk = tcoef + (epoch & 1) * 2 * n;
      if (owns && g == 0 && c >= j_lo && c <= j_hi) {
        T cc, ss;
        givens(mine[(p0 + 2 * c) * Lc], mine[(p0 + 2 * c + 1) * Lc], cc, ss);
        __stcg(gk + 2 * c, cc);
        __stcg(gk + 2 * c + 1, ss);
      }
      barrier();  // the stage's coefficients in the store
      for (int e = 2 * j_lo + lin; e <= 2 * j_hi + 1; e += NT) cs[e] = __ldcg(gk + e);
      __syncthreads();
      if (owns && mode == 0) turn_column(mine, cs, Lc, p0, j_lo + g, j_hi, G);
      __syncthreads();
    }
    if (owns) store_column(mine, R, Qt, m, n, c, Lc, g, G, B, b);
    __syncthreads();  // the next lane's columns overwrite these
  }
}

// K2a-d's shared memory a CTA with P CTAs a lane: its columns of [R | Q^T],
// m rows of ceil(cols / P) words (CTA 0 holds the most), and a stage's 2 n
// coefficients (ops/qr_wavefront.py's qr_distributed_bytes)
template <typename T>
int64_t qr_distributed_smem(int m, int n, int compute_q, int P) {
  const int cols = compute_q ? n + m : n;
  return (static_cast<int64_t>(m) * ((cols + P - 1) / P) + 2 * n) * sizeof(T);
}

// K2a-d: blocks of (ceil(cols / P), groups) threads an SM holds at once
// with P CTAs a lane, into ``blocks``
template <typename T>
int qr_distributed_occupancy(int m, int n, int compute_q, int P, int groups, int* blocks) {
  const int64_t smem = qr_distributed_smem<T>(m, n, compute_q, P);
  const int columns = ((compute_q ? n + m : n) + P - 1) / P;
  if (n < 1 || m < n || P < 1 || groups < 1 || columns * groups > 1024 || !blocks ||
      smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = qr_distributed_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, columns * groups,
                                                      static_cast<size_t>(smem));
  return static_cast<int>(err);
}

// K2a-d's launch: ``teams`` teams of P CTAs of (ceil(cols / P), groups)
// threads in one cooperative launch; coef 4 n words a team, counts one
// zeroed counter a team
template <typename T>
int launch_qr_distributed(const T* A, T* R, T* Qt, T* coef, unsigned* counts, int m, int n,
                          int64_t B, int compute_q, int P, int teams, int groups, int mode,
                          cudaStream_t st) {
  const int64_t smem = qr_distributed_smem<T>(m, n, compute_q, P);
  const int columns = ((compute_q ? n + m : n) + P - 1) / P;
  if (n < 1 || m < n || B < 1 || P < 1 || teams < 1 || groups < 1 || columns * groups > 1024 ||
      mode < 0 || mode > 2 || smem > kMaxDynamicSmem ||
      static_cast<int64_t>(teams) * P > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = qr_distributed_kernel<T>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  void* args[] = {&A, &R, &Qt, &coef, &counts, &m, &n, &P, &B, &compute_q, &mode};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(teams * P)),
      dim3(columns, groups), args, static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K2a-p, past K2a-d's range: R's rotations logged, Q^T rebuilt from the
// log.  Replaces qr_wavefront_pallas (nlsolver_tpu/ops/qr_wavefront.py:114)
// where 132 CTAs' shared memory no longer holds a lane's [R | Q^T] (m = n
// from 1875 in f32 and 1321 in f64 with Q, 2641 and 1817 without).  What
// bounds K2a-g there: one thread carries a lane's chain of some m n
// rotations, each a round trip of two rows of n + m words through L2 (some
// 6 minutes for two f64 lanes at m = n = 1321).  Two facts shape K2a-p:
// Q^T never forms a rotation, it only receives them in stage order; and
// for a fixed row r pivot j turns it at stages m - 2 + 2 j - r and m - 1 +
// 2 j - r, so every element receives the rotations of lower pivots before
// those of higher ones, and pivot j's coefficients read rows that no
// higher pivot has turned yet.  So:
//   * phase 1 (qr_panel_kernel, one cooperative launch a panel): a panel
//     of R's columns j0 .. j1 - 1 lies over P CTAs' shared memory, column c
//     in CTA (c - j0) % P, as K2a-d lays out [R | Q^T].  At each stage up to
//     the last one with a pivot below j1, the owners of the panel's pivots
//     form (c, s) and append them to the lane's rotation log in device
//     memory (stage k's pivots j_lo .. j_hi at pairs log_offset(k) + j -
//     j_lo), one barrier in device memory follows, and every CTA turns its
//     columns by the stage's pivots below j1, read from the log.  A pivot's
//     two rows take only two of the stage before's rotations, so its owner
//     forms its (c, s) a stage ahead, right after that stage's
//     coefficients arrive, and the CTA arrives at the barrier before it
//     turns its columns: the barrier's latency hides behind the turns, as
//     K2b-d's and K3-d's do.  The stages before the panel's first pivot (2
//     j0) only replay earlier panels' pivots from the log: no barrier.  A stage's coefficients are copied
//     into shared memory, at most min(n, m / 2 + 1) pairs.  R fits one
//     panel up to m = n = 2641 in f32, 1848 in f64; past that, panels as
//     wide as the card holds;
//   * phase 2 (qr_replay_kernel, one plain launch): each CTA takes a tile
//     of w columns, all m rows, in shared memory (Q^T from the identity, or
//     an earlier panel's columns of R, which still lack the rotations of
//     pivots from j1 on), streams the log in stage order and writes the
//     tile once.  A warp takes 32 pivots of a stage, their (c, s) in
//     registers, and turns them over a share of the tile's columns; rows
//     are kept by parity, so the 32 row pairs of a warp are 32 neighbouring
//     words of each half.  One block barrier a stage, no barrier across
//     the card.
// The log holds n (m - 1) - n (n - 1) / 2 pairs a lane, 14.1 MB at m = n =
// 1875 in f32: it stays in the 50 MB L2 between the phases.  What bounds
// K2a-p on an H100: phase 1's m + n - 2 stages, each a wait on the card's
// L2 for the stage's coefficients (some 2.7 us a stage at [1321, 1321, 2]
// in f64 over 132 CTAs), far above its operations; phase 2's turns through
// shared memory, a block barrier a stage (PERF.md).  Every element
// receives the twin's rotations in stage order, each rounded as
// rotate_rows rounds it, all m columns of Q^T included, so R and Q equal
// the twin's bit for bit.
__host__ __device__ inline int64_t log_offset(int k, int m, int n) {
  // stage k' < k turns pivots max(0, k' - m + 2) .. min(n - 1, k' / 2)
  const int64_t K = k < 2 * n ? k : 2 * n, a = K / 2, r = K % 2;
  int64_t below = (a + 1) * (a + r) + (k > 2 * n ? static_cast<int64_t>(k - 2 * n) * n : 0);
  const int64_t t = static_cast<int64_t>(k) - (m - 2);
  return below - (t > 0 ? t * (t - 1) / 2 : 0);
}

// Phase 1 of K2a-p (kSolve false) and of K2b-p (kSolve true, below) on the
// panel of columns j0 .. j1 - 1.  K2b-p's columns are those of [A | y]: y is
// column n, in the last panel (j1 = n + 1), and forms no pivot; a column
// takes only the pivots up to its own (the rest turn entries below R's
// diagonal, zero by then, which x never reads), and its entries on and
// above the diagonal go to the lane's store (R's row i, columns i .. n, at
// i (n + 1) - i (i - 1) / 2); K2a-p's columns take every pivot and all of
// R is written.
template <typename T, bool kSolve>
__device__ __forceinline__ void panel_stages(const T* __restrict__ A, const T* __restrict__ y,
                                             T* __restrict__ R, T* rlog, unsigned* counts, int m,
                                             int n, int j0, int j1, int P, int64_t B,
                                             int64_t pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.y, g = threadIdx.y, tc = threadIdx.x;
  const int lin = g * blockDim.x + tc, NT = blockDim.x * G;
  const int teams = static_cast<int>(gridDim.x) / P, team = blockIdx.x / P;
  const int rank = blockIdx.x % P;
  const int Lc = (j1 - j0 + P - 1) / P;  // CTA 0's columns, the most
  T* X = reinterpret_cast<T*>(smem);     // [m][Lc]
  T* cs = X + m * Lc;                    // the stage's (c, s), pivot j at 2 (j - j_lo)
  unsigned* count = counts + team;
  unsigned epoch = 0;
  const int c = j0 + rank + P * tc;  // this thread's column of R
  const bool owns = tc < Lc && c < j1;
  T* mine = X + tc;
  const int k_end = min(m + n - 3, m - 3 + j1);  // the last stage with a pivot below j1
  // whether stage k has pivots of this panel, j0 .. j1 - 1
  auto own = [&](int k) { return min(min(n - 1, k / 2), j1 - 1) >= max(max(0, k - m + 2), j0); };

#pragma unroll 1
  for (int64_t b = team; b < B; b += teams) {
    T* lg = rlog + b * 2 * pairs;
    if (owns) {
      if (kSolve && c == n) {
        for (int i = g; i < m; i += G)
          __pipeline_memcpy_async(mine + i * Lc, y + static_cast<int64_t>(i) * B + b, sizeof(T));
        __pipeline_commit();
      } else {
        load_column(mine, A, m, n, c, Lc, g, G, B, b);
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    if (k_end >= 0 && own(0)) {
      // stage 0's one pivot, column 0's rows m - 2 and m - 1
      if (owns && g == 0 && c == 0) {
        T cc, ss;
        givens(mine[(m - 2) * Lc], mine[(m - 1) * Lc], cc, ss);
        __stcg(lg, cc);
        __stcg(lg + 1, ss);
      }
      lane::arrive(count);
    }
    int64_t off = 0;  // log_offset(k)
#pragma unroll 1
    for (int k = 0; k <= k_end; ++k) {
      const int j_lo = max(0, k - m + 2), j_hi = min(n - 1, k / 2), hi = min(j_hi, j1 - 1);
      const int p0 = m - 2 - k;  // pivot j turns rows (p0 + 2 j, p0 + 2 j + 1)
      if (own(k)) lane::wait(count, ++epoch * static_cast<unsigned>(P));
      for (int e = lin; e < 2 * (hi - j_lo + 1); e += NT) cs[e] = __ldcg(lg + 2 * off + e);
      __syncthreads();
      const int64_t next = off + j_hi - j_lo + 1;  // log_offset(k + 1)
      if (k < k_end && own(k + 1)) {
        // stage k + 1's pivots ahead of the rest of stage k: pivot c reads
        // rows (p0 - 1 + 2 c, p0 + 2 c), which stage k's rotations c - 1
        // (its second row) and c (its first) turn, each as turn_column
        // will, so its (c, s) go into the log and the CTA arrives before it
        // turns its columns, and the barrier's wait hides behind that work
        const int lo1 = max(max(0, k + 1 - m + 2), j0), hi1 = min(min(n - 1, (k + 1) / 2), j1 - 1);
        if (owns && g == 0 && c >= lo1 && c <= hi1) {
          const int ra = p0 - 1 + 2 * c, rb = ra + 1;
          T va = mine[ra * Lc], vb = mine[rb * Lc];
          if (c - 1 >= j_lo && c - 1 <= hi) {
            const T cc = cs[2 * (c - 1 - j_lo)], ss = cs[2 * (c - 1 - j_lo) + 1];
            va = rn::add(rn::mul(cc, va), rn::mul(-ss, mine[(ra - 1) * Lc]));
          }
          if (c >= j_lo && c <= hi) {
            const T cc = cs[2 * (c - j_lo)], ss = cs[2 * (c - j_lo) + 1];
            vb = rn::add(rn::mul(cc, vb), rn::mul(ss, mine[(rb + 1) * Lc]));
          }
          T cc, ss;
          givens(va, vb, cc, ss);
          const int j_lo1 = max(0, k + 1 - m + 2);
          __stcg(lg + 2 * (next + c - j_lo1), cc);
          __stcg(lg + 2 * (next + c - j_lo1) + 1, ss);
        }
        lane::arrive(count);  // its block barrier first: the reads above precede the turns
      }
      if (owns) turn_column(mine, cs - 2 * j_lo, Lc, p0, j_lo + g, kSolve ? min(hi, c) : hi, G);
      __syncthreads();
      off = next;
    }
    if (owns && kSolve) {
      T* Rg = R + b * (static_cast<int64_t>(n) * (n + 3) / 2);
      for (int i = g; i <= c && i < n; i += G)
        Rg[static_cast<int64_t>(i) * (n + 1) - static_cast<int64_t>(i) * (i - 1) / 2 - i + c] =
            mine[i * Lc];
    } else if (owns) {
      for (int i = g; i < m; i += G) R[(static_cast<int64_t>(i) * n + c) * B + b] = mine[i * Lc];
    }
    __syncthreads();  // the next lane's columns overwrite these
  }
}

template <typename T>
__global__ void __launch_bounds__(1024, 1)
    qr_panel_kernel(const T* __restrict__ A, T* __restrict__ R, T* rlog, unsigned* counts,
                    int m, int n, int j0, int j1, int P, int64_t B, int64_t pairs) {
  panel_stages<T, false>(A, nullptr, R, rlog, counts, m, n, j0, j1, P, B, pairs);
}

// K2b-p, past K2b-d's range.  Replaces least_squares_wavefront_pallas
// (nlsolver_tpu/ops/qr_wavefront.py:168) where 132 CTAs' shared memory no
// longer holds a lane's window (n from 1848 in f32, 1263 in f64).  What
// bounds K2b-g there: one thread carries a lane's chain of some m n
// rotations, each a round trip of two rows through L2, and the card's other
// SMs sit idle (1.25 s at [330, 330, 2] f64, some n^3 growth past it).
// K2a-p's first phase on the columns of [A | y] (panel_stages<T, true>):
//   * R forms over the whole card, a panel of columns over P CTAs' shared
//     memory, each stage's (c, s) appended to the lane's log in device
//     memory, one barrier in device memory a stage, the next stage's pivots
//     formed ahead of it, one cooperative launch a panel;
//   * y is column n of the last panel, whose stages before its first pivot
//     replay the earlier panels' pivots from the log, so y holds Q^T y when
//     the last panel ends: no replay launch.  The earlier panels' columns
//     are not replayed at all: the later pivots turn only their entries
//     below R's diagonal, which x never reads;
//   * each panel stores its columns' rows 0 .. n - 1 on and above the
//     diagonal into the lane's store in device memory; then
//     lstsq_backsolve_kernel, a CTA a lane, solves R[:n, :n] x = (Q^T y)[:n]
//     in the twin's order (linalg/qr_parallel.py's backsolve_bm): for i from
//     n - 1 down, acc = (Q^T y)[i], less R[i][j] x[j] for j ascending, over
//     R[i][i].  Its first thread runs row i's chain of rounded
//     subtractions (rn::sub_each, unrolled by 16) while the other warps
//     fetch row i - 1 from L2 and form its products with x off the chain,
//     as K2b-d's back solve does; the lanes' solves run at once, a CTA
//     each, after every panel, where inside the last panel's launch they
//     would hold up the team's next lane.
// What bounds K2b-p on an H100: phase 1's m + n - 2 stages, each a wait on
// the card's L2 (K2a-p's), and the back solve's chain of n (n - 1) / 2
// dependent subtractions (some 10 clocks each), both far above the
// operations.  Every value goes through the twin's operations in its
// order, so x is the twin's bit for bit.
template <typename T>
__global__ void __launch_bounds__(1024, 1)
    lstsq_panel_kernel(const T* __restrict__ A, const T* __restrict__ y, T* __restrict__ Rstore,
                       T* rlog, unsigned* counts, int m, int n, int j0, int j1, int P, int64_t B,
                       int64_t pairs) {
  panel_stages<T, true>(A, y, Rstore, rlog, counts, m, n, j0, j1, P, B, pairs);
}

constexpr int kBacksolveThreads = 512;

// K2b-p's back solve, a CTA a lane: R's rows and Q^T y from the lane's
// store, x [n, B] through L2 (__stcg by the first thread, __ldcg by the
// other warps past a block barrier), row i gathered into r = rows + (i & 1)
// (n + 1): r[i] = R[i][i], r[i + 1] = R[i][i + 1], r[col] = R[i][col]
// x[col] for col > i + 1 (those x known by then), r[n] = (Q^T y)[i].  The
// chain forms only R[i][i + 1] x[i + 1] itself
template <typename T>
__global__ void __launch_bounds__(kBacksolveThreads)
    lstsq_backsolve_kernel(const T* __restrict__ Rstore, T* x, int n, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* rows = reinterpret_cast<T*>(smem);  // [2][n + 1]
  const int64_t b = blockIdx.x;
  const T* Rg = Rstore + b * (static_cast<int64_t>(n) * (n + 3) / 2);
  const int t = threadIdx.x, NT = blockDim.x;
  auto gather = [&](int i) {
    T* r = rows + (i & 1) * (n + 1);
    const T* gi = Rg + static_cast<int64_t>(i) * (n + 1) - static_cast<int64_t>(i) * (i - 1) / 2 - i;
    for (int col = i + t - 32; col <= n; col += NT - 32) {
      const T v = __ldcg(gi + col);
      r[col] = col > i + 1 && col < n ? rn::mul(v, __ldcg(x + static_cast<int64_t>(col) * B + b))
                                      : v;
    }
  };
  if (t >= 32) gather(n - 1);
  T x1 = T(0);  // x[i + 1]
#pragma unroll 1
  for (int i = n - 1; i >= 0; --i) {
    __syncthreads();  // row i gathered, x[i + 1] in place
    if (t >= 32) {
      if (i > 0) gather(i - 1);
    } else if (t == 0) {
      const T* r = rows + (i & 1) * (n + 1);
      T acc = r[n];
      if (i + 1 < n) acc = rn::sub(acc, rn::mul(r[i + 1], x1));
      x1 = rn::div(rn::sub_each(acc, r, i + 2, n), r[i]);
      __stcg(x + static_cast<int64_t>(i) * B + b, x1);
    }
  }
}

// columns c0 .. c0 + cols - 1 of X [m, ld, B] receive the rotations of
// pivots jfrom .. n - 1 from their lane's log, a tile of w columns a CTA:
// X starts as the identity (``identity``, Q^T) or as stored
template <typename T>
__global__ void __launch_bounds__(512)
    qr_replay_kernel(T* __restrict__ X, const T* __restrict__ rlog, int m, int n, int ld, int c0,
                     int cols, int w, int jfrom, int identity, int64_t B, int64_t pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = (cols + w - 1) / w;
  const int64_t b = blockIdx.x / tiles;
  const int first = c0 + static_cast<int>(blockIdx.x % tiles) * w;
  const int wt = min(w, c0 + cols - first);
  const int half = (m + 1) / 2;
  const int t = threadIdx.x, NT = blockDim.x, lane = t & 31, warp = t >> 5, W = NT >> 5;
  T* Xs = reinterpret_cast<T*>(smem);  // local column l, row r at l 2 half + (r & 1) half + r / 2
  auto at = [&](int l, int r) { return l * 2 * half + (r & 1) * half + (r >> 1); };
  for (int e = t; e < wt * m; e += NT) {
    const int l = e % wt, r = e / wt;
    Xs[at(l, r)] = identity ? T(r == first + l)
                            : X[(static_cast<int64_t>(r) * ld + first + l) * B + b];
  }
  __syncthreads();
  const T* lg = rlog + b * 2 * pairs;
  int64_t off = log_offset(2 * jfrom, m, n);
#pragma unroll 1
  for (int k = 2 * jfrom; k <= m + n - 3; ++k) {
    const int j_lo = max(0, k - m + 2), j_hi = min(n - 1, k / 2), lo = max(j_lo, jfrom);
    const int p0 = m - 2 - k;
    const int chunks = (j_hi - lo + 32) / 32;
    // a warp a chunk of 32 pivots and a share of the columns: ``split``
    // warps share a chunk's columns where the chunks are fewer than the warps
    const int split = chunks ? max(1, W / chunks) : 1;
#pragma unroll 1
    for (int item = warp; item < chunks * split; item += W) {
      const int j = lo + (item % chunks) * 32 + lane;
      if (j <= j_hi) {
        const int64_t e = 2 * (off + j - j_lo);
        const T cc = lg[e], ss = lg[e + 1];
        const int p = p0 + 2 * j;
        const int ip = (p & 1) * half + (p >> 1), iq = ((p + 1) & 1) * half + ((p + 1) >> 1);
#pragma unroll 4
        for (int l = item / chunks; l < wt; l += split) {
          T* x = Xs + l * 2 * half;
          const T vp = x[ip], vq = x[iq];
          x[ip] = rn::add(rn::mul(cc, vp), rn::mul(ss, vq));
          x[iq] = rn::add(rn::mul(cc, vq), rn::mul(-ss, vp));
        }
      }
    }
    off += j_hi - j_lo + 1;
    __syncthreads();
  }
  for (int e = t; e < wt * m; e += NT) {
    const int l = e % wt, r = e / wt;
    X[(static_cast<int64_t>(r) * ld + first + l) * B + b] = Xs[at(l, r)];
  }
}

// K2a-p's shared memory a CTA of phase 1 with P CTAs on a panel of
// ``width`` columns: m rows of ceil(width / P) words, and the (c, s) of a
// stage's pivots, at most min(n, m / 2 + 1) (ops/qr_wavefront.py's
// qr_panel_bytes)
template <typename T>
int64_t qr_panel_smem(int m, int n, int width, int P) {
  const int most = n < m / 2 + 1 ? n : m / 2 + 1;
  return (static_cast<int64_t>(m) * ((width + P - 1) / P) + 2 * most) * sizeof(T);
}

// The first phase's kernel of K2a-p (kSolve false) or of K2b-p
template <typename T, bool kSolve>
const void* panel_kernel() {
  if constexpr (kSolve) return reinterpret_cast<const void*>(lstsq_panel_kernel<T>);
  else return reinterpret_cast<const void*>(qr_panel_kernel<T>);
}

// The first phase of K2a-p (kSolve false; panels of R's n columns) or of
// K2b-p (panels of [A | y]'s n + 1): blocks of (ceil(width / P), groups)
// threads an SM holds at once, into ``blocks``
template <typename T, bool kSolve>
int panel_occupancy(int m, int n, int width, int P, int groups, int* blocks) {
  const int64_t smem = qr_panel_smem<T>(m, n, width, P);
  const int columns = (width + P - 1) / P;
  if (n < 1 || m < n || width < 1 || width > n + kSolve || P < 1 || groups < 1 ||
      columns * groups > 1024 || !blocks || smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = panel_kernel<T, kSolve>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, columns * groups, static_cast<size_t>(smem)));
}

// The first phase of K2a-p or K2b-p on the panel j0 .. j1 - 1: ``teams``
// teams of P CTAs in one cooperative launch; R all of R [m, n, B] (K2a-p)
// or the store of n (n + 3) / 2 words a lane (K2b-p, whose y is column n),
// rlog 2 ``pairs`` words a lane, counts one zeroed counter a team
template <typename T, bool kSolve>
int launch_panel(const T* A, const T* y, T* R, T* rlog, unsigned* counts, int m, int n, int64_t B,
                 int j0, int j1, int P, int teams, int groups, int64_t pairs, cudaStream_t st) {
  const int64_t smem = qr_panel_smem<T>(m, n, j1 - j0, P);
  const int columns = (j1 - j0 + P - 1) / P;
  if (n < 1 || m < n || B < 1 || j0 < 0 || j1 <= j0 || j1 > n + kSolve || P < 1 || teams < 1 ||
      groups < 1 || columns * groups > 1024 || smem > kMaxDynamicSmem ||
      pairs != log_offset(m + n - 2, m, n) || static_cast<int64_t>(teams) * P > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = panel_kernel<T, kSolve>();
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  void* qr_args[] = {&A, &R, &rlog, &counts, &m, &n, &j0, &j1, &P, &B, &pairs};
  void* lstsq_args[] = {&A, &y, &R, &rlog, &counts, &m, &n, &j0, &j1, &P, &B, &pairs};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(teams * P)), dim3(columns, groups),
      kSolve ? lstsq_args : qr_args, static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K2a-p's phase 2: B lanes of ceil(cols / w) tiles, 512 threads a tile
template <typename T>
int launch_qr_replay(T* X, const T* rlog, int m, int n, int ld, int c0, int cols, int w,
                     int jfrom, int identity, int64_t B, int64_t pairs, cudaStream_t st) {
  const int64_t smem = static_cast<int64_t>(w) * 2 * ((m + 1) / 2) * sizeof(T);
  const int64_t blocks = B * ((cols + w - 1) / w);
  if (n < 1 || m < n || B < 1 || cols < 1 || w < 1 || c0 < 0 || c0 + cols > ld || jfrom < 0 ||
      jfrom >= n || smem > kMaxDynamicSmem || pairs != log_offset(m + n - 2, m, n) ||
      blocks > (int64_t{1} << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = qr_replay_kernel<T>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<static_cast<unsigned>(blocks), 512, static_cast<size_t>(smem), st>>>(
      X, rlog, m, n, ld, c0, cols, w, jfrom, identity, B, pairs);
  return static_cast<int>(cudaGetLastError());
}

// K2b-p's back solve: B CTAs of kBacksolveThreads, two rows of n + 1 words
// of shared memory each
template <typename T>
int launch_lstsq_backsolve(const T* Rstore, T* x, int n, int64_t B, cudaStream_t st) {
  const int64_t smem = 2 * (static_cast<int64_t>(n) + 1) * sizeof(T);
  if (n < 1 || B < 1 || B > (int64_t{1} << 31) - 1 || smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = lstsq_backsolve_kernel<T>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<static_cast<unsigned>(B), kBacksolveThreads, static_cast<size_t>(smem), st>>>(
      Rstore, x, n, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_registers(const T* A, const T* y, T* x, int m, int n, int64_t B,
                     cudaStream_t s) {
  if constexpr (N > 1) {
    if (n < N) return launch_registers<T, N - 1>(A, y, x, m, n, B, s);
  }
  if (n != N) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  least_squares_registers_kernel<T, N><<<blocks, kThreads, 0, s>>>(A, y, x, m, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* A, const void* y, void* R, void* Qt, void* qty,
           void* x, int m, int n, int64_t B, int compute_q, int solve,
           void* stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(A);
  const T* yy = static_cast<const T*>(y);
  T* r = static_cast<T*>(R);
  T* qt = static_cast<T*>(Qt);
  T* qy = static_cast<T*>(qty);
  T* xx = static_cast<T*>(x);
  if (solve) {
    qr_wavefront_kernel<T, false, true>
        <<<blocks, kThreads, 0, s>>>(a, yy, r, qt, qy, xx, m, n, B);
  } else if (compute_q) {
    qr_wavefront_kernel<T, true, false>
        <<<blocks, kThreads, 0, s>>>(a, yy, r, qt, qy, xx, m, n, B);
  } else {
    qr_wavefront_kernel<T, false, false>
        <<<blocks, kThreads, 0, s>>>(a, yy, r, qt, qy, xx, m, n, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A [m, n, B] -> R [m, n, B] (+ Q^T [m, m, B] when compute_q), or with
// solve: A, y [m, B] -> x [n, B] through the scratch R and qty [m, B].
// Returns cudaGetLastError().
#define NLSOLVER_QR_LAUNCHER(SUFFIX, T)                                      \
  extern "C" int qr_wavefront_##SUFFIX(                                      \
      const void* A, const void* y, void* R, void* Qt, void* qty, void* x,   \
      int m, int n, int64_t B, int compute_q, int solve, void* stream) {     \
    return launch<T>(A, y, R, Qt, qty, x, m, n, B, compute_q, solve,         \
                     stream);                                                \
  }

NLSOLVER_QR_LAUNCHER(f32, float)
NLSOLVER_QR_LAUNCHER(f64, double)

// K2a-w, ``lanes`` warps a block (a power of two, 1 .. 32, whose arrays
// fit 232448 bytes): A [m, n, B] -> R [m, n, B] (+ Q^T [m, m, B] when
// compute_q).  Returns cudaGetLastError().
#define NLSOLVER_QR_WARP_LAUNCHER(SUFFIX, T, MAXQ, MAXR)                             \
  extern "C" int qr_wavefront_warp_##SUFFIX(const void* A, void* R, void* Qt, int m, \
                                            int n, int64_t B, int compute_q,         \
                                            int lanes, void* stream) {               \
    const T* a = static_cast<const T*>(A);                                           \
    const auto st = static_cast<cudaStream_t>(stream);                               \
    if (compute_q)                                                                   \
      return launch_qr_warp<T, true, MAXQ>(a, static_cast<T*>(R), static_cast<T*>(Qt), \
                                           m, n, B, lanes, st);                      \
    return launch_qr_warp<T, false, MAXR>(a, static_cast<T*>(R), nullptr, m, n, B,  \
                                          lanes, st);                                \
  }

NLSOLVER_QR_WARP_LAUNCHER(f32, float, kQrWarpMaxQ32, kQrWarpMaxR32)
NLSOLVER_QR_WARP_LAUNCHER(f64, double, kQrWarpMaxQ64, kQrWarpMaxR64)

// K2a-c: A [m, n, B] -> R [m, n, B] (+ Q^T [m, m, B] when compute_q),
// ``size`` CTAs a lane (2, 4 or 8), ``columns`` x ``groups`` threads a CTA
// (``mode`` 0, or the probe's 1 and 2).  K2a-d: the same, ``size`` CTAs a
// lane of (ceil(cols / size), ``groups``) threads, in ``teams`` teams (coef,
// 4 n words a team; counts, one zeroed counter a team), and its occupancy,
// the blocks an SM holds, into ``blocks``.  Return cudaGetLastError() (the
// occupancy entry, the occupancy query's error).
#define NLSOLVER_QR_SPREAD_LAUNCHERS(SUFFIX, T)                                                 \
  extern "C" int qr_wavefront_cluster_##SUFFIX(const void* A, void* R, void* Qt, int m, int n,  \
                                               int64_t B, int compute_q, int size, int columns, \
                                               int groups, int mode, void* stream) {            \
    return launch_qr_cluster<T>(static_cast<const T*>(A), static_cast<T*>(R),                  \
                                static_cast<T*>(Qt), m, n, B, compute_q, size, columns,         \
                                groups, mode, static_cast<cudaStream_t>(stream));               \
  }                                                                                             \
  extern "C" int qr_wavefront_distributed_##SUFFIX(                                             \
      const void* A, void* R, void* Qt, void* coef, void* counts, int m, int n, int64_t B,      \
      int compute_q, int size, int teams, int groups, int mode, void* stream) {                 \
    return launch_qr_distributed<T>(static_cast<const T*>(A), static_cast<T*>(R),              \
                                    static_cast<T*>(Qt), static_cast<T*>(coef),                 \
                                    static_cast<unsigned*>(counts), m, n, B, compute_q, size,   \
                                    teams, groups, mode, static_cast<cudaStream_t>(stream));    \
  }                                                                                             \
  extern "C" int qr_wavefront_distributed_occupancy_##SUFFIX(int m, int n, int compute_q,       \
                                                             int size, int groups,              \
                                                             int* blocks) {                     \
    return qr_distributed_occupancy<T>(m, n, compute_q, size, groups, blocks);                  \
  }

NLSOLVER_QR_SPREAD_LAUNCHERS(f32, float)
NLSOLVER_QR_SPREAD_LAUNCHERS(f64, double)

// K2a-p, phase 1 on the panel of R's columns j0 .. j1 - 1: A [m, n, B] ->
// those columns of R [m, n, B] and their pivots' rotations into rlog (2
// ``pairs`` words a lane), ``size`` CTAs a lane of (ceil((j1 - j0) / size),
// ``groups``) threads in ``teams`` teams (counts, one zeroed counter a
// team), and its occupancy, the blocks an SM holds, into ``blocks``.
// Phase 2: columns c0 .. c0 + cols - 1 of X [m, ld, B] (from the identity
// where ``identity``) receive the rotations of pivots jfrom .. n - 1 from
// rlog, ``w`` columns a CTA.  Return cudaGetLastError() (the occupancy
// entry, the occupancy query's error).
#define NLSOLVER_QR_PANEL_LAUNCHERS(SUFFIX, T)                                                   \
  extern "C" int qr_wavefront_panel_##SUFFIX(const void* A, void* R, void* rlog, void* counts,  \
                                             int m, int n, int64_t B, int j0, int j1, int size, \
                                             int teams, int groups, int64_t pairs,              \
                                             void* stream) {                                    \
    return launch_panel<T, false>(static_cast<const T*>(A), nullptr, static_cast<T*>(R),        \
                                  static_cast<T*>(rlog), static_cast<unsigned*>(counts), m, n, B, \
                                  j0, j1, size, teams, groups, pairs,                           \
                                  static_cast<cudaStream_t>(stream));                           \
  }                                                                                             \
  extern "C" int qr_wavefront_panel_occupancy_##SUFFIX(int m, int n, int width, int size,       \
                                                       int groups, int* blocks) {               \
    return panel_occupancy<T, false>(m, n, width, size, groups, blocks);                        \
  }                                                                                             \
  extern "C" int qr_wavefront_replay_##SUFFIX(void* X, const void* rlog, int m, int n, int ld,  \
                                              int c0, int cols, int w, int jfrom, int identity, \
                                              int64_t B, int64_t pairs, void* stream) {         \
    return launch_qr_replay<T>(static_cast<T*>(X), static_cast<const T*>(rlog), m, n, ld, c0,   \
                               cols, w, jfrom, identity, B, pairs,                              \
                               static_cast<cudaStream_t>(stream));                              \
  }

NLSOLVER_QR_PANEL_LAUNCHERS(f32, float)
NLSOLVER_QR_PANEL_LAUNCHERS(f64, double)

// K2b's register form, n = 1 .. kRegisterMaxN, its shared-memory form
// with ``lanes`` threads a block and ``smem`` bytes of dynamic shared memory,
// and its warp form with ``lanes`` warps a block (a power of two, 1 .. 32,
// whose rings fit 232448 bytes): A [m, n, B], y [m, B] -> x [n, B].
// Return cudaGetLastError().
#define NLSOLVER_LSQ_LAUNCHERS(SUFFIX, T, MAXN, MAXQ)                          \
  extern "C" int least_squares_warp_##SUFFIX(                                  \
      const void* A, const void* y, void* x, int m, int n, int64_t B,          \
      int lanes, void* stream) {                                               \
    return launch_warp<T, MAXQ>(                                               \
        static_cast<const T*>(A), static_cast<const T*>(y),                    \
        static_cast<T*>(x), m, n, B, lanes, static_cast<cudaStream_t>(stream)); \
  }                                                                            \
  extern "C" int least_squares_registers_##SUFFIX(                             \
      const void* A, const void* y, void* x, int m, int n, int64_t B,          \
      void* stream) {                                                          \
    return launch_registers<T, MAXN>(                                          \
        static_cast<const T*>(A), static_cast<const T*>(y),                    \
        static_cast<T*>(x), m, n, B, static_cast<cudaStream_t>(stream));       \
  }                                                                            \
  extern "C" int least_squares_shared_##SUFFIX(                                \
      const void* A, const void* y, void* x, int m, int n, int64_t B,          \
      int lanes, int smem, void* stream) {                                     \
    cudaError_t err = cudaFuncSetAttribute(                                    \
        least_squares_shared_kernel<T>,                                        \
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                    \
    if (err != cudaSuccess) return static_cast<int>(err);                      \
    const unsigned blocks = static_cast<unsigned>((B + lanes - 1) / lanes);    \
    least_squares_shared_kernel<T><<<blocks, lanes, smem,                      \
                                     static_cast<cudaStream_t>(stream)>>>(     \
        static_cast<const T*>(A), static_cast<const T*>(y),                    \
        static_cast<T*>(x), m, n, B);                                          \
    return static_cast<int>(cudaGetLastError());                               \
  }

// K2b-c: A [m, n, B], y [m, B] -> x [n, B], ``size`` CTAs a lane (2, 4 or
// 8), ``columns`` x ``groups`` threads a CTA.  Returns cudaGetLastError().
#define NLSOLVER_LSQ_CLUSTER_LAUNCHER(SUFFIX, T)                                         \
  extern "C" int least_squares_cluster_##SUFFIX(const void* A, const void* y, void* x,   \
                                                int m, int n, int64_t B, int size,       \
                                                int columns, int groups, void* stream) { \
    return launch_cluster<T>(static_cast<const T*>(A), static_cast<const T*>(y),         \
                             static_cast<T*>(x), m, n, B, size, columns, groups,         \
                             static_cast<cudaStream_t>(stream));                         \
  }

NLSOLVER_LSQ_CLUSTER_LAUNCHER(f32, float)
NLSOLVER_LSQ_CLUSTER_LAUNCHER(f64, double)

// K2b-d: A [m, n, B], y [m, B] -> x [n, B], ``size`` CTAs a lane of
// (ceil((n + 1) / size), ``groups``) threads, in ``teams`` teams (coef, 4 n
// words a team; R, its store of n (n + 3) / 2 words a team; counts, one
// zeroed counter a team; ``mode`` 0, or the probe's 1 and 2), and its
// occupancy, the blocks an SM holds, into ``blocks``.  Return
// cudaGetLastError() (the occupancy entry, the occupancy query's error).
#define NLSOLVER_LSQ_DISTRIBUTED_LAUNCHERS(SUFFIX, T)                                          \
  extern "C" int least_squares_distributed_##SUFFIX(                                           \
      const void* A, const void* y, void* x, void* coef, void* R, void* counts, int m, int n,  \
      int64_t B, int size, int teams, int groups, int mode, void* stream) {                    \
    return launch_distributed<T>(static_cast<const T*>(A), static_cast<const T*>(y),           \
                                 static_cast<T*>(x), static_cast<T*>(coef), static_cast<T*>(R), \
                                 static_cast<unsigned*>(counts), m, n, B, size, teams, groups, \
                                 mode, static_cast<cudaStream_t>(stream));                     \
  }                                                                                            \
  extern "C" int least_squares_distributed_occupancy_##SUFFIX(int n, int size, int groups,     \
                                                              int* blocks) {                   \
    return lsq_distributed_occupancy<T>(n, size, groups, blocks);                              \
  }

NLSOLVER_LSQ_DISTRIBUTED_LAUNCHERS(f32, float)
NLSOLVER_LSQ_DISTRIBUTED_LAUNCHERS(f64, double)

// K2b-p, phase 1 on the panel of [A | y]'s columns j0 .. j1 - 1 (y column
// n): A [m, n, B], y [m, B] -> those columns' rows on and above R's
// diagonal into Rstore (n (n + 3) / 2 words a lane) and their pivots'
// rotations into rlog (2 ``pairs`` words a lane), ``size`` CTAs a lane of
// (ceil((j1 - j0) / size), ``groups``) threads in ``teams`` teams (counts,
// one zeroed counter a team), and its occupancy, the blocks an SM holds,
// into ``blocks``; the back solve: Rstore -> x [n, B], a CTA a lane.
// Return cudaGetLastError() (the occupancy entry, the occupancy query's
// error).
#define NLSOLVER_LSQ_PANEL_LAUNCHERS(SUFFIX, T)                                                  \
  extern "C" int least_squares_panel_##SUFFIX(                                                  \
      const void* A, const void* y, void* Rstore, void* rlog, void* counts, int m, int n,       \
      int64_t B, int j0, int j1, int size, int teams, int groups, int64_t pairs, void* stream) { \
    return launch_panel<T, true>(static_cast<const T*>(A), static_cast<const T*>(y),           \
                                 static_cast<T*>(Rstore), static_cast<T*>(rlog),                \
                                 static_cast<unsigned*>(counts), m, n, B, j0, j1, size, teams,  \
                                 groups, pairs, static_cast<cudaStream_t>(stream));             \
  }                                                                                             \
  extern "C" int least_squares_panel_occupancy_##SUFFIX(int m, int n, int width, int size,      \
                                                        int groups, int* blocks) {              \
    return panel_occupancy<T, true>(m, n, width, size, groups, blocks);                         \
  }                                                                                             \
  extern "C" int least_squares_backsolve_##SUFFIX(const void* Rstore, void* x, int n,          \
                                                  int64_t B, void* stream) {                    \
    return launch_lstsq_backsolve<T>(static_cast<const T*>(Rstore), static_cast<T*>(x), n, B,  \
                                     static_cast<cudaStream_t>(stream));                        \
  }

NLSOLVER_LSQ_PANEL_LAUNCHERS(f32, float)
NLSOLVER_LSQ_PANEL_LAUNCHERS(f64, double)

NLSOLVER_LSQ_LAUNCHERS(f32, float, kRegisterMaxN32, kWarpMaxQ32)
NLSOLVER_LSQ_LAUNCHERS(f64, double, kRegisterMaxN64, kWarpMaxQ64)
