// Batched Givens QR and least squares on the Sameh-Kuck wavefront, for
// Hopper (sm_90a), batch-minor layout.
//
// Replaces nlsolver_tpu/ops/qr_wavefront.py: qr_wavefront_pallas (K2a, R
// and optionally Q of A [m, n, B]) and least_squares_wavefront_pallas (K2b,
// x = argmin ||A x - y|| for A [m, n, B], y [m, B]; the rotations thread y
// and the back-substitution runs in the kernel, so only x is written).
//
// Design: one thread per lane b.  Element (i, j) of lane b lies at
// (i * cols + j) * B + b, so neighbouring threads touch neighbouring
// addresses and every load and store coalesces without a transpose.  The
// thread walks the schedule in stage order: entry (i, j), i > j, is zeroed
// at stage k = m - 1 - i + 2 j by rotating rows (i - 1, i); for stage k the
// columns are j = max(0, k - m + 2) .. min(n - 1, k / 2), recomputed here in
// closed form, so no schedule table is passed.  The row pairs of a stage are
// disjoint, so one thread doing them one after another computes what the
// twin's whole-stage tensor ops compute.
//
// What bounds it: K2b at [34, 2, 262144] f32 must read A and y and write
// x, about 109 MB, some 33 us at 3.35 TB/s.  It measures about 240 us on an
// H100 (PERF.md), five times a plain copy of A: the per-lane working copy
// of R and Q^T y (the scratch the wrapper allocates, 70 words a lane)
// is read and written about 330 times a lane across the stages, and at
// 256 threads a block that overflows L1 into L2.  Keeping R in registers
// for small m n is the lever.  The working set lives in global memory, so
// the kernel has no fast-memory envelope: every m >= n and every B is
// taken, with no fallback and no padding lanes.  K2a also writes Q^T
// [m, m, B]; with few lanes (4096 at [16, 16]) it fills a fraction of the
// card and is bound by each thread's chain of dependent rotations.
//
// Arithmetic: each step is rounded as the plain PyTorch twin
// (nlsolver_torch/linalg/qr_parallel.py) rounds it: the Givens
// coefficients as givens.py computes its selected branch, a rotation as
// (c * x) + (s * y) with -s on row q, the back-substitution in the twin's
// order, through the _rn intrinsics so that no FMA contraction creeps in.
// The kernel is then bit-equal to the twin.  K2a rotates all n columns of a
// row pair, as the twin does, so that R is bit-equal below the diagonal
// too; K2b rotates columns j .. n - 1 only, since the columns left of j
// hold zeroed entries that x never reads.

#include <cuda_runtime.h>

#include <cstdint>

#include "rn_math.cuh"

namespace {

template <typename T>
__device__ inline void givens(T a, T b, T& c, T& s) {
  const T aa = rn::abs(a), ab = rn::abs(b);
  if (aa == T(0) && ab == T(0)) {
    c = T(1);
    s = T(0);
  } else if (aa >= ab) {
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

template <typename T>
int launch(const void* A, const void* y, void* R, void* Qt, void* qty,
           void* x, int m, int n, int64_t B, int compute_q, int solve,
           void* stream) {
  constexpr int kThreads = 256;
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
