// Batched small SPD solve, batch-minor layout, for Hopper (sm_90a):
// Cholesky-Banachiewicz factorization, forward and back substitution.
//
// Replaces nlsolver_tpu/ops/smallchol.py: solve_spd_batched_pallas, whose
// body (_chol_solve_batchminor) also serves the NLLS fleet's default
// cholesky backend through solve_spd_batchminor.  Here the kernel serves
// that call site directly: A [n, n, B], b [n, B] -> x [n, B].
//
// Design: one thread per lane b.  Element (i, j) of lane b lies at
// (i * n + j) * B + b, so neighbouring threads touch neighbouring addresses
// and every load and store coalesces without a transpose.  L lives in a
// batch-minor scratch of n (n + 1) / 2 rows (row i of L packed at
// i (i + 1) / 2), allocated by the wrapper; the forward solve writes z into
// x and the back solve overwrites it in place, from the last row up.  Any
// n >= 1 is taken.
//
// What bounds it: the compulsory traffic, (n^2 + 2 n) B words, 8.4 MB at
// n = 2, B = 262144 in f32, some 2.5 us at 3.35 TB/s; the scratch adds
// n (n + 1) / 2 B words written and read, mostly from L2.  The n^3 / 3
// multiply-adds per lane stay far below the card's arithmetic for the
// fleet's small n.  It measures about 7 us of device time there on an
// H100 (PERF.md), while its Python wrapper costs several times that in
// host time per call.
//
// Arithmetic: each operation is rounded as the plain PyTorch twin
// (nlsolver_torch/linalg/solve.py:_solve_spd_unrolled, imported by
// ops/smallchol.py as _chol_solve_batchminor) rounds it, in its order,
// through the _rn intrinsics, so the kernel is bit-equal to it.

#include <cuda_runtime.h>

#include <cstdint>

#include "rn_math.cuh"

namespace {

template <typename T>
__global__ void chol_solve_kernel(const T* __restrict__ A,
                                  const T* __restrict__ rhs, T* L, T* x, int n,
                                  int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  auto l = [&](int i, int j) -> T& {
    return L[(static_cast<int64_t>(i) * (i + 1) / 2 + j) * B + b];
  };
  auto v = [&](T* X, int i) -> T& { return X[static_cast<int64_t>(i) * B + b]; };

  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      T acc = A[(static_cast<int64_t>(i) * n + j) * B + b];
      for (int k = 0; k < j; ++k) acc = rn::sub(acc, rn::mul(l(i, k), l(j, k)));
      l(i, j) = i == j ? rn::sqrt(acc) : rn::div(acc, l(j, j));
    }
  }
  // forward solve L z = rhs, z into x
  for (int i = 0; i < n; ++i) {
    T acc = rhs[static_cast<int64_t>(i) * B + b];
    for (int k = 0; k < i; ++k) acc = rn::sub(acc, rn::mul(l(i, k), v(x, k)));
    v(x, i) = rn::div(acc, l(i, i));
  }
  // back solve L^T x = z, in place
  for (int i = n - 1; i >= 0; --i) {
    T acc = v(x, i);
    for (int k = i + 1; k < n; ++k) acc = rn::sub(acc, rn::mul(l(k, i), v(x, k)));
    v(x, i) = rn::div(acc, l(i, i));
  }
}

template <typename T>
int launch(const void* A, const void* b, void* L, void* x, int n, int64_t B,
           void* stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  chol_solve_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(L),
      static_cast<T*>(x), n, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A [n, n, B], b [n, B] -> x [n, B]; L is scratch of n (n + 1) / 2 * B.
// Returns cudaGetLastError().
extern "C" int chol_solve_batchminor_f32(const void* A, const void* b, void* L,
                                         void* x, int n, int64_t B, void* stream) {
  return launch<float>(A, b, L, x, n, B, stream);
}

extern "C" int chol_solve_batchminor_f64(const void* A, const void* b, void* L,
                                         void* x, int n, int64_t B, void* stream) {
  return launch<double>(A, b, L, x, n, B, stream);
}
