// Batched symmetric eigendecomposition by parallel-order cyclic Jacobi for
// Hopper (sm_90a), one kernel in two forms:
//
//   K5a  resident  A and V of a tile of lanes live in shared memory
//   K5b  global    A's working copy and V live in device memory, any n
//
// It replaces nlsolver_tpu/ops/eigh_jacobi.py: eigh_jacobi_pallas (_kernel,
// _round).  Per lane b of A [n, n, B] (batch-minor, element (i, j) of lane b
// at (i n + j) B + b):
//
//   A <- (A + A^T) / 2,  V <- I
//   sweeps times, for every round of the round-robin tournament:
//     (c, s) of each disjoint pair (p, q) from A[p][p], A[q][q], A[p][q]
//     rows     A[p][:] <- c A[p][:] - s A[q][:],  A[q][:] <- c A[q][:] + s A[p][:]
//     columns  the same on the columns of A and of V
//   w <- diag(A)
//
// The schedule is not computed here: the wrapper passes the table that the
// plain twin (nlsolver_torch/linalg/jacobi.py) builds, int32
// [rounds][ceil(n/2)][2], a (p, q) for each pair and (r, r) for the bye row
// of an odd n, which keeps c = 1, s = 0.
//
// What bounds it: operations, not bytes.  A lane moves 2 n^2 + n words
// once (A in, w and V out) but does some 9 n^2 operations in each of the
// sweeps (n - 1) rounds, and a round depends on the one before.  So the
// design keeps the rounds off device memory: K5a stages the [n, n] slabs of
// A and V, and the [n] coefficients c and s, of TB lanes in shared memory,
// (2 n^2 + 2 n) TB words, for all sweeps; A is read once, w and V written
// once.  Lanes are the fastest thread index, so global accesses are
// coalesced and shared accesses conflict-free.  The wrapper halves TB from
// 32 down to one 32-byte sector of lanes until the slab fits the 232448
// bytes a block may opt in to: n <= 29 at 32 lanes and n <= 59 at 8 in f32.
// K5b runs the same code on a working copy of A, on V's output itself and on
// a coefficient scratch in device memory, lane stride B: any n, every round
// through L2 or HBM.
//
// A block is (TB lanes) x (RJ x RU threads a lane).  A round is three
// phases with a barrier after each:
//   1. thread t of a lane forms (c, s) for units t, t + RJ RU, ...;
//   2. rows: thread (rj, ru) takes units ru, ru + RU, ... and columns rj,
//      rj + RJ, ...; it owns both rows of a pair, reads both entries and
//      then writes both, so no row is read after a partner rewrote it;
//   3. columns of A and V likewise, on the rows the second phase wrote.
// The next round's (c, s) read A after the third barrier.
//
// Arithmetic: every operation is rounded on its own through the _rn
// intrinsics (no FMA) in the twin's order, and a round has no sum longer
// than two terms, so the kernel equals the twin bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "rn_math.cuh"

namespace {

constexpr int kMaxDynamicSmem = 232448;
constexpr int kOptInAbove = 48 * 1024;

// the twin's _rotation: (c, s) zeroing apq, the identity where apq == 0
template <typename T>
__device__ inline void rotation(T app, T aqq, T apq, T& c, T& s) {
  if (apq == T(0)) {
    c = T(1);
    s = T(0);
    return;
  }
  const T theta = rn::div(rn::sub(aqq, app), rn::mul(T(2), apq));
  const T sign = theta >= T(0) ? T(1) : T(-1);
  const T t = rn::div(sign, rn::add(rn::abs(theta), rn::sqrt(rn::add(rn::mul(theta, theta), T(1)))));
  c = rn::div(T(1), rn::sqrt(rn::add(rn::mul(t, t), T(1))));
  s = rn::mul(t, c);
}

// (x, y) <- (cp x + sp y, cq y + sq x): the twin's C * X + S * X[perm] on
// the two members of a pair; a bye unit (p == q) rewrites x alone
template <typename T>
__device__ inline void rotate_pair(T* xp, T* yp, bool pair, T cp, T sp, T cq, T sq) {
  const T x = *xp, y = *yp;
  *xp = rn::add(rn::mul(cp, x), rn::mul(sp, y));
  if (pair) *yp = rn::add(rn::mul(cq, y), rn::mul(sq, x));
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(1024)
    eigh_jacobi_kernel(const T* __restrict__ A, T* __restrict__ work, T* __restrict__ coef,
                       T* __restrict__ wout, T* __restrict__ Vout, const int* __restrict__ units,
                       int n, int rounds, int sweeps, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TB = blockDim.x, RJ = blockDim.y, RU = blockDim.z;
  const int tb = threadIdx.x, rj = threadIdx.y, ru = threadIdx.z;
  const int t = ru * RJ + rj, NT = RJ * RU;
  const int nu = (n + 1) / 2, nn = n * n;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * TB + tb;
  const bool live = b < B;

  // element e of a lane's slab at base[e * ld + lane]
  T *a, *v, *cv, *sv;
  int64_t ld, lane;
  if (kResident) {
    a = reinterpret_cast<T*>(smem_raw);
    v = a + static_cast<size_t>(nn) * TB;
    cv = v + static_cast<size_t>(nn) * TB;
    sv = cv + n * TB;
    ld = TB;
    lane = tb;
  } else {
    a = work;
    v = Vout;
    cv = coef;
    sv = coef + static_cast<int64_t>(n) * B;
    ld = B;
    lane = b;
  }

  if (live) {
    for (int e = t; e < nn; e += NT) {
      const int i = e / n, j = e - i * n;
      const T x = A[static_cast<int64_t>(e) * B + b];
      const T y = A[(static_cast<int64_t>(j) * n + i) * B + b];
      a[e * ld + lane] = rn::mul(rn::add(x, y), T(0.5));
      v[e * ld + lane] = T(i == j);
    }
  }
  __syncthreads();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int rd = 0; rd < rounds; ++rd) {
      const int* un = units + static_cast<size_t>(rd) * nu * 2;
      if (live) {
        for (int u = t; u < nu; u += NT) {
          const int p = __ldg(un + 2 * u), q = __ldg(un + 2 * u + 1);
          T c = T(1), s = T(0);
          if (p != q)
            rotation(a[(static_cast<int64_t>(p) * n + p) * ld + lane],
                     a[(static_cast<int64_t>(q) * n + q) * ld + lane],
                     a[(static_cast<int64_t>(p) * n + q) * ld + lane], c, s);
          cv[p * ld + lane] = c;
          sv[p * ld + lane] = p != q ? -s : s;
          if (p != q) {
            cv[q * ld + lane] = c;
            sv[q * ld + lane] = s;
          }
        }
      }
      __syncthreads();
      if (live) {
        for (int u = ru; u < nu; u += RU) {
          const int p = __ldg(un + 2 * u), q = __ldg(un + 2 * u + 1);
          const T cp = cv[p * ld + lane], sp = sv[p * ld + lane];
          const T cq = cv[q * ld + lane], sq = sv[q * ld + lane];
          T* rowp = a + static_cast<int64_t>(p) * n * ld + lane;
          T* rowq = a + static_cast<int64_t>(q) * n * ld + lane;
          for (int j = rj; j < n; j += RJ)
            rotate_pair(rowp + j * ld, rowq + j * ld, p != q, cp, sp, cq, sq);
        }
      }
      __syncthreads();
      if (live) {
        for (int u = ru; u < nu; u += RU) {
          const int p = __ldg(un + 2 * u), q = __ldg(un + 2 * u + 1);
          const T cp = cv[p * ld + lane], sp = sv[p * ld + lane];
          const T cq = cv[q * ld + lane], sq = sv[q * ld + lane];
          for (int i = rj; i < n; i += RJ) {
            const int64_t row = static_cast<int64_t>(i) * n;
            rotate_pair(a + (row + p) * ld + lane, a + (row + q) * ld + lane, p != q, cp, sp, cq,
                        sq);
            rotate_pair(v + (row + p) * ld + lane, v + (row + q) * ld + lane, p != q, cp, sp, cq,
                        sq);
          }
        }
      }
      __syncthreads();
    }
  }

  if (!live) return;
  for (int i = t; i < n; i += NT)
    wout[static_cast<int64_t>(i) * B + b] = a[(static_cast<int64_t>(i) * n + i) * ld + lane];
  if (kResident)
    for (int e = t; e < nn; e += NT) Vout[static_cast<int64_t>(e) * B + b] = v[e * ld + lane];
}

template <typename T>
int launch(const void* A, void* work, void* coef, void* wout, void* Vout, const void* units, int n,
           int rounds, int sweeps, int64_t B, int tb, int rj, int ru, int resident, void* stream) {
  if (n < 1 || tb < 1 || rj < 1 || ru < 1 || tb * rj * ru > 1024 || ru > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((B + tb - 1) / tb);
  const dim3 block(tb, rj, ru);
  const int* un = static_cast<const int*>(units);
  if (resident) {
    const size_t bytes =
        (2 * static_cast<size_t>(n) * n + 2 * static_cast<size_t>(n)) * tb * sizeof(T);
    if (bytes > static_cast<size_t>(kMaxDynamicSmem)) return static_cast<int>(cudaErrorInvalidValue);
    if (bytes > static_cast<size_t>(kOptInAbove)) {
      const cudaError_t err =
          cudaFuncSetAttribute(eigh_jacobi_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    eigh_jacobi_kernel<T, true><<<blocks, block, bytes, st>>>(
        static_cast<const T*>(A), nullptr, nullptr, static_cast<T*>(wout), static_cast<T*>(Vout),
        un, n, rounds, sweeps, B);
  } else {
    eigh_jacobi_kernel<T, false><<<blocks, block, 0, st>>>(
        static_cast<const T*>(A), static_cast<T*>(work), static_cast<T*>(coef),
        static_cast<T*>(wout), static_cast<T*>(Vout), un, n, rounds, sweeps, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A, Vout [n, n, B]; wout [n, B]; units int32 [rounds, ceil(n/2), 2]; block
// (tb lanes, rj, ru).  With resident != 0 the slabs live in shared memory
// and work and coef are unused; else work [n, n, B] and coef [2, n, B] are
// scratch in device memory.  Returns cudaGetLastError().
#define EIGH_JACOBI_ENTRY_POINT(T, SUFFIX)                                                      \
  extern "C" int eigh_jacobi_##SUFFIX(const void* A, void* work, void* coef, void* wout,        \
                                      void* Vout, const void* units, int n, int rounds,         \
                                      int sweeps, int64_t B, int tb, int rj, int ru,            \
                                      int resident, void* stream) {                             \
    return launch<T>(A, work, coef, wout, Vout, units, n, rounds, sweeps, B, tb, rj, ru,        \
                     resident, stream);                                                         \
  }

EIGH_JACOBI_ENTRY_POINT(float, f32)
EIGH_JACOBI_ENTRY_POINT(double, f64)
