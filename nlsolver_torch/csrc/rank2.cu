// BFGS rank-2 inverse-Hessian update for Hopper (sm_90a), three kernels:
//
//   K4a  rank2_resident   batch-minor update + next direction, H read once
//   K4b  rank2_rowsplit   the same for n too large for one resident slab
//   K4c  rank2_batched    the update alone on the leading-batch layout
//
// They replace nlsolver_tpu/ops/rank2.py: rank2_direction_batchminor_pallas
// (_bm_kernel), rank2_direction_batchminor_pallas_rowtiled
// (_bm_rowtiled_kernel) and rank2_update_batched_pallas (_kernel).  Per lane b
//
//   Heff = I where reset[b] else H
//   Hy   = Heff y,   coef = rho (1 + rho y^T Hy)
//   H'   = Heff - rho (s Hy^T + Hy s^T) + coef s s^T
//   d'   = -H' g                                   (K4a and K4b only)
//
// What bounds them: bytes.  Each lane moves 2 n^2 + 4 n words (H in and out,
// s, y, g in, d' out) against some 13 n^2 floating-point operations, far
// under the card's 20 operations per byte in f32.  So the designs keep H's
// traffic to the least they can.
//
// K4a: batch-minor, element (i, j) of lane b at (i n + j) B + b.  A block
// takes a tile of TB lanes and stages its [n, n, TB] slab of Heff (the
// identity on reset lanes, which then read no H at all) and the [n, TB]
// slabs of s, y, g in shared memory; lanes are the fastest thread index, so
// every global load and store is coalesced and the shared accesses are free
// of bank conflicts.  Thread (r, b) forms Hy for rows r, r + R, ...; after a
// barrier every thread sums y^T Hy for its lane (n terms from shared memory,
// cheaper than a reduction across threads), then updates its rows, writes
// them and accumulates d'.  H is read once and written once.  The slab and
// the four vectors need (n^2 + 4 n) TB words: with TB = 32 and the 232448
// bytes a block may opt in to, n <= 40 in f32 and n <= 28 in f64.
//
// K4b: any n.  Three launches on one stream: Hy [n, B] by threads (i, b)
// over a 2-D grid of (lane tile, row block); coef [B] by one thread a lane;
// then the 2-D grid again, thread (i, b) forming row i of H' and d'[i] from
// H, s, Hy, rho and coef.  H is read twice and written once; s, Hy and g
// are re-read by every row of a lane and come from L1/L2.
//
// K4c: leading-batch, a lane's matrix is contiguous.  One warp per
// instance: it stages H [n, n] (rows padded by one word against bank
// conflicts), s and y in shared memory with coalesced loads over the
// flattened (i, j), forms Hy with one row per thread, and writes H' over
// the flattened (i, j) again.  H is read once and written once.
//
// Arithmetic: every operation is rounded on its own through the _rn
// intrinsics (no FMA), and the elementwise update follows the plain
// PyTorch twins (nlsolver_torch/ops/rank2.py) term for term.  The three
// sums (Hy over j, y^T Hy over i, d' over j) run in ascending index order,
// which is not torch.sum's order, so the kernels agree with the twins to a
// few ulp times n, and bit for bit where n <= 2.

#include <cuda_runtime.h>

#include <cstdint>

#include "rn_math.cuh"

namespace {

// the dynamic shared memory a block may opt in to on sm_90
constexpr int kMaxDynamicSmem = 232448;
constexpr int kOptInAbove = 48 * 1024;

template <typename T>
__device__ inline T coefficient(T rho, T yHy) {
  return rn::mul(rho, rn::add(T(1), rn::mul(rho, yHy)));
}

// H'[i][j] from Heff[i][j], in the twins' order:
// (h - rho (s_i Hy_j + Hy_i s_j)) + coef (s_i s_j)
template <typename T>
__device__ inline T updated(T h, T rho, T coef, T si, T sj, T hyi, T hyj) {
  const T sym = rn::add(rn::mul(si, hyj), rn::mul(hyi, sj));
  return rn::add(rn::sub(h, rn::mul(rho, sym)), rn::mul(coef, rn::mul(si, sj)));
}

// ---------------------------------------------------------------- K4a

// up to 1024 threads a block (32 lanes by 32 rows at n >= 32)
template <typename T>
__global__ void __launch_bounds__(1024) rank2_resident_kernel(const T* __restrict__ H, const T* __restrict__ s,
                                      const T* __restrict__ y, const T* __restrict__ g,
                                      const T* __restrict__ rho,
                                      const uint8_t* __restrict__ reset, T* __restrict__ Hout,
                                      T* __restrict__ dout, int n, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TB = blockDim.x, R = blockDim.y;
  const int tb = threadIdx.x, r = threadIdx.y;
  T* sH = reinterpret_cast<T*>(smem_raw);  // [n * n][TB]
  T* ss = sH + static_cast<size_t>(n) * n * TB;  // [n][TB] each
  T* sy = ss + n * TB;
  T* sg = sy + n * TB;
  T* sHy = sg + n * TB;

  const int64_t b = static_cast<int64_t>(blockIdx.x) * TB + tb;
  const bool live = b < B;
  const bool rst = live && reset[b] != 0;
  for (int i = r; i < n; i += R) {
    const int64_t at = static_cast<int64_t>(i) * B + b;
    ss[i * TB + tb] = live ? s[at] : T(0);
    sy[i * TB + tb] = live ? y[at] : T(0);
    sg[i * TB + tb] = live ? g[at] : T(0);
    for (int j = 0; j < n; ++j) {
      T h = T(i == j);
      if (live && !rst) h = H[(static_cast<int64_t>(i) * n + j) * B + b];
      sH[(i * n + j) * TB + tb] = h;
    }
  }
  __syncthreads();
  for (int i = r; i < n; i += R) {
    T acc = T(0);
    for (int j = 0; j < n; ++j)
      acc = rn::add(acc, rn::mul(sH[(i * n + j) * TB + tb], sy[j * TB + tb]));
    sHy[i * TB + tb] = acc;
  }
  __syncthreads();
  if (!live) return;
  T yHy = T(0);
  for (int i = 0; i < n; ++i) yHy = rn::add(yHy, rn::mul(sy[i * TB + tb], sHy[i * TB + tb]));
  const T rb = rho[b];
  const T coef = coefficient(rb, yHy);
  for (int i = r; i < n; i += R) {
    const T si = ss[i * TB + tb], hyi = sHy[i * TB + tb];
    T acc = T(0);
    for (int j = 0; j < n; ++j) {
      const T hn = updated(sH[(i * n + j) * TB + tb], rb, coef, si, ss[j * TB + tb], hyi,
                           sHy[j * TB + tb]);
      Hout[(static_cast<int64_t>(i) * n + j) * B + b] = hn;
      acc = rn::add(acc, rn::mul(hn, sg[j * TB + tb]));
    }
    dout[static_cast<int64_t>(i) * B + b] = -acc;
  }
}

template <typename T>
int launch_resident(const void* H, const void* s, const void* y, const void* g,
                    const void* rho, const void* reset, void* Hout, void* dout, int n,
                    int64_t B, void* stream) {
  // a tile of at least 32 lanes; more for small n, so a block has work
  int TB = 32;
  while (n * TB < 256 && TB < 256) TB *= 2;
  const int R = n < 1024 / TB ? n : 1024 / TB;
  const size_t bytes = (static_cast<size_t>(n) * n + 4 * static_cast<size_t>(n)) * TB * sizeof(T);
  if (bytes > static_cast<size_t>(kMaxDynamicSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > static_cast<size_t>(kOptInAbove)) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank2_resident_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((B + TB - 1) / TB);
  rank2_resident_kernel<T><<<blocks, dim3(TB, R), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<const T*>(s), static_cast<const T*>(y),
      static_cast<const T*>(g), static_cast<const T*>(rho), static_cast<const uint8_t*>(reset),
      static_cast<T*>(Hout), static_cast<T*>(dout), n, B);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K4b

constexpr int kLanes = 32;  // lanes of a block (threadIdx.x)
constexpr int kRows = 8;    // rows of a block (threadIdx.y)

template <typename T>
__global__ void rank2_hy_kernel(const T* __restrict__ H, const T* __restrict__ y,
                                const uint8_t* __restrict__ reset, T* __restrict__ Hy, int n,
                                int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (b >= B || i >= n) return;
  const bool rst = reset[b] != 0;
  T acc = T(0);
  for (int j = 0; j < n; ++j) {
    const T h = rst ? T(i == j) : H[(static_cast<int64_t>(i) * n + j) * B + b];
    acc = rn::add(acc, rn::mul(h, y[static_cast<int64_t>(j) * B + b]));
  }
  Hy[static_cast<int64_t>(i) * B + b] = acc;
}

template <typename T>
__global__ void rank2_coef_kernel(const T* __restrict__ y, const T* __restrict__ Hy,
                                  const T* __restrict__ rho, T* __restrict__ coef, int n,
                                  int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T yHy = T(0);
  for (int i = 0; i < n; ++i) {
    const int64_t at = static_cast<int64_t>(i) * B + b;
    yHy = rn::add(yHy, rn::mul(y[at], Hy[at]));
  }
  coef[b] = coefficient(rho[b], yHy);
}

template <typename T>
__global__ void rank2_rows_kernel(const T* __restrict__ H, const T* __restrict__ s,
                                  const T* __restrict__ g, const T* __restrict__ rho,
                                  const T* __restrict__ coef, const T* __restrict__ Hy,
                                  const uint8_t* __restrict__ reset, T* __restrict__ Hout,
                                  T* __restrict__ dout, int n, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (b >= B || i >= n) return;
  const bool rst = reset[b] != 0;
  const T rb = rho[b], cb = coef[b];
  const T si = s[static_cast<int64_t>(i) * B + b], hyi = Hy[static_cast<int64_t>(i) * B + b];
  T acc = T(0);
  for (int j = 0; j < n; ++j) {
    const int64_t at = (static_cast<int64_t>(i) * n + j) * B + b;
    const int64_t vj = static_cast<int64_t>(j) * B + b;
    const T h = rst ? T(i == j) : H[at];
    const T hn = updated(h, rb, cb, si, s[vj], hyi, Hy[vj]);
    Hout[at] = hn;
    acc = rn::add(acc, rn::mul(hn, g[vj]));
  }
  dout[static_cast<int64_t>(i) * B + b] = -acc;
}

template <typename T>
int launch_rowsplit(const void* H, const void* s, const void* y, const void* g, const void* rho,
                    const void* reset, void* Hy, void* coef, void* Hout, void* dout, int n,
                    int64_t B, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned tiles = static_cast<unsigned>((B + kLanes - 1) / kLanes);
  const dim3 grid(tiles, (n + kRows - 1) / kRows), block(kLanes, kRows);
  const uint8_t* rs = static_cast<const uint8_t*>(reset);
  rank2_hy_kernel<T><<<grid, block, 0, st>>>(static_cast<const T*>(H), static_cast<const T*>(y),
                                             rs, static_cast<T*>(Hy), n, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rank2_coef_kernel<T><<<static_cast<unsigned>((B + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(Hy), static_cast<const T*>(rho),
      static_cast<T*>(coef), n, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rank2_rows_kernel<T><<<grid, block, 0, st>>>(
      static_cast<const T*>(H), static_cast<const T*>(s), static_cast<const T*>(g),
      static_cast<const T*>(rho), static_cast<const T*>(coef), static_cast<const T*>(Hy), rs,
      static_cast<T*>(Hout), static_cast<T*>(dout), n, B);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K4c

template <typename T>
__global__ void rank2_batched_kernel(const T* __restrict__ H, const T* __restrict__ s,
                                     const T* __restrict__ y, const T* __restrict__ rho,
                                     T* __restrict__ Hout, int n, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * warps + warp;
  if (b >= B) return;  // a whole warp leaves; the warps of a block share no barrier
  const int ld = n + 1, nn = n * n;
  T* sH = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * (n * ld + 3 * n);
  T* ss = sH + n * ld;
  T* sy = ss + n;
  T* sHy = sy + n;
  const T* Hb = H + b * nn;
  T* Ob = Hout + b * nn;
  for (int i = lane; i < n; i += 32) {
    ss[i] = s[b * n + i];
    sy[i] = y[b * n + i];
  }
  for (int e = lane; e < nn; e += 32) sH[(e / n) * ld + e % n] = Hb[e];
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    T acc = T(0);
    for (int j = 0; j < n; ++j) acc = rn::add(acc, rn::mul(sH[i * ld + j], sy[j]));
    sHy[i] = acc;
  }
  __syncwarp();
  T yHy = T(0);
  for (int i = 0; i < n; ++i) yHy = rn::add(yHy, rn::mul(sy[i], sHy[i]));
  const T rb = rho[b];
  const T coef = coefficient(rb, yHy);
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e % n;
    Ob[e] = updated(sH[i * ld + j], rb, coef, ss[i], ss[j], sHy[i], sHy[j]);
  }
}

template <typename T>
int launch_batched(const void* H, const void* s, const void* y, const void* rho, void* Hout,
                   int n, int64_t B, void* stream) {
  const size_t per_warp = (static_cast<size_t>(n) * (n + 1) + 3 * static_cast<size_t>(n)) * sizeof(T);
  int warps = static_cast<int>(kMaxDynamicSmem / per_warp);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (warps > 8) warps = 8;
  const size_t bytes = per_warp * warps;
  if (bytes > static_cast<size_t>(kOptInAbove)) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank2_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((B + warps - 1) / warps);
  rank2_batched_kernel<T><<<blocks, 32 * warps, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<const T*>(s), static_cast<const T*>(y),
      static_cast<const T*>(rho), static_cast<T*>(Hout), n, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Batch-minor: H, Hout [n, n, B]; s, y, g, dout [n, B]; rho [B]; reset [B]
// bytes (non-zero: use the identity for H).  Leading-batch: H, Hout
// [B, n, n]; s, y [B, n]; rho [B].  Hy [n, B] and coef [B] are scratch.
// Each returns cudaGetLastError().
#define RANK2_ENTRY_POINTS(T, SUFFIX)                                                         \
  extern "C" int rank2_resident_##SUFFIX(const void* H, const void* s, const void* y,         \
                                         const void* g, const void* rho, const void* reset,   \
                                         void* Hout, void* dout, int n, int64_t B,            \
                                         void* stream) {                                      \
    return launch_resident<T>(H, s, y, g, rho, reset, Hout, dout, n, B, stream);              \
  }                                                                                           \
  extern "C" int rank2_rowsplit_##SUFFIX(const void* H, const void* s, const void* y,         \
                                         const void* g, const void* rho, const void* reset,   \
                                         void* Hy, void* coef, void* Hout, void* dout, int n, \
                                         int64_t B, void* stream) {                           \
    return launch_rowsplit<T>(H, s, y, g, rho, reset, Hy, coef, Hout, dout, n, B, stream);    \
  }                                                                                           \
  extern "C" int rank2_batched_##SUFFIX(const void* H, const void* s, const void* y,          \
                                        const void* rho, void* Hout, int n, int64_t B,        \
                                        void* stream) {                                       \
    return launch_batched<T>(H, s, y, rho, Hout, n, B, stream);                               \
  }

RANK2_ENTRY_POINTS(float, f32)
RANK2_ENTRY_POINTS(double, f64)
