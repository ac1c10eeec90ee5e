// BFGS rank-2 inverse-Hessian update for Hopper (sm_90a), seven kernels:
//
//   K4a    rank2_resident        batch-minor update + next direction, H read once
//   K4b-c  rank2_cluster         the same for n past K4a's slab, over a cluster
//   K4b-t  rank2_streamed        the same for n past K4b-c's, rows streamed twice
//   K4b    rank2_rowsplit        the same for n past K4b-t's, H read twice
//   K4c-r  rank2_batched_rows    the update alone on the leading-batch layout,
//                                a thread a row in registers (n <= 32)
//   K4c-w  rank2_batched_warp    the same, a warp an instance in shared memory
//   K4c-g  rank2_batched_global  the same for any n, H read twice
//
// They replace nlsolver_tpu/ops/rank2.py: rank2_direction_batchminor_pallas
// (_bm_kernel), rank2_direction_batchminor_pallas_rowtiled
// (_bm_rowtiled_kernel; K4b-c, K4b-t and K4b) and rank2_update_batched_pallas
// (_kernel; K4c-r, K4c-w and K4c-g).  Per lane b
//
//   Heff = I where reset[b] else H
//   Hy   = Heff y,   coef = rho (1 + rho y^T Hy)
//   H'   = Heff - rho (s Hy^T + Hy s^T) + coef s s^T
//   d'   = -H' g                                   (K4a, K4b-c, K4b-t, K4b)
//
// (K4c's lanes never reset: Heff = H.)
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
// K4b-c: K4a's slab split by rows over a thread-block cluster of C CTAs.
// The cluster takes a tile of TB lanes (TB = 8 f32 lanes are one 32-byte
// sector of an entry); CTA k stages rows k R .. k R + R - 1 (R = ceil(n /
// C)) of the tile's H and all of s, y, g in its shared memory by 16-byte
// cp.async (4-byte ones where B or a pointer leaves a lane group
// unaligned), skipping a group whose lanes all reset, the whole slab in
// flight at once in two chunks of columns; thread (lane, row) sums Hy over
// each chunk as it lands (a reset lane's row takes the identity in
// place).  A cluster barrier, then each CTA gathers the rest of Hy [n, TB]
// from its peers through distributed shared memory: n TB words, not H.
// Every CTA sums y^T Hy itself in ascending i, so the coefficient is the
// same in each, and forms its rows of H' in place, chunk by chunk, each
// chunk leaving by 16-byte stores while the next is formed.  H is read once
// and written once, where K4b reads it twice; the sums are K4b's, in its
// order, so K4b-c equals K4b bit for bit.  A row of the slab is n | 1
// entries long (odd), so the four rows a warp reads at once fall in
// distinct banks.  The slab and vectors need (R (n | 1) + 4 n) TB words a
// CTA: at TB = 8 and C = 8, n <= 224 in f32 and n <= 152 in f64.
//
// K4b-t: K4b-c's cluster grown to 16 CTAs a tile of one 32-byte sector (8
// float32 or 4 float64 lanes), whose rows need not fit its shared memory:
// a CTA streams its rows twice through a ring of kRing chunks of CW columns
// by 16-byte cp.async, the first pass summing their Hy under an L2
// evict-last policy, the second forming H' and d' from the same chunks read
// again under evict-first, so that the second read may find them in L2.
// The cluster barrier and Hy's gather sit between the passes, and one
// thread a lane sums y^T Hy.  The sums are K4b's in its order, so K4b-t
// equals K4b (and K4b-c) bit for bit.  Its plan (ops/rank2.py:
// streamed_plan) takes n <= 1024 in float32 (512 threads a CTA, a row and
// lane each) and 1415 in float64; the dispatcher gives it the n where it
// measured faster than K4b (streamed_fits).

// K4b: any n.  Three launches on one stream: Hy [n, B] by threads (i, b)
// over a 2-D grid of (lane tile, row block); coef [B] by one thread a lane;
// then the 2-D grid again, thread (i, b) forming row i of H' and d'[i] from
// H, s, Hy, rho and coef.  H is read twice and written once; s, Hy and g
// are re-read by every row of a lane and come from L1/L2.
//
// K4c: leading-batch, a lane's matrix is contiguous; it moves 2 n^2 + 2 n
// + 1 words against some 11 n^2 operations, so bytes bound it too.  Every
// form sums Hy_i over ascending j and y^T Hy over ascending i, so the three
// equal each other bit for bit (and K4a off its reset lanes).
//
// K4c-r (n <= 32): thread i of an instance holds row i of H in registers,
// and a warp packs floor(32 / n) instances, so at n = 16 a warp takes two
// and the grid fits the card in one wave where a warp an instance needed
// more.  A row comes in and goes out straight, by 16-byte accesses where n
// words and the pointers keep every row on 16 bytes (one word an access
// otherwise), or staged: a warp's instances, one run of memory, pass
// through its slab of shared memory by coalesced one-word accesses, where
// a straight access would touch as many lines as the warp has rows (the
// wrapper picks by n, dtype and B, as measured).  No division on the way.
// Hy_i is formed in the thread with y_j shuffled from lane j; y^T Hy is
// gathered from the instance's lanes by shuffles in ascending i, so every
// lane holds the same coefficient; s_j and Hy_j come by shuffle for the
// row of H'.  H is read once and written once, with no barrier beyond the
// warp.  One kernel per room of 4, 8, 16 or 32 words a row, so the row
// stays in registers.
//
// K4c-w (n up to what one instance's H, padded rows, s, y and Hy fit in a
// block's shared memory: 239 in f32, 168 in f64; the dispatcher's to n =
// 48): one warp per instance, up to 8 a block; it stages H [n, n] (rows
// padded by one word against bank conflicts), s and y in shared memory
// with coalesced loads over the flattened (i, j), forms Hy with one row per
// thread, and writes H' over the flattened (i, j) again.  H is read once
// and written once.
//
// K4c-g (any n; the dispatcher's past K4c-w): three launches on one stream.
// Hy [B, n] by blocks of 128 rows of one instance, each column tile of 32
// words staged in shared memory by coalesced (16-byte where aligned)
// loads, a thread summing its row in ascending j; y^T Hy and the
// coefficient [B] by a warp an instance, 32 products at a time shuffled in
// ascending i; then H' by a warp a row, its lanes over the columns.  H is
// read twice and written once: 3 n^2 words a lane against the 2 n^2
// compulsory, at best two thirds of the bound.
//
// Arithmetic: every operation is rounded on its own through the _rn
// intrinsics (no FMA), and the elementwise update follows the plain
// PyTorch twins (nlsolver_torch/ops/rank2.py) term for term.  The three
// sums (Hy over j, y^T Hy over i, d' over j) run in ascending index order,
// which is not torch.sum's order, so the kernels agree with the twins to a
// few ulp times n, and bit for bit where n <= 2.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "rn_math.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------- K4b-c

// The cluster barrier in its two halves: a CTA arrives once it has read
// what it needs of its peers' shared memory, and waits before it exits, so
// that no CTA leaves while a peer may still read its Hy
__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" : : : "memory");
}
__device__ inline void cluster_wait() { asm volatile("barrier.cluster.wait;\n" : : : "memory"); }

// 16 bytes of W words, or one word: a lane group's unit of copy
template <typename T, int W>
using LaneGroup = typename std::conditional<W * sizeof(T) == 16, uint4, T>::type;

// Calls f(i, j) for this thread's share of the entries i < rows, j0 <= j <
// j1: the flat index i (j1 - j0) + j - j0 from t / per in steps of NT /
// per, carried without a division a step
template <typename F>
__device__ inline void walk_entries(int t, int per, int NT, int rows, int j0, int j1, F&& f) {
  const int width = j1 - j0;
  if (width <= 0) return;
  const int first = t / per, stride = NT / per;
  const int di = stride / width, dj = stride - di * width;
  int i = first / width, j = first - i * width;
  while (i < rows) {
    f(i, j0 + j);
    i += di;
    j += dj;
    if (j >= width) {
      j -= width;
      ++i;
    }
  }
}

// the columns come in kChunks chunks: chunk c + 1 of the slab is in flight
// while Hy sums over chunk c, and H' of chunk c is stored while the rows of
// chunk c + 1 are formed
constexpr int kChunks = 2;
constexpr int kMaxCluster = 16;
constexpr int kGather = 8;
constexpr int kClusterThreads = 256;  // the most threads a CTA: a row and lane each

// One cluster of C CTAs a tile of TB = blockDim.x lanes; thread (tb, r) of
// CTA k owns row k R + r of its lane (RT = blockDim.y >= R).  W: lanes a
// copy moves (16 bytes, or one word).
template <typename T, int W>
__global__ void __launch_bounds__(kClusterThreads)
    rank2_cluster_kernel(const T* __restrict__ H, const T* __restrict__ s,
                         const T* __restrict__ y, const T* __restrict__ g,
                         const T* __restrict__ rho, const uint8_t* __restrict__ reset,
                         T* __restrict__ Hout, T* __restrict__ dout, int n, int R, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  const int TB = blockDim.x, RT = blockDim.y;
  const int tb = threadIdx.x, r = threadIdx.y;
  const int t = r * TB + tb, NT = TB * RT;
  const int ld = n | 1;
  const int lo = k * R, rows = max(0, min(R, n - lo)), gi = lo + r;
  const bool mine = r < rows;  // this thread owns row gi
  const int64_t b0 = static_cast<int64_t>(blockIdx.x / C) * TB, b = b0 + tb;
  const bool live = b < B;
  const bool rst = live && reset[b] != 0;
  T* sH = reinterpret_cast<T*>(smem_raw);           // [R][ld][TB], row lo + i at i
  T* ss = sH + static_cast<size_t>(R) * ld * TB;    // [n][TB] each
  T* sy = ss + n * TB;
  T* sg = sy + n * TB;
  T* sHy = sg + n * TB;
  T* hrow = sH + static_cast<size_t>(r) * ld * TB + tb;  // row gi of this lane, stride TB
  const auto chunk = [n](int ch) { return ch * n / kChunks; };

  // the lanes whose H is read, bit tb: each warp holds every lane of the
  // tile (TB divides 32), the last one perhaps fewer than 32 threads
  const int first = t & ~31;
  const unsigned warp_mask = NT - first >= 32 ? 0xffffffffu : (1u << (NT - first)) - 1u;
  const unsigned wanted = __ballot_sync(warp_mask, live && !rst);
  const int per = TB / W, c = t % per;  // lane groups an entry, and this thread's
  const bool group_live = b0 + c * W < B;
  const bool group_wanted = (wanted >> (c * W)) & ((1u << W) - 1u);
  // this thread's lane group of entry (lo + i, j): in the slab, in H and H'
  const auto slab = [&](int i, int j) {
    return sH + (static_cast<size_t>(i) * ld + j) * TB + c * W;
  };
  const auto dram = [&](int i, int j) {
    return (static_cast<int64_t>(lo + i) * n + j) * B + b0 + c * W;
  };
  for (int q = t; q < n * per; q += NT) {
    const int j = q / per, cq = q - j * per;
    if (b0 + cq * W < B) {
      const int64_t from = static_cast<int64_t>(j) * B + b0 + cq * W;
      const int to = j * TB + cq * W;
      __pipeline_memcpy_async(ss + to, s + from, W * sizeof(T));
      __pipeline_memcpy_async(sy + to, y + from, W * sizeof(T));
      __pipeline_memcpy_async(sg + to, g + from, W * sizeof(T));
    }
  }
  for (int ch = 0; ch < kChunks; ++ch) {
    if (group_wanted)
      walk_entries(t, per, NT, rows, chunk(ch), chunk(ch + 1), [&](int i, int j) {
        __pipeline_memcpy_async(slab(i, j), H + dram(i, j), W * sizeof(T));
      });
    __pipeline_commit();
  }

  // Hy of this CTA's rows chunk by chunk, in ascending j; a reset lane's
  // row takes the identity once its chunk has landed
  T acc = T(0);
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    __pipeline_wait_prior(kChunks - 1 - ch);
    __syncthreads();
    if (mine) {
      const int j0 = chunk(ch), j1 = chunk(ch + 1);
      if (rst)
        for (int j = j0; j < j1; ++j) hrow[j * TB] = T(gi == j);
      for (int j = j0; j < j1; ++j) acc = rn::add(acc, rn::mul(hrow[j * TB], sy[j * TB + tb]));
    }
  }
  if (mine) sHy[gi * TB + tb] = acc;
  // every CTA holds its rows of Hy, and every CTA of the cluster runs
  cluster.sync();
  // the other CTAs' rows of Hy, kGather loads in flight before any store
  for (int o0 = 0; o0 < C; o0 += kGather) {
    T got[kGather];
    const int span = R * TB;
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int o = o0 + u, q = o * span + t;
      if (o < C && o != k && t < span && q < n * TB) got[u] = cluster.map_shared_rank(sHy, o)[q];
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int o = o0 + u, q = o * span + t;
      if (o < C && o != k && t < span && q < n * TB) sHy[q] = got[u];
    }
  }
  cluster_arrive();
  __syncthreads();
  T yHy = T(0);
  for (int i = 0; i < n; ++i) yHy = rn::add(yHy, rn::mul(sy[i * TB + tb], sHy[i * TB + tb]));
  const T rb = live ? rho[b] : T(0);
  const T cb = coefficient(rb, yHy);

  // H' in place of Heff and d', chunk by chunk in ascending j; each chunk
  // of H' leaves by 16-byte stores while the next is formed
  acc = T(0);
  const T si = mine ? ss[gi * TB + tb] : T(0), hyi = mine ? sHy[gi * TB + tb] : T(0);
  for (int ch = 0; ch < kChunks; ++ch) {
    const int j0 = chunk(ch), j1 = chunk(ch + 1);
    if (mine)
      for (int j = j0; j < j1; ++j) {
        const T hn = updated(hrow[j * TB], rb, cb, si, ss[j * TB + tb], hyi, sHy[j * TB + tb]);
        hrow[j * TB] = hn;
        acc = rn::add(acc, rn::mul(hn, sg[j * TB + tb]));
      }
    __syncthreads();
    if (group_live)
      walk_entries(t, per, NT, rows, j0, j1, [&](int i, int j) {
        *reinterpret_cast<LaneGroup<T, W>*>(Hout + dram(i, j)) =
            *reinterpret_cast<const LaneGroup<T, W>*>(slab(i, j));
      });
  }
  if (live && mine) dout[static_cast<int64_t>(gi) * B + b] = -acc;
  cluster_wait();
}

template <typename T, int W>
int launch_cluster_width(const void* H, const void* s, const void* y, const void* g,
                         const void* rho, const void* reset, void* Hout, void* dout, int n,
                         int64_t B, int C, int TB, cudaStream_t st) {
  const int R = (n + C - 1) / C;
  // a thread a row and lane, in whole warps where the rows allow
  const int step = TB < 32 ? 32 / TB : 1;
  const int RT = (R + step - 1) / step * step;
  if (RT * TB > kClusterThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      (static_cast<size_t>(R) * (n | 1) + 4 * static_cast<size_t>(n)) * TB * sizeof(T);
  if (bytes > static_cast<size_t>(kMaxDynamicSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = rank2_cluster_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((B + TB - 1) / TB * C));
  cfg.blockDim = dim3(TB, RT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(H), static_cast<const T*>(s),
                           static_cast<const T*>(y), static_cast<const T*>(g),
                           static_cast<const T*>(rho), static_cast<const uint8_t*>(reset),
                           static_cast<T*>(Hout), static_cast<T*>(dout), n, R, B);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies where every lane group of 16 bytes is whole and aligned
template <typename T>
int launch_cluster(const void* H, const void* s, const void* y, const void* g, const void* rho,
                   const void* reset, void* Hout, void* dout, int n, int64_t B, int C, int TB,
                   void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (n < 1 || B < 1 || C < 1 || C > kMaxCluster || TB < kVec || TB > 32 || (TB & (TB - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B % kVec == 0 && aligned(H) && aligned(s) && aligned(y) && aligned(g) && aligned(Hout))
    return launch_cluster_width<T, kVec>(H, s, y, g, rho, reset, Hout, dout, n, B, C, TB, st);
  return launch_cluster_width<T, 1>(H, s, y, g, rho, reset, Hout, dout, n, B, C, TB, st);
}

// ---------------------------------------------------------------- K4b-t

// the chunks of columns in flight, and the most threads a CTA (a row and
// lane each)
constexpr int kRing = 2;
constexpr int kStreamThreads = 512;

// L2 policies: a row's first read marked to stay for its second, which
// marks it to go; evict-normal for probe mode 2, as a plain load
__device__ inline uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ inline uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ inline uint64_t l2_evict_normal() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// W words of T from device to shared memory by cp.async under an L2 policy
template <typename T, int W>
__device__ inline void copy_hinted(T* dst, const T* src, uint64_t policy) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (W * sizeof(T) == 16) {
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
                 ::"r"(to), "l"(src), "l"(policy) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3;\n"
                 ::"r"(to), "l"(src), "n"(static_cast<int>(W * sizeof(T))), "l"(policy)
                 : "memory");
  }
}

// One row's H' in place and its d' sum carried on, over columns j0 .. j1 -
// 1: h points at column j0 of the row (this lane, entries TB apart), ss, sHy
// and sg at this lane's s, Hy and g, each entry the identity's where
// ``eye``; the sums run in ascending j.
template <typename T>
__device__ inline T row_update(T* h, int j0, int j1, int gi, bool eye, T rb, T cb, T si, T hyi,
                               const T* ss, const T* sHy, const T* sg, int TB, T acc) {
  for (int j = j0; j < j1; ++j) {
    const T hn = updated(eye ? T(gi == j) : h[(j - j0) * TB], rb, cb, si, ss[j * TB], hyi,
                         sHy[j * TB]);
    h[(j - j0) * TB] = hn;
    acc = rn::add(acc, rn::mul(hn, sg[j * TB]));
  }
  return acc;
}

// K4b-c's cluster with C up to 16, whose CTA streams its R rows twice
// through a ring of kRing chunks of CW columns: the first pass sums their Hy
// (the reads marked evict-last in L2), the second forms their H' and d'
// (the reads marked evict-first).  Between the passes the cluster barrier
// and Hy gathered from the peers, and y^T Hy summed once a lane.  Every sum
// is K4b's, in its order.  Probe modes: 1 leaves out the arithmetic (the
// sums and H'), so that H goes out as it came in; 2 reads H without the L2
// hints.
template <typename T, int W>
__global__ void __launch_bounds__(kStreamThreads)
    rank2_streamed_kernel(const T* __restrict__ H, const T* __restrict__ s,
                          const T* __restrict__ y, const T* __restrict__ g,
                          const T* __restrict__ rho, const uint8_t* __restrict__ reset,
                          T* __restrict__ Hout, T* __restrict__ dout, int n, int R, int CW,
                          int mode, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  const int TB = blockDim.x, RT = blockDim.y;
  const int tb = threadIdx.x, r = threadIdx.y;
  const int t = r * TB + tb, NT = TB * RT;
  const int ldc = CW | 1;
  const int lo = k * R, rows = max(0, min(R, n - lo)), gi = lo + r;
  const bool mine = r < rows, arith = mode != 1;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x / C) * TB, b = b0 + tb;
  const bool live = b < B;
  const bool rst = live && reset[b] != 0;
  T* ring = reinterpret_cast<T*>(smem_raw);                     // [kRing][R][ldc][TB]
  T* ss = ring + static_cast<size_t>(kRing) * R * ldc * TB;     // [n][TB] each
  T* sy = ss + n * TB;
  T* sg = sy + n * TB;
  T* sHy = sg + n * TB;
  T* scoef = sHy + n * TB;                                      // [TB]
  const int chunks = (n + CW - 1) / CW;

  const int first = t & ~31;
  const unsigned warp_mask = NT - first >= 32 ? 0xffffffffu : (1u << (NT - first)) - 1u;
  const unsigned wanted = __ballot_sync(warp_mask, live && !rst);
  const int per = TB / W, c = t % per;
  const bool group_live = b0 + c * W < B;
  const bool group_wanted = (wanted >> (c * W)) & ((1u << W) - 1u);
  const auto dram = [&](int i, int j) {  // row lo + i
    return (static_cast<int64_t>(lo + i) * n + j) * B + b0 + c * W;
  };
  // row i's column j0 + jj of the chunk in slot u, lane 0
  const auto ring_at = [&](int u, int i, int jj) {
    return ring + ((static_cast<size_t>(u) * R + i) * ldc + jj) * TB;
  };
  const bool hinted = mode != 2;
  const uint64_t keep = hinted ? l2_evict_last() : l2_evict_normal();
  const uint64_t drop = hinted ? l2_evict_first() : l2_evict_normal();
  // chunk q into slot q % kRing; a group a call, empty past the last chunk,
  // so that every thread counts the same groups
  const auto fetch = [&](int q, uint64_t policy) {
    if (q < chunks && group_wanted) {
      const int j0 = q * CW, j1 = min(n, j0 + CW);
      walk_entries(t, per, NT, rows, j0, j1, [&](int i, int j) {
        copy_hinted<T, W>(ring_at(q % kRing, i, j - j0) + c * W, H + dram(i, j), policy);
      });
    }
    __pipeline_commit();
  };
  for (int q = t; q < n * per; q += NT) {  // s, y, g: in the first chunk's group
    const int j = q / per, cq = q - j * per;
    if (b0 + cq * W < B) {
      const int64_t from = static_cast<int64_t>(j) * B + b0 + cq * W;
      const int to = j * TB + cq * W;
      __pipeline_memcpy_async(ss + to, s + from, W * sizeof(T));
      __pipeline_memcpy_async(sy + to, y + from, W * sizeof(T));
      __pipeline_memcpy_async(sg + to, g + from, W * sizeof(T));
    }
  }
  for (int q = 0; q < kRing; ++q) fetch(q, keep);

  // the first pass: Hy in ascending j, a reset lane's row the identity
  T acc = T(0);
  for (int q = 0; q < chunks; ++q) {
    __pipeline_wait_prior(kRing - 1);
    __syncthreads();
    if (mine && arith) {
      const int j0 = q * CW, j1 = min(n, j0 + CW);
      const T* row = ring_at(q % kRing, r, 0) + tb;
      for (int j = j0; j < j1; ++j) {
        const T h = rst ? T(gi == j) : row[(j - j0) * TB];
        acc = rn::add(acc, rn::mul(h, sy[j * TB + tb]));
      }
    }
    __syncthreads();
    fetch(q + kRing, keep);
  }
  for (int q = 0; q < kRing; ++q) fetch(q, drop);  // the second pass's first chunks
  if (mine) sHy[gi * TB + tb] = acc;
  cluster.sync();
  for (int o0 = 0; o0 < C; o0 += kGather) {
    T got[kGather];
    const int span = R * TB;
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int o = o0 + u, q = o * span + t;
      if (o < C && o != k && t < span && q < n * TB) got[u] = cluster.map_shared_rank(sHy, o)[q];
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int o = o0 + u, q = o * span + t;
      if (o < C && o != k && t < span && q < n * TB) sHy[q] = got[u];
    }
  }
  cluster_arrive();
  __syncthreads();
  const T rb = live ? rho[b] : T(0);
  if (r == 0) {  // y^T Hy once a lane, in ascending i
    T yHy = T(0);
    for (int i = 0; i < n; ++i) yHy = rn::add(yHy, rn::mul(sy[i * TB + tb], sHy[i * TB + tb]));
    scoef[tb] = coefficient(rb, yHy);
  }
  __syncthreads();
  const T cb = scoef[tb];

  // the second pass: H' in place in the ring, stored chunk by chunk
  acc = T(0);
  const T si = mine ? ss[gi * TB + tb] : T(0), hyi = mine ? sHy[gi * TB + tb] : T(0);
  for (int q = 0; q < chunks; ++q) {
    const int j0 = q * CW, j1 = min(n, j0 + CW);
    __pipeline_wait_prior(kRing - 1);
    __syncthreads();
    if (mine && arith)
      acc = row_update(ring_at(q % kRing, r, 0) + tb, j0, j1, gi, rst, rb, cb, si, hyi, ss + tb,
                       sHy + tb, sg + tb, TB, acc);
    __syncthreads();
    if (group_live)
      walk_entries(t, per, NT, rows, j0, j1, [&](int i, int j) {
        *reinterpret_cast<LaneGroup<T, W>*>(Hout + dram(i, j)) =
            *reinterpret_cast<const LaneGroup<T, W>*>(ring_at(q % kRing, i, j - j0) + c * W);
      });
    __syncthreads();
    fetch(q + kRing, drop);
  }
  if (live && mine) dout[static_cast<int64_t>(gi) * B + b] = -acc;
  cluster_wait();
}

template <typename T, int W>
int launch_streamed_width(const void* H, const void* s, const void* y, const void* g,
                          const void* rho, const void* reset, void* Hout, void* dout, int n,
                          int64_t B, int C, int TB, int CW, int mode, cudaStream_t st) {
  const int R = (n + C - 1) / C;
  const int step = TB < 32 ? 32 / TB : 1;
  const int RT = (R + step - 1) / step * step;
  if (CW < 1 || CW > n || RT * TB > kStreamThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      (static_cast<size_t>(kRing) * R * (CW | 1) + 4 * static_cast<size_t>(n) + 1) * TB * sizeof(T);
  if (bytes > static_cast<size_t>(kMaxDynamicSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = rank2_streamed_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((B + TB - 1) / TB * C));
  cfg.blockDim = dim3(TB, RT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(H), static_cast<const T*>(s),
                           static_cast<const T*>(y), static_cast<const T*>(g),
                           static_cast<const T*>(rho), static_cast<const uint8_t*>(reset),
                           static_cast<T*>(Hout), static_cast<T*>(dout), n, R, CW, mode, B);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_streamed(const void* H, const void* s, const void* y, const void* g, const void* rho,
                    const void* reset, void* Hout, void* dout, int n, int64_t B, int C, int TB,
                    int CW, int mode, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (n < 1 || B < 1 || C < 1 || C > kMaxCluster || TB < kVec || TB > 32 || (TB & (TB - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B % kVec == 0 && aligned(H) && aligned(s) && aligned(y) && aligned(g) && aligned(Hout))
    return launch_streamed_width<T, kVec>(H, s, y, g, rho, reset, Hout, dout, n, B, C, TB, CW,
                                          mode, st);
  return launch_streamed_width<T, 1>(H, s, y, g, rho, reset, Hout, dout, n, B, C, TB, CW, mode,
                                     st);
}

// ---------------------------------------------------------------- K4c-w

// One warp an instance, up to 8 a block: H [n, n] staged in shared memory
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

// W consecutive words of T moved by one access: 16 bytes (float4, double2)
// or one word; ``load`` and ``store`` take a thread's words by constant
// index, so that an unrolled caller keeps them in registers
template <typename T, int W>
struct Words {
  static_assert(W == 1, "a vector access moves 16 bytes");
  __device__ static void load(T* dst, const T* src) { dst[0] = src[0]; }
  __device__ static void store(T* dst, const T* src) { dst[0] = src[0]; }
};
template <>
struct Words<float, 4> {
  __device__ static void load(float* dst, const float* src) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __device__ static void store(float* dst, const float* src) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  }
};
template <>
struct Words<double, 2> {
  __device__ static void load(double* dst, const double* src) {
    const double2 v = *reinterpret_cast<const double2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  }
  __device__ static void store(double* dst, const double* src) {
    *reinterpret_cast<double2*>(dst) = make_double2(src[0], src[1]);
  }
};

// 16-byte accesses where n words and every pointer keep each row of every
// instance on 16 bytes, else one word an access
template <typename T>
bool rows_aligned(int n, std::initializer_list<const void*> pointers) {
  if ((static_cast<size_t>(n) * sizeof(T)) % 16 != 0) return false;
  for (const void* p : pointers)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// ---------------------------------------------------------------- K4c-r

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kRowsThreads = 256;  // threads a block of K4c-r
constexpr int kRowsMost = 32;      // K4c-r's largest n: an instance's rows within a warp

// Calls f(e, at) for the words e = lane, lane + 32, ... below ``words`` of
// a warp's span of instances (one run of memory) and the place of word e
// in the warp's slab in shared memory, row e / n of ld words at ``at`` =
// (e / n) ld + e % n; the row and column are carried from one word to the
// next without a division
template <typename F>
__device__ inline void walk_span(int words, int n, int ld, int lane, F&& f) {
  const int dr = 32 / n, dc = 32 - dr * n;
  int r = lane / n, c = lane - r * n;
  for (int e = lane; e < words; e += 32) {
    f(e, r * ld + c);
    r += dr;
    c += dc;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

// Thread i of an instance holds row i of H in registers (NMAX >= n words);
// a warp packs floor(32 / n) instances, lanes q n .. q n + n - 1 for
// instance q, and the lanes past the last instance (or past B) run along
// without loading or storing, so that every shuffle finds the whole warp.
// A row comes from device memory (W words an access), or with STAGED
// through the warp's slab in shared memory: the warp's instances, one run
// of memory, are copied in and out by coalesced one-word accesses, rows
// n | 1 words apart (odd, so that the lanes' rows fall in distinct banks),
// ordered by __syncwarp alone.  Hy_i over ascending j with y_j shuffled
// from lane j; y^T Hy over ascending i from the lanes' products, the same
// sum in every lane; then row i of H' with s_j and Hy_j shuffled from lane
// j.
template <typename T, int NMAX, int W, bool STAGED>
__global__ void __launch_bounds__(kRowsThreads)
    rank2_batched_rows_kernel(const T* __restrict__ H, const T* __restrict__ s,
                              const T* __restrict__ y, const T* __restrict__ rho,
                              T* __restrict__ Hout, int n, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int per = 32 / n;                     // instances a warp
  const int q = lane / n, i = lane - q * n;   // instance of the warp, row
  const int base = q * n;                     // the instance's first lane
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t b0 = warp * per, b = b0 + q;
  const bool live = q < per && b < B;
  const int64_t row = (b * n + i) * n;
  const int ld = n | 1;
  // the warp's slab, [per n][ld], and the words of its instances
  T* slab = reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * per * n * ld;
  const int words = static_cast<int>(max(int64_t(0), min(int64_t(per), B - b0))) * n * n;
  T h[NMAX];
  T yi = T(0), si = T(0), rb = T(0);
#pragma unroll
  for (int j = 0; j < NMAX; ++j) h[j] = T(0);
  if (STAGED) {
    const T* span = H + b0 * n * n;
    walk_span(words, n, ld, lane, [&](int e, int at) { slab[at] = span[e]; });
    __syncwarp();
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NMAX; j += W) {
      if (j >= n) break;
      if (STAGED)
        for (int k = 0; k < W; ++k) h[j + k] = slab[lane * ld + j + k];
      else
        Words<T, W>::load(h + j, H + row + j);
    }
    yi = y[b * n + i];
    si = s[b * n + i];
    rb = rho[b];
  }
  T hyi = T(0);
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j >= n) break;
    hyi = rn::add(hyi, rn::mul(h[j], __shfl_sync(kFullWarp, yi, base + j)));
  }
  const T p = rn::mul(yi, hyi);
  T yHy = T(0);
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (k >= n) break;
    yHy = rn::add(yHy, __shfl_sync(kFullWarp, p, base + k));
  }
  const T cb = coefficient(rb, yHy);
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j >= n) break;
    const T sj = __shfl_sync(kFullWarp, si, base + j);
    const T hyj = __shfl_sync(kFullWarp, hyi, base + j);
    h[j] = updated(h[j], rb, cb, si, sj, hyi, hyj);
  }
  if (STAGED) {
    if (live) {
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j >= n) break;
        slab[lane * ld + j] = h[j];
      }
    }
    __syncwarp();
    T* span = Hout + b0 * n * n;
    walk_span(words, n, ld, lane, [&](int e, int at) { span[e] = slab[at]; });
    return;
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < NMAX; j += W) {
    if (j >= n) break;
    Words<T, W>::store(Hout + row + j, h + j);
  }
}

template <typename T, int NMAX, int W, bool STAGED>
int launch_rows_width(const T* H, const T* s, const T* y, const T* rho, T* Hout, int n, int64_t B,
                      cudaStream_t st) {
  const int per = 32 / n;
  const int64_t warps = (B + per - 1) / per;
  const int64_t blocks = (warps * 32 + kRowsThreads - 1) / kRowsThreads;
  const size_t bytes =
      STAGED ? static_cast<size_t>(kRowsThreads / 32) * per * n * (n | 1) * sizeof(T) : 0;
  const auto kernel = rank2_batched_rows_kernel<T, NMAX, W, STAGED>;
  if (bytes > static_cast<size_t>(kOptInAbove)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kRowsThreads, bytes, st>>>(H, s, y, rho, Hout, n, B);
  return static_cast<int>(cudaGetLastError());
}

// staged (one-word accesses through shared memory), or straight from
// device memory by 16-byte accesses where every row lies on 16 bytes
template <typename T, int NMAX>
int launch_rows_room(const T* H, const T* s, const T* y, const T* rho, T* Hout, int n, int64_t B,
                     bool staged, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (staged) return launch_rows_width<T, NMAX, 1, true>(H, s, y, rho, Hout, n, B, st);
  if (rows_aligned<T>(n, {H, Hout}))
    return launch_rows_width<T, NMAX, kVec, false>(H, s, y, rho, Hout, n, B, st);
  return launch_rows_width<T, NMAX, 1, false>(H, s, y, rho, Hout, n, B, st);
}

// the least room of 4, 8, 16 or 32 words that holds n
template <typename T>
int launch_rows(const void* H, const void* s, const void* y, const void* rho, void* Hout, int n,
                int64_t B, int staged, void* stream) {
  if (n < 1 || n > kRowsMost || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto Hp = static_cast<const T*>(H);
  const auto sp = static_cast<const T*>(s);
  const auto yp = static_cast<const T*>(y);
  const auto rp = static_cast<const T*>(rho);
  const auto Op = static_cast<T*>(Hout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sg = staged != 0;
  if (n <= 4) return launch_rows_room<T, 4>(Hp, sp, yp, rp, Op, n, B, sg, st);
  if (n <= 8) return launch_rows_room<T, 8>(Hp, sp, yp, rp, Op, n, B, sg, st);
  if (n <= 16) return launch_rows_room<T, 16>(Hp, sp, yp, rp, Op, n, B, sg, st);
  return launch_rows_room<T, 32>(Hp, sp, yp, rp, Op, n, B, sg, st);
}

// ---------------------------------------------------------------- K4c-g

constexpr int kGlobalRows = 128;  // rows a block of the first pass, a thread each
constexpr int kGlobalCols = 32;   // columns of a staged tile
constexpr int kApplyRows = 8;     // rows a block of the second pass, a warp each

// Pass 1: Hy [B, n].  A block takes kGlobalRows rows of one instance and
// walks their columns in tiles of kGlobalCols, each tile staged in shared
// memory by coalesced accesses of W words (a row's tile is one run of
// memory), each thread then summing its row's tile in ascending j.  A
// thread's share of the next tile (kPer accesses, one column group of
// rows kGlobalRows / kPer apart) is loaded into registers while the tile
// in shared memory is summed.
template <typename T, int W>
__global__ void __launch_bounds__(kGlobalRows)
    rank2_batched_hy_kernel(const T* __restrict__ H, const T* __restrict__ y, T* __restrict__ Hy,
                            int n, int tiles) {
  __shared__ T tile[kGlobalRows][kGlobalCols + 1];
  __shared__ T ty[kGlobalCols];
  constexpr int kPer = kGlobalCols / W;      // accesses a row's tile, and a thread's
  constexpr int kStep = kGlobalRows / kPer;  // rows between a thread's accesses
  const int64_t b = blockIdx.x / tiles;
  const int r0 = static_cast<int>(blockIdx.x - b * tiles) * kGlobalRows;
  const int rows = min(kGlobalRows, n - r0), t = threadIdx.x;
  const int r1 = t / kPer, c = (t - r1 * kPer) * W;  // this thread's first row and its column
  const T* Hb = H + (b * n + r0) * n;
  const T* yb = y + b * n;
  T next[kPer][W], ynext = T(0);
  const auto fetch = [&](int j0) {
    const int width = min(kGlobalCols, n - j0);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = r1 + k * kStep;
      if (r < rows && c < width)
        Words<T, W>::load(next[k], Hb + static_cast<int64_t>(r) * n + j0 + c);
    }
    if (t < width) ynext = yb[j0 + t];
  };
  fetch(0);
  T acc = T(0);
  for (int j0 = 0; j0 < n; j0 += kGlobalCols) {
    const int width = min(kGlobalCols, n - j0);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
#pragma unroll
      for (int w = 0; w < W; ++w) tile[r1 + k * kStep][c + w] = next[k][w];
    if (t < width) ty[t] = ynext;
    __syncthreads();
    if (j0 + kGlobalCols < n) fetch(j0 + kGlobalCols);
    if (t < rows)
      for (int j = 0; j < width; ++j) acc = rn::add(acc, rn::mul(tile[t][j], ty[j]));
    __syncthreads();
  }
  if (t < rows) Hy[b * n + r0 + t] = acc;
}

// y^T Hy and the coefficient, a warp an instance: the products of 32 rows
// at a time by coalesced loads, the next 32 loaded while these are summed
// in ascending i, every product shuffled to every lane ahead of the chain
// of additions
template <typename T>
__global__ void rank2_batched_coef_kernel(const T* __restrict__ y, const T* __restrict__ Hy,
                                          const T* __restrict__ rho, T* __restrict__ coef, int n,
                                          int64_t B) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (b >= B) return;  // a whole warp leaves
  const auto product = [&](int i) {
    return i < n ? rn::mul(y[b * n + i], Hy[b * n + i]) : T(0);
  };
  T yHy = T(0), p = product(lane);
  for (int i0 = 0; i0 < n; i0 += 32) {
    const T q = product(i0 + 32 + lane);
    T all[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) all[k] = __shfl_sync(kFullWarp, p, k);
    const int m = min(32, n - i0);
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < m) yHy = rn::add(yHy, all[k]);
    p = q;
  }
  if (lane == 0) coef[b] = coefficient(rho[b], yHy);
}

// Pass 2: H' [B, n, n], a warp a row, its lanes over the row's columns W
// words at a time; H read again, s and Hy from L1
template <typename T, int W>
__global__ void __launch_bounds__(32 * kApplyRows)
    rank2_batched_apply_kernel(const T* __restrict__ H, const T* __restrict__ s,
                               const T* __restrict__ rho, const T* __restrict__ coef,
                               const T* __restrict__ Hy, T* __restrict__ Hout, int n, int tiles) {
  const int64_t b = blockIdx.x / tiles;
  const int i = static_cast<int>(blockIdx.x - b * tiles) * kApplyRows + threadIdx.y;
  if (i >= n) return;
  const T rb = rho[b], cb = coef[b];
  const T* sb = s + b * n;
  const T* hb = Hy + b * n;
  const T si = sb[i], hyi = hb[i];
  const int64_t row = (b * n + i) * n;
  for (int j = threadIdx.x * W; j < n; j += 32 * W) {
    T h[W], sj[W], hyj[W];
    Words<T, W>::load(h, H + row + j);
    Words<T, W>::load(sj, sb + j);
    Words<T, W>::load(hyj, hb + j);
#pragma unroll
    for (int k = 0; k < W; ++k) h[k] = updated(h[k], rb, cb, si, sj[k], hyi, hyj[k]);
    Words<T, W>::store(Hout + row + j, h);
  }
}

template <typename T, int W>
int launch_global_width(const T* H, const T* s, const T* y, const T* rho, T* Hy, T* coef,
                        T* Hout, int n, int64_t B, int mode, cudaStream_t st) {
  const int tiles = (n + kGlobalRows - 1) / kGlobalRows;
  rank2_batched_hy_kernel<T, W><<<static_cast<unsigned>(B * tiles), kGlobalRows, 0, st>>>(
      H, y, Hy, n, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || mode == 2) return static_cast<int>(err);
  rank2_batched_coef_kernel<T><<<static_cast<unsigned>((B + 7) / 8), 256, 0, st>>>(
      y, Hy, rho, coef, n, B);
  err = cudaGetLastError();
  if (err != cudaSuccess || mode == 1) return static_cast<int>(err);
  const int rows = (n + kApplyRows - 1) / kApplyRows;
  const dim3 block(32, kApplyRows);
  rank2_batched_apply_kernel<T, W><<<static_cast<unsigned>(B * rows), block, 0, st>>>(
      H, s, rho, coef, Hy, Hout, n, rows);
  return static_cast<int>(cudaGetLastError());
}

// probe modes: 1 the first pass and the coefficient alone (H' unwritten),
// 2 the first pass alone
template <typename T>
int launch_global(const void* H, const void* s, const void* y, const void* rho, void* Hy,
                  void* coef, void* Hout, int n, int64_t B, int mode, void* stream) {
  if (n < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVec = 16 / sizeof(T);
  const auto Hp = static_cast<const T*>(H);
  const auto sp = static_cast<const T*>(s);
  const auto yp = static_cast<const T*>(y);
  const auto rp = static_cast<const T*>(rho);
  const auto hy = static_cast<T*>(Hy);
  const auto cf = static_cast<T*>(coef);
  const auto Op = static_cast<T*>(Hout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_aligned<T>(n, {H, s, Hy, Hout}))
    return launch_global_width<T, kVec>(Hp, sp, yp, rp, hy, cf, Op, n, B, mode, st);
  return launch_global_width<T, 1>(Hp, sp, yp, rp, hy, cf, Op, n, B, mode, st);
}

}  // namespace

// Batch-minor: H, Hout [n, n, B]; s, y, g, dout [n, B]; rho [B]; reset [B]
// bytes (non-zero: use the identity for H).  Leading-batch: H, Hout
// [B, n, n]; s, y [B, n]; rho [B].  Hy ([n, B], or [B, n] for K4c-g) and
// coef [B] are scratch.
// The cluster form takes C CTAs a cluster (1 .. 16) and TB lanes a tile (a
// power of two, 1 .. 32); the streamed form C, TB, CW columns a chunk and a
// probe mode (0: the update).  Each returns cudaGetLastError().
#define RANK2_ENTRY_POINTS(T, SUFFIX)                                                         \
  extern "C" int rank2_resident_##SUFFIX(const void* H, const void* s, const void* y,         \
                                         const void* g, const void* rho, const void* reset,   \
                                         void* Hout, void* dout, int n, int64_t B,            \
                                         void* stream) {                                      \
    return launch_resident<T>(H, s, y, g, rho, reset, Hout, dout, n, B, stream);              \
  }                                                                                           \
  extern "C" int rank2_cluster_##SUFFIX(const void* H, const void* s, const void* y,          \
                                        const void* g, const void* rho, const void* reset,    \
                                        void* Hout, void* dout, int n, int64_t B, int C,      \
                                        int TB, void* stream) {                               \
    return launch_cluster<T>(H, s, y, g, rho, reset, Hout, dout, n, B, C, TB, stream);        \
  }                                                                                           \
  extern "C" int rank2_streamed_##SUFFIX(const void* H, const void* s, const void* y,         \
                                         const void* g, const void* rho, const void* reset,   \
                                         void* Hout, void* dout, int n, int64_t B, int C,     \
                                         int TB, int CW, int mode, void* stream) {            \
    return launch_streamed<T>(H, s, y, g, rho, reset, Hout, dout, n, B, C, TB, CW, mode,      \
                              stream);                                                        \
  }                                                                                           \
  extern "C" int rank2_rowsplit_##SUFFIX(const void* H, const void* s, const void* y,         \
                                         const void* g, const void* rho, const void* reset,   \
                                         void* Hy, void* coef, void* Hout, void* dout, int n, \
                                         int64_t B, void* stream) {                           \
    return launch_rowsplit<T>(H, s, y, g, rho, reset, Hy, coef, Hout, dout, n, B, stream);    \
  }                                                                                           \
  extern "C" int rank2_batched_warp_##SUFFIX(const void* H, const void* s, const void* y,     \
                                             const void* rho, void* Hout, int n, int64_t B,   \
                                             void* stream) {                                  \
    return launch_batched<T>(H, s, y, rho, Hout, n, B, stream);                               \
  }                                                                                           \
  extern "C" int rank2_batched_rows_##SUFFIX(const void* H, const void* s, const void* y,     \
                                             const void* rho, void* Hout, int n, int64_t B,   \
                                             int staged, void* stream) {                      \
    return launch_rows<T>(H, s, y, rho, Hout, n, B, staged, stream);                          \
  }                                                                                           \
  extern "C" int rank2_batched_global_##SUFFIX(const void* H, const void* s, const void* y,   \
                                               const void* rho, void* Hy, void* coef,         \
                                               void* Hout, int n, int64_t B, int mode,        \
                                               void* stream) {                                \
    return launch_global<T>(H, s, y, rho, Hy, coef, Hout, n, B, mode, stream);                \
  }

RANK2_ENTRY_POINTS(float, f32)
RANK2_ENTRY_POINTS(double, f64)
