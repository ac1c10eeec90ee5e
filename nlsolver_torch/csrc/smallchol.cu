// Batched small SPD solve, batch-minor layout, for Hopper (sm_90a):
// Cholesky factorization, forward and back substitution.
//
// Replaces nlsolver_tpu/ops/smallchol.py: solve_spd_batched_pallas, whose
// body (_chol_solve_batchminor) also serves the NLLS fleet's default
// cholesky backend through solve_spd_batchminor.  Here the kernels serve
// that call site directly: A [n, n, B], b [n, B] -> x [n, B].  Element
// (i, j) of lane b lies at (i * n + j) * B + b, so neighbouring lanes lie
// at neighbouring addresses and every access coalesces without a
// transpose.  Only the lower triangle of A is read.
//
// What bounds them: the compulsory traffic, (n (n + 1) / 2 + 2 n) B words
// (7.3 MB at n = 2, B = 262144 in f32, some 2.2 us at 3.35 TB/s), against
// some (n^3 / 3 + 2 n^2) B operations.  At the fleet's small n that is
// bytes, but the work of a lane is a serial chain of dependent roundings
// (about n^3 / 6 multiply-subtracts, n (n + 1) / 2 divisions and square
// roots, then n (n - 1) / 2 steps of the back solve), so what holds a
// kernel back is how much of that chain waits on memory and how many
// chains the card runs at once.  Six forms, chosen by n and dtype in
// ops/smallchol.py (``plan``):
//   * chol_registers_kernel<T, N> (K3-r): one thread a lane, L, z and x
//     in registers.  Every index is a compile-time constant, so nothing goes
//     through memory but the reads of A and b, all issued up front, and
//     the one write of x.  One kernel per n and dtype.
//   * chol_warp_kernel<T> (K3-w): one warp a lane, the lane's packed lower
//     triangle and its right-hand side in shared memory (below).  Its
//     instruction issue bounds it: some 2.4 times the floor of it at
//     [30, 30, 4096], most of it the trailing update and the per-step
//     column work (PERF.md).
//   * chol_cluster_kernel<T> (K3-c): one lane a thread-block cluster of 2,
//     4 or 8 CTAs, K3-w's packed rows split over their shared memory
//     (below); n <= 927 in f32, 645 in f64, past K3-w's.
//   * chol_distributed_kernel<T> (K3-d): one lane over P CTAs of the whole
//     card, K3-c's rows over their shared memory, the columns of L through
//     a store in device memory, a barrier in device memory a step, one
//     cooperative launch (below); past K3-c's n, as far as 132 CTAs hold
//     the rows (ops/smallchol.py's distributed_fits), by a direct call.
//   * chol_blocked_kernel<T> (K3-b): one lane over P CTAs of the whole
//     card, its triangle packed in device memory, factored by panels with
//     one barrier in device memory a panel, the back solve by columns
//     (below); every n past K3-c's.
//   * chol_global_kernel<T> (K3-g): one thread a lane, L in a batch-minor
//     scratch of n (n + 1) / 2 rows in device memory; any n, by a direct
//     call.  Every l(i, k) is a load from device memory.
//
// Arithmetic: each operation is rounded as the plain PyTorch twin
// (nlsolver_torch/linalg/solve.py:_solve_spd_unrolled, imported by
// ops/smallchol.py as _chol_solve_batchminor) rounds it, in its order,
// through the _rn intrinsics, so every form but K3-b is bit-equal to it: entry
// (i, j) of L is A[i, j] less L[i][k] L[j][k] for k = 0 .. j - 1 in
// ascending k, then its square root or its quotient by L[j][j]; z[i] is
// b[i] less L[i][k] z[k] in ascending k, over L[i][i]; x[i] is z[i] less
// L[k][i] x[k] for k = i + 1 .. n - 1 in ascending k, over L[i][i].  K3-b
// keeps the twin's L and z, and takes x[i]'s terms in descending k.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cuda_pipeline.h>

#include <cstdint>

#include "lane_barrier.cuh"
#include "rn_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxDynamicSmem = 232448;
// K3-w's table of (r, c) for the packed entries of a triangle's first 32
// rows (ops/smallchol.py's WARP_TABLE_BYTES: 2 bytes an entry)
constexpr int kTableEntries = 32 * 33 / 2;

// K3-r's most n, by word size (ops/smallchol.py's REGISTER_MAX_N): a
// lane's n (n + 3) / 2 words stay in registers with no local memory (phase
// 2 of chip_smoke.py checks ptxas's report)
constexpr int kRegisterMaxN32 = 19, kRegisterMaxN64 = 13;

// K3-r's loads: volatile, so they are issued in program order, all of them
// before the first hold; a hold makes its value live in a register at that
// point, so no operation starts before every load has been issued.  (Left
// to itself the compiler sinks each load to its first use, and the loads'
// latencies add up along the chain: three times the time at n = 12 on an
// H100, PERF.md.)
__device__ __forceinline__ void load_nc(const float* p, float& v) {
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
}
__device__ __forceinline__ void load_nc(const double* p, double& v) {
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
}
__device__ __forceinline__ void hold(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void hold(double& v) { asm volatile("" : "+d"(v)); }

// K3-r: lane b in thread b.  Row i of L packed at i (i + 1) / 2; the loads
// of A's lower triangle and of b are all issued before the first
// operation, then L overwrites A, z overwrites b and x overwrites z, in
// registers.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    chol_registers_kernel(const T* __restrict__ A, const T* __restrict__ rhs,
                          T* __restrict__ x, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T L[N * (N + 1) / 2], z[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j)
      load_nc(A + (static_cast<int64_t>(i) * N + j) * B + b, L[i * (i + 1) / 2 + j]);
    load_nc(rhs + static_cast<int64_t>(i) * B + b, z[i]);
  }
#pragma unroll
  for (int e = 0; e < N * (N + 1) / 2; ++e) hold(L[e]);
#pragma unroll
  for (int i = 0; i < N; ++i) hold(z[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T acc = L[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k)
        acc = rn::sub(acc, rn::mul(L[i * (i + 1) / 2 + k], L[j * (j + 1) / 2 + k]));
      L[i * (i + 1) / 2 + j] = i == j ? rn::sqrt(acc) : rn::div(acc, L[j * (j + 1) / 2 + j]);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = z[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = rn::sub(acc, rn::mul(L[i * (i + 1) / 2 + k], z[k]));
    z[i] = rn::div(acc, L[i * (i + 1) / 2 + i]);
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T acc = z[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) acc = rn::sub(acc, rn::mul(L[k * (k + 1) / 2 + i], z[k]));
    z[i] = rn::div(acc, L[i * (i + 1) / 2 + i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[static_cast<int64_t>(i) * B + b] = z[i];
}

// K3-w, one warp a lane.  What holds the thread-a-lane forms back past a
// few n: one chain of some n^3 / 6 dependent steps a lane, and few lanes
// to hide it (4096 lanes are 128 warps on 132 SMs).  Here a warp shares a
// lane's work:
//   * the lane's rows 0 .. n of a packed triangle in the warp's shared
//     memory: rows 0 .. n - 1 hold A's lower triangle, row n (n words, at
//     n (n + 1) / 2) holds b; then a column buffer of n + 1 words.  The
//     words a warp takes are odd in number, so the W lanes of a block fall
//     in distinct banks;
//   * the block's W lanes fetch their triangles together by cp.async, W
//     neighbouring words an entry (128 bytes in f32 at W = 32), and
//     store x the same way;
//   * the factorization is right-looking: at step j every thread takes
//     L[j][j] = sqrt(S[j][j]) itself (the same bits in each), the threads
//     divide column j below it, rows j + 1 .. n, into L's column and the
//     column buffer, and after a warp barrier update the trailing triangle,
//     S[i][l] -= L[i][j] L[l][j] for j < l <= i, l < n, its entries dealt
//     to the 32 threads in packed order (t, t + 32, ..), so every thread
//     gets the same count to within one whatever the row lengths (a row a
//     thread would leave the warp on the longest row, twice the mean).  In
//     rows shorter than the warp a thread's next entry lies rows further
//     on, so their (row, column) come from a block-wide table of the first
//     32 rows' entries; past them a thread steps to the next row at most
//     once.  Row n is b: its column j is z[j] = (b[j] less L[j][k] z[k]) /
//     L[j][j], so the forward solve rides the factorization as one more
//     row.  Each
//     entry still gets its subtractions in ascending k, then its square
//     root or division: the twin's roundings in the twin's order;
//   * the back solve runs row by row, x[i] = (z[i] less L[k][i] x[k] for k
//     = i + 1 .. n - 1 ascending) / L[i][i], from shared memory, x over z
//     in row n: subtracting in ascending k, x[i] waits on x[i + 1] for its
//     first step, so its n (n - 1) / 2 steps form one chain, and the
//     column-oriented order that would spread it over a warp subtracts in
//     descending k and is not the twin's.  So after a block barrier thread
//     w of warp 0 runs lane w's chain: the block issues it once for its W
//     lanes, not once a lane.
// A warp needs n (n + 1) / 2 + 2 n + 1 words, a block 1056 bytes more for
// the table: n <= 337 in f32, 238 in f64.
template <typename T>
__global__ void chol_warp_kernel(const T* __restrict__ A, const T* __restrict__ rhs,
                                 T* __restrict__ x, int n, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, shift = __ffs(W) - 1;  // lanes a block, a power of two
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int tri = n * (n + 1) / 2, words = (tri + 2 * n + 1) | 1;
  T* all = reinterpret_cast<T*>(smem);
  T* S = all + warp * words;  // row i at i (i + 1) / 2, i = 0 .. n
  T* col = S + tri + n;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * W;
  // (r, c) of packed entry e = r (r + 1) / 2 + c of a triangle's first 32
  // rows, r in the low byte, after the block's lanes
  unsigned short* rc = reinterpret_cast<unsigned short*>(all + W * words);
  for (int e = threadIdx.x; e < kTableEntries; e += blockDim.x) {
    int r = 0;
    while ((r + 1) * (r + 2) / 2 <= e) ++r;
    rc[e] = static_cast<unsigned short>(r | (e - r * (r + 1) / 2) << 8);
  }

  {
    // entry `at` of the packed rows 0 .. n and lane w: thread k of the
    // block fetches entries k / W, k / W + 32, .. of lane k % W
    const int w = threadIdx.x & (W - 1);
    int at = threadIdx.x >> shift, i = 0, j = at;
    while (j > i) j -= ++i;
    for (; at < tri + n; at += 32) {
      if (b0 + w < B) {
        const T* src = i < n ? A + (static_cast<int64_t>(i) * n + j) * B
                             : rhs + static_cast<int64_t>(j) * B;
        __pipeline_memcpy_async(all + w * words + at, src + b0 + w, sizeof(T));
      }
      j += 32;
      while (j > i) j -= ++i;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (b0 + warp < B) {
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      T* sj = S + j * (j + 1) / 2;
      const T d = rn::sqrt(sj[j]);
      {
        int i = j + 1 + t;
        T* si = S + i * (i + 1) / 2 + j;
#pragma unroll 1
        for (; i <= n; si += 32 * i + 528, i += 32) {  // i (i + 1) / 2 to (i + 32) (i + 33) / 2
          const T v = rn::div(*si, d);
          *si = v;
          col[i] = v;
        }
      }
      __syncwarp();
      if (t == 0) sj[j] = d;
      // trailing entry e = r (r + 1) / 2 + c is (i, l) = (a + r, a + c),
      // a = j + 1; the last row (i = n) stops at l = n - 1.  S[i][l] lies
      // at a (a + 1) / 2 + a + r a + e.  Rows r < 32 hold fewer entries
      // than the warp: their (r, c) come from the table; from row 32 on a
      // thread's next entry, 32 on, lies in its row or the next
      const int a = j + 1, count = (n - j) * (n - j + 1) / 2 - 1;
      T* s0 = S + a * (a + 1) / 2 + a;
      const T* ca = col + a;
      int e = t;
#pragma unroll 1
      for (; e < min(count, kTableEntries); e += 32) {
        const int v = rc[e], r = v & 0xff;
        T* p = s0 + r * a + e;
        *p = rn::sub(*p, rn::mul(ca[r], ca[v >> 8]));
      }
      int r = 32, c = e - kTableEntries;
#pragma unroll 1
      for (; e < count; e += 32, c += 32) {
        while (c > r) c -= ++r;
        T* p = s0 + r * a + e;
        *p = rn::sub(*p, rn::mul(ca[r], ca[c]));
      }
      __syncwarp();
    }
  }
  // the back solve, thread w of warp 0 for lane w of the block: the chain
  // of one lane issues once for W lanes.  Four terms a pass are fetched
  // before they are subtracted, still in ascending k
  __syncthreads();
  if (threadIdx.x < W && b0 + threadIdx.x < B) {
    const T* L = all + threadIdx.x * words;
    T* z = all + threadIdx.x * words + tri;
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {
      T acc = z[i];
      int k = i + 1;
      const T* l = L + k * (k + 1) / 2 + i;  // L[k][i]; L[k + 1][i] is k + 1 words on
#pragma unroll 1
      for (; k + 4 <= n; k += 4) {
        const T* l1 = l + k + 1;
        const T* l2 = l1 + k + 2;
        const T* l3 = l2 + k + 3;
        const T v0 = *l, v1 = *l1, v2 = *l2, v3 = *l3;
        const T x0 = z[k], x1 = z[k + 1], x2 = z[k + 2], x3 = z[k + 3];
        acc = rn::sub(acc, rn::mul(v0, x0));
        acc = rn::sub(acc, rn::mul(v1, x1));
        acc = rn::sub(acc, rn::mul(v2, x2));
        acc = rn::sub(acc, rn::mul(v3, x3));
        l = l3 + k + 4;
      }
#pragma unroll 1
      for (; k < n; ++k) {
        acc = rn::sub(acc, rn::mul(*l, z[k]));
        l += k + 1;
      }
      z[i] = rn::div(acc, L[i * (i + 1) / 2 + i]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n << shift; e += blockDim.x) {
    const int i = e >> shift, w = e & (W - 1);
    if (b0 + w < B) x[static_cast<int64_t>(i) * B + b0 + w] = all[w * words + tri + i];
  }
}

// K3-c, one lane a thread-block cluster.  Replaces solve_spd_batched_pallas
// (nlsolver_tpu/ops/smallchol.py:89) for n past K3-w's, where one lane's
// packed triangle no longer fits an SM (233 KB at n = 240 in f64).  What
// bounds K3-g there: one thread carries a lane's chain of some n^3 / 6
// dependent multiply-subtracts, each with two loads from L2, and 16 lanes
// are 16 threads on 132 SMs (184.5 ms at [240, 240, 16] f64, 254x the
// library's Cholesky factor and solve).  K3-w's right-looking scheme with
// the packed rows 0 .. n (b as row n) split over the C CTAs of a cluster:
//   * row i lives in CTA i % C, packed with the CTA's other rows (local row
//     l = i / C at l (r + 1) + C l (l - 1) / 2 in CTA r), so as step j moves
//     down every CTA keeps about as many trailing rows as the others; every
//     CTA also keeps the diagonal of all rows, updated as its owner updates
//     it (the same operations in the same order), so that each takes
//     sqrt(S[j][j]) from its own shared memory;
//   * column j of L (and z[j], row n's entry) is formed a step ahead: right
//     past the barrier of step j - 1 each CTA subtracts that step's product
//     from the column-j entries of its own rows, divides them by d =
//     sqrt(S[j][j]) and stores each quotient into the column row j % 3 of
//     every CTA (distributed shared memory); then it arrives at the cluster
//     barrier of step j, and only then subtracts col[i] col[l] of step j - 1
//     from the rest of its trailing rows (a warp a row, the entries over its
//     threads) and from its diagonal, and waits at the barrier.  So the
//     barrier's latency hides behind the trailing update, and the chain from
//     one column to the next is one update, a square root, a division and a
//     store into each CTA.  A CTA writes column row (j + 1) % 3 only past
//     the barrier of step j, which every CTA reaches after it has read row
//     (j - 2) % 3 for the last time: three rows, one barrier a step;
//   * the back solve runs in CTA 0 in the twin's order, from the last i: its
//     second warp gathers L[k][i - 1] (k = i - 1 .. n - 1) and z[i - 1] from
//     the CTAs that hold them (one remote load a thread, all in flight at
//     once) while its first warp forms the products L[k][i] x[k] of the
//     gathered column i and its first thread subtracts them in ascending k.
// Every value goes through the twin's operations in its order, so x is the
// twin's bit for bit.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// kProbe: the probes' instantiation, which takes a probe_mode (1: no back
// solve, x left unwritten; 2: the cluster barriers alone), the benches'
// split of a solve into its barriers, its factorization and its back
// solve; the main path's has mode 0 built in.
template <typename T, bool kProbe>
__global__ void __launch_bounds__(1024)
    chol_cluster_kernel(const T* __restrict__ A, const T* __restrict__ rhs,
                        T* __restrict__ x, int n, int words, int64_t B, int probe_mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, NT = blockDim.x, lane = t & 31, warp = t >> 5, W = NT >> 5;
  const int64_t b = blockIdx.x / C;
  const int mode = kProbe ? probe_mode : 0;
  if (mode == 2) {
    cluster.sync();
#pragma unroll 1
    for (int j = 0; j <= n; ++j) {
      cluster_arrive();
      cluster_wait();
    }
    cluster.sync();
    return;
  }
  T* S = reinterpret_cast<T*>(smem);  // this CTA's rows, packed: ``words`` words
  T* diag = S + words;                // S[i][i] of every row i < n
  T* col = diag + n;                  // [3][n + 1]: column j in row j % 3
  const int rows = rank <= n ? (n - rank) / C + 1 : 0;  // rows rank, rank + C, .. <= n
  // local row l of CTA r (row r + C l) starts at word l (r + 1) + C l (l - 1) / 2
  auto start = [&](int r, int l) { return l * (r + 1) + C * l * (l - 1) / 2; };
  // the first of this CTA's local rows past row j
  auto after = [&](int j) { return j + 1 - rank <= 0 ? 0 : (j + 1 - rank + C - 1) / C; };

  {
    // the CTA's packed rows (row n from b, n words): entry e, as local row l
    // and column c, by thread e % NT
    auto width = [&](int l) { return min(rank + C * l + 1, n); };
    int l = 0, c = t;
    while (l < rows && c >= width(l)) c -= width(l), ++l;
    for (int e = t; l < rows; e += NT) {
      const int i = rank + C * l;
      const T* src = i < n ? A + (static_cast<int64_t>(i) * n + c) * B
                           : rhs + static_cast<int64_t>(c) * B;
      __pipeline_memcpy_async(S + e, src + b, sizeof(T));
      c += NT;
      while (l < rows && c >= width(l)) c -= width(l), ++l;
    }
    for (int i = t; i < n; i += NT)
      __pipeline_memcpy_async(diag + i, A + (static_cast<int64_t>(i) * n + i) * B + b,
                              sizeof(T));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  // every CTA runs before any writes into another's shared memory
  cluster.sync();
  {
    // column 0
    const T d = rn::sqrt(diag[0]);
    for (int l = after(0) + t; l < rows; l += NT) {
      T* e = S + start(rank, l);
      const T v = rn::div(*e, d);
      *e = v;
      for (int r = 0; r < C; ++r) cluster.map_shared_rank(col, r)[rank + C * l] = v;
    }
    if (t == 0 && rank == 0) S[0] = d;
  }
  cluster_arrive();
  cluster_wait();
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const T* cj = col + (j % 3) * (n + 1);
    const int j1 = j + 1, l1 = after(j1);
    if (j1 < n) {
      // column j + 1 a step ahead: step j's product off its entries, then
      // the division by its diagonal's square root
      T* cn = col + (j1 % 3) * (n + 1);
      const T c1 = cj[j1];
      const T d = rn::sqrt(rn::sub(diag[j1], rn::mul(c1, c1)));
      for (int l = l1 + t; l < rows; l += NT) {
        const int i = rank + C * l;
        T* e = S + start(rank, l) + j1;
        const T v = rn::div(rn::sub(*e, rn::mul(cj[i], c1)), d);
        *e = v;
        for (int r = 0; r < C; ++r) cluster.map_shared_rank(cn, r)[i] = v;
      }
      if (t == 0 && j1 % C == rank) S[start(rank, j1 / C) + j1] = d;
    }
    cluster_arrive();  // column j + 1 in every CTA once all have arrived
    // the rest of step j: rows past j + 1, columns j + 2 .. min(i, n - 1)
    for (int l = l1 + warp; l < rows; l += W) {
      const int i = rank + C * l, end = min(i, n - 1);
      T* row = S + start(rank, l);
      const T ci = cj[i];
#pragma unroll 4
      for (int c = j + 2 + lane; c <= end; c += 32) row[c] = rn::sub(row[c], rn::mul(ci, cj[c]));
    }
    for (int i = j + 2 + t; i < n; i += NT) diag[i] = rn::sub(diag[i], rn::mul(cj[i], cj[i]));
    __syncthreads();
    cluster_wait();
  }
  // L and z final in every CTA; the back solve in CTA 0: x in col[0, n), the
  // gathered column i in col[n + (i & 1) (n + 1) + k], k = i .. n (L[i][i],
  // L[k][i], z[i]), which the first warp turns into the products L[k][i]
  // x[k] in place
  if (mode == 0 && rank == 0 && warp < 2) {
    T* xs = col;
    auto gather = [&](int i) {
      T* g = col + n + (i & 1) * (n + 1);
      for (int k = i + lane; k <= n; k += 32) {
        const int r = k % C;
        g[k] = cluster.map_shared_rank(S, r)[start(r, k / C) + i];
      }
    };
    if (warp == 1) gather(n - 1);
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {
      // column i gathered; the first warp done with column i + 1
      asm volatile("bar.sync 1, 64;\n" ::: "memory");
      if (warp == 1) {
        if (i > 0) gather(i - 1);
      } else {
        T* g = col + n + (i & 1) * (n + 1);
        for (int k = i + 1 + lane; k < n; k += 32) g[k] = rn::mul(g[k], xs[k]);
        __syncwarp();
        if (lane == 0) {
          T acc = g[n];
          for (int k = i + 1; k < n; ++k) acc = rn::sub(acc, g[k]);
          xs[i] = rn::div(acc, g[i]);
          x[static_cast<int64_t>(i) * B + b] = xs[i];
        }
        __syncwarp();
      }
    }
  }
  cluster.sync();  // no CTA leaves while CTA 0 reads its rows
}

// K3-c's launch: C CTAs a lane (2, 4 or 8) of ``threads`` threads (a
// multiple of 32, at least 64: the back solve takes two warps), ``words``
// the most words of packed rows a CTA holds.  ``mode`` 0 runs the main
// path's instantiation, 1 (no back solve) and 2 (the barriers alone) the
// probes'
template <typename T>
int launch_cluster(const void* A, const void* b, void* x, int n, int64_t B, int C, int threads,
                   int mode, void* stream) {
  if (n < 1 || B < 1 || (C != 2 && C != 4 && C != 8) || threads < 64 || threads > 1024 ||
      threads % 32 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int words = 0;
  for (int r = 0; r < C && r <= n; ++r) {
    int w = 0;
    for (int i = r; i <= n; i += C) w += i < n ? i + 1 : n;
    words = w > words ? w : words;
  }
  const int64_t smem = (static_cast<int64_t>(words) + n + 3 * (n + 1)) * sizeof(T);
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = mode ? chol_cluster_kernel<T, true> : chol_cluster_kernel<T, false>;
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
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(A),
                                             static_cast<const T*>(b), static_cast<T*>(x), n,
                                             words, B, mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K3-d, one lane over P CTAs of the whole card.  Replaces
// solve_spd_batched_pallas (nlsolver_tpu/ops/smallchol.py:89) for n past
// K3-c's, where 8 CTAs' shared memory no longer holds one lane's packed
// triangle (1.67 MB at n = 646 in f64).  What bounds K3-g there: one
// thread carries a lane's chain of some n^3 / 6 dependent multiply-subtracts,
// each with two loads from L2, and 2 lanes are 2 threads on 132 SMs (3.27 s
// at [646, 646, 2] f64).  K3-c's scheme over any number P of CTAs, with
// device memory in place of distributed shared memory:
//   * row i of the packed rows 0 .. n (b as row n) lives in CTA i % P's
//     shared memory, K3-c's layout with C = P, and every CTA keeps the
//     diagonal of all rows, updated as its owner updates it;
//   * the columns of L travel through a per-team store in device memory,
//     packed by column (column j, rows j .. n, z[j] in row n, at j (n + 1)
//     - j (j - 1) / 2): right past the barrier of step j - 1 each CTA
//     copies column j's rows j + 1 .. n from L2 into its shared memory,
//     forms column j + 1 of its own rows (step j's product off, then the
//     division by sqrt(S[j+1][j+1])) and stores it into the column store
//     once; then it arrives at the team's barrier of step j, subtracts
//     step j's products from the rest of its trailing rows and its
//     diagonal, and waits.  Each column is written once, so no column row
//     is reused and nothing else leaves a CTA during the factorization;
//   * the barrier is lane_barrier.cuh's: a counter a team in device
//     memory, every CTA of the team resident by a cooperative launch;
//   * the column store holds all of L once the last barrier has passed, and
//     CTA 0 of the team runs the back solve from it in the twin's order:
//     its warps past the first fetch column i - 1 from L2, and form its
//     products L[k][i - 1] x[k] but the first, while its first thread runs
//     column i's chain, subtracting in ascending k.  Its n (n - 1) / 2
//     dependent subtractions are this form's floor (8.4 clocks each in f64
//     on an H100), above the library's whole solve across the range, so the
//     dispatcher gives the range to K3-b and K3-d runs by a direct call; a
//     last barrier keeps the next lane's first column out of the store
//     until the solve has read it;
//   * a grid of ``teams`` teams of P CTAs walks the lanes, team g taking
//     lanes g, g + teams, ..
// ``mode`` 1 skips the back solve and 2 runs the barriers alone (the
// benches' probe of what each costs).  Every value goes through the twin's
// operations in its order, so x is the twin's bit for bit.
template <typename T>
__global__ void __launch_bounds__(1024)
    chol_distributed_kernel(const T* __restrict__ A, const T* __restrict__ rhs,
                            T* __restrict__ x, T* Lstore, unsigned* counts, int n, int P,
                            int words, int64_t B, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, NT = blockDim.x, lane = t & 31, warp = t >> 5, W = NT >> 5;
  const int teams = static_cast<int>(gridDim.x) / P, team = blockIdx.x / P;
  const int rank = blockIdx.x % P;
  T* S = reinterpret_cast<T*>(smem);  // this CTA's rows, packed: ``words`` words
  T* diag = S + words;                // S[i][i] of every row i < n
  T* col = diag + n;                  // column j at col[i], i = j + 1 .. n
  T* Lg = Lstore + static_cast<int64_t>(team) * (static_cast<int64_t>(n) * (n + 3) / 2);
  unsigned* count = counts + team;
  unsigned epoch = 0;
  const int rows = rank <= n ? (n - rank) / P + 1 : 0;  // rows rank, rank + P, .. <= n
  // local row l (row rank + P l) starts at word l (rank + 1) + P l (l - 1) / 2
  auto start = [&](int l) { return l * (rank + 1) + P * l * (l - 1) / 2; };
  // the first of this CTA's local rows past row j
  auto after = [&](int j) { return j + 1 - rank <= 0 ? 0 : (j + 1 - rank + P - 1) / P; };
  // L[i][j] of the column store at column(j)[i], i = j .. n
  auto column = [&](int j) {
    return Lg + static_cast<int64_t>(j) * (n + 1) - static_cast<int64_t>(j) * (j - 1) / 2 - j;
  };
  auto barrier = [&]() {
    lane::arrive(count);
    lane::wait(count, ++epoch * static_cast<unsigned>(P));
  };

#pragma unroll 1
  for (int64_t b = team; b < B; b += teams) {
    if (mode == 2) {
#pragma unroll 1
      for (int j = 0; j < n + 2; ++j) barrier();
      continue;
    }
    {
      // the CTA's packed rows (row n from b, n words): entry e, as local row
      // l and column c, by thread e % NT; the diagonal of every row
      auto width = [&](int l) { return min(rank + P * l + 1, n); };
      int l = 0, c = t;
      while (l < rows && c >= width(l)) c -= width(l), ++l;
      for (int e = t; l < rows; e += NT) {
        const int i = rank + P * l;
        const T* src = i < n ? A + (static_cast<int64_t>(i) * n + c) * B
                             : rhs + static_cast<int64_t>(c) * B;
        __pipeline_memcpy_async(S + e, src + b, sizeof(T));
        c += NT;
        while (l < rows && c >= width(l)) c -= width(l), ++l;
      }
      for (int i = t; i < n; i += NT)
        __pipeline_memcpy_async(diag + i, A + (static_cast<int64_t>(i) * n + i) * B + b,
                                sizeof(T));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    {
      // column 0
      const T d = rn::sqrt(diag[0]);
      T* g0 = column(0);
      for (int l = after(0) + t; l < rows; l += NT) {
        T* e = S + start(l);
        const T v = rn::div(*e, d);
        *e = v;
        __stcg(g0 + rank + P * l, v);
      }
      if (t == 0 && rank == 0) {
        S[0] = d;
        __stcg(g0, d);
      }
    }
    barrier();
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      // column j's rows j + 1 .. n, stored before the barrier just passed
      const T* gj = column(j);
      for (int i = j + 1 + t; i <= n; i += NT) col[i] = __ldcg(gj + i);
      __syncthreads();
      const int j1 = j + 1, l1 = after(j1);
      if (j1 < n) {
        // column j + 1 a step ahead: step j's product off its entries, then
        // the division by its diagonal's square root
        const T c1 = col[j1];
        const T d = rn::sqrt(rn::sub(diag[j1], rn::mul(c1, c1)));
        T* g1 = column(j1);
        for (int l = l1 + t; l < rows; l += NT) {
          const int i = rank + P * l;
          T* e = S + start(l) + j1;
          const T v = rn::div(rn::sub(*e, rn::mul(col[i], c1)), d);
          *e = v;
          __stcg(g1 + i, v);
        }
        if (t == 0 && j1 % P == rank) {
          S[start(j1 / P) + j1] = d;
          __stcg(g1 + j1, d);
        }
      }
      lane::arrive(count);  // column j + 1 in the store once all have arrived
      // the rest of step j: rows past j + 1, columns j + 2 .. min(i, n - 1)
      for (int l = l1 + warp; l < rows; l += W) {
        const int i = rank + P * l, end = min(i, n - 1);
        T* row = S + start(l);
        const T ci = col[i];
#pragma unroll 4
        for (int c = j + 2 + lane; c <= end; c += 32) row[c] = rn::sub(row[c], rn::mul(ci, col[c]));
      }
      for (int i = j + 2 + t; i < n; i += NT) diag[i] = rn::sub(diag[i], rn::mul(col[i], col[i]));
      lane::wait(count, ++epoch * static_cast<unsigned>(P));
    }
    // L and z whole in the store; the back solve in CTA 0, over its rows,
    // which the store has made dead: x in S[0, n), column i gathered into
    // g = S[n + (i & 1) (n + 1) ..] by the warps past the first while the
    // first thread runs column i + 1's chain: g[i] = L[i][i], g[i + 1] =
    // L[i + 1][i], g[k] = L[k][i] x[k] for k > i + 1 (those x known by
    // then), g[n] = z[i].  The chain forms only L[i + 1][i] x[i + 1] itself
    if (mode == 0 && rank == 0) {
      T* xs = S;
      auto gather = [&](int i) {
        T* g = S + n + (i & 1) * (n + 1);
        const T* gi = column(i);
        for (int k = i + t - 32; k <= n; k += NT - 32) {
          const T v = __ldcg(gi + k);
          g[k] = k > i + 1 && k < n ? rn::mul(v, xs[k]) : v;
        }
      };
      if (warp > 0) gather(n - 1);
#pragma unroll 1
      for (int i = n - 1; i >= 0; --i) {
        __syncthreads();  // column i gathered, x[i + 1] in place
        if (warp > 0) {
          if (i > 0) gather(i - 1);
        } else if (t == 0) {
          const T* g = S + n + (i & 1) * (n + 1);
          T acc = g[n];
          if (i + 1 < n) acc = rn::sub(acc, rn::mul(g[i + 1], xs[i + 1]));
          xs[i] = rn::div(rn::sub_each(acc, g, i + 2, n), g[i]);
          x[static_cast<int64_t>(i) * B + b] = xs[i];
        }
      }
    }
    barrier();  // the store is free for the team's next lane
  }
}

// K3-d's shared memory a CTA with P CTAs a lane: ``words``, the most words
// of packed rows a CTA holds (K3-c's layout with C = P), the diagonal and a
// column of n + 1 words, and at least the back solve's 3 n + 2 words
// (ops/smallchol.py's distributed_bytes)
template <typename T>
int64_t distributed_smem(int n, int P, int* words) {
  int most = 0;
  for (int r = 0; r < P && r <= n; ++r) {
    int w = 0;
    for (int i = r; i <= n; i += P) w += i < n ? i + 1 : n;
    most = w > most ? w : most;
  }
  *words = most;
  const int64_t need = static_cast<int64_t>(most) + 2 * n + 1;
  return (need > 3 * n + 2 ? need : 3 * n + 2) * sizeof(T);
}

// K3-d: blocks of ``threads`` (a multiple of 32, at least 64) an SM holds
// at once with P CTAs a lane, into ``blocks``
template <typename T>
int distributed_occupancy(int n, int P, int threads, int* blocks) {
  int words = 0;
  const int64_t smem = distributed_smem<T>(n, P, &words);
  if (n < 1 || P < 1 || threads < 64 || threads > 1024 || threads % 32 || !blocks ||
      smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = chol_distributed_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                      static_cast<size_t>(smem));
  return static_cast<int>(err);
}

// K3-d's launch: ``teams`` teams of P CTAs of ``threads`` threads in one
// cooperative launch; L the column store of n (n + 3) / 2 words a team,
// counts one zeroed counter a team
template <typename T>
int launch_distributed(const void* A, const void* b, void* x, void* L, void* counts, int n,
                       int64_t B, int P, int teams, int threads, int mode, void* stream) {
  int words = 0;
  const int64_t smem = distributed_smem<T>(n, P, &words);
  if (n < 1 || B < 1 || P < 1 || teams < 1 || threads < 64 || threads > 1024 ||
      threads % 32 || mode < 0 || mode > 2 || smem > kMaxDynamicSmem ||
      static_cast<int64_t>(teams) * P > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = chol_distributed_kernel<T>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  const T* a = static_cast<const T*>(A);
  const T* r = static_cast<const T*>(b);
  T* xx = static_cast<T*>(x);
  T* l = static_cast<T*>(L);
  unsigned* c = static_cast<unsigned*>(counts);
  void* args[] = {&a, &r, &xx, &l, &c, &n, &P, &words, &B, &mode};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(teams * P)),
      dim3(threads), args, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K3-g: one thread a lane, L in the batch-minor scratch (row i of L packed
// at i (i + 1) / 2), z written into x and overwritten in place by the back
// solve, from the last row up.
template <typename T>
__global__ void chol_global_kernel(const T* __restrict__ A, const T* __restrict__ rhs, T* L,
                                   T* x, int n, int64_t B) {
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
  for (int i = 0; i < n; ++i) {
    T acc = rhs[static_cast<int64_t>(i) * B + b];
    for (int k = 0; k < i; ++k) acc = rn::sub(acc, rn::mul(l(i, k), v(x, k)));
    v(x, i) = rn::div(acc, l(i, i));
  }
  for (int i = n - 1; i >= 0; --i) {
    T acc = v(x, i);
    for (int k = i + 1; k < n; ++k) acc = rn::sub(acc, rn::mul(l(k, i), v(x, k)));
    v(x, i) = rn::div(acc, l(i, i));
  }
}

// K3-b, past K3-c's range: blocked over the whole card, the back solve by
// columns.  Replaces solve_spd_batched_pallas (nlsolver_tpu/ops/smallchol.py:89)
// for n past K3-c's (n from 928 in f32, 646 in f64): first past K3-d's,
// where 132 CTAs' shared memory no longer holds one lane's packed triangle
// (n from 3600 in f32, 2458 in f64), then over K3-d's range too, where
// K3-d's back solve in the twin's order, one chain of n (n - 1) / 2
// dependent subtractions, left it 1.8-8.3 times slower than K3-b on 1 to
// 64 lanes (PERF.md).  What bounds K3-g there: one thread carries a lane's
// chain of some n^3 / 6 dependent multiply-subtracts, each with two loads
// from L2 (some 3 minutes a lane at n = 2458 in f64), and the twin's back
// solve is one chain of n (n - 1) / 2 dependent subtractions: x[i] takes
// L[k][i] x[k] in ascending k, so its first term waits on x[i + 1], the
// last value formed.  So:
//   * a team of P CTAs takes a lane, and first copies its lower triangle
//     and b into a store in device memory packed by columns, column j (rows
//     j .. n, b as row n) at col(j), through 32 x 32 tiles in shared memory
//     so that both sides coalesce (one pass of the compulsory bytes; 24 MB a
//     lane at n = 2458 in f64, kept in L2).  A column's rows lie side by
//     side, so a warp's 32 rows of a column are one or two 128-byte
//     requests wherever the factorization reads or writes them;
//   * the factorization runs right-looking by panels of nb columns, b as
//     row n, with one barrier in device memory a panel: CTA 0 holds the
//     current panel's rows as nb columns of n + 1 words in shared memory
//     (in a device-memory scratch where that does not fit), and while the
//     other CTAs subtract the panel's terms from the trailing columns past
//     the next panel (a warp a tile of 32 rows by 32 columns, a lane a row,
//     its nb terms in registers), it updates the next panel by them and
//     factors it (lookahead), so the critical path is a panel's update and
//     factorization, not the trailing work;
//   * each entry subtracts L[i][k] L[j][k] in ascending k, the product and
//     the difference each rounded on its own, then takes its square root or
//     its quotient by L[j][j]: L and z are the twin's bit for bit;
//   * the back solve runs by columns, descending: once x[k] is known every
//     i < k subtracts L[k][i] x[k], so acc[i] takes its terms in descending
//     k and the critical path is n steps, not n (n - 1) / 2.  In blocks of
//     32 rows: CTA 0's first warp solves a diagonal block (a lane a row,
//     x[k] by a shuffle), and while the other CTAs subtract the block's
//     terms from every row before the next block, it subtracts them from
//     the next block's rows and solves that block; one barrier a block.
//     acc lives in n words past the columns, z first, and takes x as it
//     forms.
// What bounds K3-b on an H100: the latency of the card's L2, a panel's
// chain on the first CTA and a trailing tile's fetches on the others, each
// alone near the whole time at [2458, 2458, 2] in f64, some 2 % of its
// operations bound; the chain alone on one lane, the trailing tiles alone
// on 64 (PERF.md).  The back solve's order is not the twin's: x
// is that of solve_spd_blocked_reference (ops/smallchol.py), the twin's
// factor followed by the back solve by columns, bit for bit.
constexpr int kBlockedNb = 8;      // K3-b's panel: its columns (a probe's may be fewer)
constexpr int kBackRows = 32;      // K3-b's back solve: rows a block
// K3-b's threads a CTA: 128 registers a thread (at 384 threads and 168
// registers ptxas still kept words on the stack)
constexpr int kBlockedThreads = 512;
// K3-b's trailing update: the columns of a tile whose entries a lane loads
// at once
constexpr int kTileBatch = 8;
// K3-b's first CTA: the rows of a thread whose quotients it forms at once
constexpr int kFactorRows = 2;
// K3-b's other CTAs: the words of a warp's slab, the terms of a tile's 32
// columns, or a tile of 32 x 33 words of the copy
constexpr int kWarpSlab = 32 * 33;

// K3-b's column j of the store (rows j .. n) at packed_col(j) + i; its
// columns end at packed_col(n) + n = n (n + 3) / 2, acc's n words follow
__host__ __device__ inline int64_t packed_col(int j, int n) {
  return static_cast<int64_t>(j) * n - static_cast<int64_t>(j) * (j - 1) / 2;
}

// the tile (ib, jb <= ib) of a lower triangle of tiles numbered by rows
__device__ inline void tri_tile(int64_t it, int& ib, int& jb) {
  ib = static_cast<int>((sqrt(8.0 * static_cast<double>(it) + 1.0) - 1.0) / 2.0);
  while (static_cast<int64_t>(ib) * (ib + 1) / 2 > it) --ib;
  while (static_cast<int64_t>(ib + 1) * (ib + 2) / 2 <= it) ++ib;
  jb = static_cast<int>(it - static_cast<int64_t>(ib) * (ib + 1) / 2);
}

// kProbe: the probes' and tests' instantiation, which takes a panel of
// probe_nb <= kBlockedNb columns and a probe_mode (launch_blocked); the
// main path's has kBlockedNb and mode 0 built in
template <typename T, bool kProbe>
__global__ void __launch_bounds__(kBlockedThreads, 1)
    chol_blocked_kernel(const T* __restrict__ A, const T* __restrict__ rhs, T* __restrict__ x,
                        T* store, T* spill, unsigned* counts, int n, int P, int probe_nb,
                        int64_t B, int probe_mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = kProbe ? probe_nb : kBlockedNb, mode = kProbe ? probe_mode : 0;
  const int t = threadIdx.x, NT = blockDim.x, lane = t & 31, warp = t >> 5, W = NT >> 5;
  const int teams = static_cast<int>(gridDim.x) / P, team = blockIdx.x / P;
  const int rank = blockIdx.x % P;
  const int64_t columns = packed_col(n, n) + n;  // n (n + 3) / 2
  T* S = store + static_cast<int64_t>(team) * (columns + n);
  T* zacc = S + columns;                 // z, then acc and x
  T* blk = reinterpret_cast<T*>(smem);   // L[k1 + r][k0 + c] at r nb + c (CTA 0)
  T* D = blk + nb * nb;                  // a diagonal block of the back solve, row r at r 33
  T* xs = D + kBackRows * (kBackRows + 1);  // its x
  T* slab = xs + kBackRows + warp * kWarpSlab;  // the other CTAs' warp's slab
  // the panel, column c (L[.][k0 + c]) at c (n + 1), every row i at + i
  T* Pn = spill ? spill + static_cast<int64_t>(team) * nb * (n + 1) : xs + kBackRows;
  unsigned* count = counts + team;
  unsigned epoch = 0;
  auto barrier = [&]() {
    lane::arrive(count);
    lane::wait(count, ++epoch * static_cast<unsigned>(P));
  };
  auto pn = [&](int c, int i) -> T& { return Pn[static_cast<int64_t>(c) * (n + 1) + i]; };
  auto at = [&](int i, int j) -> T* { return S + packed_col(j, n) + i; };  // entry (i, j)
  // the panel of columns k0 .. k1 - 1, rows k0 .. n, from the store into Pn
  auto load_panel = [&](int k0, int k1) {
#pragma unroll 1
    for (int i = k0 + t; i <= n; i += NT) {
#pragma unroll
      for (int c = 0; c < kBlockedNb; ++c)
        if (k0 + c < k1 && k0 + c <= i) pn(c, i) = __ldcg(at(i, k0 + c));
    }
    __syncthreads();
  };
  // column by column: its square root, its quotients, their products off
  // the panel's later columns, in ascending k (a thread's rows kFactorRows
  // at a time for the quotients, a row's entries at once for the products,
  // so that their latencies overlap)
  auto factor_panel = [&](int k0, int k1) {
    const int wc = k1 - k0;
#pragma unroll 1
    for (int c = 0; c < wc; ++c) {
      const int kc = k0 + c;
      const T d = rn::sqrt(pn(c, kc));
#pragma unroll 1
      for (int i0 = kc + 1 + t; i0 <= n; i0 += kFactorRows * NT) {
        T v[kFactorRows];
#pragma unroll
        for (int u = 0; u < kFactorRows; ++u)
          if (i0 + u * NT <= n) v[u] = pn(c, i0 + u * NT);
#pragma unroll
        for (int u = 0; u < kFactorRows; ++u)
          if (i0 + u * NT <= n) pn(c, i0 + u * NT) = rn::div(v[u], d);
      }
      __syncthreads();
      if (t == 0) pn(c, kc) = d;
      T q[kBlockedNb];  // L[k0 + c2][kc], the later columns' own rows
#pragma unroll
      for (int c2 = 0; c2 < kBlockedNb; ++c2)
        if (c2 > c && c2 < wc) q[c2] = pn(c, k0 + c2);
#pragma unroll 1
      for (int i = kc + 1 + t; i <= n; i += NT) {
        const T li = pn(c, i);
        T v[kBlockedNb];
#pragma unroll
        for (int c2 = 0; c2 < kBlockedNb; ++c2)
          if (c2 > c && c2 < wc && k0 + c2 <= i) v[c2] = pn(c2, i);
#pragma unroll
        for (int c2 = 0; c2 < kBlockedNb; ++c2)
          if (c2 > c && c2 < wc && k0 + c2 <= i) pn(c2, i) = rn::sub(v[c2], rn::mul(li, q[c2]));
      }
      __syncthreads();
    }
  };
  // the panel into the store, z (its row n) into acc too
  auto store_panel = [&](int k0, int k1) {
#pragma unroll 1
    for (int i = k0 + t; i <= n; i += NT) {
#pragma unroll
      for (int c = 0; c < kBlockedNb; ++c) {
        if (k0 + c < k1 && k0 + c <= i) __stcg(at(i, k0 + c), pn(c, i));
        if (k0 + c < k1 && i == n) __stcg(zacc + k0 + c, pn(c, i));
      }
    }
  };

  const int np = (n + nb - 1) / nb, nq = (n + kBackRows - 1) / kBackRows;
#pragma unroll 1
  for (int64_t b = team; b < B; b += teams) {
    if (mode == 2) {
#pragma unroll 1
      for (int e = 0; e < np + nq + 1; ++e) barrier();
      continue;
    }
    {
      // the lane's lower triangle into the store by tiles of 32 x 32 (ti,
      // tj <= ti), a warp a tile: its rows of A into the slab (r 33 + c),
      // then its columns out of it; b into row n
      const int nt = (n + 31) / 32;
      const int64_t tiles = static_cast<int64_t>(nt) * (nt + 1) / 2;
#pragma unroll 1
      for (int64_t it = static_cast<int64_t>(rank) * W + warp; it < tiles;
           it += static_cast<int64_t>(P) * W) {
        int ti, tj;
        tri_tile(it, ti, tj);
        const int i0 = 32 * ti, j0 = 32 * tj, j = j0 + lane;
#pragma unroll 4
        for (int r = 0; r < 32; ++r)
          if (i0 + r < n && j <= i0 + r)
            slab[r * 33 + lane] = A[(static_cast<int64_t>(i0 + r) * n + j) * B + b];
        __syncwarp();
        const int i = i0 + lane;
#pragma unroll 4
        for (int c = 0; c < 32; ++c)
          if (i < n && j0 + c <= i) __stcg(at(i, j0 + c), slab[lane * 33 + c]);
        __syncwarp();
      }
#pragma unroll 1
      for (int j = rank * NT + t; j < n; j += P * NT) __stcg(at(n, j), rhs[static_cast<int64_t>(j) * B + b]);
    }
    barrier();
    if (rank == 0) {
      load_panel(0, min(nb, n));
      factor_panel(0, min(nb, n));
      store_panel(0, min(nb, n));
    }
    barrier();
#pragma unroll 1
    for (int p = 0; p + 1 < np; ++p) {
      const int k0 = p * nb, k1 = k0 + nb, k2 = min(k1 + nb, n), w = nb;
      if (rank == 0 && mode != 4) {
        // panel p + 1 (columns k1 .. k2 - 1, rows k1 .. n) less panel p's
        // terms, into Pn over panel p; then its factorization
#pragma unroll 1
        for (int e = t; e < (k2 - k1) * nb; e += NT) blk[e] = pn(e % nb, k1 + e / nb);
        __syncthreads();
#pragma unroll 1
        for (int i = k1 + t; i <= n && mode != 6; i += NT) {
          // the row's entries first, all in flight at once, then panel p's
          // terms in ascending k, each of the row's entries one at a step
          T acc[kBlockedNb];
#pragma unroll
          for (int jj = 0; jj < kBlockedNb; ++jj)
            acc[jj] = k1 + jj < k2 && k1 + jj <= i ? __ldcg(at(i, k1 + jj)) : T(0);
#pragma unroll 1
          for (int c = 0; c < w; ++c) {
            const T li = pn(c, i);
#pragma unroll
            for (int jj = 0; jj < kBlockedNb; ++jj)
              acc[jj] = rn::sub(acc[jj], rn::mul(li, blk[jj * nb + c]));
          }
          // the row's entries over panel p's (its own row alone reads them)
#pragma unroll
          for (int jj = 0; jj < kBlockedNb; ++jj)
            if (k1 + jj < k2 && k1 + jj <= i) pn(jj, i) = acc[jj];
        }
        __syncthreads();
        if (mode != 5) factor_panel(k1, k2);
        store_panel(k1, k2);
      } else if (rank > 0 && mode != 3) {
        // the trailing columns k2 .. n - 1, rows j .. n, less panel p's
        // terms: tiles of 32 rows (ib) by 32 columns (jb <= ib), a warp a
        // tile, a lane a row; the terms of the tile's columns (c 32 + r) and
        // rows (at 256 + c 32 + r) in the warp's slab, its entries
        // kTileBatch columns at a time
        const int rows = n + 1 - k2, nrb = (rows + 31) / 32, ncb = (n - k2 + 31) / 32;
        const int64_t tiles = static_cast<int64_t>(nrb) * (nrb + 1) / 2;
#pragma unroll 1
        for (int64_t it = static_cast<int64_t>(rank - 1) * W + warp; it < tiles;
             it += static_cast<int64_t>(P - 1) * W) {
          int ib, jb;
          tri_tile(it, ib, jb);
          if (jb >= ncb) continue;
          const int i = k2 + 32 * ib + lane, j0 = k2 + 32 * jb, cols = min(32, n - j0);
          T* li = slab + 32 * kBlockedNb;
          // every column's two loads in flight at once in f64, four columns'
          // in f32, where all eight took 40 bytes of stack at 128 registers
#pragma unroll(sizeof(T) == 8 ? kBlockedNb : 4)
          for (int c = 0; c < kBlockedNb; ++c) {
            if (c < w && i <= n) li[c * 32 + lane] = __ldcg(at(i, k0 + c));
            if (c < w && lane < cols) slab[c * 32 + lane] = __ldcg(at(j0 + lane, k0 + c));
          }
          __syncwarp();
#pragma unroll 1
          for (int c0 = 0; c0 < cols; c0 += kTileBatch) {
            T acc[kTileBatch];
#pragma unroll
            for (int u = 0; u < kTileBatch; ++u)
              acc[u] = c0 + u < cols && j0 + c0 + u <= i && i <= n ? __ldcg(at(i, j0 + c0 + u))
                                                                 : T(0);
#pragma unroll 1
            for (int c = 0; c < w; ++c) {
              const T lic = li[c * 32 + lane];
#pragma unroll
              for (int u = 0; u < kTileBatch; ++u)
                acc[u] = rn::sub(acc[u], rn::mul(lic, slab[c * 32 + c0 + u]));
            }
#pragma unroll
            for (int u = 0; u < kTileBatch; ++u)
              if (c0 + u < cols && j0 + c0 + u <= i && i <= n) __stcg(at(i, j0 + c0 + u), acc[u]);
          }
          __syncwarp();  // the slab is the warp's next tile's
        }
      }
      barrier();
    }
    if (mode == 1) continue;
    // the back solve: acc = z; block q is rows 32 q .. 32 q + 31
    // the diagonal block q by CTA 0's first warp, a lane a row: x into acc,
    // into xs and into x
    auto solve_block = [&](int q) {
      const int kb = q * kBackRows, rows = min(kBackRows, n - kb);
      // a lane's column of the block, its rows kb + lane .. kb + rows - 1
#pragma unroll 1
      for (int r0 = 0; r0 < rows; r0 += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (r0 + u < rows && lane <= r0 + u)
            D[(r0 + u) * (kBackRows + 1) + lane] = __ldcg(at(kb + r0 + u, kb + lane));
      }
      __syncwarp();
      T acc = lane < rows ? __ldcg(zacc + kb + lane) : T(0), xv = T(0);
#pragma unroll 1
      for (int r = rows - 1; r >= 0; --r) {
        if (lane == r) xv = rn::div(acc, D[r * (kBackRows + 1) + r]);
        const T xr = __shfl_sync(0xffffffffu, xv, r);
        if (lane < r) acc = rn::sub(acc, rn::mul(D[r * (kBackRows + 1) + lane], xr));
      }
      if (lane < rows) {
        xs[lane] = xv;
        __stcg(zacc + kb + lane, xv);
        x[static_cast<int64_t>(kb + lane) * B + b] = xv;
      }
      __syncwarp();
    };
    if (rank == 0 && warp == 0) solve_block(nq - 1);
    barrier();
#pragma unroll 1
    for (int q = nq - 1; q > 0; --q) {
      const int kb = q * kBackRows, ke = min(kb + kBackRows, n), kb2 = kb - kBackRows;
      if (rank == 0) {
        if (warp == 0) {
          // the next block's rows less this block's terms, in descending k
          const int i = kb2 + lane;
          T acc = __ldcg(zacc + i);
#pragma unroll 1
          for (int r0 = kBackRows - 8; r0 >= 0; r0 -= 8) {
#pragma unroll
            for (int u = 7; u >= 0; --u)
              if (kb + r0 + u < ke)
                acc = rn::sub(acc, rn::mul(__ldcg(at(kb + r0 + u, i)), xs[r0 + u]));
          }
          __stcg(zacc + i, acc);
          __syncwarp();
          solve_block(q - 1);
        }
      } else {
        // every row before the next block less this block's terms
#pragma unroll 1
        for (int r = t; r < ke - kb; r += NT) xs[r] = __ldcg(zacc + kb + r);
        __syncthreads();
#pragma unroll 1
        for (int i = (rank - 1) * NT + t; i < kb2; i += (P - 1) * NT) {
          T acc = __ldcg(zacc + i);
#pragma unroll 1
          for (int r0 = kBackRows - 8; r0 >= 0; r0 -= 8) {
#pragma unroll
            for (int u = 7; u >= 0; --u)
              if (kb + r0 + u < ke)
                acc = rn::sub(acc, rn::mul(__ldcg(at(kb + r0 + u, i)), xs[r0 + u]));
          }
          __stcg(zacc + i, acc);
        }
      }
      barrier();
    }
  }
}

// K3-b's shared memory a CTA: the panel's block of nb x nb, the back
// solve's diagonal block and its x, then the panel (nb columns of n + 1
// words; CTA 0), unless it spills to device memory, or the warps' slabs
// (the other CTAs), whichever is larger (ops/smallchol.py's blocked_bytes)
template <typename T>
int64_t blocked_smem(int n, int nb, int spill) {
  const int64_t panel = spill ? 0 : static_cast<int64_t>(nb) * (n + 1);
  const int64_t slabs = kBlockedThreads / 32 * kWarpSlab;
  return (static_cast<int64_t>(nb) * nb + kBackRows * (kBackRows + 2) +
          (panel > slabs ? panel : slabs)) * sizeof(T);
}

// K3-b's kernel: the main path's, or the probes' where ``probe``
template <typename T>
auto blocked_kernel(bool probe) {
  return probe ? chol_blocked_kernel<T, true> : chol_blocked_kernel<T, false>;
}

// K3-b (the probes' instantiation where ``probe``): blocks of
// kBlockedThreads an SM holds at once, into ``blocks``
template <typename T>
int blocked_occupancy(int n, int nb, int spill, int probe, int* blocks) {
  const int64_t smem = blocked_smem<T>(n, nb, spill);
  if (n < 1 || nb < 1 || nb > kBlockedNb || !blocks || smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = blocked_kernel<T>(probe);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kBlockedThreads, static_cast<size_t>(smem)));
}

// K3-b's launch: ``teams`` teams of P >= 2 CTAs of kBlockedThreads threads in
// one cooperative launch; store n (n + 3) / 2 + n words a team, spill (or
// null) nb (n + 1) words a team, counts one zeroed counter a team.
// ``mode`` 1 skips the back solve, 2 runs the barriers alone, 3 skips the
// trailing update (CTA 0's chain of panels alone), 4 skips CTA 0's update
// and factorization of the next panel (the trailing update alone), 5 and 6
// CTA 0's factorization or its update of the next panel alone: the
// probes' split of what each costs.  A panel of kBlockedNb columns and mode
// 0 run the main path's instantiation, anything else the probes'
template <typename T>
int launch_blocked(const void* A, const void* b, void* x, void* store, void* spill, void* counts,
                   int n, int64_t B, int P, int teams, int nb, int mode, void* stream) {
  const int64_t smem = blocked_smem<T>(n, nb, spill != nullptr);
  if (n < 1 || B < 1 || P < 2 || teams < 1 || nb < 1 || nb > kBlockedNb || mode < 0 ||
      mode > 6 || smem > kMaxDynamicSmem ||
      static_cast<int64_t>(teams) * P > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = blocked_kernel<T>(nb != kBlockedNb || mode != 0);
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  const T* a = static_cast<const T*>(A);
  const T* r = static_cast<const T*>(b);
  T* xx = static_cast<T*>(x);
  T* s = static_cast<T*>(store);
  T* sp = static_cast<T*>(spill);
  unsigned* c = static_cast<unsigned*>(counts);
  void* args[] = {&a, &r, &xx, &s, &sp, &c, &n, &P, &nb, &B, &mode};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(teams * P)),
      dim3(kBlockedThreads), args, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_registers(const void* A, const void* b, void* x, int n, int64_t B, void* stream) {
  if constexpr (N > 1) {
    if (n < N) return launch_registers<T, N - 1>(A, b, x, n, B, stream);
  }
  if (n != N || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  chol_registers_kernel<T, N><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x), B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_warp(const void* A, const void* b, void* x, int n, int64_t B, int lanes,
                void* stream) {
  const int64_t smem = static_cast<int64_t>(lanes) * ((n * (n + 1) / 2 + 2 * n + 1) | 1) *
                           sizeof(T) + kTableEntries * sizeof(unsigned short);
  if (n < 1 || B < 1 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      chol_warp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + lanes - 1) / lanes);
  chol_warp_kernel<T><<<blocks, 32 * lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x), n, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_global(const void* A, const void* b, void* L, void* x, int n, int64_t B,
                  void* stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  chol_global_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(L),
      static_cast<T*>(x), n, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A [n, n, B], b [n, B] -> x [n, B].  K3-r, n = 1 .. its most; K3-w with
// ``lanes`` warps a block (a power of two, 1 .. 32, whose triangles fit
// 232448 bytes); K3-c with ``size`` CTAs a lane (2, 4 or 8) of ``threads``
// threads (``mode`` 0, or the probe's 1 and 2); K3-d with ``size`` CTAs a
// lane of ``threads`` threads, in ``teams`` teams (L, its column store of
// n (n + 3) / 2 words a team;
// counts, one zeroed counter a team; ``mode`` 0, or the probe's 1 and 2),
// and its occupancy, the blocks an SM holds, into ``blocks``; K3-b with
// ``size`` >= 2 CTAs a lane of kBlockedThreads threads, panels of ``nb``
// columns, in ``teams`` teams (store, n (n + 3) / 2 + n words a team;
// spill, null or the panel's nb (n + 1) words a team in device memory;
// counts, one zeroed counter a team; ``mode`` 0, or the probe's 1 to 6),
// and its occupancy (of the probes' instantiation where ``probe``); K3-g with L,
// scratch of n (n + 1) / 2 * B words.  Each returns cudaGetLastError()
// (the occupancy entry, the occupancy query's error).
#define NLSOLVER_CHOL_LAUNCHERS(SUFFIX, T, MAXN)                                           \
  extern "C" int chol_solve_registers_##SUFFIX(const void* A, const void* b, void* x, int n, \
                                               int64_t B, void* stream) {                    \
    return launch_registers<T, MAXN>(A, b, x, n, B, stream);                                 \
  }                                                                                          \
  extern "C" int chol_solve_warp_##SUFFIX(const void* A, const void* b, void* x, int n,      \
                                          int64_t B, int lanes, void* stream) {              \
    return launch_warp<T>(A, b, x, n, B, lanes, stream);                                     \
  }                                                                                          \
  extern "C" int chol_solve_cluster_##SUFFIX(const void* A, const void* b, void* x, int n,   \
                                             int64_t B, int size, int threads, int mode,     \
                                             void* stream) {                                 \
    return launch_cluster<T>(A, b, x, n, B, size, threads, mode, stream);                    \
  }                                                                                          \
  extern "C" int chol_solve_distributed_##SUFFIX(const void* A, const void* b, void* x,      \
                                                 void* L, void* counts, int n, int64_t B,    \
                                                 int size, int teams, int threads, int mode, \
                                                 void* stream) {                             \
    return launch_distributed<T>(A, b, x, L, counts, n, B, size, teams, threads, mode,       \
                                 stream);                                                    \
  }                                                                                          \
  extern "C" int chol_solve_distributed_occupancy_##SUFFIX(int n, int size, int threads,     \
                                                           int* blocks) {                    \
    return distributed_occupancy<T>(n, size, threads, blocks);                               \
  }                                                                                          \
  extern "C" int chol_solve_blocked_##SUFFIX(const void* A, const void* b, void* x,          \
                                             void* store, void* spill, void* counts, int n,  \
                                             int64_t B, int size, int teams, int nb,         \
                                             int mode, void* stream) {                       \
    return launch_blocked<T>(A, b, x, store, spill, counts, n, B, size, teams, nb, mode,     \
                             stream);                                                        \
  }                                                                                          \
  extern "C" int chol_solve_blocked_occupancy_##SUFFIX(int n, int nb, int spill, int probe,  \
                                                       int* blocks) {                        \
    return blocked_occupancy<T>(n, nb, spill, probe, blocks);                                \
  }                                                                                          \
  extern "C" int chol_solve_batchminor_##SUFFIX(const void* A, const void* b, void* L,       \
                                                void* x, int n, int64_t B, void* stream) {   \
    return launch_global<T>(A, b, L, x, n, B, stream);                                       \
  }

NLSOLVER_CHOL_LAUNCHERS(f32, float, kRegisterMaxN32)
NLSOLVER_CHOL_LAUNCHERS(f64, double, kRegisterMaxN64)
