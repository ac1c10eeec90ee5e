// Batched symmetric eigendecomposition by parallel-order cyclic Jacobi for
// Hopper (sm_90a), one computation in four forms:
//
//   K5r  registers  A and V of a lane live in the registers of a few threads
//                   of one warp; n <= 32 in float32, n <= 16 in float64
//   K5a  resident   A and V of a tile of lanes live in shared memory;
//                   n <= 169 in float32, n <= 119 in float64
//   K5c  cluster    A and V of one lane live in the shared memory of a
//                   thread-block cluster of 2, 4 or 8 CTAs, split by rows;
//                   n <= 472 in float32, n <= 329 in float64
//   K5b  global     A's working copy and V live in device memory, any n;
//                   a round's phases spread over the whole card
//
// They replace nlsolver_tpu/ops/eigh_jacobi.py: eigh_jacobi_pallas (_kernel,
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
// What bounds the work: operations, not bytes.  A lane moves 2 n^2 + n words
// once (A in, w and V out) but does some 9 n^2 operations in each of the
// sweeps (n - 1) rounds, and a round depends on the one before.  So no form
// lets a round touch device memory except K5b, which has no other place.
//
// Arithmetic, all forms: every operation is rounded on its own through the
// _rn intrinsics (no FMA) in the order of the plain twin
// (nlsolver_torch/linalg/jacobi.py), each entry (c x) + (s y), and a round has
// no sum longer than two terms, so every form equals the twin, and the
// others, bit for bit.  The card's float32 peak counts an FMA as two
// operations; without FMAs the floor set by the instruction rate is about twice
// the operations bound.
//
// K5a.  The schedule is the table that the twin builds, int32
// [rounds][ceil(n/2)][2], a (p, q) for each pair and (r, r) for the bye row
// of an odd n, which keeps c = 1, s = 0.  K5a stages the [n, n] slabs of A
// and V, and the [n] coefficients c and s, of TB lanes in shared memory for
// all sweeps; A is read once, w and V written once.  A block is (TB lanes) x
// (RJ x RU threads a lane), and a round is three phases with a barrier after
// each:
//   1. thread t of a lane forms (c, s) for units t, t + RJ RU, ...;
//   2. rows: thread (rj, ru) takes units ru, ru + RU, ... and columns rj,
//      rj + RJ, ...; it owns both rows of a pair, reads both entries and
//      then writes both, so no row is read after a partner rewrote it;
//   3. columns of A and V likewise, on the rows the second phase wrote.
// What bounds K5a on this card is the shared-memory crossbar: a round moves
// every entry of A twice and of V once, in and out.  Two things keep it at
// the crossbar's rate.  Lanes are the fastest thread index, and where a
// block has fewer than 32 lanes a warp spans several rows of the column
// pass, ld TB words apart: the slabs' leading dimension ld is then odd
// (n | 1), so that those rows fall on different banks at every n.  And TB
// halves from 32 down to one lane until the slabs fit the 232448 bytes a
// block may opt in to, which is what ends the range at n = 169.
//
// K5b, past K5c's n = 472 (329 in f64), serves few lanes of a large n (16
// at n = 473 in the CMA-ES fleet): a block per sector of lanes would leave
// two blocks on 132 SMs.  So a round's three phases are spread over every
// SM of the card, and a grid-wide barrier separates them: one cooperative
// launch for all phases, its grid as many blocks as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs, fewer
// where a phase has fewer items), or, for the benches' probe, one launch a
// phase.  The working copy of A, V (built in
// its output) and the coefficients c, s [2][n][B] stay in device memory;
// at [473, 473, 16] A and V are 28.6 MB and stay in the 50 MB L2.  In each
// phase a thread walks items f = g, g + G, .. (g its index in the grid, G
// the grid's threads), lanes the fastest digit, so that a warp's accesses
// are neighbouring words:
//   1. (unit u, lane b): (c, s) from A[p][p], A[q][q], A[p][q];
//   2. (u, column j, b): rows p and q at column j, both read, then both
//      written;
//   3. (u, row i, b): columns p and q at row i, of A and of V.
// No two items of a phase touch one entry, so no entry is read after its
// partner was rewritten within a phase.  What bounds it is L2 bandwidth
// (a round moves A twice and V once, in and out: some 86 MB at [473, 473,
// 16]) and the three grid barriers a round; the operations of 2 sweeps
// there take 0.46 ms at the card's float32 rate.
//
// K5r.  At n = 16 a lane's A and V are 512 words: they fit the registers of
// 8 threads, and only a design that moves fewer words through the crossbar
// than K5a's 2700 a lane a round can beat it.  W is the even number of
// players (n, or n + 1 with a dummy player for odd n), H = W / 2 its pair
// slots, one thread of a warp for each slot of a lane, 32 / H lanes a warp.
// The tournament moves the data, not the indices, because a register array
// takes compile-time indices only:
//   * positions 0 .. W - 1 pair as (i, W - 1 - i): slot i holds position i
//     ("top") and W - 1 - i ("bottom"), as the twin's round_robin_schedule
//     seats its players;
//   * a thread holds both of its slot's columns of A and of V in full, 4 W
//     words: (c, s) come from its own registers and the column pass is
//     local;
//   * A's rows are kept in the order of the positions too (tops 0 .. H - 1,
//     then bottoms), so the two rows of slot j are registers j and H + j of
//     every column, and the row pass needs only (c, s) of slot j: two
//     shuffles a slot;
//   * after a round the players move as the schedule says: position 0
//     stays, 1 takes W - 1's, k takes k - 1's.  Each column goes to a
//     neighbouring thread by shuffle (4 W words a thread a round), and A's
//     rows shift the same way by renaming registers; after W - 1 rounds
//     every player is home again.
// Which of a slot's players is the lower index (it takes -s, and A[lo][hi]
// is the entry the rotation reads: A is not bitwise symmetric after a
// round) and which slot holds the bye come as one word a round from the
// wrapper (ops/eigh_jacobi.py: register_masks).  A round has no barrier and
// writes nothing to shared memory; what bounds K5r is the instruction rate:
// 18 W multiplies and adds a thread a round, which no FMA may fuse, 5 W
// shuffles, and some 5 W selects (a thread finds its own 2 x 2 block, and
// the threads at either end keep or turn a column).  W is a template
// parameter, one kernel for every even W and parity of n, so that every
// index is known to the compiler and nothing is padded.
//
// K5c.  Past n = 169 one lane's A and V (2 n (n|1) words) outgrow the
// 232448 bytes of shared memory one block may opt in to, and K5b, which
// sends every round through L2 or device memory, ran 10.4 times slower at
// n = 170 than K5a at 169.  A cluster of C CTAs on neighbouring SMs holds
// one lane instead: CTA k keeps rows [k R, (k + 1) R) of A and of V, R =
// ceil(n / C), with K5a's odd leading dimension ld = n | 1, and reads and
// writes the other CTAs' rows through distributed shared memory (DSMEM).
// C is the least of 2, 4, 8 for which (2 R ld + 4 n) words fit: the slabs,
// and c and s of every player in 2 n of the 4 n words kept beside them.
// The units of a round are sorted by the CTA that rotates them
// (ops/eigh_jacobi.py: cluster_schedule): a unit whose rows share an owner
// goes to it, the others to the less loaded of their two owners.  A round,
// with the cluster barriers that its data needs:
//   1. each CTA forms (c, s) of its units from A[p][p], A[q][q], A[p][q]
//      (one or two of them remote) and writes them into every CTA; a
//      block barrier, since the same threads then turn those rows;
//   2. rows: the CTA that rotates a unit reads both of its rows, the
//      remote one through DSMEM, and then writes both, as rotate_pair
//      does; cluster barrier: rows and coefficients are in place;
//   3. columns of A and V, local in every CTA, on its own rows; cluster
//      barrier: the next round reads and writes other CTAs' rows.
// That is two cluster barriers a round.  The alternative, every CTA
// forming every rotation itself from remote entries, needs a third between
// steps 1 and 2 (no row may turn while a partner still reads it): on an
// H100 at [170, 170, 4096] with 8 sweeps it took 638.9 ms where this took
// 582.2, and it was dropped.  The benches' probe times the kernel built
// with its barriers alone (no kArithmetic: 120.6 ms there, 0.7 us a
// barrier).  What bounds K5c is not the crossbar, as in K5a, but a round's
// chain, the row pass most: it moves 2 n words through DSMEM for each unit
// whose rows have different owners, half the units at C = 2, at a
// fraction of the crossbar's rate.  Reading 8 entries at once, spreading
// units over warps, turning local units through plain shared-memory
// addresses and aligned barriers were no faster, nor were larger clusters
// or smaller blocks that put more CTAs on an SM (n = 170, 238, 300, 472).  The last round's barrier is also the
// one after which no CTA touches another's shared memory, so a CTA may
// exit.  Lane b's input and output are 4-byte gathers at (i n + j) B + b,
// one lane a cluster: 3 n^2 + n accesses a lane, each its own 32-byte
// sector, 11.4 GB of sectors at [170, 170, 4096], a few ms at L2's rate
// against the rounds' hundreds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rn_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDynamicSmem = 232448;
constexpr int kOptInAbove = 48 * 1024;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kRegisterBlock = 128;  // threads a block of K5r: four warps, no barrier

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

// K5a: entry (i, j) of a lane's slab at base[(i ldn + j) TB + lane]
template <typename T>
__global__ void __launch_bounds__(1024)
    eigh_jacobi_kernel(const T* __restrict__ A, T* __restrict__ wout, T* __restrict__ Vout,
                       const int* __restrict__ units, int n, int ldn, int rounds, int sweeps,
                       int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TB = blockDim.x, RJ = blockDim.y, RU = blockDim.z;
  const int tb = threadIdx.x, rj = threadIdx.y, ru = threadIdx.z;
  const int t = ru * RJ + rj, NT = RJ * RU;
  const int nu = (n + 1) / 2, nn = n * n;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * TB + tb;
  const bool live = b < B;

  T* a = reinterpret_cast<T*>(smem_raw);
  T* v = a + static_cast<size_t>(n) * ldn * TB;
  T* cv = v + static_cast<size_t>(n) * ldn * TB;
  T* sv = cv + n * TB;
  const int64_t ld = TB, lane = tb;

  if (live) {
    for (int e = t; e < nn; e += NT) {
      const int i = e / n, j = e - i * n;
      const T x = A[static_cast<int64_t>(e) * B + b];
      const T y = A[(static_cast<int64_t>(j) * n + i) * B + b];
      const int64_t at = (static_cast<int64_t>(i) * ldn + j) * ld + lane;
      a[at] = rn::mul(rn::add(x, y), T(0.5));
      v[at] = T(i == j);
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
            rotation(a[(static_cast<int64_t>(p) * ldn + p) * ld + lane],
                     a[(static_cast<int64_t>(q) * ldn + q) * ld + lane],
                     a[(static_cast<int64_t>(p) * ldn + q) * ld + lane], c, s);
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
          T* rowp = a + static_cast<int64_t>(p) * ldn * ld + lane;
          T* rowq = a + static_cast<int64_t>(q) * ldn * ld + lane;
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
            const int64_t row = static_cast<int64_t>(i) * ldn;
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
    wout[static_cast<int64_t>(i) * B + b] = a[(static_cast<int64_t>(i) * ldn + i) * ld + lane];
  for (int e = t; e < nn; e += NT) {
    const int i = e / n, j = e - i * n;
    Vout[static_cast<int64_t>(e) * B + b] = v[(static_cast<int64_t>(i) * ldn + j) * ld + lane];
  }
}

template <typename T>
int launch(const void* A, void* wout, void* Vout, const void* units, int n, int ldn, int rounds,
           int sweeps, int64_t B, int tb, int rj, int ru, void* stream) {
  if (n < 1 || ldn < n || tb < 1 || rj < 1 || ru < 1 || tb * rj * ru > 1024 || ru > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((B + tb - 1) / tb);
  const dim3 block(tb, rj, ru);
  const size_t bytes =
      (2 * static_cast<size_t>(n) * ldn + 2 * static_cast<size_t>(n)) * tb * sizeof(T);
  if (bytes > static_cast<size_t>(kMaxDynamicSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > static_cast<size_t>(kOptInAbove)) {
    const cudaError_t err =
        cudaFuncSetAttribute(eigh_jacobi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  eigh_jacobi_kernel<T><<<blocks, block, bytes, st>>>(
      static_cast<const T*>(A), static_cast<T*>(wout), static_cast<T*>(Vout),
      static_cast<const int*>(units), n, ldn, rounds, sweeps, B);
  return static_cast<int>(cudaGetLastError());
}

// K5b: the items of a phase, f = (u * mid + j) * B + b over u < outer, j <
// mid, b < B, walked by a thread from its global index g in steps of the
// grid's threads, the stride kept split into its three digits so that a
// step costs two compares and no division
struct Walk {
  int64_t b;
  int j, u;
  int64_t db;
  int dj, du;
  __device__ Walk(int64_t g, int64_t stride, int mid, int64_t B) {
    b = g % B;
    const int64_t r = g / B;
    j = static_cast<int>(r % mid);
    u = static_cast<int>(r / mid);
    db = stride % B;
    const int64_t rs = stride / B;
    dj = static_cast<int>(rs % mid);
    du = static_cast<int>(rs / mid);
  }
  __device__ void next(int mid, int64_t B) {
    b += db;
    j += dj;
    u += du;
    if (b >= B) {
      b -= B;
      ++j;
    }
    if (j >= mid) {
      j -= mid;
      ++u;
    }
  }
};

// K5b's phases: 0 reads A (symmetrized) into the working copy and sets V =
// I; 3 r + 1, 3 r + 2, 3 r + 3 are round r's coefficients, rows and
// columns; 3 R + 1 (R rounds in all) writes w
template <typename T>
__device__ __forceinline__ void global_phase(int ph, const T* __restrict__ A, T* __restrict__ a,
                                             T* __restrict__ cv, T* __restrict__ wout,
                                             T* __restrict__ v, const int* __restrict__ units,
                                             int n, int rounds, int total, int64_t B, int64_t g,
                                             int64_t stride) {
  const int nu = (n + 1) / 2;
  T* sv = cv + static_cast<int64_t>(n) * B;
  auto at = [&](int i, int j, int64_t b) { return (static_cast<int64_t>(i) * n + j) * B + b; };
  if (ph == 0) {
    for (Walk w(g, stride, n, B); w.u < n; w.next(n, B)) {
      const int64_t e = at(w.u, w.j, w.b);
      a[e] = rn::mul(rn::add(A[e], A[at(w.j, w.u, w.b)]), T(0.5));
      v[e] = T(w.u == w.j);
    }
    return;
  }
  if (ph == total - 1) {
    for (Walk w(g, stride, 1, B); w.u < n; w.next(1, B))
      wout[static_cast<int64_t>(w.u) * B + w.b] = a[at(w.u, w.u, w.b)];
    return;
  }
  const int kind = (ph - 1) % 3;
  const int* un = units + static_cast<size_t>((ph - 1) / 3 % rounds) * nu * 2;
  if (kind == 0) {
    for (Walk w(g, stride, 1, B); w.u < nu; w.next(1, B)) {
      const int p = __ldg(un + 2 * w.u), q = __ldg(un + 2 * w.u + 1);
      T c = T(1), s = T(0);
      if (p != q) rotation(a[at(p, p, w.b)], a[at(q, q, w.b)], a[at(p, q, w.b)], c, s);
      cv[p * B + w.b] = c;
      sv[p * B + w.b] = p != q ? -s : s;
      if (p != q) {
        cv[q * B + w.b] = c;
        sv[q * B + w.b] = s;
      }
    }
    return;
  }
  for (Walk w(g, stride, n, B); w.u < nu; w.next(n, B)) {
    const int p = __ldg(un + 2 * w.u), q = __ldg(un + 2 * w.u + 1);
    const T cp = cv[p * B + w.b], sp = sv[p * B + w.b];
    const T cq = cv[q * B + w.b], sq = sv[q * B + w.b];
    if (kind == 1) {  // rows p and q, column j
      rotate_pair(a + at(p, w.j, w.b), a + at(q, w.j, w.b), p != q, cp, sp, cq, sq);
    } else {  // columns p and q, row j, of A and V
      rotate_pair(a + at(w.j, p, w.b), a + at(w.j, q, w.b), p != q, cp, sp, cq, sq);
      rotate_pair(v + at(w.j, p, w.b), v + at(w.j, q, w.b), p != q, cp, sp, cq, sq);
    }
  }
}

// K5b over the whole card: phases [first, last) of ``total``; with
// ``cooperative`` (a cooperative launch whose blocks are all resident) a
// grid-wide barrier separates them, else the host launches one a phase
template <typename T>
__global__ void __launch_bounds__(1024)
    eigh_jacobi_global_kernel(const T* __restrict__ A, T* __restrict__ work, T* __restrict__ coef,
                              T* __restrict__ wout, T* __restrict__ Vout,
                              const int* __restrict__ units, int n, int rounds, int total,
                              int64_t B, int first, int last, int cooperative) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int ph = first; ph < last; ++ph) {
    global_phase(ph, A, work, coef, wout, Vout, units, n, rounds, total, B, g, stride);
    if (cooperative && ph + 1 < last) cg::this_grid().sync();
  }
}

template <typename T>
int launch_global(const void* A, void* work, void* coef, void* wout, void* Vout,
                  const void* units, int n, int rounds, int sweeps, int64_t B, int blocks,
                  int threads, int cooperative, cudaStream_t st) {
  if (n < 1 || blocks < 1 || threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  int total = 3 * rounds * sweeps + 2;  // non-const: its address goes to the launch
  const T* a = static_cast<const T*>(A);
  T *wk = static_cast<T*>(work), *cf = static_cast<T*>(coef), *w = static_cast<T*>(wout),
    *v = static_cast<T*>(Vout);
  const int* un = static_cast<const int*>(units);
  if (cooperative) {
    int first = 0, last = total, coop = 1;
    void* args[] = {&a, &wk, &cf, &w, &v, &un, &n, &rounds, &total, &B, &first, &last, &coop};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(eigh_jacobi_global_kernel<T>), dim3(blocks), dim3(threads),
        args, 0, st));
  }
  for (int ph = 0; ph < total; ++ph) {
    eigh_jacobi_global_kernel<T><<<blocks, threads, 0, st>>>(a, wk, cf, w, v, un, n, rounds,
                                                             total, B, ph, ph + 1, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// entries of a row a thread of K5c's row pass reads before it writes any
// (float64 takes 2: 4 spilled registers under the 64 a thread may have)
template <typename T>
constexpr int kRowBatch = sizeof(T) == 4 ? 4 : 2;

// K5c.  One lane b = blockIdx.x / C a cluster; CTA k holds entry (i, j) of
// A at a[(i - k R) ld + j] for i in [k R, k R + R) (and V likewise), c and
// s of player i at cv[i], sv[i].  units [rounds][ceil(n/2)][2] is sorted by
// the rotating CTA; CTA k forms and rotates units [starts[rd][k],
// starts[rd][k + 1]) and writes their (c, s) into every CTA.  Without
// kArithmetic only the barriers run: the benches' probe of what they cost.
template <typename T, bool kArithmetic>
__global__ void __launch_bounds__(1024)
    eigh_jacobi_cluster_kernel(const T* __restrict__ A, T* __restrict__ wout,
                               T* __restrict__ Vout, const int* __restrict__ units,
                               const int* __restrict__ starts, int n, int R, int ld, int rounds,
                               int sweeps, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  const int RJ = blockDim.y, RU = blockDim.z;
  const int rj = threadIdx.y, ru = threadIdx.z;
  const int t = ru * RJ + rj, NT = RJ * RU;
  const int nu = (n + 1) / 2;
  const int64_t b = blockIdx.x / C;
  const int lo = k * R, rows = max(0, min(R, n - lo));

  T* a = reinterpret_cast<T*>(smem_raw);
  T* v = a + static_cast<size_t>(R) * ld;
  T* cv = v + static_cast<size_t>(R) * ld;
  T* sv = cv + n;
  // row i of A in its owner's shared memory, through the cluster's window
  const auto row = [&](int i) -> T* {
    const int o = i / R;
    return cluster.map_shared_rank(a, o) + static_cast<size_t>(i - o * R) * ld;
  };
  // (c, s) of unit (p, q) into the coefficients at cm, sm; a bye keeps c = 1, s = 0
  const auto form = [&](int p, int q, T* cm, T* sm) {
    T c = T(1), s = T(0);
    if (p != q) {
      const T* rp = row(p);
      rotation(rp[p], row(q)[q], rp[q], c, s);
    }
    cm[p] = c;
    sm[p] = p != q ? -s : s;
    if (p != q) {
      cm[q] = c;
      sm[q] = s;
    }
  };

  for (int e = t; e < rows * n; e += NT) {
    const int i = e / n, j = e - i * n, gi = lo + i;
    const T x = A[(static_cast<int64_t>(gi) * n + j) * B + b];
    const T y = A[(static_cast<int64_t>(j) * n + gi) * B + b];
    a[i * ld + j] = rn::mul(rn::add(x, y), T(0.5));
    v[i * ld + j] = T(gi == j);
  }
  // every CTA of the cluster runs and holds its rows before any is read
  cluster.sync();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int rd = 0; rd < rounds; ++rd) {
      const int* un = units + static_cast<size_t>(rd) * nu * 2;
      const int mine0 = __ldg(starts + rd * (C + 1) + k);
      const int mine1 = __ldg(starts + rd * (C + 1) + k + 1);
      if (kArithmetic)
        for (int u = mine0 + t; u < mine1; u += NT) {
          const int p = __ldg(un + 2 * u), q = __ldg(un + 2 * u + 1);
          form(p, q, cv, sv);
          for (int m = 0; m < C; ++m)
            if (m != k) {
              T *cm = cluster.map_shared_rank(cv, m), *sm = cluster.map_shared_rank(sv, m);
              cm[p] = cv[p];
              sm[p] = sv[p];
              cm[q] = cv[q];
              sm[q] = sv[q];
            }
        }
      __syncthreads();  // this CTA's rotations are formed before its rows turn
      // a thread reads kRowBatch entries of both rows before it writes any
      if (kArithmetic)
        for (int u = mine0 + ru; u < mine1; u += RU) {
          const int p = __ldg(un + 2 * u), q = __ldg(un + 2 * u + 1);
          const T cp = cv[p], sp = sv[p], cq = cv[q], sq = sv[q];
          T *rp = row(p), *rq = row(q);
          for (int j0 = rj; j0 < n; j0 += kRowBatch<T> * RJ) {
            T x[kRowBatch<T>], y[kRowBatch<T>];
#pragma unroll
            for (int m = 0; m < kRowBatch<T>; ++m) {
              const int j = min(j0 + m * RJ, n - 1);
              x[m] = rp[j];
              y[m] = rq[j];
            }
#pragma unroll
            for (int m = 0; m < kRowBatch<T>; ++m) {
              const int j = j0 + m * RJ;
              if (j >= n) break;
              rp[j] = rn::add(rn::mul(cp, x[m]), rn::mul(sp, y[m]));
              if (p != q) rq[j] = rn::add(rn::mul(cq, y[m]), rn::mul(sq, x[m]));
            }
          }
        }
      cluster.sync();  // rows turned and coefficients delivered in every CTA
      if (kArithmetic)
        for (int u = ru; u < nu; u += RU) {
          const int p = __ldg(un + 2 * u), q = __ldg(un + 2 * u + 1);
          const T cp = cv[p], sp = sv[p], cq = cv[q], sq = sv[q];
          for (int i = rj; i < rows; i += RJ) {
            rotate_pair(a + i * ld + p, a + i * ld + q, p != q, cp, sp, cq, sq);
            rotate_pair(v + i * ld + p, v + i * ld + q, p != q, cp, sp, cq, sq);
          }
        }
      cluster.sync();  // columns turned before the next round reads or writes a partner's rows
    }
  }

  for (int i = t; i < rows; i += NT)
    wout[static_cast<int64_t>(lo + i) * B + b] = a[i * ld + lo + i];
  for (int e = t; e < rows * n; e += NT) {
    const int i = e / n, j = e - i * n;
    Vout[(static_cast<int64_t>(lo + i) * n + j) * B + b] = v[i * ld + j];
  }
}

// K5c's launch, or with ``clusters`` the number of its clusters the card
// holds at once (cudaOccupancyMaxActiveClusters) in place of a launch
template <typename T, bool kArithmetic>
int launch_cluster(const void* A, void* wout, void* Vout, const void* units, const void* starts,
                 int n, int R, int ld, int C, int rounds, int sweeps, int64_t B, int rj, int ru,
                 cudaStream_t st, int* clusters) {
  if (n < 1 || R < 1 || static_cast<int64_t>(C) * R < n || ld < n || B < 1 || rj < 1 || ru < 1 ||
      rj * ru > 1024 || (C != 2 && C != 4 && C != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (2 * static_cast<size_t>(R) * ld + 4 * static_cast<size_t>(n)) * sizeof(T);
  if (bytes > static_cast<size_t>(kMaxDynamicSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = eigh_jacobi_cluster_kernel<T, kArithmetic>;
  if (bytes > static_cast<size_t>(kOptInAbove)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * C));
  cfg.blockDim = dim3(1, rj, ru);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(A), static_cast<T*>(wout), static_cast<T*>(Vout),
      static_cast<const int*>(units), static_cast<const int*>(starts), n, R, ld, rounds, sweeps, B);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// (x, y) <- (c x + st y, c y + sb x) in registers; in the bye slot of an odd
// n each player is its own partner, as perm[r] == r in the twin
template <typename T, bool kOdd>
__device__ inline void rotate_regs(T& x, T& y, T c, T st, T sb, bool bye) {
  const T px = (kOdd && bye) ? x : y, py = (kOdd && bye) ? y : x;
  const T nx = rn::add(rn::mul(c, x), rn::mul(st, px));
  y = rn::add(rn::mul(c, y), rn::mul(sb, py));
  x = nx;
}

// A column's rows follow the players: position 0 stays, 1 takes m - 1's
// (the bottom of slot 0), k takes k - 1's, and the bottom of the last slot
// takes that slot's top.  Only names change: no instruction remains.
template <typename T, int W>
__device__ inline void shift_rows(T (&col)[W]) {
  constexpr int H = W / 2;
  T moved[W];
  moved[0] = col[0];
  if (H > 1) moved[1] = col[H];
#pragma unroll
  for (int j = 2; j < H; ++j) moved[j] = col[j - 1];
#pragma unroll
  for (int j = 0; j < H; ++j) moved[H + j] = j == H - 1 ? col[j] : col[H + (j + 1 < H ? j + 1 : j)];
#pragma unroll
  for (int e = 0; e < W; ++e) col[e] = moved[e];
}

// One entry of both columns a thread holds moves with its player.  Slot 0's
// top stays, slot 1's top takes slot 0's bottom, every other top the top of
// the slot below; a bottom takes the bottom of the slot above, the last
// slot's its own top: by shuffle from the warp's threads ``below`` and
// ``above``, which are the thread itself at either end.
template <typename T>
__device__ inline void move_players(T& top, T& bot, bool first, bool last, int below, int above) {
  const T up = __shfl_sync(kFullWarp, first ? bot : top, below);
  const T down = __shfl_sync(kFullWarp, bot, above);
  bot = last ? top : down;
  top = first ? top : up;
}

// K5r.  W: the even number of players, n or n + 1 (kOdd: the last is the
// dummy of an odd n, and one slot a round holds the bye).  Thread k of a
// lane's H = W / 2 holds slot k.  masks[rd]: bit j set where slot j's top
// player is the lower index, bit 16 + j where slot j holds the bye.
// Register e of a column of A is the row of position e (e < H: the top of
// slot e; else the bottom of slot e - H); V's rows keep their own order.
// The second launch bound lets every kernel keep the registers it needs:
// without it ptxas spills a few words to fit one more block on an SM.
template <typename T, int W, bool kOdd>
__global__ void __launch_bounds__(kRegisterBlock, 1)
    eigh_jacobi_registers_kernel(const T* __restrict__ A, T* __restrict__ wout,
                                 T* __restrict__ Vout, const unsigned* __restrict__ masks,
                                 int sweeps, int64_t B) {
  constexpr int H = W / 2;    // slots, and threads a lane
  constexpr int LW = 32 / H;  // lanes a warp; 32 - LW H threads idle
  constexpr int n = kOdd ? W - 1 : W;
  static_assert(W % 2 == 0 && H >= 1 && H <= 16, "unsupported width");
  const int tid = threadIdx.x & 31;
  const int k = tid % H, g = tid / H < LW ? tid / H : LW - 1;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t b = warp * LW + g;
  const bool live = b < B && tid < LW * H;
  // the warp's threads that hold the lane's slot 0, the slot below and the slot above
  const int slot0 = g * H, below = slot0 + (k > 0 ? k - 1 : 0), above = slot0 + (k + 1 < H ? k + 1 : k);

  T at[W], ab[W], vt[W], vb[W];

  // at the start position i holds player i
  const int ptop = k, pbot = W - 1 - k;
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const int row = e < H ? e : W - 1 - (e - H);
    T xt = T(0), xb = T(0);
    if (live && row < n) {
      xt = rn::mul(rn::add(A[(static_cast<int64_t>(row) * n + ptop) * B + b],
                           A[(static_cast<int64_t>(ptop) * n + row) * B + b]), T(0.5));
      if (pbot < n)
        xb = rn::mul(rn::add(A[(static_cast<int64_t>(row) * n + pbot) * B + b],
                             A[(static_cast<int64_t>(pbot) * n + row) * B + b]), T(0.5));
    }
    at[e] = xt;
    ab[e] = xb;
    vt[e] = T(e == ptop);
    vb[e] = T(e == pbot && pbot < n);
  }

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int rd = 0; rd < W - 1; ++rd) {
      const unsigned mask = __ldg(masks + rd);
      // the slot's own 2 x 2 block: rows k and H + k of its two columns
      T tt = T(0), bt = T(0), tb = T(0), bb = T(0);
#pragma unroll
      for (int j = 0; j < H; ++j) {
        if (j == k) {
          tt = at[j];      // A[top][top]
          bt = at[H + j];  // A[bottom][top]
          tb = ab[j];      // A[top][bottom]
          bb = ab[H + j];  // A[bottom][bottom]
        }
      }
      const bool top_lo = (mask >> k) & 1u;
      const bool bye = kOdd && ((mask >> (16 + k)) & 1u);
      T c, s;
      rotation(top_lo ? tt : bb, top_lo ? bb : tt, top_lo ? tb : bt, c, s);
      if (bye) {
        c = T(1);
        s = T(0);
      }
      // the lower player takes -s; the bye's real player +0, as the twin's
      const T st = (top_lo && !bye) ? -s : s, sb = (top_lo || bye) ? s : -s;

      // rows: slot j's two rows in both columns of this thread
#pragma unroll
      for (int j = 0; j < H; ++j) {
        T cj = c, stj = st, sbj = sb;
        if (H > 1) {
          cj = __shfl_sync(kFullWarp, c, slot0 + j);
          stj = __shfl_sync(kFullWarp, st, slot0 + j);
          sbj = -stj;
        }
        const bool byej = kOdd && ((mask >> (16 + j)) & 1u);
        if (byej) sbj = T(0);
        rotate_regs<T, kOdd>(at[j], at[H + j], cj, stj, sbj, byej);
        rotate_regs<T, kOdd>(ab[j], ab[H + j], cj, stj, sbj, byej);
      }

      // columns of A and of V: both of the slot's columns are here
#pragma unroll
      for (int e = 0; e < W; ++e) rotate_regs<T, kOdd>(at[e], ab[e], c, st, sb, bye);
#pragma unroll
      for (int r = 0; r < n; ++r) rotate_regs<T, kOdd>(vt[r], vb[r], c, st, sb, bye);

      if (H == 1) continue;  // two players: nobody moves

      // the players move: position 0 stays, 1 takes W - 1's, k takes k - 1's.
      // First A's rows within both columns, then the columns of A and V
      // between slots.
      shift_rows<T, W>(at);
      shift_rows<T, W>(ab);
#pragma unroll
      for (int e = 0; e < W; ++e) move_players(at[e], ab[e], k == 0, k == H - 1, below, above);
#pragma unroll
      for (int r = 0; r < n; ++r) move_players(vt[r], vb[r], k == 0, k == H - 1, below, above);
    }
  }

  // after whole sweeps every player is home: position i holds player i
  if (!live) return;
  T wt = T(0), wb = T(0);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if (j == k) {
      wt = at[j];
      wb = ab[H + j];
    }
  }
  wout[static_cast<int64_t>(ptop) * B + b] = wt;
  if (pbot < n) wout[static_cast<int64_t>(pbot) * B + b] = wb;
#pragma unroll
  for (int r = 0; r < n; ++r) {
    Vout[(static_cast<int64_t>(r) * n + ptop) * B + b] = vt[r];
    if (pbot < n) Vout[(static_cast<int64_t>(r) * n + pbot) * B + b] = vb[r];
  }
}

template <typename T, int W>
int run_registers(const void* A, void* wout, void* Vout, const void* masks, int n, int sweeps,
                  int64_t B, cudaStream_t st) {
  constexpr int lanes_a_warp = 32 / (W / 2);
  const int64_t warps = (B + lanes_a_warp - 1) / lanes_a_warp;
  const unsigned blocks = static_cast<unsigned>((warps * 32 + kRegisterBlock - 1) / kRegisterBlock);
  const T* a = static_cast<const T*>(A);
  T *w = static_cast<T*>(wout), *v = static_cast<T*>(Vout);
  const unsigned* mk = static_cast<const unsigned*>(masks);
  if (n == W - 1)
    eigh_jacobi_registers_kernel<T, W, true><<<blocks, kRegisterBlock, 0, st>>>(a, w, v, mk, sweeps,
                                                                                B);
  else
    eigh_jacobi_registers_kernel<T, W, false><<<blocks, kRegisterBlock, 0, st>>>(a, w, v, mk,
                                                                                 sweeps, B);
  return static_cast<int>(cudaGetLastError());
}

// one instantiation for every even number of players, from the widest W down
template <typename T, int W>
int launch_registers(const void* A, void* wout, void* Vout, const void* masks, int n, int sweeps,
                     int64_t B, int width, cudaStream_t st) {
  if (width == W) return run_registers<T, W>(A, wout, Vout, masks, n, sweeps, B, st);
  if constexpr (W > 2)
    return launch_registers<T, W - 2>(A, wout, Vout, masks, n, sweeps, B, width, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// A, Vout [n, n, B]; wout [n, B]; units int32 [rounds, ceil(n/2), 2].  K5a
// takes a block (tb lanes, rj, ru) and its slabs' leading dimension ldn.
// K5b takes the scratch work [n, n, B] and coef [2, n, B], ``blocks`` of
// ``threads``, and runs as one cooperative launch or as one launch a phase;
// its occupancy entry point writes the blocks of ``threads`` an SM holds.
// The registers form takes masks uint32 [rounds].  The cluster form (K5c)
// takes the units sorted by the rotating CTA, starts int32 [rounds][C + 1],
// its plan (C, R, ld) and a block (1, rj, ru); its occupancy entry point
// writes the clusters the card holds at once, and its barriers entry point
// (the benches' probe: w and V are garbage) runs its barriers alone.
// All return cudaGetLastError().
#define EIGH_JACOBI_ENTRY_POINT(T, SUFFIX, MAXW)                                                     \
  extern "C" int eigh_jacobi_##SUFFIX(const void* A, void* wout, void* Vout, const void* units, \
                                      int n, int ldn, int rounds, int sweeps, int64_t B, int tb, \
                                      int rj, int ru, void* stream) {                           \
    return launch<T>(A, wout, Vout, units, n, ldn, rounds, sweeps, B, tb, rj, ru, stream);      \
  }                                                                                             \
  extern "C" int eigh_jacobi_global_##SUFFIX(const void* A, void* work, void* coef, void* wout, \
                                             void* Vout, const void* units, int n, int rounds,  \
                                             int sweeps, int64_t B, int blocks, int threads,    \
                                             int cooperative, void* stream) {                   \
    return launch_global<T>(A, work, coef, wout, Vout, units, n, rounds, sweeps, B, blocks,     \
                            threads, cooperative, static_cast<cudaStream_t>(stream));           \
  }                                                                                             \
  extern "C" int eigh_jacobi_global_occupancy_##SUFFIX(int threads, int* blocks) {              \
    if (!blocks) return static_cast<int>(cudaErrorInvalidValue);                                \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(                      \
        blocks, eigh_jacobi_global_kernel<T>, threads, 0));                                     \
  }                                                                                             \
  extern "C" int eigh_jacobi_registers_##SUFFIX(const void* A, void* wout, void* Vout,          \
                                                const void* masks, int n, int sweeps,           \
                                                int64_t B, void* stream) {                      \
    const int width = n + (n & 1);                                                              \
    if (n < 1 || width > MAXW) return static_cast<int>(cudaErrorInvalidValue);                  \
    return launch_registers<T, MAXW>(A, wout, Vout, masks, n, sweeps, B, width,                 \
                                     static_cast<cudaStream_t>(stream));                        \
  }                                                                                             \
  extern "C" int eigh_jacobi_cluster_##SUFFIX(const void* A, void* wout, void* Vout,            \
                                              const void* units, const void* starts, int n,     \
                                              int R, int ld, int C, int rounds, int sweeps,     \
                                              int64_t B, int rj, int ru, void* stream) {        \
    return launch_cluster<T, true>(A, wout, Vout, units, starts, n, R, ld, C, rounds, sweeps, B, \
                                   rj, ru, static_cast<cudaStream_t>(stream), nullptr);         \
  }                                                                                             \
  extern "C" int eigh_jacobi_cluster_occupancy_##SUFFIX(int n, int R, int ld, int C, int rj,    \
                                                        int ru, int* clusters) {                \
    if (!clusters) return static_cast<int>(cudaErrorInvalidValue);                              \
    return launch_cluster<T, true>(nullptr, nullptr, nullptr, nullptr, nullptr, n, R, ld, C, 0, \
                                   0, 1, rj, ru, nullptr, clusters);                            \
  }                                                                                             \
  extern "C" int eigh_jacobi_cluster_barriers_##SUFFIX(                                         \
      const void* A, void* wout, void* Vout, const void* units, const void* starts, int n, int R, \
      int ld, int C, int rounds, int sweeps, int64_t B, int rj, int ru, void* stream) {         \
    return launch_cluster<T, false>(A, wout, Vout, units, starts, n, R, ld, C, rounds, sweeps,  \
                                    B, rj, ru, static_cast<cudaStream_t>(stream), nullptr);     \
  }

// a thread's 4 W words of entries are 128 registers at W = 32 in float32 and
// at W = 16 in float64
EIGH_JACOBI_ENTRY_POINT(float, f32, 32)
EIGH_JACOBI_ENTRY_POINT(double, f64, 16)
