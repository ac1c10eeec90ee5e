// Batched symmetric eigendecomposition by parallel-order cyclic Jacobi for
// Hopper (sm_90a), one computation in three forms:
//
//   K5r  registers  A and V of a lane live in the registers of a few threads
//                   of one warp; n <= 32 in float32, n <= 16 in float64
//   K5a  resident   A and V of a tile of lanes live in shared memory;
//                   n <= 169 in float32, n <= 119 in float64
//   K5b  global     A's working copy and V live in device memory, any n
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
// K5a and K5b.  The schedule is the table that the twin builds, int32
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
// block may opt in to, which is what ends the range at n = 169.  K5b runs the
// same code on a working copy of A, on V's output itself and on a
// coefficient scratch in device memory, lane stride B: any n, every round
// through L2 or HBM.
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

#include <cuda_runtime.h>

#include <cstdint>

#include "rn_math.cuh"

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

// K5a (kResident) and K5b: entry (i, j) of a lane's slab at
// base[(i ldn + j) ld + lane]
template <typename T, bool kResident>
__global__ void __launch_bounds__(1024)
    eigh_jacobi_kernel(const T* __restrict__ A, T* __restrict__ work, T* __restrict__ coef,
                       T* __restrict__ wout, T* __restrict__ Vout, const int* __restrict__ units,
                       int n, int ldn, int rounds, int sweeps, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TB = blockDim.x, RJ = blockDim.y, RU = blockDim.z;
  const int tb = threadIdx.x, rj = threadIdx.y, ru = threadIdx.z;
  const int t = ru * RJ + rj, NT = RJ * RU;
  const int nu = (n + 1) / 2, nn = n * n;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * TB + tb;
  const bool live = b < B;

  T *a, *v, *cv, *sv;
  int64_t ld, lane;
  if (kResident) {
    a = reinterpret_cast<T*>(smem_raw);
    v = a + static_cast<size_t>(n) * ldn * TB;
    cv = v + static_cast<size_t>(n) * ldn * TB;
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
  if (kResident)
    for (int e = t; e < nn; e += NT) {
      const int i = e / n, j = e - i * n;
      Vout[static_cast<int64_t>(e) * B + b] = v[(static_cast<int64_t>(i) * ldn + j) * ld + lane];
    }
}

template <typename T>
int launch(const void* A, void* work, void* coef, void* wout, void* Vout, const void* units, int n,
           int ldn, int rounds, int sweeps, int64_t B, int tb, int rj, int ru, int resident,
           void* stream) {
  if (n < 1 || ldn < n || tb < 1 || rj < 1 || ru < 1 || tb * rj * ru > 1024 || ru > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((B + tb - 1) / tb);
  const dim3 block(tb, rj, ru);
  const int* un = static_cast<const int*>(units);
  if (resident) {
    const size_t bytes =
        (2 * static_cast<size_t>(n) * ldn + 2 * static_cast<size_t>(n)) * tb * sizeof(T);
    if (bytes > static_cast<size_t>(kMaxDynamicSmem)) return static_cast<int>(cudaErrorInvalidValue);
    if (bytes > static_cast<size_t>(kOptInAbove)) {
      const cudaError_t err =
          cudaFuncSetAttribute(eigh_jacobi_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    eigh_jacobi_kernel<T, true><<<blocks, block, bytes, st>>>(
        static_cast<const T*>(A), nullptr, nullptr, static_cast<T*>(wout), static_cast<T*>(Vout),
        un, n, ldn, rounds, sweeps, B);
  } else {
    if (ldn != n) return static_cast<int>(cudaErrorInvalidValue);
    eigh_jacobi_kernel<T, false><<<blocks, block, 0, st>>>(
        static_cast<const T*>(A), static_cast<T*>(work), static_cast<T*>(coef),
        static_cast<T*>(wout), static_cast<T*>(Vout), un, n, ldn, rounds, sweeps, B);
  }
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

// A, Vout [n, n, B]; wout [n, B]; units int32 [rounds, ceil(n/2), 2]; block
// (tb lanes, rj, ru).  With resident != 0 the slabs live in shared memory
// with leading dimension ldn and work and coef are unused; else ldn == n,
// and work [n, n, B] and coef [2, n, B] are scratch in device memory.
// The registers form takes masks uint32 [rounds].  All return cudaGetLastError().
#define EIGH_JACOBI_ENTRY_POINT(T, SUFFIX, MAXW)                                                     \
  extern "C" int eigh_jacobi_##SUFFIX(const void* A, void* work, void* coef, void* wout,        \
                                      void* Vout, const void* units, int n, int ldn,            \
                                      int rounds, int sweeps, int64_t B, int tb, int rj,        \
                                      int ru, int resident, void* stream) {                     \
    return launch<T>(A, work, coef, wout, Vout, units, n, ldn, rounds, sweeps, B, tb, rj, ru,   \
                     resident, stream);                                                         \
  }                                                                                             \
  extern "C" int eigh_jacobi_registers_##SUFFIX(const void* A, void* wout, void* Vout,          \
                                                const void* masks, int n, int sweeps,           \
                                                int64_t B, void* stream) {                      \
    const int width = n + (n & 1);                                                              \
    if (n < 1 || width > MAXW) return static_cast<int>(cudaErrorInvalidValue);                  \
    return launch_registers<T, MAXW>(A, wout, Vout, masks, n, sweeps, B, width,                 \
                                     static_cast<cudaStream_t>(stream));                        \
  }

// a thread's 4 W words of entries are 128 registers at W = 32 in float32 and
// at W = 16 in float64
EIGH_JACOBI_ENTRY_POINT(float, f32, 32)
EIGH_JACOBI_ENTRY_POINT(double, f64, 16)
