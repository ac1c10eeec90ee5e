// One whole Differential Evolution generation in one kernel, for Hopper
// (sm_90a): ring-rotation mutation, binomial crossover, the objective and
// greedy selection.
//
// Replaces nlsolver_tpu/ops/de_fused.py:de_generation_fused (the Pallas
// TPU kernel built by _make_kernel).  What it computes is that kernel's
// function; the circulant selection matmul there only worked around the
// TPU compiler's missing dynamic rolls, so here one thread owns one agent
// (b, p) and reads its three ring partners A[b, d, (p + o_k) % P] directly.
// Neighbouring threads own neighbouring p, so every read and write of the
// [B, n, P] agents coalesces.
//
// What bounds it: one generation must read the agents and scores and write
// them back, (2*B*n*P + 2*B*P) * 4 bytes: 46.1 MB at B=8192, n=10, P=64,
// about 14 us at the H100's 3.35 TB/s.  It also computes B*P*n accurate
// cosines (Rastrigin: some 40 instructions each with the range reduction)
// and, in Philox mode, B*P*(ceil(n/4)+1) Philox blocks of some 60 integer
// instructions each.
//
// Three forms, chosen by shape in ops/de_fused.py:
//   * de_staged_kernel: a block's instances are contiguous, per_block * n *
//     P floats, and one bulk asynchronous copy (cp.async.bulk, Hopper's 1-D
//     TMA, completing on an mbarrier) stages them in shared memory while the
//     threads draw their crossover masks; the partner reads and the write-
//     back of a rejected agent then come from shared memory.  The proposal
//     is kept from the score pass, in registers for n <= kRegisterMaxN (one
//     kernel per n) and in shared memory beyond, so an accepted agent is
//     written with no second pass.  Where the slab is not 16-byte aligned or
//     sized (n * P % 4 != 0, or a view's offset), the threads stage it with
//     plain coalesced loads instead of the bulk copy.
//   * de_cluster_kernel (K1c): one instance over a thread-block cluster of
//     2-16 CTAs, each staging its agents' rows by bulk copies, the
//     partners read from their owners' shared memory (distributed shared
//     memory), the proposal kept; for instances past one block whose
//     slabs fit a cluster.
//   * de_generation_kernel: the agents read through L1 from device memory,
//     the proposal recomputed for the write-back of an accepted agent; for
//     populations whose slab does not fit a cluster's shared memory.
// The lane freeze is folded into the accept select, so a frozen lane costs
// one copy.
//
// Arithmetic: the donor is rounded step by step as PyTorch's eager
// a1 + F * (a2 - a3) rounds it (no FMA contraction), and each objective
// term likewise, so proposals equal the plain twin's bit for bit and only
// the order of the objective's sum differs.  Build without --use_fast_math.
//
// Random draws: injected (u [B, n, P] f32 and fdim [B, P] i32 pointers,
// for testing) or Philox4x32-10 keyed by (seed, generation) and countered
// by (d / 4, p, b, stream): u = (bits >> 8) * 2^-24, fdim = bits % n.  The
// staged form is built once for each source of draws, so its Philox kernel
// holds no injected arm.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

// Objective registry: term(x) per coordinate, finish(sum, n) per agent.
struct Rastrigin {
  __device__ static float term(float x) {
    // 2*pi as a float, as PyTorch's `2.0 * PI * x` rounds it in float32
    const float c = cosf(__fmul_rn(6.283185307179586f, x));
    return __fsub_rn(__fmul_rn(x, x), __fmul_rn(10.0f, c));
  }
  __device__ static float finish(float acc, int n) {
    return __fadd_rn(static_cast<float>(10.0 * n), acc);
  }
};

struct Sphere {
  __device__ static float term(float x) { return __fmul_rn(x, x); }
  __device__ static float finish(float acc, int) { return acc; }
};

struct Draws {
  const float* u;   // [B, n, P] or null for Philox mode
  const int* fdim;  // [B, P] or null for Philox mode
  uint32_t seed, generation;
};

// crossover uniforms of coordinates d0 .. d0+3 of agent (b, p)
__device__ inline void draw_u4(const Draws& r, long long b, int n, int P,
                               int p, int d0, float u4[4]) {
  if (r.u != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + j;
      u4[j] = d < n ? r.u[(b * n + d) * P + p] : 1.0f;
    }
  } else {
    const Philox4 w = philox4x32_10(
        Philox4{static_cast<uint32_t>(d0 / 4), static_cast<uint32_t>(p),
                static_cast<uint32_t>(b), 0u},
        r.seed, r.generation);
    u4[0] = philox_unit(w.x);
    u4[1] = philox_unit(w.y);
    u4[2] = philox_unit(w.z);
    u4[3] = philox_unit(w.w);
  }
}

__device__ inline int draw_fdim(const Draws& r, long long b, int n, int P,
                                int p) {
  if (r.fdim != nullptr) return r.fdim[b * P + p];
  const Philox4 w = philox4x32_10(
      Philox4{0u, static_cast<uint32_t>(p), static_cast<uint32_t>(b), 1u},
      r.seed, r.generation);
  return static_cast<int>(w.x % static_cast<uint32_t>(n));
}

struct Agent {
  const float* A;  // this instance's [n, P] slab
  int P, p, q1, q2, q3, fdim;
  float F, CR;

  __device__ float proposal(int d, float u) const {
    const float* row = A + static_cast<long long>(d) * P;
    if (u < CR || d == fdim) {
      return __fadd_rn(row[q1], __fmul_rn(F, __fsub_rn(row[q2], row[q3])));
    }
    return row[p];
  }
};

template <class Obj>
__global__ void de_generation_kernel(
    const float* __restrict__ agents, const float* __restrict__ scores,
    const bool* __restrict__ active, Draws draws,
    float* __restrict__ out_agents, float* __restrict__ out_scores, int B,
    int n, int P, int o1, int o2, int o3, float F, float CR) {
  const int per_block = blockDim.x / P;
  const int p = threadIdx.x % P;
  const long long b =
      static_cast<long long>(blockIdx.x) * per_block + threadIdx.x / P;
  if (b >= B) return;

  const long long slab = b * n * P;
  const Agent ag{agents + slab,  P,
                 p,              (p + o1) % P,
                 (p + o2) % P,   (p + o3) % P,
                 draw_fdim(draws, b, n, P, p),
                 F,              CR};

  float acc = 0.0f;
  for (int d0 = 0; d0 < n; d0 += 4) {
    float u4[4];
    draw_u4(draws, b, n, P, p, d0, u4);
    for (int j = 0; j < 4 && d0 + j < n; ++j) {
      acc = __fadd_rn(acc, Obj::term(ag.proposal(d0 + j, u4[j])));
    }
  }
  const float prop_score = Obj::finish(acc, n);
  const float s = scores[b * P + p];
  const bool accept = active[b] && prop_score < s;
  out_scores[b * P + p] = accept ? prop_score : s;

  float* out = out_agents + slab;
  if (accept) {
    for (int d0 = 0; d0 < n; d0 += 4) {
      float u4[4];
      draw_u4(draws, b, n, P, p, d0, u4);
      for (int j = 0; j < 4 && d0 + j < n; ++j) {
        out[static_cast<long long>(d0 + j) * P + p] = ag.proposal(d0 + j, u4[j]);
      }
    }
  } else {
    for (int d = 0; d < n; ++d) {
      out[static_cast<long long>(d) * P + p] = ag.A[static_cast<long long>(d) * P + p];
    }
  }
}

// the staged form's most n with the proposal in registers
constexpr int kRegisterMaxN = 16;

__device__ inline uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the cluster barrier in its two halves
__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" : : : "memory");
}
__device__ inline void cluster_wait() { asm volatile("barrier.cluster.wait;\n" : : : "memory"); }

// whether coordinate d of agent (b, p) mutates: u < CR or d == fdim
__device__ inline bool mutates(const float u4[4], int j, int d, int fdim, float CR) {
  return u4[j] < CR || d == fdim;
}

template <class Obj, int NR, bool kPhilox>
__global__ void __launch_bounds__(1024)
    de_staged_kernel(const float* __restrict__ agents, const float* __restrict__ scores,
                     const bool* __restrict__ active, Draws given,
                     float* __restrict__ out_agents, float* __restrict__ out_scores,
                     int B, int n, int P, int o1, int o2, int o3, float F, float CR,
                     int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t staged;  // the bulk copy's mbarrier
  // Philox draws as a compile-time fact, so that this kernel holds no
  // injected arm (a reading of its SASS then follows the Philox path)
  const Draws draws = kPhilox ? Draws{nullptr, nullptr, given.seed, given.generation} : given;
  const int per_block = blockDim.x / P, t = threadIdx.x;
  const int p = t % P, local = t / P;
  const long long b0 = static_cast<long long>(blockIdx.x) * per_block;
  const int count = static_cast<int>(min(static_cast<long long>(per_block), B - b0));
  const int words = count * n * P;
  float* slab = reinterpret_cast<float*>(smem);  // [count][n][P]
  const float* src = agents + b0 * n * P;
  if (bulk) {
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_address(&staged)));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (t == 0) {
      const uint32_t bytes = static_cast<uint32_t>(words) * 4u;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_address(&staged)), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(smem_address(slab)), "l"(src), "r"(bytes), "r"(smem_address(&staged))
          : "memory");
    }
  } else {
    for (int i = t; i < words; i += blockDim.x) slab[i] = src[i];
    __syncthreads();
  }
  if (local >= count) return;  // no barrier follows
  const long long b = b0 + local;
  const int q1 = (p + o1) % P, q2 = (p + o2) % P, q3 = (p + o3) % P;
  const int fdim = draw_fdim(draws, b, n, P, p);
  const bool live = active[b];
  const float s = scores[b * P + p];
  float* out = out_agents + b * n * P;
  const float* A = slab + static_cast<long long>(local) * n * P;
  auto donor = [&](int d) {
    const float* row = A + d * P;
    return __fadd_rn(row[q1], __fmul_rn(F, __fsub_rn(row[q2], row[q3])));
  };
  auto wait_staged = [&]() {
    if (!bulk) return;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred ready;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], 0;\n"
          " selp.u32 %0, 1, 0, ready;\n}"
          : "=r"(done) : "r"(smem_address(&staged)) : "memory");
    }
  };
  float acc = 0.0f;
  if constexpr (NR > 0) {
    // the crossover mask while the copy is in flight, then the proposal in
    // registers
    uint32_t mask = 0;
#pragma unroll
    for (int d0 = 0; d0 < NR; d0 += 4) {
      float u4[4];
      draw_u4(draws, b, NR, P, p, d0, u4);
#pragma unroll
      for (int j = 0; j < 4 && d0 + j < NR; ++j)
        mask |= static_cast<uint32_t>(mutates(u4, j, d0 + j, fdim, CR)) << (d0 + j);
    }
    wait_staged();
    float prop[NR];
#pragma unroll
    for (int d = 0; d < NR; ++d) {
      prop[d] = (mask >> d & 1u) ? donor(d) : A[d * P + p];
      acc = __fadd_rn(acc, Obj::term(prop[d]));
    }
    const float prop_score = Obj::finish(acc, NR);
    const bool accept = live && prop_score < s;
    out_scores[b * P + p] = accept ? prop_score : s;
#pragma unroll
    for (int d = 0; d < NR; ++d) out[d * P + p] = accept ? prop[d] : A[d * P + p];
  } else {
    // the proposal in shared memory past the slabs, [d][thread]
    float* prop = slab + static_cast<long long>(per_block) * n * P + t;
    const int stride = blockDim.x;
    wait_staged();
    for (int d0 = 0; d0 < n; d0 += 4) {
      float u4[4];
      draw_u4(draws, b, n, P, p, d0, u4);
      for (int j = 0; j < 4 && d0 + j < n; ++j) {
        const int d = d0 + j;
        const float v = mutates(u4, j, d, fdim, CR) ? donor(d) : A[d * P + p];
        prop[d * stride] = v;
        acc = __fadd_rn(acc, Obj::term(v));
      }
    }
    const float prop_score = Obj::finish(acc, n);
    const bool accept = live && prop_score < s;
    out_scores[b * P + p] = accept ? prop_score : s;
    for (int d = 0; d < n; ++d) out[static_cast<long long>(d) * P + p] = accept ? prop[d * stride] : A[d * P + p];
  }
}

template <class Obj, int NR, bool kPhilox>
int launch_staged(const float* agents, const float* scores, const bool* active,
                  const Draws& draws, float* out_agents, float* out_scores, int B,
                  int n, int P, int o1, int o2, int o3, float F, float CR,
                  int per_block, int smem, int bulk, cudaStream_t stream) {
  if constexpr (NR > 0) {
    if (n != NR) {
      return launch_staged<Obj, NR - 1, kPhilox>(agents, scores, active, draws, out_agents,
                                                 out_scores, B, n, P, o1, o2, o3, F, CR,
                                                 per_block, smem, bulk, stream);
    }
  }
  const cudaError_t err = cudaFuncSetAttribute(
      de_staged_kernel<Obj, NR, kPhilox>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + per_block - 1) / per_block;
  de_staged_kernel<Obj, NR, kPhilox><<<blocks, per_block * P, smem, stream>>>(
      agents, scores, active, draws, out_agents, out_scores, B, n, P, o1, o2, o3, F, CR,
      bulk);
  return static_cast<int>(cudaGetLastError());
}

template <class Obj>
int launch(const void* agents, const void* scores, const void* active,
           const void* u, const void* fdim, void* out_agents,
           void* out_scores, int B, int n, int P, int o1, int o2, int o3,
           float F, float CR, uint32_t seed, uint32_t generation,
           void* stream) {
  // a block holds whole instances: P threads each, about 256 in all
  const int per_block = P >= 256 ? 1 : 256 / P;
  const int blocks = (B + per_block - 1) / per_block;
  const Draws draws{static_cast<const float*>(u), static_cast<const int*>(fdim),
                    seed, generation};
  de_generation_kernel<Obj><<<blocks, per_block * P, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(agents), static_cast<const float*>(scores),
      static_cast<const bool*>(active), draws,
      static_cast<float*>(out_agents), static_cast<float*>(out_scores), B, n,
      P, o1, o2, o3, F, CR);
  return static_cast<int>(cudaGetLastError());
}

// K1c: one instance over a thread-block cluster of C CTAs.  CTA k owns the
// agents k cols .. k cols + cols - 1 (cols = P / C), a thread each, and
// stages their n rows in its shared memory by bulk copies completing on an
// mbarrier (plain loads where a row is not 16-byte aligned or sized) while
// its threads draw the crossover mask of their first 32 coordinates.  After
// a cluster barrier a partner (p + o) % P is read from its owner's shared
// memory (distributed shared memory), the proposal is kept in the CTA's
// shared memory beside the slab, and Philox runs once an agent: an accepted
// agent is written from the kept proposal.  A CTA leaves only after its
// peers have read its slab (the barrier's second half).  Probe modes: 1
// leaves out the proposals (the copies, barriers and write-back alone), 2
// reads each partner from the CTA's own slab in place of its owner's.
template <class Obj, bool kPhilox>
__global__ void __launch_bounds__(1024)
    de_cluster_kernel(const float* __restrict__ agents, const float* __restrict__ scores,
                      const bool* __restrict__ active, Draws given,
                      float* __restrict__ out_agents, float* __restrict__ out_scores, int n,
                      int P, int o1, int o2, int o3, float F, float CR, int bulk, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t staged;  // the bulk copies' mbarrier
  cg::cluster_group cluster = cg::this_cluster();
  const Draws draws = kPhilox ? Draws{nullptr, nullptr, given.seed, given.generation} : given;
  const int C = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  const int cols = blockDim.x, t = threadIdx.x, p = k * cols + t;
  const long long b = blockIdx.x / C;
  float* slab = reinterpret_cast<float*>(smem);  // [n][cols]: this CTA's agents
  float* prop = slab + static_cast<long long>(n) * cols;  // [n][cols]: their proposals
  const float* src = agents + b * n * P + static_cast<long long>(k) * cols;
  if (bulk) {
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_address(&staged)));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (t == 0) {
      const uint32_t row = static_cast<uint32_t>(cols) * 4u;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_address(&staged)), "r"(row * static_cast<uint32_t>(n)) : "memory");
      for (int d = 0; d < n; ++d)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            ::"r"(smem_address(slab + static_cast<long long>(d) * cols)),
            "l"(src + static_cast<long long>(d) * P), "r"(row), "r"(smem_address(&staged))
            : "memory");
    }
  } else {
    for (int d = 0; d < n; ++d) slab[d * cols + t] = src[static_cast<long long>(d) * P + t];
  }
  const int fdim = draw_fdim(draws, b, n, P, p);
  const bool live = active[b];
  const float s = scores[b * P + p];
  // the mask of coordinates 0 .. 31 while the slab lands
  uint32_t mask = 0;
  const int early = mode == 1 ? 0 : min(n, 32);
  for (int d0 = 0; d0 < early; d0 += 4) {
    float u4[4];
    draw_u4(draws, b, n, P, p, d0, u4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (d0 + j < early) mask |= static_cast<uint32_t>(mutates(u4, j, d0 + j, fdim, CR)) << (d0 + j);
  }
  if (bulk) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred ready;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], 0;\n"
          " selp.u32 %0, 1, 0, ready;\n}"
          : "=r"(done) : "r"(smem_address(&staged)) : "memory");
    }
  }
  cluster.sync();  // every CTA's slab staged, and seen by its peers
  const int q1 = (p + o1) % P, q2 = (p + o2) % P, q3 = (p + o3) % P;
  const bool local = mode == 2;
  const float* A1 = local ? slab + q1 % cols : cluster.map_shared_rank(slab, q1 / cols) + q1 % cols;
  const float* A2 = local ? slab + q2 % cols : cluster.map_shared_rank(slab, q2 / cols) + q2 % cols;
  const float* A3 = local ? slab + q3 % cols : cluster.map_shared_rank(slab, q3 / cols) + q3 % cols;
  const float* own = slab + t;
  // the partners of four coordinates in registers, loaded a group ahead of
  // the proposals' stores (which the compiler may not pass: the partners'
  // pointers may alias them)
  float a1[4], a2[4], a3[4], a0[4];
  const auto load = [&](int d0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long at = static_cast<long long>(min(d0 + j, n - 1)) * cols;
      a1[j] = A1[at];
      a2[j] = A2[at];
      a3[j] = A3[at];
      a0[j] = own[at];
    }
  };
  float acc = 0.0f;
  const int coords = mode == 1 ? 0 : n;
  if (coords > 0) load(0);
  for (int d0 = 0; d0 < coords; d0 += 4) {
    float x1[4], x2[4], x3[4], x0[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1[j] = a1[j];
      x2[j] = a2[j];
      x3[j] = a3[j];
      x0[j] = a0[j];
    }
    if (d0 + 4 < coords) load(d0 + 4);
    uint32_t bits = mask >> (d0 & 31);
    if (d0 >= 32) {  // past the first 32: drawn here, still once an agent
      float u4[4];
      draw_u4(draws, b, n, P, p, d0, u4);
      bits = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) bits |= static_cast<uint32_t>(mutates(u4, j, d0 + j, fdim, CR)) << j;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + j;
      if (d >= n) break;
      const float v = (bits >> j & 1u) ? __fadd_rn(x1[j], __fmul_rn(F, __fsub_rn(x2[j], x3[j])))
                                       : x0[j];
      prop[static_cast<long long>(d) * cols + t] = v;
      acc = __fadd_rn(acc, Obj::term(v));
    }
  }
  cluster_arrive();  // this CTA reads no peer any more
  const float prop_score = Obj::finish(acc, n);
  const bool accept = live && prop_score < s && mode != 1;
  out_scores[b * P + p] = accept ? prop_score : s;
  float* out = out_agents + b * n * P + p;
  for (int d = 0; d < n; ++d) {
    const long long at = static_cast<long long>(d) * cols + t;
    out[static_cast<long long>(d) * P] = accept ? prop[at] : slab[at];
  }
  cluster_wait();  // no peer reads this CTA's slab any more
}

template <class Obj, bool kPhilox>
int launch_cluster(const float* agents, const float* scores, const bool* active,
                   const Draws& draws, float* out_agents, float* out_scores, int B, int n, int P,
                   int o1, int o2, int o3, float F, float CR, int C, int smem, int bulk,
                   int mode, cudaStream_t stream) {
  const auto kernel = de_cluster_kernel<Obj, kPhilox>;
  if (C < 2 || C > 16 || P % C != 0 || P / C > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  cfg.gridDim = dim3(static_cast<unsigned>(B) * C);
  cfg.blockDim = dim3(P / C);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, agents, scores, active, draws, out_agents, out_scores, n,
                           P, o1, o2, o3, F, CR, bulk, mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K1c on untyped arguments: the Philox kernel where u (and with it fdim) is
// null, the injected-draws kernel otherwise
template <class Obj>
int launch_cluster_draws(const void* agents, const void* scores, const void* active,
                         const void* u, const void* fdim, void* out_agents, void* out_scores,
                         int B, int n, int P, int o1, int o2, int o3, float F, float CR,
                         uint32_t seed, uint32_t generation, int C, int smem, int bulk,
                         int mode, void* stream) {
  const Draws draws{static_cast<const float*>(u), static_cast<const int*>(fdim), seed,
                    generation};
  const auto* a = static_cast<const float*>(agents);
  const auto* sc = static_cast<const float*>(scores);
  const auto* act = static_cast<const bool*>(active);
  auto* oa = static_cast<float*>(out_agents);
  auto* os = static_cast<float*>(out_scores);
  auto st = static_cast<cudaStream_t>(stream);
  if (u == nullptr)
    return launch_cluster<Obj, true>(a, sc, act, draws, oa, os, B, n, P, o1, o2, o3, F, CR, C,
                                     smem, bulk, mode, st);
  return launch_cluster<Obj, false>(a, sc, act, draws, oa, os, B, n, P, o1, o2, o3, F, CR, C,
                                    smem, bulk, mode, st);
}

// the staged form on untyped arguments: the Philox kernel where u (and
// with it fdim) is null, the injected-draws kernel otherwise
template <class Obj>
int launch_staged_draws(const void* agents, const void* scores, const void* active,
                        const void* u, const void* fdim, void* out_agents,
                        void* out_scores, int B, int n, int P, int o1, int o2, int o3,
                        float F, float CR, uint32_t seed, uint32_t generation,
                        int per_block, int smem, int bulk, void* stream) {
  const Draws draws{static_cast<const float*>(u), static_cast<const int*>(fdim), seed,
                    generation};
  const auto* a = static_cast<const float*>(agents);
  const auto* sc = static_cast<const float*>(scores);
  const auto* act = static_cast<const bool*>(active);
  auto* oa = static_cast<float*>(out_agents);
  auto* os = static_cast<float*>(out_scores);
  auto st = static_cast<cudaStream_t>(stream);
  if (u == nullptr) {
    return launch_staged<Obj, kRegisterMaxN, true>(a, sc, act, draws, oa, os, B, n, P, o1,
                                                   o2, o3, F, CR, per_block, smem, bulk, st);
  }
  return launch_staged<Obj, kRegisterMaxN, false>(a, sc, act, draws, oa, os, B, n, P, o1, o2,
                                                  o3, F, CR, per_block, smem, bulk, st);
}

}  // namespace

// One launcher per registry objective, float32.  Returns cudaGetLastError().
#define NLSOLVER_DE_LAUNCHER(NAME, OBJ)                                      \
  extern "C" int de_generation_##NAME##_f32(                                 \
      const void* agents, const void* scores, const void* active,            \
      const void* u, const void* fdim, void* out_agents, void* out_scores,   \
      int B, int n, int P, int o1, int o2, int o3, float F, float CR,        \
      uint32_t seed, uint32_t generation, void* stream) {                    \
    return launch<OBJ>(agents, scores, active, u, fdim, out_agents,          \
                       out_scores, B, n, P, o1, o2, o3, F, CR, seed,         \
                       generation, stream);                                  \
  }

NLSOLVER_DE_LAUNCHER(rastrigin, Rastrigin)
NLSOLVER_DE_LAUNCHER(sphere, Sphere)

// The staged form: ``per_block`` instances a block, ``smem`` bytes of dynamic
// shared memory (their slabs, and their proposals where n > kRegisterMaxN),
// ``bulk`` non-zero to stage them with one bulk copy; one kernel for Philox
// draws (u and fdim null) and one for injected draws.  Returns
// cudaGetLastError().
#define NLSOLVER_DE_STAGED_LAUNCHER(NAME, OBJ)                                 \
  extern "C" int de_staged_##NAME##_f32(                                       \
      const void* agents, const void* scores, const void* active,              \
      const void* u, const void* fdim, void* out_agents, void* out_scores,     \
      int B, int n, int P, int o1, int o2, int o3, float F, float CR,          \
      uint32_t seed, uint32_t generation, int per_block, int smem, int bulk,   \
      void* stream) {                                                          \
    return launch_staged_draws<OBJ>(agents, scores, active, u, fdim,           \
                                    out_agents, out_scores, B, n, P, o1, o2,   \
                                    o3, F, CR, seed, generation, per_block,    \
                                    smem, bulk, stream);                       \
  }

NLSOLVER_DE_STAGED_LAUNCHER(rastrigin, Rastrigin)
NLSOLVER_DE_STAGED_LAUNCHER(sphere, Sphere)

// K1c: ``C`` CTAs a cluster an instance, ``smem`` bytes of dynamic shared
// memory (a CTA's slab and proposals), ``bulk`` non-zero to stage each row
// with a bulk copy, ``mode`` a probe mode (0: the generation); one kernel
// for Philox draws (u and fdim null) and one for injected draws.  Returns
// cudaGetLastError().
#define NLSOLVER_DE_CLUSTER_LAUNCHER(NAME, OBJ)                                \
  extern "C" int de_cluster_##NAME##_f32(                                      \
      const void* agents, const void* scores, const void* active,              \
      const void* u, const void* fdim, void* out_agents, void* out_scores,     \
      int B, int n, int P, int o1, int o2, int o3, float F, float CR,          \
      uint32_t seed, uint32_t generation, int C, int smem, int bulk,           \
      int mode, void* stream) {                                                \
    return launch_cluster_draws<OBJ>(agents, scores, active, u, fdim,          \
                                     out_agents, out_scores, B, n, P, o1, o2,  \
                                     o3, F, CR, seed, generation, C, smem,     \
                                     bulk, mode, stream);                      \
  }

NLSOLVER_DE_CLUSTER_LAUNCHER(rastrigin, Rastrigin)
NLSOLVER_DE_CLUSTER_LAUNCHER(sphere, Sphere)
