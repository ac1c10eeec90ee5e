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
// about 14 us at the H100's 3.35 TB/s.  It computes B*P*n = 5.2 M accurate
// cosines (Rastrigin) and, in Philox mode, B*P*(ceil(n/4)+1) Philox blocks,
// each a few hundred instructions per thread, which is of the same order.
// The design moves nothing else: the partner reads of a block's instances
// hit L1, the proposal lives in registers and is recomputed (not stored)
// for the write-back of an accepted agent, and the lane freeze is folded
// into the accept select, so a frozen lane costs one copy.
//
// Arithmetic: the donor is rounded step by step as PyTorch's eager
// a1 + F * (a2 - a3) rounds it (no FMA contraction), and each objective
// term likewise, so proposals equal the plain twin's bit for bit and only
// the order of the objective's sum differs.  Build without --use_fast_math.
//
// Random draws: injected (u [B, n, P] f32 and fdim [B, P] i32 pointers,
// for testing) or Philox4x32-10 keyed by (seed, generation) and countered
// by (d / 4, p, b, stream): u = (bits >> 8) * 2^-24, fdim = bits % n.

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

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
