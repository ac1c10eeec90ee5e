// Round-to-nearest arithmetic for float and double through the _rn
// intrinsics, so that the compiler never fuses a multiply and an add into
// an FMA: each operation rounds once, as one PyTorch elementwise op does.
// The kernels that must equal their plain PyTorch twins bit for bit
// compute through these.
#pragma once

#include <cuda_runtime.h>

namespace rn {

__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }
__device__ inline float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ inline float sqrt(float a) { return __fsqrt_rn(a); }
__device__ inline float abs(float a) { return fabsf(a); }

__device__ inline double add(double a, double b) { return __dadd_rn(a, b); }
__device__ inline double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ inline double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ inline double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ inline double sqrt(double a) { return __dsqrt_rn(a); }
__device__ inline double abs(double a) { return fabs(a); }

// acc less g[k] for k = lo .. hi - 1, one rounded subtraction each in
// ascending k (the twins' order of a back solve's row); unrolled by 16, so
// that the loads of shared memory are issued ahead of the subtractions
// that wait on them (on an H100, 9.7 clocks a step in f64 against the 8.4
// of the subtraction's latency; unrolled by 8, 11.4; a word a step, 44:
// benches.probe_chain_latency)
template <typename T>
__device__ inline T sub_each(T acc, const T* g, int lo, int hi) {
#pragma unroll 16
  for (int k = lo; k < hi; ++k) acc = sub(acc, g[k]);
  return acc;
}

// torch.sign: 1, -1 or 0
template <typename T>
__device__ inline T sign(T a) {
  return static_cast<T>((a > T(0)) - (a < T(0)));
}

}  // namespace rn
