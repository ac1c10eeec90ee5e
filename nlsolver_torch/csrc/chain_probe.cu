// The benches' probe of the back solves' floor (benches.probe_chain_latency):
// clocks a step of one thread's chain of dependent rounded f64 subtractions,
// the chain that the twins' order of a back solve's row makes (K2b-c, K2b-d,
// K3-c, K3-d), read in the ways those kernels could read their words.  It
// serves no solver.  One block; thread 0 times each chain of n steps with
// clock64 over words that the block first stages in shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "rn_math.cuh"

namespace {

constexpr int kChains = 7;

__global__ void chain_probe_kernel(const double* __restrict__ in, double* __restrict__ out,
                                   int n) {
  extern __shared__ double g[];  // [2][n]: words, then the x of the products
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) g[i] = in[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const double* x = g + n;
  const double c = g[0];
  double acc, sink = 0.0;
  long long t[kChains + 1];
  t[0] = clock64();
  acc = 1.0;
#pragma unroll 8
  for (int k = 0; k < n; ++k) acc = rn::sub(acc, c);  // from a register: the latency
  t[1] = clock64();
  sink += acc, acc = 1.0;
#pragma unroll 1
  for (int k = 0; k < n; ++k) acc = rn::sub(acc, g[k]);  // a word of shared memory a step
  t[2] = clock64();
  sink += acc, acc = 1.0;
#pragma unroll 8
  for (int k = 0; k < n; ++k) acc = rn::sub(acc, g[k]);  // the same, unrolled by 8
  t[3] = clock64();
  sink += acc;
  sink += rn::sub_each(1.0, g, 0, n);  // unrolled by 16, the kernels' back solves
  t[4] = clock64();
  acc = 1.0;
#pragma unroll 8
  for (int k = 0; k < n; ++k) acc = rn::sub(acc, rn::mul(g[k], x[k]));  // the product inline
  t[5] = clock64();
  sink += acc, acc = 1.0;
  {
    // eight words a pass, loaded a pass ahead
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = g[u];
#pragma unroll 1
    for (int k = 8; k + 8 <= n; k += 8) {
      double w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = g[k + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = rn::sub(acc, v[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = w[u];
    }
  }
  t[6] = clock64();
  double d = sink + acc;
#pragma unroll 8
  for (int k = 0; k < n; ++k) d = rn::div(d, 1.0000001);  // a division a step
  t[7] = clock64();
  out[kChains] = d;  // keeps every chain live
  for (int i = 0; i < kChains; ++i) out[i] = static_cast<double>(t[i + 1] - t[i]) / n;
}

}  // namespace

// out[0 .. 6]: clocks a step of each chain (a register; a shared word a
// step; unrolled by 8; unrolled by 16; the product inline, unrolled by 8;
// eight a pass ahead; a division a step), out[7] a sink; in [2 n] words,
// n a multiple of 8 whose 2 n words fit 232448 bytes.  Returns
// cudaGetLastError().
extern "C" int chain_probe_f64(const void* in, void* out, int n, void* stream) {
  const int64_t smem = 2 * static_cast<int64_t>(n) * sizeof(double);
  if (n < 16 || n % 8 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaFuncSetAttribute(
      chain_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  chain_probe_kernel<<<1, 64, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(in), static_cast<double*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
