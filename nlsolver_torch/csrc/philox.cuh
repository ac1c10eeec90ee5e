// Philox4x32-10 counter-based generator (Salmon, Moraes, Dror, Shaw,
// "Parallel random numbers: as easy as 1, 2, 3", SC 2011).  Stateless: the
// 128-bit counter and the 64-bit key give four 32-bit words.  The Python
// twin is nlsolver_torch/ops/de_fused.py:philox4x32_10.
#pragma once

#include <cstdint>

struct Philox4 {
  uint32_t x, y, z, w;
};

__host__ __device__ inline void philox_mulhilo(uint32_t a, uint32_t b,
                                               uint32_t& hi, uint32_t& lo) {
#ifdef __CUDA_ARCH__
  lo = a * b;
  hi = __umulhi(a, b);
#else
  const uint64_t p = static_cast<uint64_t>(a) * b;
  lo = static_cast<uint32_t>(p);
  hi = static_cast<uint32_t>(p >> 32);
#endif
}

__host__ __device__ inline Philox4 philox4x32_10(Philox4 c, uint32_t k0,
                                                 uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    uint32_t hi0, lo0, hi1, lo1;
    philox_mulhilo(M0, c.x, hi0, lo0);
    philox_mulhilo(M1, c.z, hi1, lo1);
    c = Philox4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// 24 random bits as a float in [0, 1); exact in float32.
__host__ __device__ inline float philox_unit(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}
