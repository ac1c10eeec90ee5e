// A barrier among the P CTAs that share one lane, in device memory, for
// the forms that spread a lane over the whole card (K2b-d, K3-d).  Each
// team of P CTAs owns one 32-bit counter, zeroed by the wrapper before the
// launch.  A CTA arrives, after a block barrier, by adding one with a
// release reduction at gpu scope from its first thread (its threads' stores
// to device memory visible at gpu scope first), and waits until the
// counter reaches the next multiple of P by an acquire load in its first
// thread, then a block barrier.  The counter
// only grows, so no reset sits between two barriers; targets wrap modulo
// 2^32 and are compared by their signed difference.
//
// Every CTA of a team must be resident at once, or a wait never ends:
// the kernels that use it are launched cooperatively
// (cudaLaunchCooperativeKernel), which refuses a grid the card cannot hold.
// The data that crosses CTAs is stored with st.global.cg and read with
// ld.global.cg (__stcg / __ldcg): at L2, never from a stale line of an
// SM's L1.  A wait longer than 2^35 SM clocks (some 17 s; a barrier of
// these kernels waits on one step of the other CTAs, or one back solve,
// milliseconds) traps, so a fault ends the launch with an error and never
// hangs the card.
#pragma once

#include <cuda_runtime.h>

namespace lane {

// this CTA's arrival: every thread's earlier stores, then one increment
// with release semantics at gpu scope
__device__ __forceinline__ void arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
}

// the wait for the team's arrival number ``target`` (a multiple of P): an
// acquire load at gpu scope in the first thread, then a block barrier
__device__ __forceinline__ void wait(const unsigned* count, unsigned target) {
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const long long t0 = clock64();
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
      if (clock64() - t0 > (1ll << 35)) __trap();
    } while (static_cast<int>(seen - target) < 0);
  }
  __syncthreads();
}

}  // namespace lane
