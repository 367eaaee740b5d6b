// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011; the Random123 constants), written out for the fused step
// kernel. It takes the place of the TPU kernel's pltpu.prng_random_bits in
// sdmm_tpu/ops/bounce_pallas.py _step_kernel. The plain twin is
// ops/bounce.py philox4x32 / philox_uniforms, which yields the same bits.

#pragma once

#include <stdint.h>

namespace philox {

struct U4 {
  uint32_t x[4];
};

__device__ __forceinline__ U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x[0], hi0 = __umulhi(0xD2511F53u, c.x[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c.x[2], hi1 = __umulhi(0xCD9E8D57u, c.x[2]);
    c = U4{{hi1 ^ c.x[1] ^ k0, lo1, hi0 ^ c.x[3] ^ k1, lo0}};
  }
  return c;
}

// A uniform in [0, 1) from the top 24 bits of a word, as the TPU kernel
// converts its random bits (exact in float32).
__device__ __forceinline__ float uniform24(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}

}  // namespace philox
