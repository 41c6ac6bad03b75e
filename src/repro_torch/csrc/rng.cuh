// Counter-based RNG for the in-kernel Gibbs noise: device port of
// repro/kernels/rng.py (threefry2x32, uniform_from_bits, normal_from_bits,
// counter_noise). The words equal the host's exactly (native uint32_t
// arithmetic wraps as the reference's does). The floats use one logf,
// sqrtf and cosf (CUDA's IEEE-mode library, no fast-math) joined by
// bare multiplies written as __fmul_rn, so nothing is contracted into an
// FMA and the values are those PyTorch's eager ops give on the card.
#pragma once

#include <stdint.h>

namespace rt {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// Threefry-2x32, 20 rounds: 5 groups of 4 rotations with alternating
// schedules and a key injection after each group.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t c0, uint32_t c1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = x0 ^ rotl32(x1, rot[i % 2][r]);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// (i + 0.5) * 2^-23 from the top 23 bits: strictly inside (0, 1).
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __fmul_rn(__fadd_rn((float)(bits >> 9), 0.5f), 0x1p-23f);
}

// Box-Muller: sqrt(-2 ln u1) * cos(2 pi u2), 2 pi rounded to float32.
__device__ __forceinline__ float normal_from_bits(uint32_t b0, uint32_t b1) {
  const float r = __fsqrt_rn(__fmul_rn(-2.0f, logf(uniform_from_bits(b0))));
  return __fmul_rn(r, cosf(__fmul_rn(0x1.921fb6p+2f, uniform_from_bits(b1))));
}

// The (nu, u) pair of mixture ``mix`` (0: gamma's, 1: SVR's omega) at
// global row ``row`` and chain ``chain``: counter words c1 = chain*4 + 2 mix
// (the normal's two words) and chain*4 + 2 mix + 1 (word 0 is the
// accept-reject uniform).
__device__ __forceinline__ void counter_noise(uint32_t k0, uint32_t k1,
                                              uint32_t row, uint32_t chain,
                                              int mix, float& nu, float& u) {
  const uint32_t base = (chain << 2) | (2u * (uint32_t)mix);
  const uint2 n = threefry2x32(k0, k1, row, base);
  const uint2 w = threefry2x32(k0, k1, row, base | 1u);
  nu = normal_from_bits(n.x, n.y);
  u = uniform_from_bits(w.x);
}

}  // namespace rt
