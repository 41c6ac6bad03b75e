// Per-row augmentation epilogues: device port of the hinge half of
// repro/kernels/epilogues.py. Each maps (rho, margin[, nu, u]) to gamma;
// the kernels then weigh Sigma by 1/gamma and b by rho/gamma + beta.
//
// nvcc contracts a*b + c into an FMA by default; PyTorch's eager ops
// round every operation. The IG transform is sensitive to that (its
// x = mu + mu*muy/2 - (mu/2)*sqrt(...) cancels at large mu), so every
// operation below is an explicit round-to-nearest intrinsic, in the
// reference's order, and the kernel's gamma equals the plain version's
// for the same margin and noise.
#pragma once

#include <stdint.h>

namespace rt {

enum Epilogue : int { EM_HINGE = 0, MC_NOISE = 1, MC_SEED = 2 };

constexpr float MU_MAX = 0x1.7d784p+26f;      // float32(1e8)
constexpr float INV_MU_MAX = 0x1.5798eep-27f;  // float32(1e-8)
constexpr float F32_TINY = 0x1p-126f;          // finfo(float32).tiny

// em_hinge: gamma = max(eps, |rho - m|) (paper Eq. 9 and the Sec 5.7.3
// clamp).
__device__ __forceinline__ float em_gamma(float rho, float m, float eps) {
  return fmaxf(fabsf(__fsub_rn(rho, m)), eps);
}

// Michael-Schucany-Haas IG(mu, 1) transform of (nu, u).
__device__ __forceinline__ float ig_transform(float mu, float nu, float u) {
  const float y = __fmul_rn(nu, nu);
  const float muy = __fmul_rn(mu, y);
  const float a = __fadd_rn(mu, __fmul_rn(__fmul_rn(mu, muy), 0.5f));
  const float h = __fmul_rn(mu, 0.5f);
  const float d = __fadd_rn(__fmul_rn(__fmul_rn(4.0f, mu), y),
                            __fmul_rn(muy, muy));
  float x = __fsub_rn(a, __fmul_rn(h, __fsqrt_rn(d)));
  x = fmaxf(x, F32_TINY);  // the sqrt may overshoot mu by an ulp
  const float accept = __fdiv_rn(mu, __fadd_rn(mu, x));
  return u <= accept ? x : __fdiv_rn(__fmul_rn(mu, mu), x);
}

// mc_hinge: gamma^{-1} ~ IG(1/|rho - m|, 1) from (nu, u), clamped to
// [1/MU_MAX, ...] on both sides and to eps below (paper Eq. 5).
__device__ __forceinline__ float mc_gamma(float rho, float m, float nu,
                                          float u, float eps) {
  const float r = fabsf(__fsub_rn(rho, m));
  const float mu = fminf(__fdiv_rn(1.0f, fmaxf(r, INV_MU_MAX)), MU_MAX);
  const float inv_gamma = ig_transform(mu, nu, u);
  return fmaxf(__fdiv_rn(1.0f, fmaxf(inv_gamma, INV_MU_MAX)), eps);
}

}  // namespace rt
