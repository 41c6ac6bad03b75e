// Per-row augmentation epilogues: device port of repro/kernels/epilogues.py.
// The hinge pair maps (rho, margin[, nu, u]) to gamma, weight 1/gamma and
// coef rho/gamma + beta; SVR's double mixture maps (y, margin[, nu_g, u_g,
// nu_o, u_o]) to (gamma, omega), weight 1/gamma + 1/omega and coef
// (y - eps_ins)/gamma + (y + eps_ins)/omega (paper Eq. 25-28).
//
// nvcc contracts a*b + c into an FMA by default; PyTorch's eager ops
// round every operation. The IG transform is sensitive to that (its
// x = mu + mu*muy/2 - (mu/2)*sqrt(...) cancels at large mu), so every
// operation below is an explicit round-to-nearest intrinsic, in the
// reference's order, and the kernel's gamma equals the plain version's
// for the same margin and noise.
#pragma once

#include <stdint.h>

#include "rng.cuh"

namespace rt {

// Epilogue x noise source codes of the launchers. The seed variants derive
// the noise in-body from the counter cipher (rng.cuh).
enum Epilogue : int {
  EM_HINGE = 0,
  MC_NOISE = 1,
  MC_SEED = 2,
  EM_SVR = 3,
  MC_SVR_NOISE = 4,
  MC_SVR_SEED = 5
};

__host__ __device__ constexpr bool is_svr(int e) { return e >= EM_SVR; }
__host__ __device__ constexpr bool is_seed(int e) {
  return e == MC_SEED || e == MC_SVR_SEED;
}

constexpr float MU_MAX = 0x1.7d784p+26f;      // float32(1e8)
constexpr float INV_MU_MAX = 0x1.5798eep-27f;  // float32(1e-8)
constexpr float F32_TINY = 0x1p-126f;          // finfo(float32).tiny

// max / min as jnp.maximum / jnp.minimum take them: NaN in either operand
// gives NaN. fmaxf / fminf return the other operand instead, which would
// turn a NaN margin into gamma = eps. For operands that are not NaN these
// are fmaxf / fminf, bit for bit.
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

// em_hinge: gamma = max(eps, |rho - m|) (paper Eq. 9 and the Sec 5.7.3
// clamp).
__device__ __forceinline__ float em_gamma(float rho, float m, float eps) {
  return max_nan(fabsf(__fsub_rn(rho, m)), eps);
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
  x = max_nan(x, F32_TINY);  // the sqrt may overshoot mu by an ulp
  const float accept = __fdiv_rn(mu, __fadd_rn(mu, x));
  return u <= accept ? x : __fdiv_rn(__fmul_rn(mu, mu), x);
}

// ig_gamma_from_noise: gamma^{-1} ~ IG(1/|residual|, 1) from (nu, u),
// clamped to [1/MU_MAX, ...] on both sides and to eps below (paper Eq. 5).
__device__ __forceinline__ float ig_gamma(float residual, float nu, float u,
                                          float eps) {
  const float r = fabsf(residual);
  const float mu =
      min_nan(__fdiv_rn(1.0f, max_nan(r, INV_MU_MAX)), MU_MAX);
  const float inv_gamma = ig_transform(mu, nu, u);
  return max_nan(__fdiv_rn(1.0f, max_nan(inv_gamma, INV_MU_MAX)), eps);
}

// mc_hinge: the Gibbs draw on the residual rho - m.
__device__ __forceinline__ float mc_gamma(float rho, float m, float nu,
                                          float u, float eps) {
  return ig_gamma(__fsub_rn(rho, m), nu, u, eps);
}

// Where the MC noise of a row comes from: ``op`` holds the (N,) operands
// (nu, u[, nu_o, u_o]) of the noise variants; the seed variants run the
// counter cipher with key (k0, k1) on ``chain``'s plane.
struct Noise {
  const float* op[4];
  uint32_t k0, k1, chain;
};

// One row's epilogue: rho (the target y under SVR), margin m; ``i``
// indexes the noise operands and ``crow`` is the row's counter word.
// Outputs gamma, omega (SVR; gamma otherwise), the Sigma weight before the
// mask, and the b coefficient. The hinge's coefficient is rho/gamma; the
// caller adds beta after the epilogue.
template <int EPI>
__device__ __forceinline__ void row_epilogue(float rho, float m,
                                             const Noise& nz, int64_t i,
                                             uint32_t crow, float eps,
                                             float eps_ins, float& g,
                                             float& o, float& weight,
                                             float& coef) {
  float nu[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  if (EPI == MC_NOISE || EPI == MC_SVR_NOISE) {
#pragma unroll
    for (int mix = 0; mix < (EPI == MC_SVR_NOISE ? 2 : 1); ++mix) {
      nu[mix] = nz.op[2 * mix][i];
      u[mix] = nz.op[2 * mix + 1][i];
    }
  } else if (is_seed(EPI)) {
#pragma unroll
    for (int mix = 0; mix < (EPI == MC_SVR_SEED ? 2 : 1); ++mix)
      counter_noise(nz.k0, nz.k1, crow, nz.chain, mix, nu[mix], u[mix]);
  }
  if (!is_svr(EPI)) {
    g = EPI == EM_HINGE ? em_gamma(rho, m, eps)
                        : mc_gamma(rho, m, nu[0], u[0], eps);
    o = g;
    weight = __fdiv_rn(1.0f, g);
    coef = __fdiv_rn(rho, g);
    return;
  }
  const float res = __fsub_rn(rho, m);
  const float lo = __fsub_rn(res, eps_ins), hi = __fadd_rn(res, eps_ins);
  if (EPI == EM_SVR) {
    g = max_nan(fabsf(lo), eps);
    o = max_nan(fabsf(hi), eps);
  } else {
    g = ig_gamma(lo, nu[0], u[0], eps);
    o = ig_gamma(hi, nu[1], u[1], eps);
  }
  weight = __fadd_rn(__fdiv_rn(1.0f, g), __fdiv_rn(1.0f, o));
  coef = __fadd_rn(__fdiv_rn(__fsub_rn(rho, eps_ins), g),
                   __fdiv_rn(__fadd_rn(rho, eps_ins), o));
}

}  // namespace rt
