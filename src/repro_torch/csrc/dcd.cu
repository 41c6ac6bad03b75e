// Dual coordinate descent for the L1-loss linear SVM (LibLinear's
// "LL-Dual"): every coordinate of every epoch in one launch of one CTA.
//
// Replaces no Pallas kernel: the reference runs the sweep as one jitted
// lax.scan (repro/baselines/dcd.py, DCDSVM.fit's ``step``). Launched a
// coordinate at a time from Python the port would pay about six launches
// a coordinate, for 7.5 M sequential coordinates at Table 5's protocol.
//
// The sweep is a chain of dependent steps: coordinate i's update needs w
// after coordinate i - 1's. So one CTA walks the chain; for each
// coordinate i = order[t]:
//   1. every thread forms its columns' share of x_i . w (columns tid,
//      tid + T, ...: coalesced row reads), a butterfly sum in each warp,
//      the warps' sums in shared memory; barrier;
//   2. warp 0 sums the warps' sums in warp order, and lane 0 forms
//      G = y_i (x_i . w) - 1, a_new = clip(a_i - G / max(q_ii, 1e-12),
//      0, C), stores alpha_i and the step d = (a_new - a_i) y_i in shared
//      memory; barrier;
//   3. every thread adds d x_ij to its own w_j.
// A thread reads and writes only its own w entries, so steps 3 and 1 of
// the next coordinate need no barrier between them. w sits in shared
// memory (W_GLOBAL = false) up to SMEM_W_FLOATS columns, else in the
// output buffer in global memory (W_GLOBAL = true), the same code.
//
// What bounds it on the H100: neither bytes nor flops but the chain's
// latency, two barriers and a dependent global read of x_i, alpha_i and
// q_ii a coordinate. Its bytes bound (each x row read once an epoch over
// 3.35 TB/s) is far below; prefetching the next row while the current
// one reduces is the next step.
//
// The clamps are max_nan / min_nan (epilogues.cuh): NaN passes as
// jnp.clip / jnp.maximum pass it. Every operation is a rounded intrinsic
// (no contraction into an FMA), in the reference's order, so a step
// differs from the plain version only by the dot product's summation
// order.
#include <stdint.h>

#include "common.cuh"
#include "epilogues.cuh"

namespace {

// 224 KiB of the 227 KiB a CTA may use; kernels/dcd.py holds the same.
constexpr int SMEM_W_FLOATS = 56 * 1024;
constexpr int MAX_WARPS = 32;

template <bool W_GLOBAL>
__global__ void __launch_bounds__(1024)
    dcd_sweep_kernel(const float* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ qdiag,
                     const int32_t* __restrict__ order, int64_t steps,
                     float C, int K, float* __restrict__ w_out,
                     float* __restrict__ alpha) {
  extern __shared__ float smem[];
  __shared__ float red[MAX_WARPS];
  __shared__ float step;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float* w = W_GLOBAL ? w_out : smem;
  for (int j = tid; j < K; j += blockDim.x) w[j] = 0.f;
  __syncthreads();
  for (int64_t t = 0; t < steps; ++t) {
    const int64_t i = order[t];
    const float* xi = X + i * (int64_t)K;
    float s = 0.f;
    for (int j = tid; j < K; j += blockDim.x) s = fmaf(xi[j], w[j], s);
    s = rt::warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (warp == 0) {
      float d = lane < nwarps ? red[lane] : 0.f;
      d = rt::warp_sum(d);
      if (lane == 0) {
        const float yi = y[i], ai = alpha[i];
        const float G = __fsub_rn(__fmul_rn(yi, d), 1.0f);
        const float q = rt::max_nan(qdiag[i], 1e-12f);
        const float a_new = rt::min_nan(
            rt::max_nan(__fsub_rn(ai, __fdiv_rn(G, q)), 0.0f), C);
        alpha[i] = a_new;
        step = __fmul_rn(__fsub_rn(a_new, ai), yi);
      }
    }
    __syncthreads();
    const float st = step;
    for (int j = tid; j < K; j += blockDim.x)
      w[j] = __fadd_rn(w[j], __fmul_rn(st, xi[j]));
  }
  if (!W_GLOBAL) {
    __syncthreads();
    for (int j = tid; j < K; j += blockDim.x) w_out[j] = w[j];
  }
}

}  // namespace

// X (N, K) f32 row-major; y, qdiag (N,) f32; order (steps,) int32 row
// indices; alpha (N,) f32, zeros on entry, the duals on return; w (K,) f32
// out. ``threads``: a multiple of 32 up to 1024. Returns the launch's CUDA
// error, 0 if none.
extern "C" int rt_dcd_sweep(int device, void* stream, const void* X,
                            const void* y, const void* qdiag,
                            const void* order, int64_t steps, float C, int K,
                            void* w, void* alpha, int threads) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* yf = static_cast<const float*>(y);
  const float* qf = static_cast<const float*>(qdiag);
  const int32_t* of = static_cast<const int32_t*>(order);
  float* wf = static_cast<float*>(w);
  float* af = static_cast<float*>(alpha);
  if (K <= SMEM_W_FLOATS) {
    const int smem = K * (int)sizeof(float);
    err = cudaFuncSetAttribute(dcd_sweep_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    dcd_sweep_kernel<false><<<1, threads, smem, st>>>(Xf, yf, qf, of, steps,
                                                      C, K, wf, af);
  } else {
    dcd_sweep_kernel<true><<<1, threads, 0, st>>>(Xf, yf, qf, of, steps, C,
                                                  K, wf, af);
  }
  return (int)cudaGetLastError();
}
