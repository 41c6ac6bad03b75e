// Fused E-step for the generic hinge: margin = Xw, gamma = max(eps,
// |rho - margin|), b = X^T (rho/gamma + beta), in one pass over X.
//
// Replaces the TPU kernel repro/kernels/fused_estep.py::fused_estep. One
// CTA per contiguous row range, one warp per row for the margin; the CTA
// then adds coef * X-row to a (K,) accumulator in shared memory (each
// thread owns the columns c = tid mod 256, so no atomics) and writes it as
// a per-CTA partial. A second launch sums the partials in CTA order. See
// kernels/fused_estep.py for the design note.
#include "common.cuh"

namespace rt {

constexpr int ESTEP_THREADS = 256;
constexpr int ESTEP_ROWS = ESTEP_THREADS / 32;  // rows per step: one a warp

template <typename T>
__global__ void __launch_bounds__(ESTEP_THREADS)
    estep_rows(const T* __restrict__ X, const float* __restrict__ rho,
               const float* __restrict__ beta, const float* __restrict__ wvec,
               float* __restrict__ margin, float* __restrict__ gamma,
               float* __restrict__ bpart, int64_t N, int K,
               int64_t rows_per_cta, float eps) {
  extern __shared__ float bacc[];  // (K,)
  __shared__ float scoef[ESTEP_ROWS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r_begin = (int64_t)blockIdx.x * rows_per_cta;
  const int64_t r_end = min64(N, r_begin + rows_per_cta);
  for (int c = threadIdx.x; c < K; c += ESTEP_THREADS) bacc[c] = 0.f;
  for (int64_t row0 = r_begin; row0 < r_end; row0 += ESTEP_ROWS) {
    const int64_t row = row0 + warp;
    float cf = 0.f;
    if (row < r_end) {  // warp-uniform
      const float m = row_dot<1>(X + row * (int64_t)K, K, 1, wvec, K, lane);
      const float g = fmaxf(fabsf(rho[row] - m), eps);
      cf = rho[row] / g + beta[row];
      if (lane == 0) {
        margin[row] = m;
        gamma[row] = g;
      }
    }
    if (lane == 0) scoef[warp] = cf;
    __syncthreads();
    const int nr = (int)min64(ESTEP_ROWS, r_end - row0);
    for (int c = threadIdx.x; c < K; c += ESTEP_THREADS) {
      float a = bacc[c];
      for (int r = 0; r < nr; ++r)
        a = fmaf(scoef[r], to_f32(X[(row0 + r) * (int64_t)K + c]), a);
      bacc[c] = a;
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < K; c += ESTEP_THREADS)
    bpart[(int64_t)blockIdx.x * K + c] = bacc[c];
}

template <typename T>
static cudaError_t launch(const void* X, const float* rho, const float* beta,
                          const float* w, float* margin, float* gamma,
                          float* bpart, float* b, int64_t N, int K, int nctas,
                          int64_t rows_per_cta, float eps,
                          cudaStream_t stream) {
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        estep_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  estep_rows<T><<<nctas, ESTEP_THREADS, smem, stream>>>(
      static_cast<const T*>(X), rho, beta, w, margin, gamma, bpart, N, K,
      rows_per_cta, eps);
  launch_sum_partials(bpart, b, K, K, nctas, stream);
  return cudaSuccess;
}

}  // namespace rt

// X (N, K) row-major f32 or bf16 (x_bf16); rho, beta (N,) f32; w (K,) f32.
// Outputs margin, gamma (N,), b (K,) f32; bpart: nctas * K f32 scratch.
extern "C" int rt_fused_estep(int device, void* stream, const void* X,
                              int x_bf16, const void* rho, const void* beta,
                              const void* w, void* margin, void* gamma,
                              void* bpart, void* b, int64_t N, int K,
                              int nctas, int64_t rows_per_cta, float eps) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rho);
  const float* bf = static_cast<const float*>(beta);
  const float* wf = static_cast<const float*>(w);
  float* mf = static_cast<float*>(margin);
  float* gf = static_cast<float*>(gamma);
  float* pf = static_cast<float*>(bpart);
  float* of = static_cast<float*>(b);
  err = x_bf16 ? rt::launch<__nv_bfloat16>(X, rf, bf, wf, mf, gf, pf, of, N,
                                           K, nctas, rows_per_cta, eps, st)
               : rt::launch<float>(X, rf, bf, wf, mf, gf, pf, of, N, K,
                                   nctas, rows_per_cta, eps, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
