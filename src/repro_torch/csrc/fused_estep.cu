// Fused E-step for the generic hinge: margin = Xw, gamma = max(eps,
// |rho - margin|), b = X^T (rho/gamma + beta), reading X once.
//
// Replaces the TPU kernel repro/kernels/fused_estep.py::fused_estep.
//
// What bounds it on the H100: bytes. 4 N K flop on 4 N K bytes of X (2 N K
// for bf16), so the floor is reading X once at 3.35 TB/s; the kernel has
// to keep enough bytes in flight to reach it, and must not read a row
// twice.
//
// The design: each warp owns a contiguous range of rows and takes them one
// at a time. Its 32 lanes load the whole row into registers, lane l holding
// the four-column groups l, l + 32, ... of it: where K % 4 == 0 and X is
// aligned each group is one 16-byte (bf16: 8-byte) load (VEC16), else four
// element loads, which together still cover each 512-byte span of the row
// once a warp (phase 8's K = 2,049; one column a lane, lane-strided, read
// the same bytes several times slower on the H100). The lanes form the margin
// from those values (each lane's fmaf chain over its columns in order,
// then the butterfly warp_sum) with w read from shared memory, run the
// em_hinge epilogue in registers, and add coef * x to the lane's b
// partials, also in registers, from the same values: X is read once and
// no barrier falls inside the row loop. A lane holds VALUES values of a
// row; a row wider than 32 VALUES columns goes in column segments of that
// width: the margins first, over every segment, then each segment's b
// from a second read of it (coef from the gamma just written).
//
// b's order, fixed: each warp sums its rows in row order; the CTA adds its
// warps' partials in warp order through shared memory and writes one
// partial a CTA; sum_partials adds those in CTA order. No atomics, so b is
// repeatable run to run.
#include "common.cuh"
#include "epilogues.cuh"

namespace rt {

constexpr int ESTEP_THREADS = 128;
constexpr int ESTEP_WARPS = ESTEP_THREADS / 32;
constexpr int ESTEP_VALUES = 68;              // values a lane holds
constexpr int ESTEP_GROUPS = ESTEP_VALUES / 4;
constexpr int ESTEP_SEG = 32 * ESTEP_VALUES;  // columns a segment: 2,176

// Four consecutive elements of X from p as fp32, 0 past the ``n`` valid
// ones: with VEC16 (n >= 4 or n <= 0) one 16-byte (8-byte) load, p
// aligned to it; else one load an element.
template <bool VEC16>
__device__ __forceinline__ void load4(float* v, const float* p, int n) {
  if constexpr (VEC16) {
    const float4 u = n > 0 ? __ldcs(reinterpret_cast<const float4*>(p))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < n ? __ldg(p + j) : 0.f;
  }
}
template <bool VEC16>
__device__ __forceinline__ void load4(float* v, const __nv_bfloat16* p,
                                      int n) {
  if constexpr (VEC16) {
    const uint2 u = n > 0 ? __ldcs(reinterpret_cast<const uint2*>(p))
                          : make_uint2(0u, 0u);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = j < n ? __uint_as_float((uint32_t)__ldg(h + j) << 16) : 0.f;
  }
}

// The lane's values x[4 g + j] = the segment's column 4 (32 g + lane) + j,
// 0 at or past ``width``; groups wholly past it are not read.
template <typename T, bool VEC16>
__device__ __forceinline__ void load_seg(float (&x)[ESTEP_VALUES],
                                         const T* row, int width, int lane) {
#pragma unroll
  for (int g = 0; g < ESTEP_GROUPS; ++g) {
    const int c = 4 * (32 * g + lane);
    load4<VEC16>(&x[4 * g], row + c, width - c);
  }
}

// s += x . w over the lane's columns below width, in order; w from shared
// memory (16-byte aligned) or, with GLOBAL, from device memory.
template <bool GLOBAL>
__device__ __forceinline__ float seg_dot(const float (&x)[ESTEP_VALUES],
                                         const float* ws, int width,
                                         int lane, float s) {
#pragma unroll
  for (int g = 0; g < ESTEP_GROUPS; ++g) {
    const int c = 4 * (32 * g + lane);
    if (c >= width) break;
    float w[4];
    if constexpr (GLOBAL) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = c + j < width ? __ldg(ws + c + j) : 0.f;
    } else {
      const float4 w4 = *reinterpret_cast<const float4*>(ws + c);
      w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < width) s = fmaf(x[4 * g + j], w[j], s);
  }
  return s;
}

// The CTA's b partial of a segment of ``width`` columns: the warps'
// register partials added in warp order in shared memory, then written to
// bpart.
__device__ __forceinline__ void seg_reduce(const float (&b)[ESTEP_VALUES],
                                           float* acc, float* bpart,
                                           int width, int lane, int warp) {
  for (int w = 0; w < ESTEP_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int v = 0; v < ESTEP_VALUES; ++v) {
        const int c = 4 * (32 * (v / 4) + lane) + v % 4;
        if (c < width) acc[c] = w == 0 ? b[v] : acc[c] + b[v];
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < width; c += ESTEP_THREADS) bpart[c] = acc[c];
  __syncthreads();
}

// Grid: CTAs of ESTEP_WARPS warps, warp w of CTA k taking rows
// [(4 k + w) rows_per_warp, ...).
template <typename T, bool VEC16>
__global__ void __launch_bounds__(ESTEP_THREADS, 3)
    estep_rows(const T* __restrict__ X, const float* __restrict__ rho,
               const float* __restrict__ beta, const float* __restrict__ wvec,
               float* __restrict__ margin, float* __restrict__ gamma,
               float* __restrict__ bpart, int64_t N, int K,
               int64_t rows_per_warp, float eps) {
  __shared__ __align__(16) float ws[ESTEP_SEG];   // w's segment
  __shared__ __align__(16) float acc[ESTEP_SEG];  // the CTA's b partial
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r_begin =
      ((int64_t)blockIdx.x * ESTEP_WARPS + warp) * rows_per_warp;
  const int64_t r_end = min64(N, r_begin + rows_per_warp);
  const int nseg = (K + ESTEP_SEG - 1) / ESTEP_SEG;
  float* bp = bpart + (int64_t)blockIdx.x * K;
  float x[ESTEP_VALUES], b[ESTEP_VALUES];

  if (nseg == 1) {  // the whole row in registers: X read once
    for (int c = threadIdx.x; c < K; c += ESTEP_THREADS) ws[c] = wvec[c];
    __syncthreads();
#pragma unroll
    for (int v = 0; v < ESTEP_VALUES; ++v) b[v] = 0.f;
    for (int64_t row = r_begin; row < r_end; ++row) {
      load_seg<T, VEC16>(x, X + row * (int64_t)K, K, lane);
      const float rh = __ldg(rho + row), bt = __ldg(beta + row);
      const float m = warp_sum(seg_dot<false>(x, ws, K, lane, 0.f));
      const float g = max_nan(fabsf(rh - m), eps);
      const float cf = rh / g + bt;
      if (lane == 0) {
        margin[row] = m;
        gamma[row] = g;
      }
#pragma unroll
      for (int v = 0; v < ESTEP_VALUES; ++v) b[v] = fmaf(cf, x[v], b[v]);
    }
    seg_reduce(b, acc, bp, K, lane, warp);
    return;
  }

  // Wider rows: the margins over every segment first ...
  for (int64_t row = r_begin; row < r_end; ++row) {
    float s = 0.f;
    for (int sg = 0; sg < nseg; ++sg) {
      const int c0 = sg * ESTEP_SEG, width = min(ESTEP_SEG, K - c0);
      load_seg<T, VEC16>(x, X + row * (int64_t)K + c0, width, lane);
      s = seg_dot<true>(x, wvec + c0, width, lane, s);
    }
    const float m = warp_sum(s);
    const float rh = __ldg(rho + row);
    const float g = max_nan(fabsf(rh - m), eps);
    if (lane == 0) {
      margin[row] = m;
      gamma[row] = g;
    }
  }
  __syncwarp();
  // ... then each segment's b, the rows read again, coef from gamma.
  for (int sg = 0; sg < nseg; ++sg) {
    const int c0 = sg * ESTEP_SEG, width = min(ESTEP_SEG, K - c0);
#pragma unroll
    for (int v = 0; v < ESTEP_VALUES; ++v) b[v] = 0.f;
    for (int64_t row = r_begin; row < r_end; ++row) {
      const float cf = rho[row] / gamma[row] + beta[row];
      load_seg<T, VEC16>(x, X + row * (int64_t)K + c0, width, lane);
#pragma unroll
      for (int v = 0; v < ESTEP_VALUES; ++v) b[v] = fmaf(cf, x[v], b[v]);
    }
    seg_reduce(b, acc, bp + c0, width, lane, warp);
  }
}

template <typename T, bool VEC16>
static cudaError_t launch(const void* X, const float* rho, const float* beta,
                          const float* w, float* margin, float* gamma,
                          float* bpart, float* b, int64_t N, int K, int nctas,
                          int64_t rows_per_warp, float eps,
                          cudaStream_t stream) {
  estep_rows<T, VEC16><<<nctas, ESTEP_THREADS, 0, stream>>>(
      static_cast<const T*>(X), rho, beta, w, margin, gamma, bpart, N, K,
      rows_per_warp, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launch_sum_partials(bpart, b, K, K, nctas, stream);
  return cudaGetLastError();
}

}  // namespace rt

// X (N, K) row-major f32 or bf16 (x_bf16); vec16 1: K % 4 == 0 and X 16-
// byte (bf16: 8-byte) aligned, a group of four columns one load; rho, beta
// (N,) f32; w (K,) f32. Outputs margin, gamma (N,), b (K,) f32; bpart:
// nctas * K f32 scratch; nctas CTAs of 4 warps, rows_per_warp consecutive
// rows a warp.
extern "C" int rt_fused_estep(int device, void* stream, const void* X,
                              int x_bf16, int vec16, const void* rho,
                              const void* beta, const void* w, void* margin,
                              void* gamma, void* bpart, void* b, int64_t N,
                              int K, int nctas, int64_t rows_per_warp,
                              float eps) {
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
  using Launch = cudaError_t (*)(const void*, const float*, const float*,
                                 const float*, float*, float*, float*, float*,
                                 int64_t, int, int, int64_t, float,
                                 cudaStream_t);
  const Launch fn = x_bf16 ? (vec16 ? rt::launch<__nv_bfloat16, true>
                                    : rt::launch<__nv_bfloat16, false>)
                           : (vec16 ? rt::launch<float, true>
                                    : rt::launch<float, false>);
  return (int)fn(X, rf, bf, wf, mf, gf, pf, of, N, K, nctas, rows_per_warp,
                 eps, st);
}

// Static shared memory bytes and resident CTAs an SM of estep_rows for X
// of f32 (x_bf16 = 0) or bf16, on 16-byte (vec16 = 1) or element loads.
extern "C" int rt_fused_estep_occupancy(int device, int x_bf16, int vec16,
                                        int* smem, int* ctas) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  const void* fn =
      x_bf16 ? (vec16 ? (const void*)rt::estep_rows<__nv_bfloat16, true>
                      : (const void*)rt::estep_rows<__nv_bfloat16, false>)
             : (vec16 ? (const void*)rt::estep_rows<float, true>
                      : (const void*)rt::estep_rows<float, false>);
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *smem = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, fn, rt::ESTEP_THREADS, 0);
}
