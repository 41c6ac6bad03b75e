// The RBF tile body shared by rbf_gram.cu and every Nystrom kernel
// (nystrom_phi.cu), so the two paths cannot drift numerically: device port
// of repro/kernels/rbf_gram.py::rbf_tile.
//
//   K_ij = exp(-max(sq_i - 2 x_i.l_j + sq_j, 0) * inv_two_sigma_sq)
//
// with sq the squared row norms (row_sqnorm) and the inner products from a
// register-tiled fp32 product on the CUDA cores (no TF32). The elementwise
// transform rounds each operation (explicit __f*_rn, no FMA contraction)
// in the order of the Pallas tile, and calls the IEEE-mode expf (not the
// __expf intrinsic). The linear kind keeps the inner product itself.
//
// A CTA of 256 threads owns a 128 x 128 output tile, 8 x 8 outputs a
// thread (gemm_acc), and stages 32-deep slices of both operands in shared
// memory. Each inner product is one thread's sequential fmaf over D in
// ascending order, so its bits do not depend on the grid or on how the
// rows are chunked. The output is row-major (rbf_gram.cu) or, for the
// Nystrom kernels, landmark-major: the (m, R) transpose of a row chunk's
// cross-Gram, the A operand of the projection k(X, L) @ proj, which runs
// on the Gram engine (gram_pipe.cuh's CopyPair; nystrom_phi.cu).
#pragma once

#include "common.cuh"

namespace rt {
// Internal linkage: rbf_gram.cu and nystrom_phi.cu each instantiate these
// templates, and the kernel library links both objects.
namespace {

enum Kind : int { KIND_RBF = 0, KIND_LINEAR = 1 };

constexpr int GT = 128;      // output tile edge
constexpr int GK = 32;       // depth staged per step
constexpr int GLD = GT + 4;  // padded row: 4-way (not 32-way) bank
                             // conflicts on the transposing stores, and
                             // rows stay 16-byte aligned for float4 reads

// sq[r] = sum_d x[r, d]^2, a warp per row (fixed summation order).
template <typename T>
__global__ void row_sqnorm(const T* __restrict__ X, int64_t N, int D,
                           float* __restrict__ sq) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (row >= N) return;
  const T* xr = X + row * (int64_t)D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = to_f32(xr[c]);
    s = fmaf(v, v, s);
  }
  s = warp_sum(s);
  if (lane == 0) sq[row] = s;
}

template <typename T>
static inline void launch_row_sqnorm(const T* X, int64_t N, int D, float* sq,
                                     cudaStream_t stream) {
  row_sqnorm<T><<<(unsigned)((N + 7) / 8), 256, 0, stream>>>(X, N, D, sq);
}

// exp(-max(sq1 - 2 dot + sq2, 0) * inv_two_sigma_sq), rounded op by op.
__device__ __forceinline__ float rbf_value(float sq1, float sq2, float dot,
                                           float inv_two_sigma_sq) {
  const float d2 =
      fmaxf(__fadd_rn(__fsub_rn(sq1, __fmul_rn(2.0f, dot)), sq2), 0.0f);
  return expf(__fmul_rn(-d2, inv_two_sigma_sq));
}

// As[k][i] = A[(r0 + i) * lda + k0 + k] for rows r0 + i < nrows and
// k < kd, else 0: a row-major operand staged depth-major. A warp reads 32
// consecutive depth entries of one row (coalesced).
template <typename T>
__device__ __forceinline__ void stage_rows_t(const T* __restrict__ A,
                                             int64_t lda, int64_t r0,
                                             int64_t nrows, int k0, int kd,
                                             float (*As)[GLD]) {
  const int k = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < GT; i += TILE_THREADS / 32) {
    float v = 0.f;
    if (k < kd && r0 + i < nrows) v = to_f32(A[(r0 + i) * lda + k0 + k]);
    As[k][i] = v;
  }
}

// Output row / column of slot p (or q) of thread (tx, ty) in a tile.
__device__ __forceinline__ int tile_row(int p) {
  return (p < 4 ? 0 : 64) + (threadIdx.x / 16) * 4 + (p & 3);
}
__device__ __forceinline__ int tile_col(int q) {
  return (q < 4 ? 0 : 64) + (threadIdx.x % 16) * 4 + (q & 3);
}

// acc[p][q] += sum_{r < kd} As[r][tile_row(p)] * Bs[r][tile_col(q)].
__device__ __forceinline__ void gemm_acc(float acc[8][8], float (*As)[GLD],
                                         float (*Bs)[GLD], int kd) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int r = 0; r < kd; ++r) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[r][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[r][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[r][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
  }
}

// out[i * ldo + j] = k(A_i, B_j) for i < na, j < nb: the RBF (or linear)
// cross-Gram of two row-major (., D) operands; with LM (landmark-major)
// its transpose, out[j * ldo + i]. One CTA a 128 x 128 tile, B's tiles
// fastest so the CTAs that share rows of A run together. Under LM the
// tile is computed as (B rows) x (A rows), so that a thread's consecutive
// outputs are consecutive in memory and the stores stay coalesced:
// fmaf(b, a, acc) is fmaf(a, b, acc) exactly, and the transform keeps A's
// squared norm first, so every value has the bits of the row-major form.
template <typename TA, typename TB, int KIND, bool LM>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    cross_tiles(const TA* __restrict__ A, const TB* __restrict__ B,
                const float* __restrict__ sqa, const float* __restrict__ sqb,
                float* __restrict__ out, int64_t na, int nb, int D,
                int64_t ldo, float inv_two_sigma_sq) {
  __shared__ __align__(16) float As[GK][GLD];
  __shared__ __align__(16) float Bs[GK][GLD];
  const int ntc = (nb + GT - 1) / GT;
  const int64_t i0 = (int64_t)(blockIdx.x / ntc) * GT;
  const int j0 = (int)(blockIdx.x % ntc) * GT;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  for (int d0 = 0; d0 < D; d0 += GK) {
    const int kd = min(GK, D - d0);
    if constexpr (LM) {
      stage_rows_t(B, D, j0, nb, d0, kd, As);
      stage_rows_t(A, D, i0, na, d0, kd, Bs);
    } else {
      stage_rows_t(A, D, i0, na, d0, kd, As);
      stage_rows_t(B, D, j0, nb, d0, kd, Bs);
    }
    __syncthreads();
    gemm_acc(acc, As, Bs, kd);
    __syncthreads();
  }
  if constexpr (LM) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int j = j0 + tile_row(p);
      if (j >= nb) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int64_t i = i0 + tile_col(q);
        if (i >= na) continue;
        out[j * ldo + i] = KIND == KIND_RBF
                               ? rbf_value(sqa[i], sqb[j], acc[p][q],
                                           inv_two_sigma_sq)
                               : acc[p][q];
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int64_t i = i0 + tile_row(p);
      if (i >= na) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = j0 + tile_col(q);
        if (j >= nb) continue;
        out[i * ldo + j] = KIND == KIND_RBF
                               ? rbf_value(sqa[i], sqb[j], acc[p][q],
                                           inv_two_sigma_sq)
                               : acc[p][q];
      }
    }
  }
}

// The cross-Gram of A (na, D) and B (nb, D) into out, row-major (na, nb)
// with rows ldo apart, or with LM landmark-major (nb, na) with rows ldo
// apart.
template <bool LM, typename TA, typename TB>
static inline void launch_cross_tiles(const TA* A, const TB* B,
                                      const float* sqa, const float* sqb,
                                      float* out, int64_t na, int nb, int D,
                                      int64_t ldo, int kind,
                                      float inv_two_sigma_sq,
                                      cudaStream_t stream) {
  const int64_t nctas = ((na + GT - 1) / GT) * ((nb + GT - 1) / GT);
  if (kind == KIND_RBF)
    cross_tiles<TA, TB, KIND_RBF, LM><<<(unsigned)nctas, TILE_THREADS, 0,
                                        stream>>>(A, B, sqa, sqb, out, na,
                                                  nb, D, ldo,
                                                  inv_two_sigma_sq);
  else
    cross_tiles<TA, TB, KIND_LINEAR, LM><<<(unsigned)nctas, TILE_THREADS, 0,
                                           stream>>>(A, B, sqa, sqb, out, na,
                                                     nb, D, ldo,
                                                     inv_two_sigma_sq);
}

}  // namespace
}  // namespace rt
