// The whole EM iteration statistic in one pass over X (em_hinge):
// margin = Xw; gamma = max(eps, |rho - margin|); weight = wmask / gamma;
// b = X^T (rho/gamma + beta); Sigma = X^T diag(weight) X.
//
// Replaces the TPU kernel repro/kernels/fused_stats.py::fused_stats
// (em_hinge, full width). Sigma is tiled across CTAs exactly as in syrk.cu
// (same tile code, common.cuh). Every CTA recomputes the margin, gamma and
// weight of each row it stages (a warp per row, same summation order in
// every CTA, so all CTAs agree bitwise); the T CTAs of one row split are
// launched together so the repeated row reads hit L2. The tile-0 CTAs
// write margin and gamma; the diagonal-tile CTAs of column block i
// accumulate b[i-block] from the unweighted staged columns. See
// kernels/fused_stats.py for the design note.
#include "common.cuh"

namespace rt {

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    fused_tiles(const T* __restrict__ X, const float* __restrict__ rho,
                const float* __restrict__ beta,
                const float* __restrict__ wmask,  // may be null: all ones
                const float* __restrict__ wvec, float* __restrict__ margin,
                float* __restrict__ gamma, float* __restrict__ part,
                float* __restrict__ bpart, int64_t N, int K, int Kp,
                int ntiles, int64_t rows_per_split, float eps) {
  __shared__ __align__(16) float As[BN][BK];
  __shared__ __align__(16) float Bs[BN][BK];
  __shared__ float sw[BN];
  __shared__ float scoef[BN];
  constexpr int ROWS_PER_WARP = BN / (TILE_THREADS / 32);
  const int t = (int)(blockIdx.x % ntiles);
  const int64_t s = blockIdx.x / ntiles;
  int bi, bj;
  tri_ij(t, bi, bj);
  const bool diag = bi == bj;
  const bool writer = t == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r_begin = s * rows_per_split;
  const int64_t r_end = min64(N, r_begin + rows_per_split);
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  float bacc = 0.f;
  for (int64_t row0 = r_begin; row0 < r_end; row0 += BN) {
    // margin and the em_hinge epilogue of the BN rows about to be staged
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      const int r = warp * ROWS_PER_WARP + k;
      const int64_t row = row0 + r;
      float wgt = 0.f, cf = 0.f;
      if (row < r_end) {  // warp-uniform
        const float m = row_dot(X + row * (int64_t)K, wvec, K, lane);
        const float rh = rho[row];
        const float g = fmaxf(fabsf(rh - m), eps);
        const float inv = 1.0f / g;
        wgt = wmask ? wmask[row] * inv : inv;
        cf = rh / g + beta[row];
        if (writer && lane == 0) {
          margin[row] = m;
          gamma[row] = g;
        }
      }
      if (lane == 0) {
        sw[r] = wgt;
        scoef[r] = cf;
      }
    }
    __syncthreads();
    stage_rows(X, row0, r_end, K, bi * BK, bj * BK, sw, As, Bs);
    __syncthreads();
    if (diag && threadIdx.x < BK) {
#pragma unroll 8
      for (int r = 0; r < BN; ++r) bacc = fmaf(scoef[r], Bs[r][threadIdx.x], bacc);
    }
    accumulate(acc, As, Bs);
    __syncthreads();
  }
  store_tile(part + ((int64_t)s * ntiles + t) * BK * BK, acc);
  if (diag && threadIdx.x < BK)
    bpart[s * Kp + (int64_t)bi * BK + threadIdx.x] = bacc;
}

template <typename T>
static void launch(const void* X, const float* rho, const float* beta,
                   const float* wmask, const float* w, float* margin,
                   float* gamma, float* part, float* bpart, float* sigma,
                   float* b, int64_t N, int K, int Kp, int ntiles,
                   int nsplits, int64_t rows_per_split, float eps,
                   cudaStream_t stream) {
  fused_tiles<T><<<(unsigned)((int64_t)nsplits * ntiles), TILE_THREADS, 0,
                   stream>>>(static_cast<const T*>(X), rho, beta, wmask, w,
                             margin, gamma, part, bpart, N, K, Kp, ntiles,
                             rows_per_split, eps);
  launch_tri_finalize(part, sigma, K, ntiles, nsplits, stream);
  launch_sum_partials(bpart, b, K, Kp, nsplits, stream);
}

}  // namespace rt

// X (N, K) row-major f32 or bf16 (x_bf16); rho, beta, wmask (N,) f32 (wmask
// null = ones); w (K,) f32. Outputs margin, gamma (N,), sigma (K, K), b (K,)
// f32. Scratch: part nsplits * ntiles * 128 * 128 f32, bpart nsplits * Kp
// f32 with Kp = 128 * (tiles per side).
extern "C" int rt_fused_stats(int device, void* stream, const void* X,
                              int x_bf16, const void* rho, const void* beta,
                              const void* wmask, const void* w, void* margin,
                              void* gamma, void* part, void* bpart,
                              void* sigma, void* b, int64_t N, int K, int Kp,
                              int ntiles, int nsplits,
                              int64_t rows_per_split, float eps) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rho);
  const float* bf = static_cast<const float*>(beta);
  const float* mk = static_cast<const float*>(wmask);
  const float* wf = static_cast<const float*>(w);
  float* mf = static_cast<float*>(margin);
  float* gf = static_cast<float*>(gamma);
  float* pf = static_cast<float*>(part);
  float* bp = static_cast<float*>(bpart);
  float* sf = static_cast<float*>(sigma);
  float* of = static_cast<float*>(b);
  if (x_bf16)
    rt::launch<__nv_bfloat16>(X, rf, bf, mk, wf, mf, gf, pf, bp, sf, of, N, K,
                              Kp, ntiles, nsplits, rows_per_split, eps, st);
  else
    rt::launch<float>(X, rf, bf, mk, wf, mf, gf, pf, bp, sf, of, N, K, Kp,
                      ntiles, nsplits, rows_per_split, eps, st);
  return (int)cudaGetLastError();
}
