// Triangle-tiled weighted SYRK: Sigma = X^T diag(w) X.
//
// Replaces the TPU kernel repro/kernels/syrk.py::syrk_tri. Grid = (S row
// splits) x (T lower-triangle tiles), tile index fastest, so the T CTAs
// that read the same rows are launched together and share them in L2.
// Each CTA keeps its 128 x 128 tile in registers over its rows and writes
// a per-split partial; a second launch sums the partials in split order
// and mirrors the upper triangle (common.cuh). See kernels/syrk.py for the
// design note.
#include "common.cuh"

namespace rt {

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    syrk_tiles(const T* __restrict__ X, const float* __restrict__ w,
               float* __restrict__ part, int64_t N, int K, int ntiles,
               int64_t rows_per_split) {
  __shared__ __align__(16) float As[BN][BK];
  __shared__ __align__(16) float Bs[BN][BK];
  const int t = (int)(blockIdx.x % ntiles);
  const int64_t s = blockIdx.x / ntiles;
  int bi, bj;
  tri_ij(t, bi, bj);
  const int64_t r_begin = s * rows_per_split;
  const int64_t r_end = min64(N, r_begin + rows_per_split);
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  for (int64_t row0 = r_begin; row0 < r_end; row0 += BN) {
    stage_rows(X, row0, r_end, K, bi * BK, bj * BK, w + row0, As, Bs);
    __syncthreads();
    accumulate(acc, As, Bs);
    __syncthreads();
  }
  store_tile(part + ((int64_t)s * ntiles + t) * BK * BK, acc);
}

template <typename T>
static void launch(const void* X, const float* w, float* part, float* out,
                   int64_t N, int K, int ntiles, int nsplits,
                   int64_t rows_per_split, cudaStream_t stream) {
  syrk_tiles<T><<<(unsigned)((int64_t)nsplits * ntiles), TILE_THREADS, 0,
                  stream>>>(static_cast<const T*>(X), w, part, N, K, ntiles,
                            rows_per_split);
  launch_tri_finalize(part, out, K, ntiles, nsplits, stream);
}

}  // namespace rt

// X (N, K) row-major f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w (N,) f32;
// part: nsplits * ntiles * 128 * 128 f32 scratch; out (K, K) f32.
// Returns cudaGetLastError() after the launches.
extern "C" int rt_syrk_tri(int device, void* stream, const void* X,
                           int x_bf16, const void* w, void* part, void* out,
                           int64_t N, int K, int ntiles, int nsplits,
                           int64_t rows_per_split) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  if (x_bf16)
    rt::launch<__nv_bfloat16>(X, wf, pf, of, N, K, ntiles, nsplits,
                              rows_per_split, st);
  else
    rt::launch<float>(X, wf, pf, of, N, K, ntiles, nsplits, rows_per_split,
                      st);
  return (int)cudaGetLastError();
}
