// Dense weighted Gram: Sigma = X^T diag(w) X over the full tile grid.
//
// Replaces the TPU kernel repro/kernels/weighted_gram.py::weighted_gram,
// the dense baseline of the paper's Table 9 statistic: its pallas_call
// walks all (K/bk)^2 output blocks, the N sweep innermost. Unlike
// syrk_tri it computes every tile, upper triangle included, and mirrors
// nothing, so it does twice the triangle's work by design (the Table 9
// comparison is dense against triangle). Grid = (S row splits of
// ROWS_PER_SPLIT rows) x (nb^2 tiles), tile index fastest, so the CTAs that
// read the same rows run together and share them in L2. Each CTA keeps its
// 128 x 128 tile in registers over its rows (common.cuh) and writes a
// per-split partial; dense_finalize sums the partials in split order, so
// the result is bitwise repeatable (no atomics). Tile (i, j) and tile
// (j, i) round differently, as the TPU kernel's blocks do: the result is
// not required to be bitwise symmetric. See kernels/weighted_gram.py.
#include "common.cuh"

namespace rt {
namespace {

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    gram_tiles(const T* __restrict__ X, const float* __restrict__ w,
               float* __restrict__ part, int64_t N, int K, int nb,
               int64_t rows_per_split) {
  __shared__ __align__(16) float As[BN][BK];
  __shared__ __align__(16) float Bs[BN][BK];
  const int ntiles = nb * nb;
  const int t = (int)(blockIdx.x % ntiles);
  const int64_t s = blockIdx.x / ntiles;
  const int bi = t / nb, bj = t % nb;
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

// out (K x K) = sum over S splits of the tile partials part[S][nb^2][BK][BK]
// in split order.
__global__ void dense_finalize(const float* __restrict__ part,
                               float* __restrict__ out, int K, int nb,
                               int S) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)K * K) return;
  const int r = (int)(idx / K), c = (int)(idx % K);
  const int64_t t = (int64_t)(r / BK) * nb + c / BK;
  const int64_t off = (r % BK) * BK + c % BK;
  const int64_t stride = (int64_t)nb * nb * BK * BK;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += part[s * stride + t * BK * BK + off];
  out[idx] = sum;
}

template <typename T>
void launch(const void* X, const float* w, float* part, float* out,
            int64_t N, int K, int nsplits, int64_t rows_per_split,
            cudaStream_t stream) {
  const int nb = (K + BK - 1) / BK;
  gram_tiles<T><<<(unsigned)((int64_t)nsplits * nb * nb), TILE_THREADS, 0,
                  stream>>>(static_cast<const T*>(X), w, part, N, K, nb,
                            rows_per_split);
  const int64_t n = (int64_t)K * K;
  dense_finalize<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, out, K, nb, nsplits);
}

}  // namespace
}  // namespace rt

// X (N, K) row-major f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w (N,) f32;
// part: nsplits * ceil(K / 128)^2 * 128 * 128 f32 scratch; out (K, K) f32;
// nsplits = ceil(N / rows_per_split). Returns cudaGetLastError() after the
// launches.
extern "C" int rt_weighted_gram(int device, void* stream, const void* X,
                                int x_bf16, const void* w, void* part,
                                void* out, int64_t N, int K, int nsplits,
                                int64_t rows_per_split) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  if (x_bf16)
    rt::launch<__nv_bfloat16>(X, wf, pf, of, N, K, nsplits, rows_per_split,
                              st);
  else
    rt::launch<float>(X, wf, pf, of, N, K, nsplits, rows_per_split, st);
  return (int)cudaGetLastError();
}
