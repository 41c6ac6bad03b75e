// Dense weighted Gram: Sigma = X^T diag(w) X over the full tile grid.
//
// Replaces the TPU kernel repro/kernels/weighted_gram.py::weighted_gram,
// the dense baseline of the paper's Table 9 statistic: its pallas_call
// walks all (K/bk)^2 output blocks, the N sweep innermost. Unlike
// syrk_tri it computes every tile, upper triangle included, and mirrors
// nothing, so it does twice the triangle's work by design (the Table 9
// comparison is dense against triangle). Grid = (S row splits of
// ROWS_PER_SPLIT rows) x (nb^2 tiles), tile index fastest, so the CTAs that
// read the same rows run together and share them in L2. Each CTA runs the
// pipelined tile pass of gram_pipe.cuh (the engine syrk_tri runs, on the
// dense grid) and writes a per-split partial; dense_finalize sums the
// partials in split order, so the result is bitwise repeatable (no
// atomics). Tile (i, j) and tile (j, i) round differently, as the TPU
// kernel's blocks do: the result is not required to be bitwise symmetric.
// See gram_pipe.cuh for what bounds it and kernels/weighted_gram.py.
#include "gram_pipe.cuh"

namespace rt {
namespace {

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

}  // namespace
}  // namespace rt

// X (N, K) row-major f32 or bf16, copied on ``path`` as in rt_syrk_tri;
// w (N,) f32; part: nsplits * ceil(K / 128)^2 * 128 * 128 f32 scratch;
// out (K, K) f32; nsplits = ceil(N / rows_per_split). Returns the first
// CUDA error of the launches, 0 if none.
extern "C" int rt_weighted_gram(int device, void* stream, const void* X,
                                int path, const void* w, void* part,
                                void* out, int64_t N, int K, int nsplits,
                                int64_t rows_per_split) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  const int nb = (K + rt::BK - 1) / rt::BK;
  err = rt::gp::launch_tiles<false>(X, path, static_cast<const float*>(w),
                                    pf, N, K, nb * nb, nsplits,
                                    rows_per_split, st);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)K * K;
  rt::dense_finalize<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      pf, static_cast<float*>(out), K, nb, nsplits);
  return (int)cudaGetLastError();
}

// Dynamic shared memory bytes and resident CTAs an SM of the tile kernel
// on copy path ``path``.
extern "C" int rt_weighted_gram_occupancy(int device, int path, int* smem,
                                          int* ctas) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)rt::gp::occupancy<false>(path, smem, ctas);
}
