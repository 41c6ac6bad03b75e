// Triangle-tiled weighted SYRK: Sigma = X^T diag(w) X.
//
// Replaces the TPU kernel repro/kernels/syrk.py::syrk_tri. Grid = (S row
// splits) x (T lower-triangle tiles), tile index fastest, so the T CTAs
// that read the same rows are launched together and share them in L2.
// Each CTA runs the pipelined tile pass of gram_pipe.cuh (rows through a
// cp.async ring, its 128 x 128 tile in registers) and writes a per-split
// partial; a second launch (common.cuh's tri_finalize, which fused_stats
// and nystrom_fused_stats share) sums the partials in split order and
// mirrors the upper triangle. See gram_pipe.cuh for what bounds it and
// kernels/syrk.py for the plan.
#include "gram_pipe.cuh"

// X (N, K) row-major f32 or bf16, copied on ``path`` (gram_pipe.cuh's
// Path: 0 f32 by 4 bytes, 1 f32 by 16 bytes, 2 bf16); w (N,) f32; part:
// nsplits * ntiles * 128 * 128 f32 scratch; out (K, K) f32. Returns the
// first CUDA error of the launches, 0 if none.
extern "C" int rt_syrk_tri(int device, void* stream, const void* X,
                           int path, const void* w, void* part, void* out,
                           int64_t N, int K, int ntiles, int nsplits,
                           int64_t rows_per_split) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  err = rt::gp::launch_tiles<true>(X, path, static_cast<const float*>(w),
                                   pf, N, K, ntiles, nsplits,
                                   rows_per_split, st);
  if (err != cudaSuccess) return (int)err;
  rt::launch_tri_finalize(pf, static_cast<float*>(out), K, ntiles, nsplits,
                          st);
  return (int)cudaGetLastError();
}

// Dynamic shared memory bytes and resident CTAs an SM of the tile kernel
// on copy path ``path``.
extern "C" int rt_syrk_occupancy(int device, int path, int* smem,
                                 int* ctas) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)rt::gp::occupancy<true>(path, smem, ctas);
}
