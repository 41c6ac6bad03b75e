// RBF Gram matrix K (N1, N2) = exp(-max(|x1|^2 - 2 x1.x2 + |x2|^2, 0) /
// 2 sigma^2).
//
// Replaces the TPU kernel repro/kernels/rbf_gram.py::rbf_gram. Launches:
// the squared norms of both operands (a warp per row), both operands
// written depth-major (cross_operand), then the 128 x 128 cross tiles of
// rbf.cuh (the Gram engine's tile pass, or at small D the direct route)
// with the RBF transform applied in registers before the single store of
// each entry. See kernels/rbf_gram.py for the design note.
#include "rbf.cuh"

namespace rt {

template <typename TA, typename TB>
static cudaError_t launch_rbf_gram(const void* X1, const void* X2,
                                   float* sq1, float* sq2, float* t1,
                                   float* t2, float* out, int N1, int N2,
                                   int D, float inv_two_sigma_sq, int route,
                                   cudaStream_t stream) {
  const TA* a = static_cast<const TA*>(X1);
  const TB* b = static_cast<const TB*>(X2);
  launch_row_sqnorm(a, (int64_t)N1, D, sq1, stream);
  launch_row_sqnorm(b, (int64_t)N2, D, sq2, stream);
  CrossArgs c;
  c.lda = (N1 + 3) / 4 * 4;
  c.ldb = (N2 + 3) / 4 * 4;
  launch_cross_operand(a, (int64_t)N1, D, t1, c.lda, stream);
  launch_cross_operand(b, (int64_t)N2, D, t2, c.ldb, stream);
  c.A = t1;
  c.B = t2;
  c.sqa = sq1;
  c.sqb = sq2;
  c.out = out;
  c.ldo = N2;
  c.wa = N1;
  c.wb = N2;
  c.D = D;
  c.vec = N2 % 4 == 0;
  c.inv_two_sigma_sq = inv_two_sigma_sq;
  return launch_cross_kind<KIND_RBF, false>(c, route, stream);
}

}  // namespace rt

// X1 (N1, D), X2 (N2, D) row-major; dtypes: 0 = f32, 1 = bf16, and the
// pairs (f32, f32), (bf16, f32), (bf16, bf16) are built. sq1 (N1,), sq2
// (N2,) f32 scratch; t1 (D, N1 rounded up to 4) and t2 (D, N2 rounded up
// to 4) f32 scratch, 16-byte aligned; out (N1, N2) f32, 16-byte aligned.
// route: rbf.cuh's CrossRoute. Returns -1 for another dtype pair, else
// the first CUDA error of the launches.
extern "C" int rt_rbf_gram(int device, void* stream, const void* X1,
                           int x1_bf16, const void* X2, int x2_bf16,
                           void* sq1, void* sq2, void* t1, void* t2,
                           void* out, int N1, int N2, int D,
                           float inv_two_sigma_sq, int route) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s1 = static_cast<float*>(sq1);
  float* s2 = static_cast<float*>(sq2);
  float* a = static_cast<float*>(t1);
  float* b = static_cast<float*>(t2);
  float* o = static_cast<float*>(out);
  if (!x1_bf16 && !x2_bf16)
    err = rt::launch_rbf_gram<float, float>(X1, X2, s1, s2, a, b, o, N1, N2,
                                            D, inv_two_sigma_sq, route, st);
  else if (x1_bf16 && !x2_bf16)
    err = rt::launch_rbf_gram<__nv_bfloat16, float>(
        X1, X2, s1, s2, a, b, o, N1, N2, D, inv_two_sigma_sq, route, st);
  else if (x1_bf16 && x2_bf16)
    err = rt::launch_rbf_gram<__nv_bfloat16, __nv_bfloat16>(
        X1, X2, s1, s2, a, b, o, N1, N2, D, inv_two_sigma_sq, route, st);
  else
    return -1;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory bytes and resident CTAs an SM of rbf_gram's
// cross-Gram kernel on ``route``.
extern "C" int rt_rbf_gram_occupancy(int device, int route, int* smem,
                                     int* ctas) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)rt::cross_occupancy_kind<rt::KIND_RBF, false>(route, smem,
                                                            ctas);
}
