// RBF Gram matrix K (N1, N2) = exp(-max(|x1|^2 - 2 x1.x2 + |x2|^2, 0) /
// 2 sigma^2).
//
// Replaces the TPU kernel repro/kernels/rbf_gram.py::rbf_gram. Two
// launches: the squared norms of both operands (a warp per row), then
// the 128 x 128 cross tiles of rbf.cuh with the RBF transform applied in
// registers before the single store of each entry. See
// kernels/rbf_gram.py for the design note.
#include "rbf.cuh"

namespace rt {

template <typename TA, typename TB>
static void launch_rbf_gram(const void* X1, const void* X2, float* sq1,
                            float* sq2, float* out, int64_t N1, int N2, int D,
                            float inv_two_sigma_sq, cudaStream_t stream) {
  const TA* a = static_cast<const TA*>(X1);
  const TB* b = static_cast<const TB*>(X2);
  launch_row_sqnorm(a, N1, D, sq1, stream);
  launch_row_sqnorm(b, (int64_t)N2, D, sq2, stream);
  launch_cross_tiles<false>(a, b, sq1, sq2, out, N1, N2, D, (int64_t)N2,
                            KIND_RBF, inv_two_sigma_sq, stream);
}

}  // namespace rt

// X1 (N1, D), X2 (N2, D) row-major; dtypes: 0 = f32, 1 = bf16, and the
// pairs (f32, f32), (bf16, f32), (bf16, bf16) are built. sq1 (N1,), sq2
// (N2,) f32 scratch; out (N1, N2) f32. Returns -1 for another dtype pair,
// else cudaGetLastError().
extern "C" int rt_rbf_gram(int device, void* stream, const void* X1,
                           int x1_bf16, const void* X2, int x2_bf16,
                           void* sq1, void* sq2, void* out, int64_t N1,
                           int N2, int D, float inv_two_sigma_sq) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s1 = static_cast<float*>(sq1);
  float* s2 = static_cast<float*>(sq2);
  float* o = static_cast<float*>(out);
  if (!x1_bf16 && !x2_bf16)
    rt::launch_rbf_gram<float, float>(X1, X2, s1, s2, o, N1, N2, D,
                                      inv_two_sigma_sq, st);
  else if (x1_bf16 && !x2_bf16)
    rt::launch_rbf_gram<__nv_bfloat16, float>(X1, X2, s1, s2, o, N1, N2, D,
                                              inv_two_sigma_sq, st);
  else if (x1_bf16 && x2_bf16)
    rt::launch_rbf_gram<__nv_bfloat16, __nv_bfloat16>(
        X1, X2, s1, s2, o, N1, N2, D, inv_two_sigma_sq, st);
  else
    return -1;
  return (int)cudaGetLastError();
}
