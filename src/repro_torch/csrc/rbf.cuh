// The RBF cross-Gram shared by rbf_gram.cu and every Nystrom kernel
// (nystrom_phi.cu), so the two paths cannot drift numerically: device port
// of repro/kernels/rbf_gram.py::rbf_tile.
//
//   K_ij = exp(-max(sq_i - 2 x_i.l_j + sq_j, 0) * inv_two_sigma_sq)
//
// with sq the squared row norms (row_sqnorm) and the inner products from an
// fp32 product on the CUDA cores (no TF32). The elementwise transform rounds
// each operation (explicit __f*_rn, no FMA contraction) in the order of the
// Pallas tile, and calls the IEEE-mode expf (not the __expf intrinsic). The
// linear kind keeps the inner product itself.
//
// What bounds it on the H100: at depth D >= ~32 the 2 n1 n2 D flop of the
// inner products (fp32 FMAs); at small D (the rings' D = 2) the bytes of
// the output it writes, 4 n1 n2, and the expf of each entry.
//
// The operands, rows of X and of the landmarks, are row-major (., D): the
// depth runs along a row. A transposing pass (cross_operand) first writes
// each of them depth-major, (D, n) fp32 with rows ld apart (ld a multiple
// of 4, the base 16-byte aligned), converting bf16 exactly on the way, so
// that the product sees only fp32 and its copies go 16 bytes at a time.
// Then one CTA of 256 threads owns a 128 x 128 output tile, 8 x 8 outputs a
// thread, by one of two routes (the wrapper picks by D,
// kernels/rbf_gram.py::cross_route):
// - cross_tiles: the Gram engine's pipelined tile pass (gram_pipe.cuh's
//   tile_pass with CopyPair: a three-slot cp.async ring of 32-deep stages,
//   one barrier a stage, the next stage's fragments read while the FMAs
//   run); the depth is zero-filled up to a whole stage;
// - cross_direct (small D): no ring; each thread reads its fragments
//   straight from the depth-major operands (L1), D steps.
// Both hand the accumulator to CrossEpilogue: the transform in registers,
// then one store of each entry, four consecutive entries as one 16-byte
// store where the leading dimension and the column allow it.
//
// Each inner product is one thread's fmaf chain over d ascending from +0,
// never split, so its bits do not depend on the grid, the route or how the
// rows are chunked; the engine's zero-filled depth past D adds fmaf(0, 0,
// acc), which turns an accumulator of -0 into +0 (the linear kind's output;
// the RBF transform maps both to the same value). The output is row-major
// (rbf_gram.cu) or, for the Nystrom kernels, landmark-major: the (m, R)
// transpose of a row chunk's cross-Gram, the A operand of the projection
// k(X, L) @ proj (nystrom_phi.cu). Landmark-major computes the tile as
// (landmarks x rows), so that a thread's consecutive outputs are
// consecutive in memory: fmaf(l, x, acc) is fmaf(x, l, acc) exactly, and
// the transform keeps X's squared norm first, so every value has the bits
// of the row-major form.
#pragma once

#include "gram_pipe.cuh"

namespace rt {
// Internal linkage: rbf_gram.cu and nystrom_phi.cu each instantiate these
// templates, and the kernel library links both objects.
namespace {

enum Kind : int { KIND_RBF = 0, KIND_LINEAR = 1 };
// How the cross-Gram multiplies (kernels/rbf_gram.py's CROSS_ROUTES).
enum CrossRoute : int { CROSS_ENGINE = 0, CROSS_DIRECT = 1 };

constexpr int GT = 128;  // output tile edge

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

// Output row / column of slot p (or q) of thread (tx, ty) in a tile (the
// engine's accumulator layout, common.cuh's store_tile).
__device__ __forceinline__ int tile_row(int p) {
  return (p < 4 ? 0 : 64) + (threadIdx.x / 16) * 4 + (p & 3);
}
__device__ __forceinline__ int tile_col(int q) {
  return (q < 4 ? 0 : 64) + (threadIdx.x % 16) * 4 + (q & 3);
}

// out[d * ld + r] = X[r * D + d] in fp32, for r < n and d < D: a row-major
// operand written depth-major. 32 x 32 blocks through shared memory, read
// along the rows and written along the depth (both coalesced).
template <typename T>
__global__ void cross_operand(const T* __restrict__ X, int64_t n, int D,
                              float* __restrict__ out, int64_t ld) {
  __shared__ float blk[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * 32;
  const int d0 = (int)blockIdx.y * 32;
  for (int i = ty; i < 32; i += 8) {
    const int64_t r = r0 + i;
    const int d = d0 + tx;
    blk[i][tx] = (r < n && d < D) ? to_f32(X[r * D + d]) : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int d = d0 + i;
    const int64_t r = r0 + tx;
    if (d < D && r < n) out[(int64_t)d * ld + r] = blk[tx][i];
  }
}

template <typename T>
static inline void launch_cross_operand(const T* X, int64_t n, int D,
                                        float* out, int64_t ld,
                                        cudaStream_t stream) {
  const dim3 grid((unsigned)((n + 31) / 32), (unsigned)((D + 31) / 32));
  cross_operand<T><<<grid, 256, 0, stream>>>(X, n, D, out, ld);
}

// One cross-Gram launch: A (D, wa) and B (D, wb) depth-major fp32, rows
// lda / ldb apart (multiples of 4, 16-byte aligned); out[i * ldo + j] =
// k(A_i, B_j) for i < wa, j < wb. sqa, sqb: the squared norms of A's and
// B's rows (rbf only). With LM, A holds the landmarks and B the rows of X,
// and the transform takes B's norm first.
struct CrossArgs {
  const float* A;
  const float* B;
  const float* sqa;
  const float* sqb;
  float* out;
  int64_t lda, ldb, ldo;
  int wa, wb, D;
  int vec;  // out 16-byte aligned and ldo % 4 == 0: 16-byte stores
  float inv_two_sigma_sq;
};

// The transform of tile (i0, j0) and its stores.
template <int KIND, bool LM>
struct CrossEpilogue {
  const CrossArgs& a;
  int i0, j0;

  __device__ __forceinline__ void operator()(float (&acc)[8][8]) const {
    const int tx = threadIdx.x % 16;
    float sb[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + tile_col(q);
      sb[q] = (KIND == KIND_RBF && j < a.wb) ? a.sqb[j] : 0.f;
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int i = i0 + tile_row(p);
      if (i >= a.wa) continue;
      const float sa = KIND == KIND_RBF ? a.sqa[i] : 0.f;
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = KIND == KIND_LINEAR ? acc[p][q]
               : LM ? rbf_value(sb[q], sa, acc[p][q], a.inv_two_sigma_sq)
                    : rbf_value(sa, sb[q], acc[p][q], a.inv_two_sigma_sq);
      float* row = a.out + (int64_t)i * a.ldo;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + h * 64 + tx * 4;
        if (a.vec && j + 3 < a.wb) {
          *reinterpret_cast<float4*>(row + j) =
              make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j + e < a.wb) row[j + e] = v[4 * h + e];
        }
      }
    }
  }
};

// The tile of CTA blockIdx.x: B's tiles fastest (row-major), or A's
// (landmark-major), so that the CTAs that share a block of X's rows run
// together.
template <bool LM>
__device__ __forceinline__ void cross_tile_of(const CrossArgs& a, int& i0,
                                              int& j0) {
  if (LM) {
    const int nta = (a.wa + GT - 1) / GT;
    i0 = (int)(blockIdx.x % nta) * GT;
    j0 = (int)(blockIdx.x / nta) * GT;
  } else {
    const int ntb = (a.wb + GT - 1) / GT;
    i0 = (int)(blockIdx.x / ntb) * GT;
    j0 = (int)(blockIdx.x % ntb) * GT;
  }
}

// The engine route: the tile pass over the depth (rows of A and B).
template <int KIND, bool LM>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    cross_tiles(const CrossArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int i0, j0;
  cross_tile_of<LM>(a, i0, j0);
  gp::CopyPair cp(a.A, a.lda, a.wa, a.B, a.ldb, a.wb, smem);
  const gp::Tile t{a.D, a.D, a.wa, i0, j0, false};
  gp::tile_pass(cp, t, 0, CrossEpilogue<KIND, LM>{a, i0, j0});
}

// The direct route: D steps of 8 x 8 fmaf, each thread's fragments read
// from the depth-major operands (a four-column group lies wholly inside
// the operand's ld where it starts below the width; past it, 0).
template <int KIND, bool LM>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    cross_direct(const CrossArgs a) {
  int i0, j0;
  cross_tile_of<LM>(a, i0, j0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ca[2] = {i0 + ty * 4, i0 + 64 + ty * 4};
  const int cb[2] = {j0 + tx * 4, j0 + 64 + tx * 4};
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int d = 0; d < a.D; ++d) {
    const float* ar = a.A + (int64_t)d * a.lda;
    const float* br = a.B + (int64_t)d * a.ldb;
    float x[8], y[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 u = ca[h] < a.wa
          ? __ldg(reinterpret_cast<const float4*>(ar + ca[h])) : zero;
      const float4 v = cb[h] < a.wb
          ? __ldg(reinterpret_cast<const float4*>(br + cb[h])) : zero;
      x[4 * h] = u.x; x[4 * h + 1] = u.y; x[4 * h + 2] = u.z;
      x[4 * h + 3] = u.w;
      y[4 * h] = v.x; y[4 * h + 1] = v.y; y[4 * h + 2] = v.z;
      y[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(x[p], y[q], acc[p][q]);
  }
  CrossEpilogue<KIND, LM>{a, i0, j0}(acc);
}

template <int KIND, bool LM>
static inline cudaError_t launch_cross_kind(const CrossArgs& a, int route,
                                            cudaStream_t stream) {
  const unsigned nctas = (unsigned)(((int64_t)(a.wa + GT - 1) / GT) *
                                    ((a.wb + GT - 1) / GT));
  if (route == CROSS_DIRECT) {
    cross_direct<KIND, LM><<<nctas, TILE_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      cross_tiles<KIND, LM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gp::CopyPair::SMEM);
  if (err != cudaSuccess) return err;
  cross_tiles<KIND, LM>
      <<<nctas, TILE_THREADS, gp::CopyPair::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// The cross-Gram of the depth-major operands in ``a`` on ``route``:
// row-major, or with LM landmark-major.
template <bool LM>
static inline cudaError_t launch_cross(const CrossArgs& a, int kind,
                                       int route, cudaStream_t stream) {
  return kind == KIND_RBF ? launch_cross_kind<KIND_RBF, LM>(a, route, stream)
                          : launch_cross_kind<KIND_LINEAR, LM>(a, route,
                                                               stream);
}

// Dynamic shared memory bytes and resident CTAs an SM of the cross-Gram
// kernel of (route, kind, LM).
template <int KIND, bool LM>
static inline cudaError_t cross_occupancy_kind(int route, int* smem,
                                               int* ctas) {
  if (route == CROSS_DIRECT) {
    *smem = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, cross_direct<KIND, LM>, TILE_THREADS, 0);
  }
  return gp::occupancy_of<gp::CopyPair>(cross_tiles<KIND, LM>, smem, ctas);
}

}  // namespace
}  // namespace rt
