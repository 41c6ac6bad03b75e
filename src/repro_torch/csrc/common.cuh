// Device code shared by the Hopper kernels of repro_torch (sm_90a, fp32 on
// CUDA cores: no TF32, no fast-math, IEEE division).
//
// The Sigma statistic X^T diag(w) X is tiled across CTAs. A CTA owns one
// (BK x BK) tile of Sigma and one contiguous range of rows (a "split"); it
// keeps the tile in registers while it sweeps its rows and writes the tile
// as a per-split partial. The sweep is the pipelined Gram engine of
// gram_pipe.cuh (syrk.cu, weighted_gram.cu, and the statistic of
// fused_stats.cu and nystrom_phi.cu); this file holds what surrounds it:
// the row dot product of the row passes, the triangle's tile index, the
// tile store, and the finalize launches. ``tri_finalize`` sums the
// partials of every split in a fixed order and mirrors the upper triangle,
// so the result is deterministic: no floating-point atomics. C chains run
// as C interleaved copies of the grid, finalized per chain.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int BK = 128;            // Sigma tile edge
constexpr int BN = 32;             // rows staged in shared memory per step
constexpr int TILE_THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Butterfly sum: every lane ends with the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// w . x for R rows xrow, xrow + ld, ... (those below nr), read
// lane-strided (coalesced) by a whole warp, the rows' loads interleaved.
// Each row's summation order depends only on K, so a row's margin has the
// same bits in every kernel that forms it (the row pass of stats.cuh,
// fused_estep). Lane k returns row k % R's sum (R = 1: every lane).
template <int R, typename T>
__device__ __forceinline__ float row_dot(const T* __restrict__ xrow,
                                         int64_t ld, int nr,
                                         const float* __restrict__ w, int K,
                                         int lane) {
  float s[R];
#pragma unroll
  for (int k = 0; k < R; ++k) s[k] = 0.f;
  for (int c = lane; c < K; c += 32) {
    const float wc = __ldg(w + c);
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (k < nr) s[k] = fmaf(to_f32(xrow[k * ld + c]), wc, s[k]);
  }
  float mine = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float d = warp_sum(s[k]);
    if (lane % R == k) mine = d;
  }
  return mine;
}

// Flattened lower-triangle index t -> tile (i, j), i >= j.
__device__ __forceinline__ void tri_ij(int t, int& i, int& j) {
  int ii = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while (ii * (ii + 1) / 2 > t) --ii;
  while ((ii + 1) * (ii + 2) / 2 <= t) ++ii;
  i = ii;
  j = t - ii * (ii + 1) / 2;
}

// Write the (BK x BK) tile, row-major, to dst (16-byte aligned).
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           float acc[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int ai = (p < 4 ? 0 : 64) + ty * 4 + (p & 3);
    float* row = dst + (int64_t)ai * BK;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) =
        make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
  }
}

// dst += the (BK x BK) tile, row-major (store_tile's layout): a tile
// pass's running sum of its row blocks (gram_pipe.cuh's FLUSH_STAGES).
__device__ __forceinline__ void add_tile(float* __restrict__ dst,
                                         float acc[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int ai = (p < 4 ? 0 : 64) + ty * 4 + (p & 3);
    float4* lo = reinterpret_cast<float4*>(dst + (int64_t)ai * BK + tx * 4);
    float4* hi = reinterpret_cast<float4*>(dst + (int64_t)ai * BK + 64 +
                                           tx * 4);
    const float4 a = *lo, b = *hi;
    *lo = make_float4(a.x + acc[p][0], a.y + acc[p][1], a.z + acc[p][2],
                      a.w + acc[p][3]);
    *hi = make_float4(b.x + acc[p][4], b.y + acc[p][5], b.z + acc[p][6],
                      b.w + acc[p][7]);
  }
}

// out[c] (K x K) = sum over S splits of the tile partials
// part[S][T][C][BK][BK] of chain c, in split order: a thread an element of
// lower tile t = blockIdx.y of chain c = blockIdx.z, reading the S
// partials coalesced. An element of an off-diagonal tile is also written
// at its mirror, so out is exactly symmetric outside the diagonal tiles.
// With ``acc`` each sum starts from out's value at the element it writes
// instead of 0: splits finalized in several launches are summed in the one
// global split order.
static __global__ void tri_finalize(const float* __restrict__ part,
                                    float* __restrict__ out, int K, int T,
                                    int S, int C, int acc) {
  const int t = blockIdx.y, ch = blockIdx.z;
  const int off = blockIdx.x * blockDim.x + threadIdx.x;
  int bi, bj;
  tri_ij(t, bi, bj);
  const int r = bi * BK + off / BK, c = bj * BK + off % BK;
  if (r >= K || c >= K) return;
  const bool mirror = bi != bj;
  float* lo = out + (int64_t)ch * K * K + (int64_t)r * K + c;
  float* up = out + (int64_t)ch * K * K + (int64_t)c * K + r;
  float sum_lo = acc ? *lo : 0.f;
  float sum_up = acc && mirror ? *up : 0.f;
  const float* p = part + ((int64_t)t * C + ch) * BK * BK + off;
  const int64_t stride = (int64_t)T * C * BK * BK;
  for (int s = 0; s < S; ++s) {
    const float v = p[s * stride];
    sum_lo += v;
    sum_up += v;
  }
  *lo = sum_lo;
  if (mirror) *up = sum_up;
}

// The column window Sigma[:, start:start + blk] of a width-K statistic,
// tiled with the full statistic's own lower-triangle tiles (i >= j, BK
// each side): ``tab`` lists the window's ``ntw`` tiles as (i, j, bmode),
// those with i or j among the column blocks the window overlaps, and
// ``tmap`` (nb x nb, nb = tiles a side) gives the index in ``tab`` of tile
// (i, j), -1 where it is not computed. Every tile block q of b is summed
// by one CTA a split: bmode 1, its B side holds block j (a diagonal tile,
// or a tile left of the window); bmode 2, it reads block i from the rows
// (no tile of the window has i as its column block); 0, none.
struct WinArgs {
  const int* tab;
  const int* tmap;
  int ntw, nb, start, blk;
};

// out (K x blk) += or = the window's columns, each element summed over the
// S splits of part[S][ntw][BK][BK] in split order from the tile that holds
// it, or above the diagonal from the transposed lower tile: the sums
// tri_finalize forms for the same elements, so the window is bitwise the
// full statistic's column slice. ``acc`` as in tri_finalize.
static __global__ void win_finalize(const float* __restrict__ part,
                                    float* __restrict__ out, int K,
                                    WinArgs w, int S, int acc) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)K * w.blk) return;
  const int r = (int)(idx / w.blk), c = w.start + (int)(idx % w.blk);
  const int bi = r / BK, bj = c / BK;
  int t, off;
  if (bi >= bj) {
    t = w.tmap[bi * w.nb + bj];
    off = (r % BK) * BK + c % BK;
  } else {
    t = w.tmap[bj * w.nb + bi];
    off = (c % BK) * BK + r % BK;
  }
  float sum = acc ? out[idx] : 0.f;
  for (int s = 0; s < S; ++s)
    sum += part[((int64_t)s * w.ntw + t) * BK * BK + off];
  out[idx] = sum;
}

static inline void launch_win_finalize(const float* part, float* out, int K,
                                       const WinArgs& w, int S,
                                       cudaStream_t stream,
                                       bool acc = false) {
  const int64_t n = (int64_t)K * w.blk;
  win_finalize<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, out, K, w, S, (int)acc);
}

// out[ch][c] = sum over S rows of part[S][C][ld] for chain ch =
// blockIdx.y, in row order (c < K); ``acc`` as in tri_finalize.
static __global__ void sum_partials(const float* __restrict__ part,
                                    float* __restrict__ out, int K, int ld,
                                    int S, int C, int acc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= K) return;
  const int ch = blockIdx.y;
  float* o = out + (int64_t)ch * K + c;
  float sum = acc ? *o : 0.f;
  for (int s = 0; s < S; ++s)
    sum += part[((int64_t)s * C + ch) * ld + c];
  *o = sum;
}

static inline void launch_tri_finalize(const float* part, float* out, int K,
                                       int T, int S, cudaStream_t stream,
                                       int C = 1, bool acc = false) {
  const dim3 grid(BK * BK / 256, (unsigned)T, (unsigned)C);
  tri_finalize<<<grid, 256, 0, stream>>>(part, out, K, T, S, C, (int)acc);
}

static inline void launch_sum_partials(const float* part, float* out, int K,
                                       int ld, int S, cudaStream_t stream,
                                       int C = 1, bool acc = false) {
  const dim3 grid((unsigned)((K + 255) / 256), (unsigned)C);
  sum_partials<<<grid, 256, 0, stream>>>(part, out, K, ld, S, C, (int)acc);
}

}  // namespace rt
