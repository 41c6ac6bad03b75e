// The whole iteration statistic in one pass over X, for C chains:
// margin = X w_c; the epilogue's (gamma[, omega], weight, coef);
// b_c = X^T coef; Sigma_c = X^T diag(wmask * weight) X, or with a column
// window (start, blk) its block Sigma[:, start:start + blk].
//
// Replaces the TPU kernel repro/kernels/fused_stats.py::fused_stats for all
// four epilogues: em_hinge and em_svr; mc_hinge and mc_svr with their noise
// either read from (N,) operands (two, or four for SVR's double mixture)
// or derived in-body from the counter seed [k0, k1, row0, chain0]
// (rng.cuh); a (K, C) wvec with the seed runs C chains (multichain).
// Sigma is tiled across CTAs exactly as in syrk.cu (same tile code,
// common.cuh): the grid is (row split) x (lower-triangle tile) x (chain),
// chain fastest, so the C CTAs of one (split, tile) run together and their
// X reads hit L2. Every CTA recomputes the margin and the epilogue of each
// row it stages for its chain (a warp per row, same summation order in
// every CTA, so all CTAs agree bitwise); the tile-0 CTAs write margin,
// gamma and omega; the diagonal-tile CTAs of column block i accumulate
// b[i-block]. The window variant (single chain) runs only the lower tiles
// the window needs, from a table (WinArgs, common.cuh), over the full
// statistic's split plan, and win_finalize picks the window's columns: the
// result is bitwise the full variant's column slice. See
// kernels/fused_stats.py for the design note.
#include "common.cuh"
#include "epilogues.cuh"

namespace rt {

struct StatsArgs {
  const float* rho;      // the target y under SVR
  const float* beta;
  const float* wmask;    // may be null: all ones
  const float* wt;       // (C, K): chain c's weights at wt + c * K
  const float* nu;       // noise variants: (N,) normals (gamma's mixture)
  const float* u;        // noise variants: (N,) uniforms
  const int64_t* seed;   // seed variants: [k0, k1, row0, chain0] as words
  float* margin;         // (N, C)
  float* gamma;          // (N, C)
  float* part;           // (S, T, C) tiles of BK x BK
  float* bpart;          // (S, C, Kp)
  int64_t N;
  int K, Kp, ntiles, C;
  int64_t rows_per_split;
  float eps;
};

// SVR's second mixture and tube, a kernel argument of their own: only the
// SVR instantiations read them. Kept out of StatsArgs, because there they
// change the hinge instantiations' register allocation and slow them.
struct SvrArgs {
  const float* nu_o;     // mc_svr noise: (N,) normals (omega's mixture)
  const float* u_o;      // mc_svr noise: (N,) uniforms
  float* omega;          // (N, C)
  float eps_ins;
};

// b's block q of one tile CTA under a window (WinArgs, bmode 2): the
// staged rows' coef times the unweighted X[row, q * BK + threadIdx.x],
// rows past row_end and columns past K read as zero, in the order and
// with the values a diagonal tile sums from its B side, so b is bitwise
// the full statistic's.
template <typename T>
__device__ __forceinline__ float b_from_rows(const T* __restrict__ X,
                                             int64_t row0, int64_t row_end,
                                             int K, int q,
                                             const float* scoef, float bacc) {
  const int col = q * BK + threadIdx.x;
  for (int r = 0; r < BN; ++r) {
    const int64_t row = row0 + r;
    const float x = (row < row_end && col < K)
                        ? to_f32(X[row * (int64_t)K + col]) : 0.f;
    bacc = fmaf(scoef[r], x, bacc);
  }
  return bacc;
}

// One tile CTA's pass over its split, the tile (bi, bj) of Sigma: per
// BN-row step, the rows' margins (all lanes of a warp), then lane k runs
// the epilogue of the warp's k-th row, so the rows' epilogues overlap; the
// rows are staged and accumulated into the tile. ``writer`` CTAs store
// margin, gamma (and omega). b's block sits on the diagonal tiles at full
// width (bmode 1 with bj the block); under a window (WIN), bmode says
// where (WinArgs). Returns b's partial (0 without bmode).
template <typename T, int EPI, bool WIN>
__device__ __forceinline__ float tile_pass(const T* __restrict__ X,
                                           const StatsArgs a,
                                           const SvrArgs v, int c,
                                           int64_t s, int bi, int bj,
                                           int bmode, bool writer,
                                           float (*As)[BK], float (*Bs)[BK],
                                           float* sw, float* scoef,
                                           float acc[8][8]) {
  constexpr int ROWS_PER_WARP = BN / (TILE_THREADS / 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r_begin = s * a.rows_per_split;
  const int64_t r_end = min64(a.N, r_begin + a.rows_per_split);
  const float* __restrict__ w = a.wt + (int64_t)c * a.K;
  Noise nz = {{a.nu, a.u, v.nu_o, v.u_o}, 0u, 0u, 0u};
  uint32_t row0 = 0;
  if (is_seed(EPI)) {
    nz.k0 = (uint32_t)a.seed[0];
    nz.k1 = (uint32_t)a.seed[1];
    row0 = (uint32_t)a.seed[2];
    nz.chain = (uint32_t)a.seed[3] + (uint32_t)c;
  }
  float bacc = 0.f;
  for (int64_t rb = r_begin; rb < r_end; rb += BN) {
    float mk = 0.f;
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      const int64_t row = rb + warp * ROWS_PER_WARP + k;
      if (row < r_end) {  // warp-uniform
        const float m = row_dot(X + row * (int64_t)a.K, w, a.K, lane);
        if (lane == k) mk = m;
      }
    }
    if (lane < ROWS_PER_WARP) {
      const int r = warp * ROWS_PER_WARP + lane;
      const int64_t row = rb + r;
      float wgt = 0.f, cf = 0.f;
      if (row < r_end) {
        const float rh = a.rho[row];
        float g, o, weight;
        row_epilogue<EPI>(rh, mk, nz, row, row0 + (uint32_t)row, a.eps,
                          v.eps_ins, g, o, weight, cf);
        wgt = a.wmask ? __fmul_rn(a.wmask[row], weight) : weight;
        if (!is_svr(EPI)) cf = __fadd_rn(cf, a.beta[row]);
        if (writer) {
          a.margin[row * a.C + c] = mk;
          a.gamma[row * a.C + c] = g;
          if (is_svr(EPI)) v.omega[row * a.C + c] = o;
        }
      }
      sw[r] = wgt;
      scoef[r] = cf;
    }
    __syncthreads();
    stage_rows(X, rb, r_end, a.K, bi * BK, bj * BK, sw, As, Bs);
    __syncthreads();
    if (bmode == 1 && threadIdx.x < BK) {
#pragma unroll 8
      for (int r = 0; r < BN; ++r)
        bacc = fmaf(scoef[r], Bs[r][threadIdx.x], bacc);
    } else if (WIN && bmode == 2 && threadIdx.x < BK) {
      bacc = b_from_rows(X, rb, r_end, a.K, bi, scoef, bacc);
    }
    accumulate(acc, As, Bs);
    __syncthreads();
  }
  return bacc;
}

template <typename T, int EPI>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    fused_tiles(const T* __restrict__ X, StatsArgs a, SvrArgs v) {
  __shared__ __align__(16) float As[BN][BK];
  __shared__ __align__(16) float Bs[BN][BK];
  __shared__ float sw[BN];
  __shared__ float scoef[BN];
  const int c = (int)(blockIdx.x % a.C);
  const int t = (int)((blockIdx.x / a.C) % a.ntiles);
  const int64_t s = blockIdx.x / ((int64_t)a.C * a.ntiles);
  int bi, bj;
  tri_ij(t, bi, bj);
  const bool diag = bi == bj;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  const float bacc = tile_pass<T, EPI, false>(X, a, v, c, s, bi, bj,
                                              diag ? 1 : 0,
                                              t == 0, As, Bs, sw, scoef,
                                              acc);
  store_tile(a.part + ((s * a.ntiles + t) * a.C + c) * BK * BK, acc);
  if (diag && threadIdx.x < BK)
    a.bpart[(s * a.C + c) * a.Kp + (int64_t)bi * BK + threadIdx.x] = bacc;
}

// The window variant: CTA (split, window tile) of one chain, the tile and
// b's block from the window table; a.ntiles counts the window's tiles.
template <typename T, int EPI>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    fused_window_tiles(const T* __restrict__ X, StatsArgs a, SvrArgs v,
                       WinArgs win) {
  __shared__ __align__(16) float As[BN][BK];
  __shared__ __align__(16) float Bs[BN][BK];
  __shared__ float sw[BN];
  __shared__ float scoef[BN];
  const int t = (int)(blockIdx.x % a.ntiles);
  const int64_t s = blockIdx.x / a.ntiles;
  const int bi = win.tab[3 * t], bj = win.tab[3 * t + 1];
  const int bmode = win.tab[3 * t + 2];
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  const float bacc = tile_pass<T, EPI, true>(X, a, v, 0, s, bi, bj, bmode,
                                             t == 0, As, Bs, sw, scoef, acc);
  store_tile(a.part + (s * a.ntiles + t) * BK * BK, acc);
  if (bmode != 0 && threadIdx.x < BK)
    a.bpart[s * a.Kp + (int64_t)(bmode == 1 ? bj : bi) * BK + threadIdx.x] =
        bacc;
}

template <typename T, int EPI>
static void launch_epi(const void* X, const StatsArgs& a, const SvrArgs& v,
                       const WinArgs* win, float* sigma, float* b,
                       int nsplits, cudaStream_t stream) {
  const int64_t nctas = (int64_t)nsplits * a.ntiles * a.C;
  if (win == nullptr) {
    fused_tiles<T, EPI><<<(unsigned)nctas, TILE_THREADS, 0, stream>>>(
        static_cast<const T*>(X), a, v);
    launch_tri_finalize(a.part, sigma, a.K, a.ntiles, nsplits, stream, a.C);
  } else {
    fused_window_tiles<T, EPI><<<(unsigned)nctas, TILE_THREADS, 0, stream>>>(
        static_cast<const T*>(X), a, v, *win);
    launch_win_finalize(a.part, sigma, a.K, *win, nsplits, stream);
  }
  launch_sum_partials(a.bpart, b, a.K, a.Kp, nsplits, stream, a.C);
}

template <typename T>
static int launch(const void* X, const StatsArgs& a, const SvrArgs& v,
                  const WinArgs* win, float* sigma, float* b, int nsplits,
                  int epilogue, cudaStream_t stream) {
  switch (epilogue) {
    case EM_HINGE:
      launch_epi<T, EM_HINGE>(X, a, v, win, sigma, b, nsplits, stream);
      return 0;
    case MC_NOISE:
      launch_epi<T, MC_NOISE>(X, a, v, win, sigma, b, nsplits, stream);
      return 0;
    case MC_SEED:
      launch_epi<T, MC_SEED>(X, a, v, win, sigma, b, nsplits, stream);
      return 0;
    case EM_SVR:
      launch_epi<T, EM_SVR>(X, a, v, win, sigma, b, nsplits, stream);
      return 0;
    case MC_SVR_NOISE:
      launch_epi<T, MC_SVR_NOISE>(X, a, v, win, sigma, b, nsplits, stream);
      return 0;
    case MC_SVR_SEED:
      launch_epi<T, MC_SVR_SEED>(X, a, v, win, sigma, b, nsplits, stream);
      return 0;
  }
  return -1;
}

}  // namespace rt

// X (N, K) row-major f32 or bf16 (x_bf16); rho, beta, wmask (N,) f32 (wmask
// null = ones; beta is read by the hinge only); wt (C, K) f32, chain-major.
// epilogue 0 = em_hinge, 1 = mc_hinge reading nu, u (N,) f32 (C = 1),
// 2 = mc_hinge deriving them from seed, four int64 words on the device;
// 3 = em_svr, 4 = mc_svr reading nu, u, nu_o, u_o (N,) f32 (C = 1),
// 5 = mc_svr from the seed; eps_ins is the SVR tube. Outputs margin, gamma
// (N, C), omega (N, C) for SVR (else unused, may be null), sigma (C, K, K),
// b (C, K) f32. Scratch: part nsplits * ntiles * C * 128 * 128 f32, bpart
// nsplits * C * Kp f32 with Kp = 128 * (tiles per side).
// With win_tab non-null (C = 1): the column window (win_start, win_blk),
// sigma (K, win_blk); win_tab (ntiles, 3) and win_tmap (nb, nb) int32 on
// the device as WinArgs describes, ntiles the window's tile count, and
// nsplits / rows_per_split the full statistic's plan. Returns -1 for an
// unknown epilogue, else cudaGetLastError().
extern "C" int rt_fused_stats(int device, void* stream, const void* X,
                              int x_bf16, const void* rho, const void* beta,
                              const void* wmask, const void* wt,
                              const void* nu, const void* u,
                              const void* nu_o, const void* u_o,
                              const void* seed, void* margin, void* gamma,
                              void* omega, void* part, void* bpart,
                              void* sigma, void* b, int64_t N, int K, int Kp,
                              int ntiles, int nsplits, int64_t rows_per_split,
                              int C, int epilogue, float eps, float eps_ins,
                              const void* win_tab, const void* win_tmap,
                              int win_nb, int win_start, int win_blk) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rt::StatsArgs a;
  a.rho = static_cast<const float*>(rho);
  a.beta = static_cast<const float*>(beta);
  a.wmask = static_cast<const float*>(wmask);
  a.wt = static_cast<const float*>(wt);
  a.nu = static_cast<const float*>(nu);
  a.u = static_cast<const float*>(u);
  a.seed = static_cast<const int64_t*>(seed);
  a.margin = static_cast<float*>(margin);
  a.gamma = static_cast<float*>(gamma);
  a.part = static_cast<float*>(part);
  a.bpart = static_cast<float*>(bpart);
  a.N = N;
  a.K = K;
  a.Kp = Kp;
  a.ntiles = ntiles;
  a.C = C;
  a.rows_per_split = rows_per_split;
  a.eps = eps;
  rt::SvrArgs v;
  v.nu_o = static_cast<const float*>(nu_o);
  v.u_o = static_cast<const float*>(u_o);
  v.omega = static_cast<float*>(omega);
  v.eps_ins = eps_ins;
  rt::WinArgs w;
  w.tab = static_cast<const int*>(win_tab);
  w.tmap = static_cast<const int*>(win_tmap);
  w.ntw = ntiles;
  w.nb = win_nb;
  w.start = win_start;
  w.blk = win_blk;
  const rt::WinArgs* win = win_tab ? &w : nullptr;
  if (win && C != 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(sigma);
  float* of = static_cast<float*>(b);
  const int bad = x_bf16 ? rt::launch<__nv_bfloat16>(X, a, v, win, sf, of,
                                                     nsplits, epilogue, st)
                         : rt::launch<float>(X, a, v, win, sf, of, nsplits,
                                             epilogue, st);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
