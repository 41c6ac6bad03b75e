// The whole iteration statistic over X, for C chains: margin = X w_c; the
// epilogue's (gamma[, omega], weight, coef); b_c = X^T coef;
// Sigma_c = X^T diag(wmask * weight) X, or with a column window (start,
// blk) its block Sigma[:, start:start + blk].
//
// Replaces the TPU kernel repro/kernels/fused_stats.py::fused_stats for all
// four epilogues: em_hinge and em_svr; mc_hinge and mc_svr with their noise
// either read from (N,) operands (two, or four for SVR's double mixture)
// or derived in-body from the counter seed [k0, k1, row0, chain0]
// (rng.cuh); a (K, C) wvec with the seed runs C chains (multichain).
//
// Two passes over X (stats.cuh), then the finalize:
//   1. stat_rows, the row pass: a warp 4 rows, margin = row_dot,
//      the epilogue on lanes 0-3; it writes margin, gamma (omega) and the
//      (C, N) Sigma weights and b coefficients. X is read once a chain.
//   2. the Gram engine (gram_pipe.cuh's stat_tiles) on X with those
//      weights: grid (row split) x (lower-triangle tile) x (chain), chain
//      fastest, so the C CTAs of one (split, tile) read X's rows from L2;
//      b's block q is summed on the diagonal tile (q, q) from its unscaled
//      B side. The window variant (single chain) runs only the lower tiles
//      the window needs, from a table (WinArgs, common.cuh), over the full
//      statistic's split plan.
//   3. tri_finalize (or win_finalize) and sum_partials add the partials in
//      split order: deterministic, and a window is bitwise the full
//      variant's column slice.
// The row pass computes each row's margin and epilogue once; the tile
// grid only multiplies. This file also holds the passes that nystrom_phi.cu
// runs on its phi chunks. See kernels/fused_stats.py for the design note.
#include "epilogues.cuh"
#include "stats.cuh"

namespace rt {
namespace {

// Four rows a warp: enough warps for a Nystrom chunk to fill the card,
// and four epilogues (lanes 0-3) at a time.
constexpr int ROWS_A_WARP = 4;
constexpr int ROWS_A_CTA = ROWS_A_WARP * TILE_THREADS / 32;

// Grid = (row groups of ROWS_A_CTA) x (C chains), chain fastest. A warp
// forms its rows' margins together (row_dot), then lane k
// runs row k's epilogue.
template <typename T, int EPI>
__global__ void __launch_bounds__(TILE_THREADS) stat_rows(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const int c = (int)(blockIdx.x % a.C);
  const int64_t row0 = (int64_t)(blockIdx.x / a.C) * ROWS_A_CTA +
                       (threadIdx.x >> 5) * ROWS_A_WARP;
  if (row0 >= a.nrows) return;  // warp-uniform
  const int nr = (int)min64(ROWS_A_WARP, a.nrows - row0);
  const float m = row_dot<ROWS_A_WARP>(
      static_cast<const T*>(a.X) + row0 * a.ld, a.ld, nr,
      a.w + (int64_t)c * a.K, a.K, lane);
  if (lane >= nr) return;
  const int64_t row = row0 + lane;
  Noise nz = {{a.noise[0], a.noise[1], a.noise[2], a.noise[3]}, 0u, 0u, 0u};
  uint32_t crow = 0;
  if (is_seed(EPI)) {
    nz.k0 = (uint32_t)a.seed[0];
    nz.k1 = (uint32_t)a.seed[1];
    nz.chain = (uint32_t)a.seed[3] + (uint32_t)c;
    crow = (uint32_t)a.seed[2] + (uint32_t)(a.row_base + row);
  }
  float g, o, weight, cf;
  row_epilogue<EPI>(a.rho[row], m, nz, row, crow, a.eps, a.eps_ins, g, o,
                    weight, cf);
  const int64_t v = (int64_t)c * a.nrows + row, at = row * a.C + c;
  a.wgt[v] = a.mask ? __fmul_rn(a.mask[row], weight) : weight;
  a.coef[v] = is_svr(EPI) ? cf : __fadd_rn(cf, a.beta[row]);
  a.margin[at] = m;
  a.gamma[at] = g;
  if (is_svr(EPI)) a.omega[at] = o;
}

template <typename T>
int launch_rows(const RowArgs& a, int epilogue, cudaStream_t st) {
  const unsigned grid =
      (unsigned)((a.nrows + ROWS_A_CTA - 1) / ROWS_A_CTA * a.C);
  switch (epilogue) {
    case EM_HINGE:
      stat_rows<T, EM_HINGE><<<grid, TILE_THREADS, 0, st>>>(a);
      break;
    case MC_NOISE:
      stat_rows<T, MC_NOISE><<<grid, TILE_THREADS, 0, st>>>(a);
      break;
    case MC_SEED:
      stat_rows<T, MC_SEED><<<grid, TILE_THREADS, 0, st>>>(a);
      break;
    case EM_SVR:
      stat_rows<T, EM_SVR><<<grid, TILE_THREADS, 0, st>>>(a);
      break;
    case MC_SVR_NOISE:
      stat_rows<T, MC_SVR_NOISE><<<grid, TILE_THREADS, 0, st>>>(a);
      break;
    case MC_SVR_SEED:
      stat_rows<T, MC_SVR_SEED><<<grid, TILE_THREADS, 0, st>>>(a);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

int launch_stat_rows(const RowArgs& a, bool bf16, int epilogue,
                     cudaStream_t stream) {
  return bf16 ? launch_rows<__nv_bfloat16>(a, epilogue, stream)
              : launch_rows<float>(a, epilogue, stream);
}

cudaError_t launch_stat_tiles(const void* X, int path,
                              const gp::StatArgs& a, bool win,
                              cudaStream_t stream) {
  return win ? gp::launch_stats<true>(X, path, a, stream)
             : gp::launch_stats<false>(X, path, a, stream);
}

}  // namespace rt

// X (N, K) row-major f32 or bf16, copied on ``path`` (gram_pipe.cuh's
// Path: 0 f32 by 4 bytes, 1 f32 by 16 bytes, 2 bf16); rho, beta, wmask (N,)
// f32 (wmask null = ones; beta is read by the hinge only); wt (C, K) f32,
// chain-major. epilogue 0 = em_hinge, 1 = mc_hinge reading nu, u (N,) f32
// (C = 1), 2 = mc_hinge deriving them from seed, four int64 words on the
// device; 3 = em_svr, 4 = mc_svr reading nu, u, nu_o, u_o (N,) f32 (C = 1),
// 5 = mc_svr from the seed; eps_ins is the SVR tube. Outputs margin, gamma
// (N, C), omega (N, C) for SVR (else unused, may be null), sigma (C, K, K),
// b (C, K) f32. Scratch: wgt and coef C * N f32, part nsplits * ntiles *
// C * 128 * 128 f32, bpart nsplits * C * Kp f32 with Kp = 128 * (tiles per
// side). With win_tab non-null (C = 1): the column window (win_start,
// win_blk), sigma (K, win_blk); win_tab (ntiles, 3) and win_tmap (nb, nb)
// int32 on the device as WinArgs describes, ntiles the window's tile count,
// and nsplits / rows_per_split the full statistic's plan. Returns -1 for an
// unknown epilogue or a multichain window, else the first CUDA error.
extern "C" int rt_fused_stats(int device, void* stream, const void* X,
                              int path, const void* rho, const void* beta,
                              const void* wmask, const void* wt,
                              const void* nu, const void* u,
                              const void* nu_o, const void* u_o,
                              const void* seed, void* margin, void* gamma,
                              void* omega, void* wgt, void* coef, void* part,
                              void* bpart, void* sigma, void* b, int64_t N,
                              int K, int Kp, int ntiles, int nsplits,
                              int64_t rows_per_split, int C, int epilogue,
                              float eps, float eps_ins, const void* win_tab,
                              const void* win_tmap, int win_nb,
                              int win_start, int win_blk) {
  const bool win = win_tab != nullptr;
  if (win && C != 1) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rt::RowArgs r;
  r.X = X;
  r.ld = K;
  r.w = static_cast<const float*>(wt);
  r.rho = static_cast<const float*>(rho);
  r.beta = static_cast<const float*>(beta);
  r.mask = static_cast<const float*>(wmask);
  r.noise[0] = static_cast<const float*>(nu);
  r.noise[1] = static_cast<const float*>(u);
  r.noise[2] = static_cast<const float*>(nu_o);
  r.noise[3] = static_cast<const float*>(u_o);
  r.seed = static_cast<const int64_t*>(seed);
  r.row_base = 0;
  r.nrows = N;
  r.K = K;
  r.C = C;
  r.margin = static_cast<float*>(margin);
  r.gamma = static_cast<float*>(gamma);
  r.omega = static_cast<float*>(omega);
  r.wgt = static_cast<float*>(wgt);
  r.coef = static_cast<float*>(coef);
  r.eps = eps;
  r.eps_ins = eps_ins;
  const int bad = rt::launch_stat_rows(r, path == rt::gp::BF16, epilogue, st);
  if (bad) return bad;
  rt::gp::StatArgs a;
  a.wgt = r.wgt;
  a.coef = r.coef;
  a.part = static_cast<float*>(part);
  a.bpart = static_cast<float*>(bpart);
  a.N = N;
  a.rows_per_split = rows_per_split;
  a.K = K;
  a.Kp = Kp;
  a.ntiles = ntiles;
  a.C = C;
  a.nsplits = nsplits;
  a.win.tab = static_cast<const int*>(win_tab);
  a.win.tmap = static_cast<const int*>(win_tmap);
  a.win.ntw = ntiles;
  a.win.nb = win_nb;
  a.win.start = win_start;
  a.win.blk = win_blk;
  err = rt::launch_stat_tiles(X, path, a, win, st);
  if (err != cudaSuccess) return (int)err;
  float* sf = static_cast<float*>(sigma);
  if (win)
    rt::launch_win_finalize(a.part, sf, K, a.win, nsplits, st);
  else
    rt::launch_tri_finalize(a.part, sf, K, ntiles, nsplits, st, C);
  rt::launch_sum_partials(a.bpart, static_cast<float*>(b), K, Kp, nsplits,
                          st, C);
  return (int)cudaGetLastError();
}

// Dynamic shared memory bytes and resident CTAs an SM of the statistic's
// tile kernel (gram_pipe.cuh's stat_tiles) on copy path ``path``, the
// window table's grid if ``win``.
extern "C" int rt_fused_stats_occupancy(int device, int path, int win,
                                        int* smem, int* ctas) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(win ? rt::gp::stat_occupancy<true>(path, smem, ctas)
                   : rt::gp::stat_occupancy<false>(path, smem, ctas));
}
