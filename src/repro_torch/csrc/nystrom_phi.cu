// The Nystrom kernels: the featurizer phi = k(X, L) @ proj (masked, with an
// optional mask-valued bias column LAST), the scorer phi @ W, and the
// featurize-and-accumulate statistic (margin, gamma[, omega], b, Sigma on
// phi, or a column window of Sigma).
//
// Replaces the TPU kernels of repro/kernels/nystrom_phi.py: nystrom_phi,
// nystrom_score and nystrom_fused_stats (em_hinge and em_svr; mc_hinge and
// mc_svr from noise operands or from the counter seed; full width or a
// column window of phi columns). The TPU kernels
// hold the landmark strip, the projection, the cross tile, the phi tile and
// the (M, M) Sigma in VMEM at once; a Hopper CTA has 227 KB of shared
// memory, so here the rows go in chunks and every operand streams through
// shared memory in 32-deep slices. Per chunk of R rows:
//
//   A. cross_tiles (rbf.cuh): the cross-Gram chunk k(X, L), each entry
//      computed once, into an L2-sized scratch stored landmark-major,
//      (m, R) with rows R apart;
//   B. phi_tiles: its product with proj on the Gram engine
//      (gram_pipe.cuh's tile_pass and CopyPair: a three-slot cp.async ring
//      of 16-byte copies of both operands, the landmarks the depth), 128 x
//      128 tiles, masked in registers, with the bias column; WRITE stores
//      the phi rows, SCORE multiplies them by W at once and keeps (column
//      block, row, C) partial scores, summed in column-block order by
//      score_reduce;
//   and for the statistic, phi rows go to an (R, M) scratch, then the two
//   passes of fused_stats (stats.cuh) run on it:
//   C. the row pass: a warp 4 rows: margin = phi . w, the epilogue
//      (rng.cuh, epilogues.cuh), the row's Sigma weight (mask times the
//      epilogue's) and coef;
//   D. the Gram engine's statistic grid (gram_pipe.cuh's stat_tiles):
//      Sigma's lower-triangle 128 x 128 tiles over row splits, b on the
//      diagonal tiles; the partials are added to Sigma and b in split
//      order, chunk after chunk (tri_finalize / sum_partials with acc).
//      Under a column window the engine runs the window's tiles (WinArgs)
//      and win_finalize adds its columns: bitwise the full statistic's
//      column slice.
//
// No (N, m) and no (N, M) buffer is allocated on the statistic's route.
// Each phi entry is one thread's fmaf chain over the landmarks in order,
// from +0, so phi does not depend on R: the statistic sees the bits
// nystrom_phi writes. Past the last landmark the engine's last stage is
// zero-filled (m % 32 != 0), and its fmaf(0, 0, acc) turns an accumulator
// of -0 into +0; no other bit depends on it. See kernels/nystrom_phi.py
// for the design note.
#include "epilogues.cuh"
#include "rbf.cuh"
#include "stats.cuh"

namespace rt {
namespace {

enum PhiMode : int { PHI_WRITE = 0, PHI_SCORE = 1 };

inline int64_t rows_left(int64_t chunk, int64_t rest) {
  return chunk < rest ? chunk : rest;
}

struct PhiArgs {
  const float* kc;    // (m, ldk): the landmark-major cross-Gram chunk
  int64_t ldk;        // a multiple of 4
  const float* proj;  // (m, ldp), ldp a multiple of 4: P columns, 0 after
  int ldp;
  const float* mask;  // (nrows,), null = ones
  int64_t nrows;
  int m, P, bias;     // phi width M = P + bias
  float* out;         // WRITE: (nrows, M) rows, ldo apart
  int ldo;            // WRITE: >= M; columns M..ldo - 1 are written 0
  const float* W;     // SCORE: (M, C)
  int C;
  float* spart;       // SCORE: (column blocks, nrows, C)
};

// The projection tile's epilogue, on the engine's accumulator (acc[p][q]:
// chunk row i0 + tile_row(p), phi column j0 + tile_col(q)).
template <int MODE>
struct PhiEpilogue {
  const PhiArgs& a;
  int64_t i0;
  int j0, cb;
  unsigned char* smem;  // the engine's ring, free after a barrier

  __device__ __forceinline__ void operator()(float (&acc)[8][8]) const {
    const int M = a.P + a.bias;
    // phi = [k @ proj, 1] * mask, in place.
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int64_t i = i0 + tile_row(p);
      const float mk = (a.mask != nullptr && i < a.nrows) ? a.mask[i] : 1.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = j0 + tile_col(q);
        acc[p][q] = j < a.P ? __fmul_rn(acc[p][q], mk) : (j < M ? mk : 0.f);
      }
    }
    if (MODE == PHI_WRITE) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int64_t i = i0 + tile_row(p);
        if (i >= a.nrows) continue;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + tile_col(q);
          if (j < a.ldo) a.out[i * a.ldo + j] = acc[p][q];
        }
      }
      return;
    }
    // SCORE: the tile's partial scores, phi never leaving registers. Each
    // thread sums its 8 columns; the 16 threads of a row group are summed
    // in tx order through shared memory (a ring slot, once every thread
    // is past its last stage).
    __syncthreads();
    float(*red)[GT] = reinterpret_cast<float(*)[GT]>(smem);
    const int tx = threadIdx.x % 16;
    for (int c = 0; c < a.C; ++c) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + tile_col(q);
          if (j < M) s = fmaf(acc[p][q], __ldg(a.W + (int64_t)j * a.C + c), s);
        }
        red[tx][tile_row(p)] = s;
      }
      __syncthreads();
      if (threadIdx.x < GT) {
        float s = 0.f;
        for (int x = 0; x < 16; ++x) s += red[x][threadIdx.x];
        const int64_t i = i0 + threadIdx.x;
        if (i < a.nrows) a.spart[((int64_t)cb * a.nrows + i) * a.C + c] = s;
      }
      __syncthreads();
    }
  }
};

// One CTA a 128 x 128 phi tile: rows i0.., columns j0.. of the chunk,
// column tiles fastest, so the CTAs that share a row block of kc run
// together and read it from L2. The product is the engine's tile pass over
// the m landmarks (A = kc's columns i0.., B = proj's columns j0..); a tile
// holding only the bias column runs none.
template <int MODE>
__global__ void __launch_bounds__(TILE_THREADS, 2) phi_tiles(PhiArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntc = (a.P + a.bias + GT - 1) / GT;
  const int cb = (int)(blockIdx.x % ntc);
  const int64_t i0 = (int64_t)(blockIdx.x / ntc) * GT;
  const int j0 = cb * GT;
  const PhiEpilogue<MODE> epi{a, i0, j0, cb, smem};
  if (j0 < a.P) {
    gp::CopyPair cp(a.kc, a.ldk, (int)a.nrows, a.proj, a.ldp, a.P, smem);
    const gp::Tile t{a.m, a.m, (int)a.nrows, (int)i0, j0, false};
    gp::tile_pass(cp, t, 0, epi);
  } else {
    float acc[8][8];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
    epi(acc);
  }
}

// out[i, c] = sum over column blocks of spart, in block order.
__global__ void score_reduce(const float* __restrict__ spart,
                             float* __restrict__ out, int64_t n, int ncb) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int cb = 0; cb < ncb; ++cb) s += spart[(int64_t)cb * n + idx];
  out[idx] = s;
}

struct Featurizer {
  const void* X;
  int x_bf16;
  const float* L;     // (m, D)
  const float* proj;  // (m, ldp)
  const float* mask;  // (N,), null = ones
  float* sqx;         // (N,) scratch (rbf)
  float* sql;         // (m,) scratch (rbf)
  float* kc;          // (m, ldk) scratch, landmark-major
  int64_t N, ldk;
  int D, m, P, ldp, bias, kind;
  float inv_two_sigma_sq;
};

// Squared norms of every row and landmark (rbf only).
static void sqnorms(const Featurizer& f, cudaStream_t st) {
  if (f.kind != KIND_RBF) return;
  if (f.x_bf16)
    launch_row_sqnorm(static_cast<const __nv_bfloat16*>(f.X), f.N, f.D,
                      f.sqx, st);
  else
    launch_row_sqnorm(static_cast<const float*>(f.X), f.N, f.D, f.sqx, st);
  launch_row_sqnorm(f.L, (int64_t)f.m, f.D, f.sql, st);
}

// Stage A for rows [c0, c0 + nr): the cross-Gram chunk into kc, landmark-
// major.
static void cross_chunk(const Featurizer& f, int64_t c0, int64_t nr,
                        cudaStream_t st) {
  const float* sq = f.kind == KIND_RBF ? f.sqx + c0 : nullptr;
  if (f.x_bf16)
    launch_cross_tiles<true>(static_cast<const __nv_bfloat16*>(f.X) +
                                 c0 * f.D,
                             f.L, sq, f.sql, f.kc, nr, f.m, f.D, f.ldk,
                             f.kind, f.inv_two_sigma_sq, st);
  else
    launch_cross_tiles<true>(static_cast<const float*>(f.X) + c0 * f.D, f.L,
                             sq, f.sql, f.kc, nr, f.m, f.D, f.ldk, f.kind,
                             f.inv_two_sigma_sq, st);
}

// Stage B for rows [c0, c0 + nr); WRITE stores them ldo apart.
template <int MODE>
static cudaError_t phi_chunk(const Featurizer& f, int64_t c0, int64_t nr,
                             float* out, int ldo, const float* W, int C,
                             float* spart, cudaStream_t st) {
  PhiArgs a;
  a.kc = f.kc;
  a.ldk = f.ldk;
  a.proj = f.proj;
  a.ldp = f.ldp;
  a.mask = f.mask ? f.mask + c0 : nullptr;
  a.nrows = nr;
  a.m = f.m;
  a.P = f.P;
  a.bias = f.bias;
  a.out = out;
  a.ldo = ldo;
  a.W = W;
  a.C = C;
  a.spart = spart;
  const int ntc = (f.P + f.bias + GT - 1) / GT;
  const int64_t nctas = ((nr + GT - 1) / GT) * ntc;
  cudaError_t err = cudaFuncSetAttribute(
      phi_tiles<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gp::CopyPair::SMEM);
  if (err != cudaSuccess) return err;
  phi_tiles<MODE><<<(unsigned)nctas, TILE_THREADS, gp::CopyPair::SMEM, st>>>(
      a);
  return cudaGetLastError();
}

static Featurizer featurizer(const void* X, int x_bf16, const void* L,
                             const void* proj, const void* mask, void* sqx,
                             void* sql, void* kc, int64_t N, int D, int m,
                             int P, int proj_ld, int bias, int kind,
                             float inv_two_sigma_sq, int64_t chunk_rows) {
  Featurizer f;
  f.X = X;
  f.x_bf16 = x_bf16;
  f.L = static_cast<const float*>(L);
  f.proj = static_cast<const float*>(proj);
  f.mask = static_cast<const float*>(mask);
  f.sqx = static_cast<float*>(sqx);
  f.sql = static_cast<float*>(sql);
  f.kc = static_cast<float*>(kc);
  f.N = N;
  f.ldk = chunk_rows;
  f.D = D;
  f.m = m;
  f.P = P;
  f.ldp = proj_ld;
  f.bias = bias;
  f.kind = kind;
  f.inv_two_sigma_sq = inv_two_sigma_sq;
  return f;
}

}  // namespace
}  // namespace rt

// Common arguments: X (N, D) row-major f32 (x_bf16 = 0) or bf16; L (m, D)
// f32 row-major; proj (m, P) f32 with rows proj_ld apart (proj_ld a
// multiple of 4, proj 16-byte aligned; columns P..proj_ld - 1 unread);
// mask (N,) f32 or null (ones); bias 0/1 appends the mask-valued column
// after the P projected ones (M = P + bias); kind 0 = rbf, 1 = linear;
// chunk_rows rows a chunk, a multiple of 4. Scratch: sqx (N,) and sql
// (m,) f32 (rbf only), kc (m, chunk_rows) f32, 16-byte aligned. Each
// returns the first CUDA error of its launches (-1 for a bad epilogue
// code).

// out (N, M) f32: the phi rows.
extern "C" int rt_nystrom_phi(int device, void* stream, const void* X,
                              int x_bf16, const void* L, const void* proj,
                              const void* mask, void* sqx, void* sql,
                              void* kc, void* out, int64_t N, int D, int m,
                              int P, int proj_ld, int bias, int kind,
                              float inv_two_sigma_sq, int64_t chunk_rows) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rt::Featurizer f =
      rt::featurizer(X, x_bf16, L, proj, mask, sqx, sql, kc, N, D, m, P,
                     proj_ld, bias, kind, inv_two_sigma_sq, chunk_rows);
  float* o = static_cast<float*>(out);
  const int64_t M = P + bias;
  rt::sqnorms(f, st);
  for (int64_t c0 = 0; c0 < N; c0 += chunk_rows) {
    const int64_t nr = rt::rows_left(chunk_rows, N - c0);
    rt::cross_chunk(f, c0, nr, st);
    err = rt::phi_chunk<rt::PHI_WRITE>(f, c0, nr, o + c0 * M, (int)M,
                                       nullptr, 0, nullptr, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// W (M, C) f32; spart (ceil(M / 128), chunk_rows, C) f32 scratch; out
// (N, C) f32 scores.
extern "C" int rt_nystrom_score(int device, void* stream, const void* X,
                                int x_bf16, const void* L, const void* proj,
                                const void* mask, const void* W, void* sqx,
                                void* sql, void* kc, void* spart, void* out,
                                int64_t N, int D, int m, int P,
                                int proj_ld, int bias, int C, int kind,
                                float inv_two_sigma_sq, int64_t chunk_rows) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rt::Featurizer f =
      rt::featurizer(X, x_bf16, L, proj, mask, sqx, sql, kc, N, D, m, P,
                     proj_ld, bias, kind, inv_two_sigma_sq, chunk_rows);
  float* sp = static_cast<float*>(spart);
  float* o = static_cast<float*>(out);
  const int ncb = (P + bias + rt::GT - 1) / rt::GT;
  rt::sqnorms(f, st);
  for (int64_t c0 = 0; c0 < N; c0 += chunk_rows) {
    const int64_t nr = rt::rows_left(chunk_rows, N - c0);
    rt::cross_chunk(f, c0, nr, st);
    err = rt::phi_chunk<rt::PHI_SCORE>(f, c0, nr, nullptr, 0,
                                       static_cast<const float*>(W), C, sp,
                                       st);
    if (err != cudaSuccess) return (int)err;
    const int64_t n = nr * C;
    rt::score_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        sp, o + c0 * C, n, ncb);
  }
  return (int)cudaGetLastError();
}

// rho, beta (N,) f32 (beta read by the hinge only); w (M,) f32; epilogue
// 0 = em_hinge, 1 = mc_hinge reading nu, u (N,) f32, 2 = mc_hinge deriving
// them from seed (four int64 words on the device; the counter row is
// seed[2] + operand row), 3 = em_svr, 4 = mc_svr reading nu, u, nu_o, u_o
// (N,) f32, 5 = mc_svr from the seed; eps_ins is the SVR tube. Scratch:
// phi (chunk_rows, phi_ld) with phi_ld >= M (the columns past M are
// written 0), copied by the Gram engine on ``phi_path`` (gram_pipe.cuh's
// Path: 1 if phi_ld % 4 == 0, else 0), wgt and coef
// (chunk_rows,), part (chunk_rows / rows_per_split, ntiles, 128, 128),
// bpart (chunk_rows / rows_per_split, Mp) f32 with Mp = 128 ceil(M / 128);
// chunk_rows a multiple of rows_per_split. Outputs margin, gamma (N,),
// omega (N,) for SVR (else unused, may be null), sigma (M, M), b (M,) f32.
// With win_tab non-null: the column window (win_start, win_blk) of phi
// columns, sigma (M, win_blk); win_tab (ntiles, 3) and win_tmap (nb, nb)
// int32 on the device as WinArgs describes, ntiles the window's tile
// count, rows_per_split and chunk_rows the full statistic's plan.
extern "C" int rt_nystrom_fused_stats(
    int device, void* stream, const void* X, int x_bf16, const void* L,
    const void* proj, const void* mask, const void* rho, const void* beta,
    const void* w, const void* nu, const void* u, const void* nu_o,
    const void* u_o, const void* seed, void* sqx, void* sql, void* kc,
    void* phi, void* wgt, void* coef, void* part, void* bpart, void* margin,
    void* gamma, void* omega, void* sigma, void* b, int64_t N, int D, int m,
    int P, int proj_ld, int bias, int kind, float inv_two_sigma_sq,
    int64_t chunk_rows,
    int ntiles, int64_t rows_per_split, int phi_ld, int phi_path,
    int epilogue,
    float eps, float eps_ins, const void* win_tab, const void* win_tmap,
    int win_nb, int win_start, int win_blk) {
  if (epilogue < rt::EM_HINGE || epilogue > rt::MC_SVR_SEED) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rt::Featurizer f =
      rt::featurizer(X, x_bf16, L, proj, mask, sqx, sql, kc, N, D, m, P,
                     proj_ld, bias, kind, inv_two_sigma_sq, chunk_rows);
  const int M = P + bias;
  const bool win = win_tab != nullptr;
  float* ph = static_cast<float*>(phi);
  float* sg = static_cast<float*>(sigma);
  float* bo = static_cast<float*>(b);
  rt::RowArgs r;
  r.X = ph;
  r.ld = phi_ld;
  r.w = static_cast<const float*>(w);
  r.seed = static_cast<const int64_t*>(seed);
  r.K = M;
  r.C = 1;
  r.wgt = static_cast<float*>(wgt);
  r.coef = static_cast<float*>(coef);
  r.eps = eps;
  r.eps_ins = eps_ins;
  rt::gp::StatArgs a;
  a.wgt = r.wgt;
  a.coef = r.coef;
  a.part = static_cast<float*>(part);
  a.bpart = static_cast<float*>(bpart);
  a.rows_per_split = rows_per_split;
  // The engine runs on all phi_ld columns: those past M are 0, and so
  // are their entries of the tiles, which the finalize never reads.
  a.K = phi_ld;
  a.Kp = rt::BK * ((M + rt::BK - 1) / rt::BK);
  a.ntiles = ntiles;
  a.C = 1;
  a.win.tab = static_cast<const int*>(win_tab);
  a.win.tmap = static_cast<const int*>(win_tmap);
  a.win.ntw = ntiles;
  a.win.nb = win_nb;
  a.win.start = win_start;
  a.win.blk = win_blk;
  const float* ops[4] = {static_cast<const float*>(nu),
                         static_cast<const float*>(u),
                         static_cast<const float*>(nu_o),
                         static_cast<const float*>(u_o)};
  rt::sqnorms(f, st);
  for (int64_t c0 = 0; c0 < N; c0 += chunk_rows) {
    const int64_t nr = rt::rows_left(chunk_rows, N - c0);
    rt::cross_chunk(f, c0, nr, st);
    err = rt::phi_chunk<rt::PHI_WRITE>(f, c0, nr, ph, phi_ld, nullptr, 0,
                                       nullptr, st);
    if (err != cudaSuccess) return (int)err;
    r.rho = static_cast<const float*>(rho) + c0;
    r.beta = static_cast<const float*>(beta) + c0;
    r.mask = f.mask ? f.mask + c0 : nullptr;
    for (int q = 0; q < 4; ++q) r.noise[q] = ops[q] ? ops[q] + c0 : nullptr;
    r.row_base = c0;
    r.nrows = nr;
    r.margin = static_cast<float*>(margin) + c0;
    r.gamma = static_cast<float*>(gamma) + c0;
    r.omega = omega ? static_cast<float*>(omega) + c0 : nullptr;
    const int bad = rt::launch_stat_rows(r, false, epilogue, st);
    if (bad) return bad;
    a.N = nr;
    a.nsplits = (int)((nr + rows_per_split - 1) / rows_per_split);
    err = rt::launch_stat_tiles(ph, phi_path, a, win, st);
    if (err != cudaSuccess) return (int)err;
    if (win)
      rt::launch_win_finalize(a.part, sg, M, a.win, a.nsplits, st, c0 > 0);
    else
      rt::launch_tri_finalize(a.part, sg, M, ntiles, a.nsplits, st, 1,
                              c0 > 0);
    rt::launch_sum_partials(a.bpart, bo, M, a.Kp, a.nsplits, st, 1, c0 > 0);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory bytes and resident CTAs an SM of the projection
// kernel phi_tiles (mode 0 = WRITE, 1 = SCORE) on the engine's CopyPair.
extern "C" int rt_nystrom_phi_occupancy(int device, int mode, int* smem,
                                        int* ctas) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(mode == rt::PHI_SCORE
                   ? rt::gp::occupancy_of<rt::gp::CopyPair>(
                         rt::phi_tiles<rt::PHI_SCORE>, smem, ctas)
                   : rt::gp::occupancy_of<rt::gp::CopyPair>(
                         rt::phi_tiles<rt::PHI_WRITE>, smem, ctas));
}
