// The iteration statistic's two passes, shared by fused_stats.cu (rows of
// X, C chains) and nystrom_phi.cu (rows of a phi chunk) and defined in
// fused_stats.cu:
//
//   1. the row pass (stat_rows): a warp takes 4 consecutive rows, computes
//      their margins with all lanes (row_dot: a fixed summation order,
//      the rows' loads interleaved), lane k keeping row k's, then
//      lanes 0-3 run their rows' epilogues (epilogues.cuh; rng.cuh for the
//      seed variants). It writes margin, gamma (omega) and each row's
//      Sigma weight (mask times the epilogue's weight) and b coefficient;
//   2. the Gram engine's statistic grid (gram_pipe.cuh's stat_tiles) on the
//      same rows with those weights and coefficients: Sigma's tiles and b's
//      blocks as per-split partials, summed in split order by common.cuh's
//      finalize launches (no atomics: bitwise repeatable).
#pragma once

#include "gram_pipe.cuh"

namespace rt {

struct RowArgs {
  const void* X;          // nrows rows of K values, ld apart; f32 or bf16
  int64_t ld;
  const float* w;         // (C, K): chain c's weights at w + c * K
  const float* rho;       // (nrows,) the target y under SVR
  const float* beta;      // (nrows,) read by the hinge only
  const float* mask;      // (nrows,) or null (ones)
  const float* noise[4];  // noise variants: (nrows,) nu, u[, nu_o, u_o]
  const int64_t* seed;    // seed variants: [k0, k1, row0, chain0] as words
  int64_t row_base;       // row r's counter row is seed[2] + row_base + r
  int64_t nrows;
  int K, C;
  float* margin;          // (nrows, C)
  float* gamma;           // (nrows, C)
  float* omega;           // (nrows, C), SVR only
  float* wgt;             // (C, nrows): mask times the epilogue's weight
  float* coef;            // (C, nrows): b's coefficient (+ beta, hinge)
  float eps, eps_ins;
};

// The row pass over a.X (bf16 rows if ``bf16``) under epilogue code
// ``epilogue`` (epilogues.cuh's Epilogue). Returns -1 for an unknown
// code, else cudaGetLastError() after the launch.
int launch_stat_rows(const RowArgs& a, bool bf16, int epilogue,
                     cudaStream_t stream);

// stat_tiles on X's rows, copied on ``path`` (gram_pipe.cuh's Path): the
// lower triangle, or with ``win`` the tile table of a.win.
cudaError_t launch_stat_tiles(const void* X, int path,
                              const gp::StatArgs& a, bool win,
                              cudaStream_t stream);

}  // namespace rt
