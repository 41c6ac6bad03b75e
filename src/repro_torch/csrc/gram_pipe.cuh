// The pipelined fp32 Gram engine: Sigma = X^T diag(w) X on the CUDA cores
// (FFMA; no TF32, no fast-math), for syrk.cu (lower-triangle tiles),
// weighted_gram.cu (the dense tile grid) and the iteration statistic of
// fused_stats.cu and nystrom_phi.cu (stat_tiles: lower-triangle tiles or a
// column window's tile table, C chains, and b = X^T coef beside Sigma);
// and, with two operands (CopyPair), the Nystrom projection A^T B of
// nystrom_phi.cu, whose depth is the landmarks, and the cross-Gram of
// rbf.cuh (rbf_gram.cu, nystrom_phi.cu), whose depth is the rows' D.
//
// What bounds it on the H100: fp32 FMAs. The triangle needs N K (K + 1)
// flop on 4 N K bytes of X, (K + 1) / 4 flop a byte against a ridge of ~20
// (67 TFLOP/s over 3.35 TB/s). So a CTA must keep its FMA pipe fed: a pass
// whose loads, shared-memory stores and FMAs follow one another behind
// __syncthreads leaves it idle between them (the staged pass the port ran
// before reached ~37 % of fp32 peak; this one 72-74 %).
//
// The engine: a CTA of 256 threads owns one 128 x 128 tile (i, j) of
// Sigma for one split of at most ROWS_PER_SPLIT rows (the plan of the
// wrapper), keeps it in registers (8 x 8 a thread) and writes it as a
// per-split partial; a finalize launch sums the partials in split order.
// Rows arrive 32 at a time ("a stage") through cp.async into a ring in
// dynamic shared memory, two stages ahead of the one being multiplied:
// while the CTA multiplies stage s, the copies of stage s + 2 are in flight
// and the arrived stage s + 1 is prepared in shared memory (its i-block
// scaled by w, or converted from bf16). One __syncthreads a stage. The
// FMAs read the next row's fragments while they run (mma_stage).
// The preparation rounds each product fl(x w) once. In Sigma's tiles
// (gram_tiles, stat_tiles) a split of more than ONE_CHAIN_STAGES stages
// (1,024 rows) sums in two levels: every element is one FMA chain over a
// block of FLUSH_STAGES stages (256 rows) from 0, and the blocks join a
// running sum at the tile's partial in row order. A single chain over a
// 3,072-row split erred 3.6x cuBLAS's product in the 2-norm and, at the
// granite head's hinge weights (1/gamma up to 1e6), pushed P's smallest
// eigenvalue below 0 where float64 and cuBLAS kept it at 7-9
// (chip_head_numerics.py); 256-row blocks err under half of cuBLAS's there,
// for a few per cent more time (PERF.md section 6). A shorter split stays
// one chain and keeps its bits: within 1.5x of cuBLAS's error there
// (tests/test_torch_kernels_gpu.py holds both). The bits depend only on
// the split plan, so every caller of gram_tiles and stat_tiles on one
// plan gives the same bits.
//
// How a stage is copied, by the row alignment (the wrapper picks it):
// - CopyF32<4>: fp32 with K % 4 == 0 and X 16-byte aligned: one 16-byte
//   cp.async a four-column group (K = 500, Table 9; K = 2,048, phase 5 and
//   the SVR split route). A group lies wholly inside or outside [0, K).
// - CopyF32<1>: fp32 otherwise: one 4-byte cp.async an element (K = 501,
//   2,049 (phase 8), 91, 29).
// - CopyBf16: bf16 at any K: the 4-byte words that cover a row's 128
//   columns (65 words, the first may start half a word early) land raw in
//   a bf16 ring; the preparation picks each element's half-word, converts
//   it to fp32 (exactly) and masks columns >= K. A row whose segment starts
//   half a word early reads the two bytes before it, which lie in the same
//   aligned word as an element of X (never outside a mapped page); bytes
//   past the end of X are not read (cp.async's source size).
// - CopyPair: two fp32 operands, each with its own base, leading
//   dimension and width (the projection: A the landmark-major cross-Gram
//   chunk, B proj), 16-byte copies, nothing to prepare.
// Rows past the split's end and columns past K are zero-filled by
// cp.async's source size. On a diagonal tile (i == j) the A and B blocks
// are the same columns: only B is copied, and A = B w is made from it.
// Where the last column block is ragged (K = 2,049: one column), the warps
// whose A rows all lie past K skip the FMAs; 17 of phase 8's 153 tiles are
// such edge tiles, and in each only the first warp multiplies.
//
// The statistic's hooks (stat_tiles; NV = 2 per-row vectors in the ring):
// - b: the row's b coefficient is copied beside its weight. A CTA that
//   owns b's column block q sums coef[r] x[r][q-block] over its split's
//   rows in row order: from the unscaled B side when q = j (bmode 1: the
//   diagonal tiles of the triangle), else from X's rows of block i (bmode
//   2, a window's tile whose row block no window tile has as its column
//   block). The sum is the one the B side gives, so b does not depend on
//   which CTA forms it.
// - the window: (i, j, bmode) from WinArgs' table (common.cuh) in place of
//   the triangle's index; win_finalize then picks the window's columns
//   from the full statistic's tiles: bitwise the full call's slice.
// - C chains: a chain index in the grid, fastest, so the C CTAs of one
//   (split, tile) run together and read the same rows of X from L2; chain
//   c's weights and coefficients are row c of (C, N) operands.
#pragma once

#include "common.cuh"

namespace rt {
namespace gp {

constexpr int RAW_WORDS = 66;  // words a raw bf16 row segment (65 used)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy ``src_bytes`` (<= BYTES) bytes from src to dst, zero-filling the
// rest of the BYTES. src must be a valid address even when src_bytes = 0.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What every copy policy knows of the CTA's work: the rows [.., r_end) of
// its split and the first columns of its two blocks.
struct Tile {
  int64_t N, r_end;
  int K, c0i, c0j;
  bool diag;
};

// The operands of one stage as mma_stage reads them.
struct Operands {
  float (*A)[BK];     // X[rows, c0i:c0i + BK] * w[rows]
  float (*B)[BK];     // X[rows, c0j:c0j + BK]
  const float* coef;  // NV = 2: the rows' b coefficients
};

// Copy the stage's per-row vectors: w to v[0, BN) and, with NV = 2, coef
// to v[BN, 2 BN); rows past the split's end read 0.
template <int NV>
__device__ __forceinline__ void fetch_vectors(float* v, const float* w,
                                              const float* coef,
                                              int64_t row0, const Tile& t) {
  if (threadIdx.x < BN) {
    const int64_t row = row0 + threadIdx.x;
    const bool ok = row < t.r_end;
    cp_async<4>(&v[threadIdx.x], ok ? w + row : w, ok ? 4 : 0);
  }
  if constexpr (NV == 2) {
    if (threadIdx.x >= BN && threadIdx.x < 2 * BN) {
      const int64_t row = row0 + threadIdx.x - BN;
      const bool ok = row < t.r_end;
      cp_async<4>(&v[threadIdx.x], ok ? coef + row : coef, ok ? 4 : 0);
    }
  }
}

// fp32 rows copied straight into the operand slot; the preparation scales
// the A block by w in place (or makes it from B on a diagonal tile).
// VEC = 4: 16-byte copies of four columns; VEC = 1: 4-byte copies. NV:
// per-row vectors staged (1: w; 2: w and coef).
template <int VEC, int NV = 1>
struct CopyF32 {
  static constexpr int SLOTS = 3;
  struct Slot {
    float A[BN][BK];
    float B[BN][BK];
    float w[NV * BN];  // [0, BN): w; [BN, 2 BN): coef
  };
  static constexpr size_t SMEM = SLOTS * sizeof(Slot);

  const float* __restrict__ X;
  const float* __restrict__ w;
  const float* __restrict__ coef;
  Slot* slot;

  __device__ CopyF32(const float* X_, const float* w_, unsigned char* smem,
                     const float* coef_ = nullptr)
      : X(X_), w(w_), coef(coef_), slot(reinterpret_cast<Slot*>(smem)) {}

  // The thread copies one VEC-column group of every ROWS-th row: one
  // pointer, stepped a row group at a time.
  __device__ __forceinline__ void block(float (*dst)[BK], int64_t row0,
                                        const Tile& t, int c0) const {
    constexpr int PER_ROW = BK / VEC, ROWS = TILE_THREADS / PER_ROW;
    const int r0 = threadIdx.x / PER_ROW, c = (threadIdx.x % PER_ROW) * VEC;
    const bool col_ok = c0 + c < t.K;
    const int nrows = (int)min64(BN, t.r_end - row0);
    const float* src = X + (row0 + r0) * (int64_t)t.K + c0 + c;
#pragma unroll
    for (int i = 0; i < BN / ROWS; ++i) {
      const int r = r0 + i * ROWS;
      const bool ok = col_ok && r < nrows;
      cp_async<4 * VEC>(&dst[r][c], ok ? src : X, ok ? 4 * VEC : 0);
      src += (int64_t)ROWS * t.K;
    }
  }

  // Start the copies of the stage at row0 into slot k.
  __device__ __forceinline__ void fetch(int k, int64_t row0,
                                        const Tile& t) const {
    Slot& s = slot[k];
    if (!t.diag) block(s.A, row0, t, t.c0i);
    block(s.B, row0, t, t.c0j);
    fetch_vectors<NV>(s.w, w, coef, row0, t);
  }

  // A = (diag ? B : A) * w, row by row (the stage has arrived and is
  // visible to every thread).
  __device__ __forceinline__ void prepare(int k, int64_t, const Tile& t) {
    Slot& s = slot[k];
    const float4* src = reinterpret_cast<const float4*>(t.diag ? s.B : s.A);
    float4* dst = reinterpret_cast<float4*>(s.A);
#pragma unroll
    for (int i = 0; i < BN * BK / 4 / TILE_THREADS; ++i) {
      const int e = threadIdx.x + i * TILE_THREADS;
      const float ww = s.w[e / (BK / 4)];
      float4 v = src[e];
      v.x = __fmul_rn(v.x, ww);
      v.y = __fmul_rn(v.y, ww);
      v.z = __fmul_rn(v.z, ww);
      v.w = __fmul_rn(v.w, ww);
      dst[e] = v;
    }
  }

  __device__ __forceinline__ Operands operands(int k) const {
    return {slot[k].A, slot[k].B, NV == 2 ? slot[k].w + BN : nullptr};
  }

  // X[row, col] as the B side holds it (row < N, col < K).
  __device__ __forceinline__ float value(int64_t row, int K, int col) const {
    return X[row * (int64_t)K + col];
  }
};

// The fp32 operand ring of CopyBf16, with the stage's b coefficients
// (NV = 2) carried over from the raw ring.
template <int NV>
struct Bf16Ops {
  float A[BN][BK];
  float B[BN][BK];
  float coef[BN];
};
template <>
struct Bf16Ops<1> {
  float A[BN][BK];
  float B[BN][BK];
};

// bf16 rows: the covering 4-byte words land raw in a two-slot ring, and the
// preparation writes the fp32 operands into a two-slot operand ring.
template <int NV = 1>
struct CopyBf16 {
  static constexpr int SLOTS = 2;
  struct Raw {
    uint32_t word[2][BN][RAW_WORDS];  // [0]: the i-block, [1]: the j-block
    float w[NV * BN];                 // [0, BN): w; [BN, 2 BN): coef
  };
  using Ops = Bf16Ops<NV>;
  static constexpr size_t SMEM = SLOTS * (sizeof(Raw) + sizeof(Ops));

  const uint32_t* __restrict__ base;  // X rounded down to a 4-byte word
  int64_t shift;                      // X's first element's half-word in it
  const float* __restrict__ w;
  const float* __restrict__ coef;
  Raw* raw;
  Ops* ops;

  __device__ CopyBf16(const __nv_bfloat16* X, const float* w_,
                      unsigned char* smem, const float* coef_ = nullptr)
      : base(reinterpret_cast<const uint32_t*>(
            reinterpret_cast<uintptr_t>(X) & ~uintptr_t(3))),
        shift((int64_t)((reinterpret_cast<uintptr_t>(X) >> 1) & 1)),
        w(w_),
        coef(coef_),
        raw(reinterpret_cast<Raw*>(smem)),
        ops(reinterpret_cast<Ops*>(smem + SLOTS * sizeof(Raw))) {}

  // Half-word index, from ``base``, of element (row, col).
  __device__ __forceinline__ int64_t half(int64_t row, int K, int col) const {
    return shift + row * (int64_t)K + col;
  }

  __device__ __forceinline__ void block(uint32_t (*dst)[RAW_WORDS],
                                        int64_t row0, const Tile& t,
                                        int c0) const {
    const int64_t end_bytes = 2 * half(t.N, t.K, 0);  // one past X
    for (int e = threadIdx.x; e < BN * (RAW_WORDS - 1); e += TILE_THREADS) {
      const int r = e / (RAW_WORDS - 1), q = e % (RAW_WORDS - 1);
      const int64_t row = row0 + r;
      const int64_t gw = (half(row, t.K, c0) >> 1) + q;
      int64_t nb = end_bytes - 4 * gw;
      nb = row < t.r_end ? (nb < 0 ? 0 : (nb > 4 ? 4 : nb)) : 0;
      cp_async<4>(&dst[r][q], nb ? base + gw : base, (int)nb);
    }
  }

  __device__ __forceinline__ void fetch(int k, int64_t row0,
                                        const Tile& t) const {
    Raw& s = raw[k];
    if (!t.diag) block(s.word[0], row0, t, t.c0i);
    block(s.word[1], row0, t, t.c0j);
    fetch_vectors<NV>(s.w, w, coef, row0, t);
  }

  __device__ __forceinline__ void prepare(int k, int64_t row0,
                                          const Tile& t) {
    const Raw& s = raw[k];
    Ops& o = ops[k];
    const int c = threadIdx.x % BK;
    const int sa = t.diag ? 1 : 0;
    const bool ok_i = t.c0i + c < t.K, ok_j = t.c0j + c < t.K;
#pragma unroll 4
    for (int r = threadIdx.x / BK; r < BN; r += TILE_THREADS / BK) {
      // c0 is even, so a row's segment starts at the parity of row * K
      const int p = (int)(half(row0 + r, t.K, 0) & 1) + c;
      const uint16_t* ha = reinterpret_cast<const uint16_t*>(s.word[sa][r]);
      const uint16_t* hb = reinterpret_cast<const uint16_t*>(s.word[1][r]);
      const float a = ok_i ? __uint_as_float((uint32_t)ha[p] << 16) : 0.f;
      const float b = ok_j ? __uint_as_float((uint32_t)hb[p] << 16) : 0.f;
      o.A[r][c] = __fmul_rn(a, s.w[r]);
      o.B[r][c] = b;
    }
    if constexpr (NV == 2) {
      if (threadIdx.x < BN) o.coef[threadIdx.x] = s.w[BN + threadIdx.x];
    }
  }

  __device__ __forceinline__ Operands operands(int k) const {
    if constexpr (NV == 2) return {ops[k].A, ops[k].B, ops[k].coef};
    return {ops[k].A, ops[k].B, nullptr};
  }

  // X[row, col] in fp32, as the B side holds it (row < N, col < K).
  __device__ __forceinline__ float value(int64_t row, int K, int col) const {
    const uint16_t h =
        reinterpret_cast<const uint16_t*>(base)[half(row, K, col)];
    return __uint_as_float((uint32_t)h << 16);
  }
};

// Two fp32 operands whose rows are the depth: the stage's A block is
// A[row0:row0 + BN, c0i:c0i + BK] and its B block B[.., c0j:c0j + BK],
// each row-major with its own leading dimension (a multiple of 4, the base
// 16-byte aligned) and width. One 16-byte cp.async a four-column group;
// rows past t.r_end and columns past the width are zero-filled by the
// source size (a group across the width copies its columns below it). No
// per-row vector, nothing to prepare: the operands are multiplied as they
// land. The Nystrom projection (nystrom_phi.cu): A the (m, R) landmark-
// major cross-Gram chunk, B proj (m, P), the depth the m landmarks. The
// cross-Gram (rbf.cuh): A and B the depth-major (D, n) copies of its two
// operands' rows.
struct CopyPair {
  static constexpr int SLOTS = 3;
  struct Slot {
    float A[BN][BK];
    float B[BN][BK];
  };
  static constexpr size_t SMEM = SLOTS * sizeof(Slot);

  const float* __restrict__ A;
  const float* __restrict__ B;
  int64_t lda, ldb;
  int wa, wb;  // widths: columns at or past them read 0
  Slot* slot;

  __device__ CopyPair(const float* A_, int64_t lda_, int wa_, const float* B_,
                      int64_t ldb_, int wb_, unsigned char* smem)
      : A(A_), B(B_), lda(lda_), ldb(ldb_), wa(wa_), wb(wb_),
        slot(reinterpret_cast<Slot*>(smem)) {}

  // The thread copies one four-column group of every ROWS-th row.
  __device__ __forceinline__ static void block(float (*dst)[BK],
                                               const float* X, int64_t ld,
                                               int width, int64_t row0,
                                               const Tile& t, int c0) {
    constexpr int PER_ROW = BK / 4, ROWS = TILE_THREADS / PER_ROW;
    const int r0 = threadIdx.x / PER_ROW, c = (threadIdx.x % PER_ROW) * 4;
    const int left = width - c0 - c;
    const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : 4 * left);
    const int nrows = (int)min64(BN, t.r_end - row0);
    const float* src = X + (row0 + r0) * ld + c0 + c;
#pragma unroll
    for (int i = 0; i < BN / ROWS; ++i) {
      const int r = r0 + i * ROWS;
      const bool ok = bytes != 0 && r < nrows;
      cp_async<16>(&dst[r][c], ok ? src : X, ok ? bytes : 0);
      src += (int64_t)ROWS * ld;
    }
  }

  __device__ __forceinline__ void fetch(int k, int64_t row0,
                                        const Tile& t) const {
    block(slot[k].A, A, lda, wa, row0, t, t.c0i);
    block(slot[k].B, B, ldb, wb, row0, t, t.c0j);
  }

  __device__ __forceinline__ void prepare(int, int64_t, const Tile&) {}

  __device__ __forceinline__ Operands operands(int k) const {
    return {slot[k].A, slot[k].B, nullptr};
  }

  // B[row, col] (b_stage's hook; the projection runs with bmode 0).
  __device__ __forceinline__ float value(int64_t row, int, int col) const {
    return B[row * ldb + col];
  }
};

// acc[p][q] += A[r][ai(p)] * B[r][bj(q)] over the stage's BN rows in
// order. Thread (tx, ty) owns A rows 4ty..4ty+3 and 64+4ty..64+4ty+3 and
// the same pattern of B columns in tx (common.cuh's store_tile layout), so
// every element is one FMA chain over the stage's rows. The next row's
// fragments are read while this row's FMAs run.
__device__ __forceinline__ void frag(float a[8], float b[8], const float* Ar,
                                     const float* Br, int tx, int ty) {
  const float4 a0 = *reinterpret_cast<const float4*>(Ar + ty * 4);
  const float4 a1 = *reinterpret_cast<const float4*>(Ar + 64 + ty * 4);
  const float4 b0 = *reinterpret_cast<const float4*>(Br + tx * 4);
  const float4 b1 = *reinterpret_cast<const float4*>(Br + 64 + tx * 4);
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
  b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
  b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
}

__device__ __forceinline__ void mma_stage(float acc[8][8],
                                          const float (*A)[BK],
                                          const float (*B)[BK]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float a[2][8], b[2][8];
  frag(a[0], b[0], A[0], B[0], tx, ty);
#pragma unroll
  for (int r = 0; r < BN; ++r) {
    if (r + 1 < BN)
      frag(a[(r + 1) & 1], b[(r + 1) & 1], A[r + 1], B[r + 1], tx, ty);
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        acc[p][q] = fmaf(a[r & 1][p], b[r & 1][q], acc[p][q]);
  }
}

// b's column c = threadIdx.x (< BK) of block q over the stage's rows from
// row0, in row order: bmode 1 from the B side (q = j), bmode 2 from X's
// rows of block i (q = i); rows past the split and columns past K add 0.
template <class Copy>
__device__ __forceinline__ float b_stage(const Copy& cp, const Operands& o,
                                         const Tile& t, int64_t row0,
                                         int bmode, float bacc) {
  const int c = threadIdx.x;
  if (bmode == 1) {
#pragma unroll 8
    for (int r = 0; r < BN; ++r) bacc = fmaf(o.coef[r], o.B[r][c], bacc);
    return bacc;
  }
  const int col = t.c0i + c;
#pragma unroll 8
  for (int r = 0; r < BN; ++r) {
    const int64_t row = row0 + r;
    const float x = (row < t.r_end && col < t.K) ? cp.value(row, t.K, col)
                                                  : 0.f;
    bacc = fmaf(o.coef[r], x, bacc);
  }
  return bacc;
}

// Stages a row block of Sigma's tiles sums over before the block joins the
// running sum (the header): a chain of 256 rows, then one add a block; a
// split of at most ONE_CHAIN_STAGES stages is one chain.
constexpr int FLUSH_STAGES = 8;
constexpr int ONE_CHAIN_STAGES = 32;

// The accumulator's destination in gram_tiles and stat_tiles: the tile,
// row-major, at dst (a per-split partial): the first block is stored,
// each later one added.
struct StoreTile {
  float* dst;
  __device__ __forceinline__ void operator()(float (&acc)[8][8]) const {
    store_tile(dst, acc);
  }
  __device__ __forceinline__ void add(float (&acc)[8][8]) const {
    add_tile(dst, acc);
  }
};

// One CTA: tile (bi, bj) over rows [r_begin, r_end), the accumulator
// handed to ``epi`` (StoreTile: the partial); and b's block as bmode
// says (b_stage), returned (0 with bmode 0). With FLUSH > 0, on a split
// of more than ONE_CHAIN_STAGES stages, the accumulator goes to ``epi``
// every FLUSH stages (first ``epi(acc)``, then ``epi.add(acc)``) and
// restarts from 0. The
// stage s sits in slot s % SLOTS of the copy ring (CopyF32: 3 slots, so
// the stage being copied, prepared and multiplied never share one;
// CopyBf16: 2 raw and 2 operand slots, as it copies two stages ahead but
// prepares into its own ring; CopyPair: 3 slots, nothing prepared).
template <int FLUSH = 0, class Copy, class Epi>
__device__ __forceinline__ float tile_pass(Copy& cp, const Tile& t,
                                           int64_t r_begin, const Epi& epi,
                                           int bmode = 0) {
  constexpr int S = Copy::SLOTS;
  const int nst = (int)((t.r_end - r_begin + BN - 1) / BN);
  // A warp whose A rows all lie past K (the last block of a ragged K, as
  // at K = 2,049; the projection's rows past its chunk) multiplies
  // nothing: its part of the tile stays 0 and is never read.
  const int wr = 8 * (threadIdx.x / 32);
  const bool busy = t.c0i + wr < t.K || t.c0i + 64 + wr < t.K;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  float bacc = 0.f;

  cp.fetch(0, r_begin, t);
  cp_commit();
  if (nst > 1) cp.fetch(1 % S, r_begin + BN, t);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  cp.prepare(0, r_begin, t);
  for (int st = 0; st < nst; ++st) {
    // Stage st + 1 has arrived and stage st is prepared, for every thread;
    // every thread is done with stage st - 1, whose slot the copies of
    // stage st + 2 now take.
    cp_wait<0>();
    __syncthreads();
    if (st + 2 < nst)
      cp.fetch((st + 2) % S, r_begin + (int64_t)(st + 2) * BN, t);
    cp_commit();
    if (st + 1 < nst)
      cp.prepare((st + 1) % S, r_begin + (int64_t)(st + 1) * BN, t);
    const Operands o = cp.operands(st % S);
    if (bmode != 0 && threadIdx.x < BK)
      bacc = b_stage(cp, o, t, r_begin + (int64_t)st * BN, bmode, bacc);
    if (busy) mma_stage(acc, o.A, o.B);
    if constexpr (FLUSH > 0) {
      if (nst > ONE_CHAIN_STAGES && (st + 1) % FLUSH == 0 && st + 1 < nst) {
        if (st + 1 == FLUSH)
          epi(acc);
        else
          epi.add(acc);
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
      }
    }
  }
  if constexpr (FLUSH > 0) {
    if (nst > ONE_CHAIN_STAGES) {
      epi.add(acc);
      return bacc;
    }
  }
  epi(acc);
  return bacc;
}

// Grid = (S row splits) x (T tiles), tile index fastest. TRI: T lower-
// triangle tiles in tri_ij order; otherwise nb^2 tiles (i, j) row-major.
template <class Copy, bool TRI, typename T>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    gram_tiles(const T* __restrict__ X, const float* __restrict__ w,
               float* __restrict__ part, int64_t N, int K, int ntiles,
               int64_t rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tt = (int)(blockIdx.x % ntiles);
  const int64_t s = blockIdx.x / ntiles;
  int bi, bj;
  if (TRI) {
    tri_ij(tt, bi, bj);
  } else {
    const int nb = (K + BK - 1) / BK;
    bi = tt / nb;
    bj = tt % nb;
  }
  const int64_t r_begin = s * rows_per_split;
  const Tile t{N, min64(N, r_begin + rows_per_split), K, bi * BK, bj * BK,
               bi == bj};
  Copy cp(X, w, smem);
  tile_pass<FLUSH_STAGES>(
      cp, t, r_begin, StoreTile{part + ((int64_t)s * ntiles + tt) * BK * BK});
}

// Launch gram_tiles for X of dtype T (float or bf16) on copy path Copy,
// grid nsplits x ntiles.
template <bool TRI, class Copy, typename T>
cudaError_t launch_one(const T* X, const float* w, float* part, int64_t N,
                       int K, int ntiles, int nsplits,
                       int64_t rows_per_split, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gram_tiles<Copy, TRI, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Copy::SMEM);
  if (err != cudaSuccess) return err;
  gram_tiles<Copy, TRI, T>
      <<<(unsigned)((int64_t)nsplits * ntiles), TILE_THREADS, Copy::SMEM,
         stream>>>(X, w, part, N, K, ntiles, rows_per_split);
  return cudaGetLastError();
}

// The copy paths, as the wrapper names them (_build.GRAM_PATHS).
enum Path { F32_4B = 0, F32_16B = 1, BF16 = 2 };

template <bool TRI>
cudaError_t launch_tiles(const void* X, int path, const float* w,
                         float* part, int64_t N, int K, int ntiles,
                         int nsplits, int64_t rows_per_split,
                         cudaStream_t stream) {
  if (path == BF16)
    return launch_one<TRI, CopyBf16<>>(static_cast<const __nv_bfloat16*>(X),
                                       w, part, N, K, ntiles, nsplits,
                                       rows_per_split, stream);
  const float* Xf = static_cast<const float*>(X);
  if (path == F32_16B)
    return launch_one<TRI, CopyF32<4>>(Xf, w, part, N, K, ntiles, nsplits,
                                       rows_per_split, stream);
  return launch_one<TRI, CopyF32<1>>(Xf, w, part, N, K, ntiles, nsplits,
                                     rows_per_split, stream);
}

// The dynamic shared memory a CTA of kernel ``fn`` on copy path Copy
// takes, and how many such CTAs fit an SM.
template <class Copy, class Fn>
cudaError_t occupancy_of(Fn fn, int* smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Copy::SMEM);
  if (err != cudaSuccess) return err;
  *smem = (int)Copy::SMEM;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn,
                                                       TILE_THREADS,
                                                       Copy::SMEM);
}

template <bool TRI>
cudaError_t occupancy(int path, int* smem, int* ctas) {
  if (path == BF16)
    return occupancy_of<CopyBf16<>>(gram_tiles<CopyBf16<>, TRI,
                                               __nv_bfloat16>, smem, ctas);
  if (path == F32_16B)
    return occupancy_of<CopyF32<4>>(gram_tiles<CopyF32<4>, TRI, float>,
                                    smem, ctas);
  return occupancy_of<CopyF32<1>>(gram_tiles<CopyF32<1>, TRI, float>, smem,
                                  ctas);
}

// The statistic's tile grid (stat_tiles): Sigma_c's tiles and b_c's
// blocks from the row pass's weights and coefficients.
struct StatArgs {
  const float* wgt;   // (C, N): chain c's Sigma weights at wgt + c * N
  const float* coef;  // (C, N): its b coefficients
  float* part;        // (S, T, C) tiles of BK x BK
  float* bpart;       // (S, C, Kp): b's blocks
  int64_t N, rows_per_split;
  int K, Kp, ntiles, C, nsplits;
  WinArgs win;        // WIN: the window's tile table (ntiles = win.ntw)
};

// Grid = (S row splits) x (T tiles) x (C chains), chain fastest, then
// tile. TRI (WIN false): the lower triangle in tri_ij order, b's block q
// on the diagonal tile (q, q); WIN: the table's (i, j, bmode).
template <class Copy, bool WIN, typename T>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    stat_tiles(const T* __restrict__ X, const StatArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = (int)(blockIdx.x % a.C);
  const int tt = (int)((blockIdx.x / a.C) % a.ntiles);
  const int64_t s = blockIdx.x / ((int64_t)a.C * a.ntiles);
  int bi, bj, bmode;
  if (WIN) {
    bi = a.win.tab[3 * tt];
    bj = a.win.tab[3 * tt + 1];
    bmode = a.win.tab[3 * tt + 2];
  } else {
    tri_ij(tt, bi, bj);
    bmode = bi == bj ? 1 : 0;
  }
  const int64_t r_begin = s * a.rows_per_split;
  const Tile t{a.N, min64(a.N, r_begin + a.rows_per_split), a.K, bi * BK,
               bj * BK, bi == bj};
  Copy cp(X, a.wgt + (int64_t)c * a.N, smem, a.coef + (int64_t)c * a.N);
  const float bacc = tile_pass<FLUSH_STAGES>(
      cp, t, r_begin,
      StoreTile{a.part + ((s * a.ntiles + tt) * a.C + c) * BK * BK}, bmode);
  if (bmode != 0 && threadIdx.x < BK)
    a.bpart[(s * a.C + c) * a.Kp + (int64_t)(bmode == 1 ? bj : bi) * BK +
            threadIdx.x] = bacc;
}

template <bool WIN, class Copy, typename T>
cudaError_t launch_stat_one(const T* X, const StatArgs& a,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stat_tiles<Copy, WIN, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Copy::SMEM);
  if (err != cudaSuccess) return err;
  stat_tiles<Copy, WIN, T>
      <<<(unsigned)((int64_t)a.nsplits * a.ntiles * a.C), TILE_THREADS,
         Copy::SMEM, stream>>>(X, a);
  return cudaGetLastError();
}

// Launch stat_tiles for X on copy path ``path``.
template <bool WIN>
cudaError_t launch_stats(const void* X, int path, const StatArgs& a,
                         cudaStream_t stream) {
  if (path == BF16)
    return launch_stat_one<WIN, CopyBf16<2>>(
        static_cast<const __nv_bfloat16*>(X), a, stream);
  const float* Xf = static_cast<const float*>(X);
  if (path == F32_16B)
    return launch_stat_one<WIN, CopyF32<4, 2>>(Xf, a, stream);
  return launch_stat_one<WIN, CopyF32<1, 2>>(Xf, a, stream);
}

template <bool WIN>
cudaError_t stat_occupancy(int path, int* smem, int* ctas) {
  if (path == BF16)
    return occupancy_of<CopyBf16<2>>(
        stat_tiles<CopyBf16<2>, WIN, __nv_bfloat16>, smem, ctas);
  if (path == F32_16B)
    return occupancy_of<CopyF32<4, 2>>(stat_tiles<CopyF32<4, 2>, WIN, float>,
                                       smem, ctas);
  return occupancy_of<CopyF32<1, 2>>(stat_tiles<CopyF32<1, 2>, WIN, float>,
                                     smem, ctas);
}

}  // namespace gp
}  // namespace rt
