// Dual coordinate descent for the L1-loss linear SVM (LibLinear's
// "LL-Dual"): every coordinate of every epoch in one launch of one CTA.
//
// Replaces no Pallas kernel: the reference runs the sweep as one jitted
// lax.scan (repro/baselines/dcd.py, DCDSVM.fit's ``step``). Launched a
// coordinate at a time from Python the port would pay about six launches
// a coordinate, for 7.5 M sequential coordinates at Table 5's protocol.
//
// What bounds it on the H100: the chain. Coordinate i's update needs w
// after coordinate i - 1's, so the sweep is one dependent chain of a dot
// product x_i . w, a clipped scalar update and an axpy w += d x_i. Its
// bytes bound (each row read once an epoch over 3.35 TB/s) is about 1 ns
// a coordinate at K = 801; the chain takes about 0.44 us (some 870
// cycles at 1.98 GHz: the stage's mbarrier wait and release, the row's
// loads and the dot, a five-step butterfly, the IEEE division and
// clamps, the axpy), whether X sits in L2 or not. The design keeps
// everything else off the chain:
//
// Rows streamed ahead. The whole order is known at launch, so a producer
// warp copies rows order[t + 1 ...] into a ring of ``depth`` stages of
// shared memory while the chain works on row order[t]: one bulk copy
// (cp.async.bulk, the TMA's 1-D form) a stage, completing on the stage's
// ``full`` mbarrier; the chain warps arrive on its ``empty`` mbarrier when
// they are done with it. The producer polls ``empty`` (test_wait): a
// producer suspended in try_wait woke too late to keep the ring full, and
// each row then cost the chain about 0.6 us on an H100. The chain itself
// waits in try_wait, which measured faster there than polling. A bulk
// copy wants 16-byte addresses and sizes,
// and at K % 4 != 0 only some rows start on 16 bytes, so a stage receives
// the aligned span that covers the row and the chain reads from the row's
// word offset in it (X is never padded; the span's extra words lie in the
// same 16-byte chunks as the row's own, so they never cross a page).
//
// The scalars. Each chain warp keeps a window of the order in its lanes:
// lane l holds row order[b + l] of the current block of 32 coordinates
// with its y_i, q_ii and alpha_i, the next block's the same, and the
// block after's row index; a block's scalars are loaded a block before
// they are used, so no coordinate waits on a global read. alpha is the
// one state that is read and written: a window's alpha_i may be
// overwritten by a coordinate between its load and its use (at an epoch
// boundary, throughout when N < 64, or when the order names a row twice
// in a row). Every lane of every chain warp forms each coordinate's
// a_new, so each lane records it against its window entries of the same
// row (an override used in place of the loaded value), and the last
// write, which a load may not see yet, is matched against each new
// window. Lane 0 of warp 0 alone writes alpha_i to global memory.
//
// A chain with no barrier. The route by K (kernels/dcd.py's ``plan``):
//   registers (K <= REG_K): each chain lane holds its columns of w and of
//     x_i in registers (LANE_FLOATS buckets of floats a lane); one warp up
//     to ONE_WARP_K columns, a warp group of GROUP_WARPS above;
//   shared (REG_K < K <= SMEM_W_FLOATS): w in shared memory beside the
//     ring, WIDE_WARPS chain warps, the row streamed in pieces of
//     PIECE_FLOATS columns, twice (the dot, then the axpy);
//   global (K > SMEM_W_FLOATS): the same with w in global memory.
// One warp sums its lanes' partials with the xor butterfly, which leaves
// the same bits in every lane, and every lane then forms a_new itself
// with the same rounded intrinsics: no barrier, no shared step slot, no
// broadcast. Several chain warps sum their warps' partials, written to
// double-buffered slots, in warp order after one named barrier over the
// chain's threads (bar.sync 1): coordinate t + 1 writes the other slots,
// and no warp reaches t + 2's slots before every warp has read t's. A
// thread reads and writes only its own columns of w, so the axpy and the
// next dot need no barrier between them.
//
// The clamps are max_nan / min_nan (epilogues.cuh): NaN passes as
// jnp.clip / jnp.maximum pass it. Every operation is a rounded intrinsic
// (no contraction into an FMA), in the reference's order, so a step
// differs from the plain version only by the dot product's summation
// order, which is fixed by K and the plan: two calls give the same bits.
#include <stdint.h>

#include <utility>

#include "common.cuh"
#include "epilogues.cuh"

namespace {

// kernels/dcd.py holds the same values (tests/test_torch_dcd_plan.py
// reads them from here).
constexpr int SMEM_BYTES = 232448;     // shared memory a CTA may use
constexpr int STATIC_BYTES = 1024;     // this kernel's static share, at most
constexpr int MAX_DEPTH = 16;          // ring stages
constexpr int ONE_WARP_K = 1024;       // K one chain warp keeps in registers
constexpr int GROUP_WARPS = 4;         // the chain's warps up to REG_K
constexpr int REG_K = 4096;            // K kept in registers
constexpr int WIDE_WARPS = 8;          // the chain's warps past REG_K
constexpr int PIECE_FLOATS = 4096;     // columns a stage carries past REG_K
constexpr int SMEM_W_FLOATS = 32768;   // K whose w is kept in shared memory
// w's floats a lane holds on the registers route: one kernel each.
constexpr int LANE_FLOATS[] = {1, 2, 4, 8, 12, 16, 20, 24, 28, 32};
constexpr int N_LANE = sizeof(LANE_FLOATS) / sizeof(LANE_FLOATS[0]);

static_assert(ONE_WARP_K == 32 * LANE_FLOATS[N_LANE - 1], "one warp");
static_assert(REG_K == GROUP_WARPS * 32 * LANE_FLOATS[N_LANE - 1], "group");
static_assert(PIECE_FLOATS % (WIDE_WARPS * 32 * 4) == 0, "piece");
static_assert(2 * MAX_DEPTH * 8 + 2 * WIDE_WARPS * 4 <= STATIC_BYTES,
              "static shared memory");

enum Route { REGS = 0, SHARED = 1, GLOBAL = 2 };

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Until the phase of parity ``parity`` has completed (a fresh barrier
// counts the phase before its first as completed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The same, polling: the thread is never suspended, so it sees the phase
// complete within a few cycles (the producer, on a stage's release).
__device__ __forceinline__ void mbar_poll(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// ``bytes`` (a multiple of 16) from 16-byte aligned ``src`` to ``dst``,
// completing on ``bar``, which this thread's arrival also completes.
__device__ __forceinline__ void bulk_load(float* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void chain_barrier(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ int order_at(const int32_t* __restrict__ order,
                                        int64_t u, int64_t steps) {
  return u < steps ? __ldg(order + u) : -1;
}

// The producer: one warp walks the order and keeps the ring full. Lane l
// holds order[b + l] of the block of 32 coordinates at hand and of the
// next; lane 0 issues the copies.
template <int ROUTE>
__device__ __forceinline__ void produce(
    const float* __restrict__ X, const int32_t* __restrict__ order,
    int64_t steps, int K, float* ring, int stage_floats, int depth,
    uint64_t* full, uint64_t* empty, int lane) {
  const uintptr_t xp = reinterpret_cast<uintptr_t>(X);
  const char* xa = reinterpret_cast<const char*>(xp & ~uintptr_t(15));
  const int64_t x0 = (int64_t)((xp & 15) >> 2);  // X[0]'s word in its chunk
  const int width = ROUTE == REGS ? K : PIECE_FLOATS;
  const int pieces = (K + width - 1) / width;
  const int passes = ROUTE == REGS ? 1 : 2;
  int cur = order_at(order, lane, steps);
  int nxt = order_at(order, 32 + lane, steps);
  int stage = 0;
  uint32_t phase = 0;
  for (int64_t t = 0; t < steps; ++t) {
    if ((t & 31) == 0 && t > 0) {
      cur = nxt;
      nxt = order_at(order, t + 32 + lane, steps);
    }
    const int i = __shfl_sync(FULL_MASK, cur, (int)(t & 31));
    if (lane == 0) {
      const int64_t row = x0 + (int64_t)i * K;
      for (int pass = 0; pass < passes; ++pass)
        for (int p = 0; p < pieces; ++p) {
          const int64_t a = row + (int64_t)p * width;
          const int len = min(width, K - p * width);
          const int64_t s0 = a & ~int64_t(3);
          const uint32_t bytes =
              (uint32_t)((((a + len + 3) & ~int64_t(3)) - s0) * 4);
          mbar_poll(empty + stage, phase ^ 1);
          bulk_load(ring + (size_t)stage * stage_floats, xa + s0 * 4, bytes,
                    full + stage);
          if (++stage == depth) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    __syncwarp();
  }
}

// The chain: CW warps (threads 0 .. 32 CW - 1). NW: w's floats a lane
// holds on the registers route (lane's columns (c CW + warp) 32 + lane).
template <int ROUTE, int CW, int NW>
__device__ __forceinline__ void chain(
    const float* __restrict__ X, const float* __restrict__ y,
    const float* __restrict__ qdiag, const int32_t* __restrict__ order,
    int64_t steps, float C, int K, const float* ring, int stage_floats,
    int depth, float* wsm, uint64_t* full, uint64_t* empty,
    float (*part)[CW], float* __restrict__ w_out, float* alpha, int tid) {
  constexpr int T = CW * 32;
  const int lane = tid & 31, warp = CW == 1 ? 0 : tid >> 5;
  const int64_t x0 = (int64_t)((reinterpret_cast<uintptr_t>(X) & 15) >> 2);
  const int pieces = (K + PIECE_FLOATS - 1) / PIECE_FLOATS;
  float wr[NW > 0 ? NW : 1], xr[NW > 0 ? NW : 1];
  float* ws = ROUTE == SHARED ? wsm : w_out;
  if constexpr (ROUTE == REGS) {
#pragma unroll
    for (int c = 0; c < NW; ++c) wr[c] = 0.f;
  } else {
    for (int j = tid; j < K; j += T) ws[j] = 0.f;
  }

  // The window: current block (c), next block (n), the block after (2).
  int ic = order_at(order, lane, steps), in = order_at(order, 32 + lane,
                                                       steps);
  int i2 = order_at(order, 64 + lane, steps);
  float yc = 0.f, qc = 0.f, ac = 0.f, oc = 0.f;
  float yn = 0.f, qn = 0.f, an = 0.f, on = 0.f;
  bool hc = false, hn = false;
  if (ic >= 0) yc = __ldg(y + ic), qc = __ldg(qdiag + ic), ac = alpha[ic];
  if (in >= 0) yn = __ldg(y + in), qn = __ldg(qdiag + in), an = alpha[in];
  int ilast = -1;
  float alast = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  auto next_stage = [&]() {
    if (++stage == depth) {
      stage = 0;
      phase ^= 1;
    }
  };
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);
    next_stage();
  };

  for (int64_t t = 0; t < steps; ++t) {
    const int src = (int)(t & 31);
    if (src == 0 && t > 0) {
      // every write before the last is visible after this warp's sync
      // (one warp) or the chain barrier of the last coordinate (several)
      __syncwarp();
      ic = in, yc = yn, qc = qn, ac = an, hc = hn, oc = on;
      in = i2;
      if (in >= 0)
        yn = __ldg(y + in), qn = __ldg(qdiag + in), an = alpha[in];
      hn = in >= 0 && in == ilast;
      on = alast;
      i2 = order_at(order, t + 64 + lane, steps);
    }
    const int i = __shfl_sync(FULL_MASK, ic, src);
    const float yi = __shfl_sync(FULL_MASK, yc, src);
    const float qi = __shfl_sync(FULL_MASK, qc, src);
    const float ai = __shfl_sync(FULL_MASK, hc ? oc : ac, src);
    const int off = (int)((x0 + (int64_t)i * K) & 3);

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (ROUTE == REGS) {
      mbar_wait(full + stage, phase);
      const float* xs = ring + (size_t)stage * stage_floats + off;
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        const int col = (c * CW + warp) * 32 + lane;
        xr[c] = col < K ? xs[col] : 0.f;
      }
      release();
#pragma unroll
      for (int c = 0; c < NW; ++c)
        acc[c & 3] = fmaf(xr[c], wr[c], acc[c & 3]);
    } else {
      for (int p = 0; p < pieces; ++p) {
        mbar_wait(full + stage, phase);
        const float* xs = ring + (size_t)stage * stage_floats + off;
        const int c0 = p * PIECE_FLOATS;
#pragma unroll
        for (int m = 0; m < PIECE_FLOATS / T; ++m) {
          const int j = tid + m * T, col = c0 + j;
          if (col < K) acc[m & 3] = fmaf(xs[j], ws[col], acc[m & 3]);
        }
        release();
      }
    }
    float s = rt::warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
    if constexpr (CW > 1) {
      float* slot = part[t & 1];
      if (lane == 0) slot[warp] = s;
      chain_barrier(T);
      s = slot[0];
#pragma unroll
      for (int v = 1; v < CW; ++v) s += slot[v];
    }

    const float G = __fsub_rn(__fmul_rn(yi, s), 1.0f);
    const float q = rt::max_nan(qi, 1e-12f);
    const float a_new =
        rt::min_nan(rt::max_nan(__fsub_rn(ai, __fdiv_rn(G, q)), 0.0f), C);
    const float d = __fmul_rn(__fsub_rn(a_new, ai), yi);
    if (tid == 0) alpha[i] = a_new;
    if (ic == i) hc = true, oc = a_new;
    if (in == i) hn = true, on = a_new;
    ilast = i;
    alast = a_new;

    if constexpr (ROUTE == REGS) {
#pragma unroll
      for (int c = 0; c < NW; ++c)
        wr[c] = __fadd_rn(wr[c], __fmul_rn(d, xr[c]));
    } else {
      for (int p = 0; p < pieces; ++p) {
        mbar_wait(full + stage, phase);
        const float* xs = ring + (size_t)stage * stage_floats + off;
        const int c0 = p * PIECE_FLOATS;
#pragma unroll
        for (int m = 0; m < PIECE_FLOATS / T; ++m) {
          const int j = tid + m * T, col = c0 + j;
          if (col < K) ws[col] = __fadd_rn(ws[col], __fmul_rn(d, xs[j]));
        }
        release();
      }
    }
  }

  if constexpr (ROUTE == REGS) {
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      const int col = (c * CW + warp) * 32 + lane;
      if (col < K) w_out[col] = wr[c];
    }
  } else if constexpr (ROUTE == SHARED) {
    for (int j = tid; j < K; j += T) w_out[j] = ws[j];
  }
}

// Dynamic shared memory: the ring (depth stages of stage_floats, each a
// multiple of 16 bytes), then w on the shared route.
template <int ROUTE, int CW, int NW>
__global__ void __launch_bounds__((CW + 1) * 32)
    dcd_sweep_kernel(const float* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ qdiag,
                     const int32_t* __restrict__ order, int64_t steps,
                     float C, int K, int stage_floats, int depth,
                     float* __restrict__ w_out, float* alpha) {
  extern __shared__ __align__(128) float smem[];
  __shared__ uint64_t full[MAX_DEPTH], empty[MAX_DEPTH];
  __shared__ float part[2][CW];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= CW * 32) {
    produce<ROUTE>(X, order, steps, K, smem, stage_floats, depth, full,
                   empty, tid & 31);
    return;
  }
  chain<ROUTE, CW, NW>(X, y, qdiag, order, steps, C, K, smem, stage_floats,
                       depth, smem + (size_t)depth * stage_floats, full,
                       empty, part, w_out, alpha, tid);
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const int32_t*, int64_t, float, int, int, int,
                        float*, float*);

template <int CW, int... I>
Kernel regs_kernel(int nw, std::integer_sequence<int, I...>) {
  Kernel k = nullptr;
  ((k = LANE_FLOATS[I] == nw ? &dcd_sweep_kernel<REGS, CW, LANE_FLOATS[I]>
                             : k),
   ...);
  return k;
}

}  // namespace

// X (N, K) f32 row-major; y, qdiag (N,) f32; order (steps,) int32 row
// indices; alpha (N,) f32, zeros on entry, the duals on return; w (K,) f32
// out. The plan (kernels/dcd.py): ``route`` 0 registers, 1 shared, 2
// global; ``warps`` the chain's warps; ``lane_floats`` a LANE_FLOATS
// bucket (registers route); ``stage_floats`` and ``depth`` the ring.
// Returns the launch's CUDA error, 0 if none (cudaErrorInvalidValue for a
// plan this file does not build or that does not fit).
extern "C" int rt_dcd_sweep(int device, void* stream, const void* X,
                            const void* y, const void* qdiag,
                            const void* order, int64_t steps, float C, int K,
                            void* w, void* alpha, int route, int warps,
                            int lane_floats, int stage_floats, int depth) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int width = route == REGS ? K : PIECE_FLOATS;
  const auto buckets = std::make_integer_sequence<int, N_LANE>{};
  Kernel kern = nullptr;
  if (route == REGS && warps == 1 && K <= 32 * lane_floats)
    kern = regs_kernel<1>(lane_floats, buckets);
  else if (route == REGS && warps == GROUP_WARPS &&
           K <= GROUP_WARPS * 32 * lane_floats)
    kern = regs_kernel<GROUP_WARPS>(lane_floats, buckets);
  else if (route == SHARED && warps == WIDE_WARPS && K <= SMEM_W_FLOATS)
    kern = dcd_sweep_kernel<SHARED, WIDE_WARPS, 0>;
  else if (route == GLOBAL && warps == WIDE_WARPS)
    kern = dcd_sweep_kernel<GLOBAL, WIDE_WARPS, 0>;
  const int64_t smem = (int64_t)depth * stage_floats * 4 +
                       (route == SHARED ? (int64_t)K * 4 : 0);
  if (kern == nullptr || depth < 1 || depth > MAX_DEPTH ||
      stage_floats % 4 != 0 ||
      stage_floats < ((K < width ? K : width) + 6) / 4 * 4 ||
      smem > SMEM_BYTES - STATIC_BYTES)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kern<<<1, (warps + 1) * 32, (size_t)smem, st>>>(
      static_cast<const float*>(X), static_cast<const float*>(y),
      static_cast<const float*>(qdiag), static_cast<const int32_t*>(order),
      steps, C, K, stage_floats, depth, static_cast<float*>(w),
      static_cast<float*>(alpha));
  return (int)cudaGetLastError();
}
