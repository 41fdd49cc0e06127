// K6b: the gradient of blockwise flash attention (K6) on Hopper's tensor
// cores, with GQA, a sliding window and a tanh logit softcap; a bf16 route
// and a float32 route (split-TF32).
//
// The JAX package has no Pallas kernel for it: JAX differentiates its
// attention (_xla_flash, repro/models/attention.py) by autodiff, with each
// KV block checkpointed so that the backward recomputes the probabilities
// instead of storing them.  This is the same contract by hand: K6 stores
// each row's log-sum-exp (lse, on both of its routes), and the backward
// recomputes P tile by tile from q, k and lse, never holding a [T, S]
// matrix.  With
//   x = scale q.k,  s = cap tanh(x / cap) (s = x without a cap),
//   P = exp(s - lse) (0 where the mask hides the column),
//   delta_i = dO_i . O_i,  dP = dO V^T,  dS = P (dP - delta),
//   dX = dS (1 - tanh^2)  (dX = dS without a cap),
// it returns dV = P^T dO, dQ = scale dX K and dK = scale dX^T Q, where dK
// and dV sum over the G = Hq / Hkv query heads that read each KV head.
//
// Each element of dQ, dK and dV is summed in a fixed order by one thread
// of one block, with no atomics, so two calls give the same bits.  On both
// routes a kernel sums dK and dV over the query heads and query tiles that
// see a KV tile, and another sums dQ over the KV tiles a query tile sees:
// S and dP are computed by both, 7 products of T x S x D per query head
// where the backward needs 5.  A design that saved the two products, the
// dK/dV kernel writing each KV tile's share of dQ to float32 partials that
// a second pass adds in KV-tile order, was level with this split in
// float32 and slower in bf16 on an H100 (PERF.md): reading the partials
// back costs about what the dQ kernel does.  An ordered accumulation into
// one float32 dQ (a block waiting on a per-query-tile counter before its
// add) saves that traffic but chains the KV tiles of a head: under a
// causal mask every block would wait as long as the longest.
//
// bf16 (flash_bwd_dq_bf16, then flash_bwd_dkv_bf16; two launches): the shape
// of K6's wgmma route.  A block is two consumer warpgroups, 256 threads: two
// warps on each of the SM's four schedulers, so ptxas may give each thread
// 255 registers (a producer warp more puts three warps on one scheduler and
// held every thread to 168: the first version of these kernels spilled and
// ran slower than the design they replace).  The first thread of each
// consumer loads, between its own steps, the ring's steps of its parity by
// TMA (cp.async.bulk.tensor, 64 dims x the tile's rows a box, 128-byte
// swizzled, rows past the end zero-filled), each stage's arrival reported to
// an mbarrier that both consumers wait on; both free a stage after their
// last product that reads it.  A TMA issue holds its warpgroup up for
// hundreds of cycles (clock() traces on an H100, PERF.md), so the two share
// the loads and issue them right after their step's products, while the
// tensor cores run.  Every streamed tile is loaded once for both.
//   dQ: a block owns 128 query rows, 64 a consumer (wgmma's M), longest
//     causal rows first, and steps through the KV tiles they see (64 rows,
//     32 at D 256 for shared memory): S = Q K^T and dP = dO V^T with K and
//     V K-major as they lie, then dX in the accumulator layout, packed to
//     bf16 as wgmma's register A (as K6 packs P), and dQ += dX K with K
//     read MN-major through the descriptor's transpose bit: no transposed
//     copy.  It owns every query row, so it also forms each row's delta =
//     rowsum(dO * O) and lse log2(e) and writes them, padded to 128-row
//     multiples with zeros, for the dK/dV kernel, which runs after it.
//   dK/dV: up to D 128 a block owns 128 KV rows, 64 a consumer, and steps
//     through the G query heads and the 64-row query tiles that see them
//     (skipped by the causal and window bounds, as K6 skips them): S^T = K
//     Q^T and dP^T = V dO^T, both operands K-major, then P^T and dX^T in
//     registers, and dV += P^T dO, dK += dX^T Q with dO and Q read MN-major;
//     each step's lse and delta ride with its tiles (two bulk copies).  At
//     D 256 the float32 dK and dV of 64 rows (2 x 128 registers a thread)
//     do not fit one consumer, so the two consumers share 64 KV rows and
//     split the head dim of dK and dV, 128 each: consumer 0 computes S^T,
//     consumer 1 dP^T, each hands its product to the other through shared
//     memory (two barriers a step), and both form P^T and dX^T from the
//     pair, so S and dP are computed once.  On an H100 that ran 1.58x and
//     1.44x faster at gemma2-2b's layers than two blocks a 128-row tile,
//     each summing half the head dim and recomputing S and dP (the earlier
//     design's split); forming P^T and dX^T half each and swapping the
//     halves as bf16 fragments (a third barrier) was 1.27x slower.
//   wgmma stays in flight: S (dQ: and dP) of the next step is issued in the
//   commit group of this step's last gradient product, after a wait for the
//   next tile, so that the tensor cores run them back to back; dP^T is
//   issued at the step's start and P^T formed while it runs, dV issued
//   before dX^T is formed (wgmma.wait_group 1 between).  The two consumers
//   run apart, one's exp and tanh beside the other's products.  Every sum
//   stays in wgmma's float32 accumulators across the steps; P and dX are
//   rounded to bf16 for their products, dK, dV and dQ once at the end.
//   The last step of a loop is peeled off so that no branch sits inside a
//   wgmma stage.
// float32 (split-TF32, flash_bwd_kernel, with flash_tf32.cuh's operands):
//   bwd_delta: delta = rowsum(dO * O) in float32, a warp per row;
//   bwd_split: lo = x - hi of q, dO, k and v, where hi is x with its low 13
//     mantissa bits cleared, the tf32 value the tensor cores read from x
//     itself (a tf32 operand is the top 19 bits of each 32-bit word), so x
//     stands for its own hi and only lo is copied;
//   bwd_transpose: Q^T, dO^T and K^T and their lo copies, [heads][D]
//     [rows]: wgmma reads a tf32 operand K-major only (the descriptor's
//     transpose bit is for 16-bit types), and three of the five products
//     contract over rows, which run across the [B, H, T, D] layout;
//   flash_bwd_kernel<KV_ROWS = true>, dK and dV: a block per (b, KV head,
//     64-row KV tile, half of the head dim at D 256) loops over the G query
//     heads and the query tiles that can see its rows and computes S^T =
//     K Q^T and dP^T = V dO^T with the KV tile as wgmma's M, then P^T and
//     dX^T in the accumulator layout, fed from registers to dV += P^T dO
//     and dK += dX^T Q;
//   flash_bwd_kernel<KV_ROWS = false>, dQ: a block per (b, query head,
//     64-row query tile) loops over the KV tiles its rows can see and
//     computes S = Q K^T, dP = dO V^T and dQ += dX K.
//   At D 256 the two float32 accumulators of dK and dV (2 x 128 registers
//   a thread) do not fit in one warpgroup, so each half of the head dim is
//   a block of its own and recomputes S and dP: 9 products.  x = hi + lo
//   with hi = tf32(x), and a product is hi.hi + hi.lo + lo.hi on the tf32
//   tensor cores (m64nNk8): about float32's accuracy, where one tf32 pass
//   keeps about three digits; in registers both halves are made from x
//   (split4).  A block is two warpgroups over one copy of its own rows
//   (loaded once into shared memory): warpgroup w takes steps w, w + 2,
//   ... of the block's loop, each with its own ring of units, so one
//   warpgroup's exp and tanh overlap the other's products; at the end
//   warpgroup 1 hands its sums to warpgroup 0 through shared memory, which
//   adds them in that fixed order.  The other side streams through each
//   ring (2 to 6 units of 16 KB) by cp.async, zero-filled past the last
//   row: a unit is a 128-byte slice of the head dim of the two score
//   operands, each and its lo copy, or a [64 dims][128 bytes] tile of one
//   transposed operand, and a step's lse and delta ride with its last
//   slice.  The block's rows go into registers, split there, as the
//   register-A form; the second products take P and dX from the
//   accumulator registers as wgmma's A: the fragment wants columns t and
//   t + 4 of each 8 where a thread holds 2t and 2t + 1, so bwd_transpose
//   stores the rows of each group of 8 in the order (0, 2, 4, 6, 1, 3, 5,
//   7), which the contraction does not see.  A unit's products are waited
//   for before its slot is refilled, and each unit's second product starts
//   from zero and is added to its sum in float32 registers: the tensor
//   cores truncate a product's terms to the largest one's exponent, and
//   over 4096 rows that bias alone put dV outside FLASH_BWD_TOL
//   (chip_smoke.py).  Tiles: 64 rows by 32 columns (128 bytes, one 128-byte
//   swizzle atom).
// On both routes the exp runs in base 2 (ex2.approx) and tanh as
// 1 - 2 / (1 + e^2y), within a few float32 ulps, cheaper than libm's.
//
// Bound on the H100: operations, in the unit the route runs on: the 5
// products of the backward over the visible pairs, 10 B Hq D pairs
// operations, at 989 TFLOP/s (bf16) or three times them at 495 TFLOP/s
// (split-TF32), against reading q, k, v, o, dO and writing dq, dk, dv
// once: at gemma2-2b's training layer (T 4096, D 256) about 1000
// operations per byte.  The bf16 route runs 7 products (S and dP in both
// kernels) at 35-40 % of the tensor cores' rate (PERF.md): the first
// bf16 design, 64-row blocks waiting on every 128-byte unit of cp.async
// copies through transposed operands, reached 7-12 % of this bound.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_tf32.cuh"
#include "tma.cuh"

namespace {

constexpr int kStat = 512;           // a step's lse and delta, 2 x 64 floats

struct Tf32x3 {
  static constexpr int kBytes = 4, kCopies = 2, kBN = 32, kK = 8;
};

template <int DP, bool KV_ROWS>
struct Cfg {
  using E = Tf32x3;
  static constexpr int BN = E::kBN;                 // columns of a step
  static constexpr int NCB = DP * E::kBytes / kRow;  // 128-byte head slices
  // dims a block accumulates: all but dK and dV at D 256, two float32
  // accumulators of 128 registers a thread that would not fit together
  static constexpr int DA = KV_ROWS && DP > 128 ? 128 : DP;
  static constexpr int SPLIT = DP / DA;             // blocks per row tile
  static constexpr int NA = DA / 64;                // 64-dim acc tiles
  static constexpr int TILE = kBM * kRow;           // one [64][128 B] tile
  static constexpr int ROWSIDE = 2 * NCB * TILE;    // the block's rows
  // each warpgroup's ring as deep as the rest of the block's shared
  // memory allows
  static constexpr int FIXED = 1024 + ROWSIDE;
  static constexpr int STAGES = ring_stages(FIXED, kUnit + kStat);
  static constexpr int SMEM = FIXED + kWG * STAGES * (kUnit + kStat);
  static_assert(BN * kRow * E::kCopies * 2 <= kUnit, "score unit too big");
  static_assert(kBM * kRow * E::kCopies <= kUnit, "acc unit too big");
  static_assert(STAGES >= 2 && SMEM <= kSmemBlock,
                "shared memory of a block on the H100");
  // the second warpgroup's sums, [values][thread], fit in the rings
  static_assert((KV_ROWS ? 2 : 1) * DA / 2 * kThreads * 4 <=
                    kWG * STAGES * kUnit,
                "no room to add the warpgroups' sums");
};

struct BwdArgs {
  // the block's rows: K and V (KV_ROWS) or Q and dO, [heads][rows][DP]
  const char* a1;
  const char* a2;
  // the streamed score operands, [heads][rows][DP]: x (bf16, or tf32's
  // hi) and its lo copy
  const char* b1[2];
  const char* b2[2];
  // the transposed operands [heads][DP][rows_p]: with P, t2 (dO^T, KV_ROWS
  // only); with dX, t1 (Q^T, or K^T)
  const char* t1[2];
  const char* t2[2];
  const float* lse;     // [B * Hq][nq]
  const float* delta;   // [B * Hq][nq]
  void* out1;           // dV (KV_ROWS only), [heads][rows][D]
  void* out2;           // dK (KV_ROWS) or dQ, [heads][rows][D]
  int Hq, Hkv, nq, nk, nq_p, nk_p, D, causal, window;
  float softcap, scale;
};

// The query tiles of BN columns that KV tile j of `rows` rows (rows
// rows j..) has a visible pair with: tiles t_lo .. t_lo + n_t - 1 (query
// rows q >= kv when causal, q < kv + window)
__device__ __forceinline__ void kv_tile_cols(int j, int rows, int nk, int nq,
                                             int causal, int window, int BN,
                                             int& t_lo, int& n_t) {
  const int row0 = j * rows;
  const int row_last = (row0 + rows < nk ? row0 + rows : nk) - 1;
  const int c_lo = causal ? row0 : 0;
  const int c_hi = window > 0 && row_last + window < nq ? row_last + window
                                                        : nq;
  t_lo = c_lo / BN;
  n_t = c_hi > c_lo ? (c_hi + BN - 1) / BN - t_lo : 0;
}

template <int DP, bool KV_ROWS>
__global__ void __launch_bounds__(kWG * kThreads, 1)
flash_bwd_kernel(const BwdArgs a) {
  using E = Tf32x3;
  using C = Cfg<DP, KV_ROWS>;
  constexpr int STAGES = C::STAGES;
  constexpr int BN = C::BN, NCB = C::NCB, NA = C::NA;
  constexpr int NACC = KV_ROWS ? 2 : 1;          // acc tiles per 64 dims
  constexpr int UPS = NCB + NA * NACC;           // units per step
  constexpr int ESZ = E::kBytes;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sA1 = base, sA2 = base + NCB * C::TILE;
  // [kWG][STAGES] units
  const uint32_t sRings = base + C::ROWSIDE;
  // warpgroup wg takes steps wg, wg + kWG, ... with a ring of its own
  const int wg = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const uint32_t sRing = sRings + wg * STAGES * kUnit;
  // [kWG][STAGES][2][64] floats after the rings
  const uint32_t sStat = sRings + kWG * STAGES * kUnit + wg * STAGES * kStat;

  const int G = a.Hq / a.Hkv;
  const int split = blockIdx.y % C::SPLIT, hy = blockIdx.y / C::SPLIT;
  const int b = blockIdx.z;
  const int d0 = split * C::DA;
  const int n_rows = KV_ROWS ? a.nk : a.nq;      // the block's side
  const int n_cols = KV_ROWS ? a.nq : a.nk;
  const int n_tiles = (n_rows + kBM - 1) / kBM;
  // longest rows first: KV tile 0 sees the most causal rows, query tile
  // n - 1 the most columns
  const int row0 = (KV_ROWS ? (int)blockIdx.x
                            : n_tiles - 1 - (int)blockIdx.x) * kBM;
  const int row_last = min(row0 + kBM, n_rows) - 1;
  const int hk = KV_ROWS ? hy : hy / G;          // KV head
  // the column tiles with a pair some row of this block can see
  int t_lo, n_t;
  if (KV_ROWS) {
    kv_tile_cols(blockIdx.x, kBM, a.nk, a.nq, a.causal, a.window, BN, t_lo,
                 n_t);
  } else {             // KV columns kv <= q (causal), kv > q - window
    const int c_hi = a.causal ? min(n_cols, row_last + 1) : n_cols;
    const int c_lo = a.window > 0 ? max(0, row0 - a.window + 1) : 0;
    t_lo = c_lo / BN;
    n_t = c_hi > c_lo ? (c_hi + BN - 1) / BN - t_lo : 0;
  }
  const int n_steps = KV_ROWS ? G * n_t : n_t;
  const int my_steps = n_steps > wg ? (n_steps - wg + kWG - 1) / kWG : 0;
  const int n_units = my_steps * UPS;

  const long long row_bytes = (long long)DP * ESZ;
  const int rows_p = KV_ROWS ? a.nq_p : a.nk_p;  // transposed copies' rows
  // the block's rows
  const long long own_head = KV_ROWS ? (long long)b * a.Hkv + hk
                                     : (long long)b * a.Hq + hy;
  {
    const char* s1 = a.a1 + own_head * n_rows * row_bytes;
    const char* s2 = a.a2 + own_head * n_rows * row_bytes;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      load_tile<kBM, kWG * kThreads>(sA1 + cb * C::TILE, s1, row_bytes, row0,
                                     n_rows, cb * kRow, threadIdx.x);
      load_tile<kBM, kWG * kThreads>(sA2 + cb * C::TILE, s2, row_bytes, row0,
                                     n_rows, cb * kRow, threadIdx.x);
    }
    cp_async_commit();
  }

  // the head (of the streamed side) and first column of this warpgroup's
  // step i
  auto step_of = [&](int i, long long& head, int& col0) {
    const int s = wg + i * kWG;
    if (KV_ROWS) {
      head = (long long)b * a.Hq + hk * G + s / n_t;
      col0 = (t_lo + s % n_t) * BN;
    } else {
      head = (long long)b * a.Hkv + hk;
      col0 = (t_lo + s) * BN;
    }
  };
  // issues the loads of unit v into its ring slot (nothing past the end)
  auto issue = [&](int v) {
    if (v < n_units) {
      const uint32_t slot = sRing + (v % STAGES) * kUnit;
      long long head;
      int col0;
      step_of(v / UPS, head, col0);
      const int k = v % UPS;
      if (k < NCB) {   // 128 bytes of the head dim of both score operands
#pragma unroll
        for (int c = 0; c < E::kCopies; ++c) {
          load_tile<BN, kThreads>(slot + c * BN * kRow,
                                  a.b1[c] + head * n_cols * row_bytes,
                                  row_bytes, col0, n_cols, k * kRow, tid);
          load_tile<BN, kThreads>(slot + (E::kCopies + c) * BN * kRow,
                                  a.b2[c] + head * n_cols * row_bytes,
                                  row_bytes, col0, n_cols, k * kRow, tid);
        }
        if (KV_ROWS && k == NCB - 1 && tid < 2 * BN) {
          // the step's columns' lse and delta, with its last slice: read
          // after that slice's products, before the slot is refilled
          const int i = tid % BN, q = col0 + i;
          const float* src = tid < BN ? a.lse : a.delta;
          cp_async4(sStat + (v % STAGES) * kStat + (tid < BN ? 0 : 256) +
                        4 * i,
                    src + (q < a.nq ? head * a.nq + q : 0), q < a.nq);
        }
      } else {         // 64 dims x BN columns of a transposed operand
        const int j = k - NCB, at = j % NA;
        const long long tstride = (long long)rows_p * ESZ;
#pragma unroll
        for (int c = 0; c < E::kCopies; ++c) {
          const char* t = (j < NA ? a.t1[c] : a.t2[c]) +
                          head * DP * tstride;
          load_tile<kBM, kThreads>(slot + c * C::TILE, t, tstride,
                                   d0 + 64 * at, DP, col0 * ESZ, tid);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int v = 0; v < STAGES - 1; ++v) issue(v);
  // the block's rows in place for both warpgroups
  cp_async_wait<STAGES - 1>();
  fence_async_smem();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // the thread's tile rows
  const int rA = row0 + lr0, rB = row0 + lr1;    // and their indices

  float sacc[BN / 2], pacc[BN / 2];
  float acc2[NA][32], acc1[KV_ROWS ? NA : 1][32];   // 64 dims a tile
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sacc[i] = pacc[i] = 0.f;
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[at][i] = acc1[KV_ROWS ? at : 0][i] = 0.f;

  // the statistics of the block's rows (query rows only)
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if (!KV_ROWS) {
    const long long hrow = ((long long)b * a.Hq + hy) * a.nq;
    lse_r[0] = rA < a.nq ? a.lse[hrow + rA] * kLog2e : INFINITY;
    lse_r[1] = rB < a.nq ? a.lse[hrow + rB] * kLog2e : INFINITY;
    dl_r[0] = rA < a.nq ? a.delta[hrow + rA] : 0.f;
    dl_r[1] = rB < a.nq ? a.delta[hrow + rB] : 0.f;
  }

  const bool capped = a.softcap > 0.f;
  // 2 y log2(e) for y = x / cap, and the capped logit's factor
  const float tanh_k = capped ? 2.f * kLog2e * a.scale / a.softcap : 0.f;
  const float cap_l2 = a.softcap * kLog2e, scale_l2 = a.scale * kLog2e;
  int u = 0;   // units consumed
  // waits for unit u, then refills the slot unit u - 1 used
  auto begin_unit = [&]() -> uint32_t {
    return ring_begin<STAGES>(sRing, u, 1 + wg, issue);
  };

  for (int s = 0; s < my_steps; ++s) {
    long long head;
    int col0;
    step_of(s, head, col0);

    // S = A1 B1^T and dP = A2 B2^T over the head dim, a slice a unit
#pragma unroll 1
    for (int cb = 0; cb < NCB; ++cb) {
      const uint32_t slot = begin_unit();
      // the block's rows from shared memory into tf32 fragments: rows
      // lr0 and lr1 at dims 8 kk + t and 8 kk + t + 4 of this slice
      uint32_t h1[4][4], l1[4][4], h2[4][4], l2[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float x1[4], x2[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e & 1 ? lr1 : lr0;
          const int chunk = 2 * kk + (e >> 1);
          const uint32_t off = cb * C::TILE + r * kRow +
                               ((chunk ^ (r & 7)) << 4) + t * 4;
          asm volatile("ld.shared.f32 %0, [%1];\n"
                       : "=f"(x1[e]) : "r"(sA1 + off));
          asm volatile("ld.shared.f32 %0, [%1];\n"
                       : "=f"(x2[e]) : "r"(sA2 + off));
        }
        split4(x1, h1[kk], l1[kk]);
        split4(x2, h2[kk], l2[kk]);
      }
      fence_regs(sacc);
      fence_regs(pacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int first = cb == 0 && kk == 0 ? 0 : 1;
        const uint32_t off = kk * 32;
        const uint64_t b1h = sw128_desc(slot + off, 16, 1024);
        const uint64_t b1l = sw128_desc(slot + BN * kRow + off, 16, 1024);
        const uint64_t b2h = sw128_desc(slot + 2 * BN * kRow + off, 16,
                                        1024);
        const uint64_t b2l = sw128_desc(slot + 3 * BN * kRow + off, 16,
                                        1024);
        WgmmaTf32<BN>::rs(sacc, l1[kk], b1h, first);
        WgmmaTf32<BN>::rs(sacc, h1[kk], b1l, 1);
        WgmmaTf32<BN>::rs(sacc, h1[kk], b1h, 1);
        WgmmaTf32<BN>::rs(pacc, l2[kk], b2h, first);
        WgmmaTf32<BN>::rs(pacc, h2[kk], b2l, 1);
        WgmmaTf32<BN>::rs(pacc, h2[kk], b2h, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);
      fence_regs(pacc);
      ++u;
    }

    // P and dX in the accumulator layout: rows lr0 (e < 2) and lr1,
    // columns 8 j + 2 t + (e & 1) of the step's tile.  exp in base 2 from
    // the lse times log2(e); tanh(y) = 1 - 2 / (1 + e^2y), |y| clamped to
    // 15, where tanh is 1 in float32 (both within a few float32 ulps)
    const uint32_t stat = sStat + ((u - 1) % STAGES) * kStat;
    const int q_lo = KV_ROWS ? col0 : row0, q_hi = KV_ROWS ? col0 + BN - 1
                                                           : row0 + kBM - 1;
    const int k_lo = KV_ROWS ? row0 : col0, k_hi = KV_ROWS ? row0 + kBM - 1
                                                           : col0 + BN - 1;
    const bool all_seen = q_hi < a.nq && k_hi < a.nk &&
                          (!a.causal || k_hi <= q_lo) &&
                          (a.window <= 0 || k_lo > q_hi - a.window);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float lse_c[2], dl_c[2];
      if (KV_ROWS) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * j + 2 * t + e;
          asm volatile("ld.shared.f32 %0, [%1];\n"
                       : "=f"(lse_c[e]) : "r"(stat + 4 * i));
          asm volatile("ld.shared.f32 %0, [%1];\n"
                       : "=f"(dl_c[e]) : "r"(stat + 256 + 4 * i));
          lse_c[e] *= kLog2e;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? rA : rB;
        const int c = col0 + 8 * j + 2 * t + (e & 1);
        const int q = KV_ROWS ? c : r, kv = KV_ROWS ? r : c;
        const bool vis = all_seen ||
                         (q < a.nq && kv < a.nk && (!a.causal || kv <= q) &&
                          (a.window <= 0 || kv > q - a.window));
        const float lse2 = KV_ROWS ? lse_c[e & 1] : lse_r[e >> 1];
        const float dl = KV_ROWS ? dl_c[e & 1] : dl_r[e >> 1];
        float x2, dsdx = 1.f;   // the logit times log2(e)
        if (capped) {
          const float y2 = fminf(fmaxf(sacc[4 * j + e] * tanh_k, -43.3f),
                                 43.3f);
          const float th = 1.f - __fdividef(2.f, 1.f + ex2(y2));
          x2 = th * cap_l2;
          dsdx = 1.f - th * th;
        } else {
          x2 = sacc[4 * j + e] * scale_l2;
        }
        const float p = vis ? ex2(x2 - lse2) : 0.f;
        sacc[4 * j + e] = p;
        pacc[4 * j + e] = p * (pacc[4 * j + e] - dl) * dsdx;
      }
    }

    // x (dX or P) as wgmma's A operand: tf32 slots (lr0, t), (lr1, t),
    // (lr0, t + 4), (lr1, t + 4) take columns 2t, 2t, 2t + 1, 2t + 1: the
    // transposed copies hold their rows in that order
    constexpr int NK = BN / E::kK;   // k steps over the tile's columns
    auto frags = [&](const float (&x)[BN / 2], uint32_t (&h)[NK][4],
                     uint32_t (&l)[NK][4]) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const float x4[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1],
                             x[4 * kk + 3]};
        split4(x4, h[kk], l[kk]);
      }
    };

    // acc += A T over 64 dims of the next unit's transposed tile.  The
    // tensor cores sum a product's terms by truncating them to the largest
    // one's exponent, which biases a long sum, so each unit's product
    // starts from zero and is added to acc in float32
    auto accumulate = [&](float (&acc)[32], const uint32_t (&ah)[NK][4],
                          const uint32_t (&al)[NK][4]) {
      const uint32_t slot = begin_unit();
      float part[32];
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint64_t bh = sw128_desc(slot + kk * 32, 16, 1024);
        const uint64_t bl = sw128_desc(slot + C::TILE + kk * 32, 16, 1024);
        WgmmaTf32<64>::rs(part, al[kk], bh, kk > 0);
        WgmmaTf32<64>::rs(part, ah[kk], bl, 1);
        WgmmaTf32<64>::rs(part, ah[kk], bh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
      ++u;
    };
    // acc2 += dX T1, then (KV_ROWS) acc1 += P T2, 64 dims a unit.  The
    // fragments of P are made after dX's are used, so one set of 32
    // registers lives at a time
    uint32_t xh[NK][4], xl[NK][4], ph[NK][4], pl[NK][4];
    frags(pacc, xh, xl);
#pragma unroll
    for (int at = 0; at < NA; ++at) accumulate(acc2[at], xh, xl);
    if constexpr (KV_ROWS) {
      frags(sacc, ph, pl);
#pragma unroll
      for (int at = 0; at < NA; ++at) accumulate(acc1[at], ph, pl);
    }
  }
  cp_async_wait<0>();

  // warpgroup 1 hands its sums to warpgroup 0 through the rings, which
  // adds them to its own (a fixed order) and writes the block's rows:
  // dims d0 + 64 at + 8 j + 2 t (+ 1) of rows rA, rB
  float* red = reinterpret_cast<float*>(smem_raw + (sRings - raw));
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        red[(32 * at + i) * kThreads + tid] = acc2[at][i];
        if constexpr (KV_ROWS)
          red[(32 * (NA + at) + i) * kThreads + tid] = acc1[at][i];
      }
  }
  __syncthreads();
  if (wg == 1) return;
  const long long out_head = own_head * n_rows;
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? rA : rB;
        const int d = d0 + 64 * at + 8 * j + 2 * t + (e & 1);
        const int i = 4 * j + e;
        if (r >= n_rows || d >= a.D) continue;
        const long long o = (out_head + r) * a.D + d;
        if constexpr (KV_ROWS) {
          static_cast<float*>(a.out1)[o] =
              acc1[at][i] + red[(32 * (NA + at) + i) * kThreads + tid];
        }
        static_cast<float*>(a.out2)[o] =
            (acc2[at][i] + red[(32 * at + i) * kThreads + tid]) * a.scale;
      }
}

// delta[row] = sum_d dO[row][d] O[row][d] in float32, a warp per row
__global__ void bwd_delta(const float* __restrict__ o,
                          const float* __restrict__ dout,
                          float* __restrict__ delta, long long rows, int DP) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < DP; d += 32)
    acc = fmaf(dout[row * DP + d], o[row * DP + d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// lo = x - tf32(x), elementwise
__global__ void bwd_split(const float* __restrict__ x, float* __restrict__ lo,
                          long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    lo[i] = tf32_lo(x[i]);
  }
}

// out0 [heads][DP][rows_p] = x [heads][rows][DP] transposed (tf32's hi),
// zeros past `rows`, and out1 its tf32 lo copy, the rows of each group of 8
// stored in the order (0, 2, 4, 6, 1, 3, 5, 7)
__global__ void bwd_transpose(const float* __restrict__ x,
                              float* __restrict__ out0,
                              float* __restrict__ out1, int rows, int rows_p,
                              int DP) {
  transpose_tile(x, out0, out1, rows, rows_p, DP);
}


// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, two consumer warpgroups, one of whose threads loads
// ---------------------------------------------------------------------------
// 256 threads: two warps on each of the SM's four schedulers, whose
// register files then hold up to 255 registers a thread (a producer warp
// more puts three warps on one of them and caps every thread at 168)
constexpr int kBwdThreads = 256;
constexpr int kBars = 8 * 9;       // the mbarriers' bytes (rings of <= 4)
constexpr int kMaxRing = 4;        // ring stages, at most

constexpr int ring_depth(int fixed, int per_stage) {
  return (kSmemBlock - fixed) / per_stage < kMaxRing
             ? (kSmemBlock - fixed) / per_stage
             : kMaxRing;
}

// the rows of the bf16 route's padded statistics, delta and lse log2(e)
// [B * Hq][T_p], zeros past T
int stat_rows(int T) { return round_up(T, 128); }

// The dK/dV kernel at head dim DP.  Up to D 128 a block owns 128 KV rows,
// 64 a consumer, and steps through 64 query rows at a time.  At D 256
// (SHARED) the two consumers share 64 KV rows and split the head dim of dK
// and dV: consumer 0 computes S^T, consumer 1 dP^T, and each hands its
// product to the other through shared memory (XCH).
template <int DP>
struct Dkv {
  static constexpr bool SHARED = DP == 256;
  static constexpr int R = SHARED ? 64 : 128;          // KV rows a block
  static constexpr int BN = 64;                        // query rows a step
  static constexpr int DA = SHARED ? DP / 2 : DP;      // dims a consumer sums
  static constexpr int KV_BYTES = R * DP * 2;          // K or V
  static constexpr int T_BYTES = BN * DP * 2;          // a Q or dO tile
  static constexpr int STAT = 2 * BN * 4;              // a step's lse, delta
  static constexpr int XCH = SHARED ? 2 * (BN / 2) * 128 * 4 : 0;
  static constexpr int FIXED = 1024 + 2 * KV_BYTES + XCH + kBars;
  static constexpr int STAGES = ring_depth(FIXED, 2 * T_BYTES + STAT);
  static constexpr int SMEM = FIXED + STAGES * (2 * T_BYTES + STAT);
  static_assert(STAGES >= 2 && SMEM <= kSmemBlock,
                "shared memory of a block on the H100");
};

// The dQ kernel at head dim DP: a block owns 128 query rows, 64 a
// consumer, and steps through BN KV rows at a time.
template <int DP>
struct Dq {
  static constexpr int BN = DP == 256 ? 32 : 64;       // KV rows a step
  static constexpr int QO_BYTES = 128 * DP * 2;        // Q or dO
  static constexpr int T_BYTES = BN * DP * 2;          // a K or V tile
  static constexpr int FIXED = 1024 + 2 * QO_BYTES + kBars;
  static constexpr int STAGES = ring_depth(FIXED, 2 * T_BYTES);
  static constexpr int SMEM = FIXED + STAGES * 2 * T_BYTES;
  static_assert(STAGES >= 2 && SMEM <= kSmemBlock,
                "shared memory of a block on the H100");
};

struct BwdBf16 {
  const float* lse;             // K6's, [B * Hq][nq]
  const __nv_bfloat16* o;       // [B * Hq][nq][DP]
  const __nv_bfloat16* dout;    // [B * Hq][nq][DP]
  // lse log2(e) and delta = rowsum(dO * O), [B * Hq][nq_p] with zeros past
  // nq: written by the dQ kernel, read by the dK/dV kernel after it
  float* lse2;
  float* delta;
  __nv_bfloat16* out1;   // dV, or dQ, [heads][rows][D]
  __nv_bfloat16* out2;   // dK (the dK/dV kernel), [heads][rows][D]
  int Hq, Hkv, nq, nq_p, nk, D, causal, window;
  float softcap, scale;
};

__device__ __forceinline__ void st_shared(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}
__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}
__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
// a barrier of the block's threads, by id
__device__ __forceinline__ void block_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kBwdThreads) : "memory");
}
// `bytes` from global src to shared dst (both 16-byte aligned, bytes a
// multiple of 16), reported to the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// whether the phase of the given parity has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// The ring's loads, issued between its own steps by the first thread of
// each consumer warpgroup, which loads the steps of its parity (a TMA
// issue holds its warpgroup up for hundreds of cycles, so the two share
// them): step v is loaded into stage v % STAGES once both consumers have
// freed the step before it there (its empty mbarrier's phase), without
// waiting for it.  The consumers wait for a stage's full mbarrier; a
// loader loads while it waits, so a stage freed late is loaded as soon as
// it is free.  A wait of about 10 s traps, as mbar_wait's.
template <int STAGES, typename Load>
struct Ring {
  uint32_t full, empty;   // the mbarriers, 8 bytes a stage
  int n, next;            // steps, the next step this loader loads
  Load& load;
  __device__ __forceinline__ void produce() {
    while (next < n &&
           (next < STAGES ||
            mbar_test(empty + 8 * (next % STAGES), (next / STAGES - 1) & 1))) {
      load(next, full + 8 * (next % STAGES));
      next += 2;
    }
  }
  __device__ __forceinline__ void wait(int i, bool loader) {
    const uint32_t bar = full + 8 * (i % STAGES), parity = (i / STAGES) & 1;
    if (!loader) {
      mbar_wait(bar, parity);
      return;
    }
    const long long t0 = clock64();
    while (!mbar_try_wait(bar, parity)) {
      produce();
      if (clock64() - t0 > (1LL << 34)) __trap();
    }
  }
  __device__ __forceinline__ void release(int i) {
    mbar_arrive(empty + 8 * (i % STAGES));
  }
};

// P = exp(s - lse) of one accumulator element in the log2 domain (s the
// raw logit, 0 where hidden), and g = P (1 - tanh^2) with a cap (CAP; g =
// P without), from which dX = g (dP - delta) once dP is in
struct Grad {
  float tanh_k, cap_l2, scale_l2;
  __device__ __forceinline__ Grad(float softcap, float scale)
      : tanh_k(softcap > 0.f ? 2.f * kLog2e * scale / softcap : 0.f),
        cap_l2(softcap * kLog2e),
        scale_l2(scale * kLog2e) {}
  // tanh(y) = 1 - 2 / (1 + e^2y), |y| clamped to 15, where tanh is 1 in
  // float32 (within a few float32 ulps); ex2.approx for the exp
  template <bool CAP>
  __device__ __forceinline__ void prob(float s, float lse2, bool vis,
                                       float& p, float& g) const {
    if constexpr (CAP) {
      const float y2 = fminf(fmaxf(s * tanh_k, -43.3f), 43.3f);
      const float th = 1.f - __fdividef(2.f, 1.f + ex2(y2));
      p = vis ? ex2(th * cap_l2 - lse2) : 0.f;
      g = p * (1.f - th * th);
    } else {
      p = vis ? ex2(s * scale_l2 - lse2) : 0.f;
      g = p;
    }
  }
};

// The columns one row of the mask sees, [lo, lo + n): one unsigned compare
// a column
struct Seen {
  int lo;
  unsigned n;
  __device__ __forceinline__ Seen(int lo_, int hi)
      : lo(lo_), n(hi > lo_ ? (unsigned)(hi - lo_) : 0u) {}
  __device__ __forceinline__ bool operator()(int c) const {
    return (unsigned)(c - lo) < n;
  }
};

// The accumulator layout of wgmma m64nN (f32): thread t of a warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) at columns 8 j + 2 (t % 4)
// (+ 1) in d[4 j .. 4 j + 3]; as wgmma's register A operand, bf16 pairs
// (row, 16 kk + 2 (t % 4)..), (row + 8, ..), (row, .. + 8), (row + 8, .. + 8)
// for the k16 step kk, the packing of K6's P.
__device__ __forceinline__ void pack_a(uint32_t (&f)[4], int h2,
                                       const float (&x)[4]) {
  f[2 * h2] = pack_bf16(x[0], x[1]);
  f[2 * h2 + 1] = pack_bf16(x[2], x[3]);
}

// x, as a value the compiler cannot know: the shared-memory descriptors of
// a block's own rows, built from it in each step, are then not hoisted out
// of the step loop into registers that the accumulators need
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// dK and dV: a block per (128 KV rows, or 64 SHARED; KV head; batch row)
// loops over the G query heads of its KV head and the query tiles that see
// its rows.  Shared memory: K and V [DP / 64][R][128 B], then the
// ring of Q and dO tiles [DP / 64][BN][128 B] (each 64-dim block one TMA
// box, 128-byte swizzled), the steps' lse log2(e) and delta [BN] each, the
// exchange (SHARED), and the mbarriers full[STAGES], empty[STAGES], kv.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const BwdBf16 a) {
  using C = Dkv<DP>;
  constexpr bool SHARED = C::SHARED;
  constexpr int BN = C::BN, R = C::R, DA = C::DA, STAGES = C::STAGES;
  constexpr int NK = BN / 16;   // k16 steps over a step's query rows
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + C::KV_BYTES;
  const uint32_t sRing = sV + C::KV_BYTES;   // stage s: Q, then dO
  const uint32_t sStat = sRing + STAGES * 2 * C::T_BYTES;
  const uint32_t sXch = sStat + STAGES * C::STAT;
  const uint32_t bar_full = sXch + C::XCH;   // + 8 stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_kv = bar_empty + 8 * STAGES;

  const int G = a.Hq / a.Hkv;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * R;   // tile 0, the most causal rows, first
  int t_lo, n_t;
  kv_tile_cols(blockIdx.x, R, a.nk, a.nq, a.causal, a.window, BN, t_lo, n_t);
  const int n_steps = G * n_t;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kBwdThreads);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step v's query tile and its lse log2(e) and delta into its stage
  auto load = [&](int v, uint32_t full) {
    const int s = v % STAGES;
    const int hq = b * a.Hq + hk * G + v / n_t;
    const int col0 = (t_lo + v % n_t) * BN;
    const uint32_t tq = sRing + s * 2 * C::T_BYTES;
    const uint32_t stat = sStat + s * C::STAT;
    const long long at = (long long)hq * a.nq_p + col0;
    mbar_expect_tx(full, 2 * C::T_BYTES + C::STAT);
    for (int kb = 0; kb < DP / 64; ++kb) {
      tma_load_3d(tq + kb * BN * kRow, &tm_q, full, kb * 64, col0, hq);
      tma_load_3d(tq + C::T_BYTES + kb * BN * kRow, &tm_do, full, kb * 64,
                  col0, hq);
    }
    bulk_load(stat, a.lse2 + at, BN * 4, full);
    bulk_load(stat + BN * 4, a.delta + at, BN * 4, full);
  };
  Ring<STAGES, decltype(load)> ring{bar_full, bar_empty, n_steps,
                                    tid / 128, load};
  const bool loader = tid % 128 == 0;
  if (tid == 0 && n_steps > 0) {
    mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
    for (int kb = 0; kb < DP / 64; ++kb) {
      tma_load_3d(sK + kb * R * kRow, &tm_k, bar_kv, kb * 64, row0,
                  b * a.Hkv + hk);
      tma_load_3d(sV + kb * R * kRow, &tm_v, bar_kv, kb * 64, row0,
                  b * a.Hkv + hk);
    }
  }
  if (loader) ring.produce();

  // consumer c: KV rows crow0.. (its 64, or the shared 64), dims d0..
  // d0 + DA - 1 of dK and dV
  // the consumer, warp-uniform as the compiler sees it (a broadcast), so
  // that the descriptors built from it live in uniform registers
  const int c = __shfl_sync(0xffffffffu, tid / 128, 0), lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, t = lane % 4;
  const int lr0 = warp * 16 + lane / 4;
  const int crow0 = row0 + (SHARED ? 0 : 64 * c);
  const int rA = crow0 + lr0, rB = rA + 8;
  const int d0 = SHARED ? DA * c : 0;
  const uint32_t own = (SHARED ? 0 : 64 * c) * kRow;   // its rows in K, V
  const Grad grad(a.softcap, a.scale);
  const bool capped = a.softcap > 0.f;
  // the query rows q that KV rows rA and rB see: q >= kv (causal), q < kv +
  // window, q < nq
  auto seen_of = [&](int r) {
    return Seen(a.causal ? r : 0,
                r >= a.nk ? 0
                          : a.window > 0 ? min(a.nq, r + a.window) : a.nq);
  };
  const Seen seen[2] = {seen_of(rA), seen_of(rB)};

  // S^T and dP^T (SHARED: this consumer's product in sacc, then S^T in
  // sacc and dP^T in dpv)
  float acc_v[DA / 2], acc_k[DA / 2], sacc[BN / 2],
      pacc[SHARED ? 1 : BN / 2], dpv[SHARED ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < DA / 2; ++i) acc_v[i] = acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (SHARED ? 1 : BN / 2); ++i) pacc[i] = 0.f;

  // S^T = K Q^T (SHARED: consumer 0's S^T, consumer 1's dP^T, into sacc)
  // and dP^T = V dO^T of step i over the head dim, both operands K-major in
  // shared memory
  const uint32_t kv_a = SHARED ? (c == 0 ? sK : sV) : sK + own;
  auto issue_product = [&](float (&acc)[BN / 2], uint32_t ta, uint32_t tb) {
    ta = opaque(ta);
#pragma unroll
    for (int k = 0; k < DP / 16; ++k) {
      const uint32_t off = (k % 4) * 32;   // 16 dims inside a 128 B row
      Wgmma<BN>::ss(acc, sw128_desc(ta + (k / 4) * R * kRow + off, 16, 1024),
                    sw128_desc(tb + (k / 4) * BN * kRow + off, 16, 1024),
                    k > 0);
    }
  };
  auto tile_of = [&](int i) { return sRing + (i % STAGES) * 2 * C::T_BYTES; };
  auto issue_s = [&](int i) {
    issue_product(sacc, kv_a, tile_of(i) + (SHARED ? c * C::T_BYTES : 0));
  };
  // dV += P^T dO or dK += dX^T Q at this consumer's dims, dO and Q read
  // MN-major (the descriptor's transpose bit)
  auto issue_grad = [&](float (&acc)[DA / 2], const uint32_t (&f)[NK][4],
                        uint32_t tile) {
    const uint32_t dims = (d0 / 64) * BN * kRow;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      Wgmma<DA>::rs(acc, f[kk],
                    sw128_desc(tile + dims + kk * 16 * kRow, BN * kRow, 1024));
  };

  // Step i, its S^T issued (with step i - 1's dK): dP^T issued, P^T in
  // registers while it runs (S^T's registers then hold g = P (1 - tanh^2)),
  // dV += P^T dO issued, dX^T = g (dP^T - delta) while that runs, then dK +=
  // dX^T Q and the next step's S^T in one commit group, so that the tensor
  // cores run them back to back (SHARED: the consumers first swap their
  // products, and both form P^T and dX^T whole).  The last step is peeled
  // off (`next` false) so that no branch sits inside a wgmma stage.
  auto step = [&](int i, auto next) {
    constexpr bool NEXT = decltype(next)::value;
    const uint32_t tq = tile_of(i);
    wgmma_wait_all();   // S^T, and step i - 1's dV and dK: its stage is free
    fence_regs(sacc);
    if (i > 0) ring.release(i - 1);
    // a ring of two stages has no step to load until now
    if (loader && STAGES == 2) ring.produce();
    // S^T in sacc, where P^T's g then goes, and dP^T in pacc (SHARED: dpv):
    // the next wgmma reads the registers it overwrites, so a copy would
    // hold 32 more
    if constexpr (SHARED) {
      // [BN / 2][128 threads] floats each: both consumers are past their
      // last read before either writes again
      block_sync(1);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        st_shared(sXch + ((c * (BN / 2) + e) * 128 + lt) * 4, sacc[e]);
      block_sync(2);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const float other =
            ld_shared(sXch + (((1 - c) * (BN / 2) + e) * 128 + lt) * 4);
        dpv[e] = c == 0 ? other : sacc[e];
        sacc[e] = c == 0 ? sacc[e] : other;
      }
    } else {
      fence_regs(pacc);
      wgmma_fence();
      issue_product(pacc, sV + own, tq + C::T_BYTES);
      wgmma_commit();
    }
    const int col0 = (t_lo + i % n_t) * BN + 2 * t;   // this thread's
    const uint32_t stat = sStat + (i % STAGES) * C::STAT + 8 * t;
    uint32_t pf[NK][4], xf[NK][4];
    auto p_pass = [&](auto cap) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 lse2 = ld_shared2(stat + 32 * j);
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          grad.prob<decltype(cap)::value>(
              sacc[4 * j + e], e & 1 ? lse2.y : lse2.x,
              seen[e >> 1](col0 + 8 * j + (e & 1)), pv[e], sacc[4 * j + e]);
        pack_a(pf[j / 2], j % 2, pv);
      }
    };
    if (capped) {
      p_pass(std::true_type{});
    } else {
      p_pass(std::false_type{});
    }
    fence_regs(pf);
    fence_regs(acc_v);
    wgmma_fence();
    issue_grad(acc_v, pf, tq + C::T_BYTES);
    wgmma_commit();
    auto x_pass = [&](const float (&dp)[BN / 2]) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 dl = ld_shared2(stat + 4 * BN + 32 * j);
        float xv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xv[e] = sacc[4 * j + e] * (dp[4 * j + e] - (e & 1 ? dl.y : dl.x));
        pack_a(xf[j / 2], j % 2, xv);
      }
    };
    if constexpr (SHARED) {
      x_pass(dpv);
    } else {
      wgmma_wait<1>();   // dP^T in (dV may run on)
      fence_regs(pacc);
      x_pass(pacc);
    }
    if constexpr (NEXT) ring.wait(i + 1, loader);
    fence_regs(xf);
    fence_regs(acc_k);
    fence_regs(sacc);
    wgmma_fence();
    issue_grad(acc_k, xf, tq);
    if constexpr (NEXT) issue_s(i + 1);
    wgmma_commit();
    // the loads of steps whose stages are free, while the tensor cores run
    if (loader) ring.produce();
  };
  if (n_steps > 0 && crow0 >= a.nk) {
    // no row of this consumer: it frees each stage once it is full
    for (int i = 0; i < n_steps; ++i) {
      ring.wait(i, loader);
      ring.release(i);
    }
  } else if (n_steps > 0) {
    mbar_wait(bar_kv, 0);
    ring.wait(0, loader);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    for (int i = 0; i + 1 < n_steps; ++i) step(i, std::true_type{});
    step(n_steps - 1, std::false_type{});
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
  }

  // rows rA, rB at dims d0 + 8 j + 2 t (+ 1); dK scaled, both rounded once
  const long long head = ((long long)b * a.Hkv + hk) * a.nk;
#pragma unroll
  for (int j = 0; j < DA / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? rA : rB;
      const int d = d0 + 8 * j + 2 * t + (e & 1);
      if (r >= a.nk || d >= a.D) continue;
      const long long o = (head + r) * a.D + d;
      a.out1[o] = __float2bfloat16_rn(acc_v[4 * j + e]);
      a.out2[o] = __float2bfloat16_rn(acc_k[4 * j + e] * a.scale);
    }
}

// dQ: a block per (128 query rows, query head, batch row), longest causal
// rows first, loops over the KV tiles its rows see, after forming its
// rows' delta and lse log2(e) for the dK/dV kernel.  Shared memory: Q and
// dO [DP / 64][128][128 B], then the ring of K and V tiles [DP / 64][BN]
// [128 B], and the mbarriers full[STAGES], empty[STAGES], q.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_do,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const BwdBf16 a) {
  using C = Dq<DP>;
  constexpr int BN = C::BN, STAGES = C::STAGES;
  constexpr int NK = BN / 16;   // k16 steps over a step's KV rows
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sO = sQ + C::QO_BYTES;       // dO
  const uint32_t sRing = sO + C::QO_BYTES;    // stage s: K, then V
  const uint32_t bar_full = sRing + STAGES * 2 * C::T_BYTES;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_q = bar_empty + 8 * STAGES;

  const int n_qt = (a.nq + 127) / 128;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_last = min(q0 + 128, a.nq) - 1;
  // the KV tiles with a column some row of this block can see: kv <= q
  // (causal), kv > q - window
  const int c_hi = a.causal ? min(a.nk, q_last + 1) : a.nk;
  const int c_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_lo = c_lo / BN;
  const int n_t = c_hi > c_lo ? (c_hi + BN - 1) / BN - t_lo : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kBwdThreads);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step v's K and V tiles into its stage
  auto load = [&](int v, uint32_t full) {
    const uint32_t tk = sRing + (v % STAGES) * 2 * C::T_BYTES;
    const int col0 = (t_lo + v) * BN;
    mbar_expect_tx(full, 2 * C::T_BYTES);
    for (int kb = 0; kb < DP / 64; ++kb) {
      tma_load_3d(tk + kb * BN * kRow, &tm_k, full, kb * 64, col0,
                  b * a.Hkv + hk);
      tma_load_3d(tk + C::T_BYTES + kb * BN * kRow, &tm_v, full, kb * 64,
                  col0, b * a.Hkv + hk);
    }
  };
  Ring<STAGES, decltype(load)> ring{bar_full, bar_empty, n_t, tid / 128,
                                    load};
  const bool loader = tid % 128 == 0;
  if (tid == 0 && n_t > 0) {
    mbar_expect_tx(bar_q, 2 * C::QO_BYTES);
    for (int kb = 0; kb < DP / 64; ++kb) {
      tma_load_3d(sQ + kb * 128 * kRow, &tm_q, bar_q, kb * 64, q0,
                  b * a.Hq + h);
      tma_load_3d(sO + kb * 128 * kRow, &tm_do, bar_q, kb * 64, q0,
                  b * a.Hq + h);
    }
  }
  if (loader) ring.produce();

  // consumer c: query rows cq0..cq0 + 63
  // the consumer, warp-uniform as the compiler sees it (a broadcast), so
  // that the descriptors built from it live in uniform registers
  const int c = __shfl_sync(0xffffffffu, tid / 128, 0), lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, t = lane % 4;
  const int lr0 = warp * 16 + lane / 4;
  const int cq0 = q0 + 64 * c;
  const int rA = cq0 + lr0, rB = rA + 8;
  const uint32_t own = 64 * c * kRow;   // its rows in Q, dO
  const Grad grad(a.softcap, a.scale);
  const bool capped = a.softcap > 0.f;
  // the KV rows that query rows rA and rB see: kv <= q (causal), kv > q -
  // window, kv < nk
  auto seen_of = [&](int r) {
    return Seen(a.window > 0 ? max(0, r - a.window + 1) : 0,
                r >= a.nq ? 0 : a.causal ? min(a.nk, r + 1) : a.nk);
  };
  const Seen seen[2] = {seen_of(rA), seen_of(rB)};
  // the rows' lse log2(e) and delta = rowsum(dO * O) (zeros past nq):
  // the four threads of a row take 8 dims of each 32, in float32, and the
  // row's first writes both for the dK/dV kernel
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = rr ? rB : rA;
    const long long row = ((long long)b * a.Hq + h) * a.nq + r;
    float acc = 0.f;
    if (r < a.nq) {
#pragma unroll
      for (int d = 8 * t; d < DP; d += 32) {
        const uint4 x =
            *reinterpret_cast<const uint4*>(a.o + row * DP + d);
        const uint4 y =
            *reinterpret_cast<const uint4*>(a.dout + row * DP + d);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xs[k]));
          const float2 yf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ys[k]));
          acc = fmaf(yf.x, xf.x, acc);
          acc = fmaf(yf.y, xf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    dl_r[rr] = acc + __shfl_xor_sync(0xffffffffu, acc, 2);
    lse_r[rr] = r < a.nq ? a.lse[row] * kLog2e : 0.f;
    if (t == 0) {
      const long long at = ((long long)b * a.Hq + h) * a.nq_p + r;
      a.delta[at] = dl_r[rr];
      a.lse2[at] = lse_r[rr];
    }
  }

  float acc[DP / 2], sacc[BN / 2], pacc[BN / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sacc[i] = pacc[i] = 0.f;

  // S = Q K^T and dP = dO V^T of step i, K-major as they lie, a commit
  // group each
  auto issue_scores = [&](int i) {
    const uint32_t tk = sRing + (i % STAGES) * 2 * C::T_BYTES;
    auto product = [&](float (&acc)[BN / 2], uint32_t ta, uint32_t tb) {
      ta = opaque(ta);
#pragma unroll
      for (int k = 0; k < DP / 16; ++k) {
        const uint32_t off = (k % 4) * 32;
        Wgmma<BN>::ss(acc,
                      sw128_desc(ta + (k / 4) * 128 * kRow + own + off, 16,
                                 1024),
                      sw128_desc(tb + (k / 4) * BN * kRow + off, 16, 1024),
                      k > 0);
      }
    };
    product(sacc, sQ, tk);
    wgmma_commit();
    product(pacc, sO, tk + C::T_BYTES);
    wgmma_commit();
  };
  // Step i, its scores issued: P (S's registers then hold g = P (1 -
  // tanh^2)), then dX = g (dP - delta) once dP is in, and dQ += dX K with
  // K read MN-major and the next step's scores behind it
  auto step = [&](int i, auto next) {
    constexpr bool NEXT = decltype(next)::value;
    wgmma_wait<1>();   // S in, and step i - 1's dQ: its stage is free
    fence_regs(sacc);
    if (i > 0) ring.release(i - 1);
    const int col0 = (t_lo + i) * BN + 2 * t;   // this thread's
    auto p_pass = [&](auto cap) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p;
          grad.prob<decltype(cap)::value>(
              sacc[4 * j + e], lse_r[e >> 1],
              seen[e >> 1](col0 + 8 * j + (e & 1)), p, sacc[4 * j + e]);
        }
    };
    if (capped) {
      p_pass(std::true_type{});
    } else {
      p_pass(std::false_type{});
    }
    wgmma_wait<0>();   // dP in
    fence_regs(pacc);
    uint32_t xf[NK][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float xv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xv[e] = sacc[4 * j + e] * (pacc[4 * j + e] - dl_r[e >> 1]);
      pack_a(xf[j / 2], j % 2, xv);
    }
    if constexpr (NEXT) ring.wait(i + 1, loader);
    fence_regs(xf);
    fence_regs(acc);
    fence_regs(sacc);
    fence_regs(pacc);
    wgmma_fence();
    const uint32_t tk = sRing + (i % STAGES) * 2 * C::T_BYTES;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      Wgmma<DP>::rs(acc, xf[kk],
                    sw128_desc(tk + kk * 16 * kRow, BN * kRow, 1024));
    if constexpr (NEXT) {
      issue_scores(i + 1);
    } else {
      wgmma_commit();
    }
    // the loads of steps whose stages are free, while the tensor cores run
    if (loader) ring.produce();
  };
  if (n_t > 0 && cq0 >= a.nq) {
    // no row of this consumer: it frees each stage once it is full
    for (int i = 0; i < n_t; ++i) {
      ring.wait(i, loader);
      ring.release(i);
    }
  } else if (n_t > 0) {
    mbar_wait(bar_q, 0);
    ring.wait(0, loader);
    wgmma_fence();
    issue_scores(0);
    for (int i = 0; i + 1 < n_t; ++i) step(i, std::true_type{});
    step(n_t - 1, std::false_type{});
    wgmma_wait_all();
    fence_regs(acc);
  }

  const long long head = ((long long)b * a.Hq + h) * a.nq;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? rA : rB;
      const int d = 8 * j + 2 * t + (e & 1);
      if (r >= a.nq || d >= a.D) continue;
      a.out1[(head + r) * a.D + d] =
          __float2bfloat16_rn(acc[4 * j + e] * a.scale);
    }
}

// Byte offsets of the workspace's parts, each 256-byte aligned: delta, and
// (bf16) lse log2(e), both over padded rows, or (float32) the split and
// transposed copies.
struct Work {
  long long delta, lse2, split[4], tq[2], tdo[2], tk[2], total;
  Work(int B, int Hq, int Hkv, int T, int S, int DP, bool bf16) {
    long long at = 0;
    auto take = [&](long long bytes) {
      const long long p = at;
      at += (bytes + 255) / 256 * 256;
      return p;
    };
    delta = take(4LL * B * Hq * (bf16 ? stat_rows(T) : T));
    lse2 = bf16 ? take(4LL * B * Hq * stat_rows(T)) : -1;
    const long long q_el = (long long)B * Hq * T * DP;
    const long long k_el = (long long)B * Hkv * S * DP;
    for (int i = 0; i < 4; ++i)   // lo of q, dO, k, v
      split[i] = bf16 ? -1 : take(4 * (i < 2 ? q_el : k_el));
    const long long tq_el = (long long)B * Hq * DP * round_up(T, 64);
    const long long tk_el = (long long)B * Hkv * DP * round_up(S, 64);
    for (int c = 0; c < 2; ++c) {
      tq[c] = bf16 ? -1 : take(4 * tq_el);
      tdo[c] = bf16 ? -1 : take(4 * tq_el);
      tk[c] = bf16 ? -1 : take(4 * tk_el);
    }
    total = at;
  }
};

template <int DP, bool KV_ROWS>
int launch_main(const BwdArgs& args, int B, cudaStream_t stream) {
  using C = Cfg<DP, KV_ROWS>;
  const auto kernel = flash_bwd_kernel<DP, KV_ROWS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int rows = KV_ROWS ? args.nk : args.nq;
  const int heads = KV_ROWS ? args.Hkv : args.Hq;
  const dim3 grid((rows + kBM - 1) / kBM, heads * C::SPLIT, B);
  kernel<<<grid, kWG * kThreads, C::SMEM, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* work, void* dq,
                   void* dk, void* dv, int B, int Hq, int Hkv, int T, int S,
                   int D, int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const Work w(B, Hq, Hkv, T, S, DP, false);
  char* ws = static_cast<char*>(work);
  float* delta = reinterpret_cast<float*>(ws + w.delta);
  const long long q_rows = (long long)B * Hq * T;
  bwd_delta<<<(unsigned)((q_rows + 7) / 8), 256, 0, stream>>>(
      (const float*)o, (const float*)dout, delta, q_rows, DP);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // the streamed score operands: q, dO, k, v themselves (tf32's hi) and
  // their lo copies
  const void* src[4] = {q, dout, k, v};
  const char* sc[4][2];
  for (int i = 0; i < 4; ++i) {
    sc[i][0] = static_cast<const char*>(src[i]);
    const long long n = (long long)B * (i < 2 ? Hq * T : Hkv * S) * DP;
    float* lo = reinterpret_cast<float*>(ws + w.split[i]);
    bwd_split<<<(unsigned)min((n + 255) / 256, 4096LL), 256, 0, stream>>>(
        (const float*)src[i], lo, n);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    sc[i][1] = reinterpret_cast<const char*>(lo);
  }

  // Q^T, dO^T and K^T, each with its lo copy
  const int Tp = round_up(T, 64), Sp = round_up(S, 64);
  const long long toff[3][2] = {{w.tq[0], w.tq[1]}, {w.tdo[0], w.tdo[1]},
                                {w.tk[0], w.tk[1]}};
  const void* tsrc[3] = {q, dout, k};
  const char* tr[3][2];
  for (int i = 0; i < 3; ++i) {
    const int rows = i < 2 ? T : S, rows_p = i < 2 ? Tp : Sp;
    const int heads = B * (i < 2 ? Hq : Hkv);
    float* o0 = reinterpret_cast<float*>(ws + toff[i][0]);
    float* o1 = reinterpret_cast<float*>(ws + toff[i][1]);
    const dim3 grid(rows_p / 32, DP / 32, heads), block(32, 8);
    bwd_transpose<<<grid, block, 0, stream>>>(
        (const float*)tsrc[i], o0, o1, rows, rows_p, DP);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    tr[i][0] = reinterpret_cast<const char*>(o0);
    tr[i][1] = reinterpret_cast<const char*>(o1);
  }

  BwdArgs args{};
  args.lse = (const float*)lse;
  args.delta = delta;
  args.Hq = Hq;
  args.Hkv = Hkv;
  args.nq = T;
  args.nk = S;
  args.nq_p = Tp;
  args.nk_p = Sp;
  args.D = D;
  args.causal = causal;
  args.window = window;
  args.softcap = softcap;
  args.scale = scale;
  // dK and dV: the KV tile's rows, Q and dO streamed
  args.a1 = static_cast<const char*>(k);
  args.a2 = static_cast<const char*>(v);
  for (int c = 0; c < 2; ++c) {
    args.b1[c] = sc[0][c];
    args.b2[c] = sc[1][c];
    args.t1[c] = tr[0][c];
    args.t2[c] = tr[1][c];
  }
  args.out1 = dv;
  args.out2 = dk;
  if ((e = (cudaError_t)launch_main<DP, true>(args, B, stream)) !=
      cudaSuccess)
    return (int)e;
  // dQ: the query tile's rows, K and V streamed
  args.a1 = static_cast<const char*>(q);
  args.a2 = static_cast<const char*>(dout);
  for (int c = 0; c < 2; ++c) {
    args.b1[c] = sc[2][c];
    args.b2[c] = sc[3][c];
    args.t1[c] = tr[2][c];
    args.t2[c] = nullptr;
  }
  args.out1 = nullptr;
  args.out2 = dq;
  return launch_main<DP, false>(args, B, stream);
}

template <int DP>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* work, void* dq, void* dk, void* dv, int B, int Hq,
                    int Hkv, int T, int S, int D, int causal, int window,
                    float softcap, float scale, cudaStream_t stream) {
  using KV = Dkv<DP>;
  using QR = Dq<DP>;
  const Work w(B, Hq, Hkv, T, S, DP, true);
  char* ws = static_cast<char*>(work);
  // the dQ kernel's maps (its query rows, the streamed KV tiles) and the
  // dK/dV kernel's (its KV rows, the streamed query tiles)
  CUtensorMap q_q, q_do, q_k, q_v, kv_q, kv_do, kv_k, kv_v;
  if (!make_map(&q_q, q, DP, T, B * Hq, 128) ||
      !make_map(&q_do, dout, DP, T, B * Hq, 128) ||
      !make_map(&q_k, k, DP, S, B * Hkv, QR::BN) ||
      !make_map(&q_v, v, DP, S, B * Hkv, QR::BN) ||
      !make_map(&kv_q, q, DP, T, B * Hq, KV::BN) ||
      !make_map(&kv_do, dout, DP, T, B * Hq, KV::BN) ||
      !make_map(&kv_k, k, DP, S, B * Hkv, KV::R) ||
      !make_map(&kv_v, v, DP, S, B * Hkv, KV::R))
    return (int)cudaErrorInvalidValue;
  BwdBf16 args{(const float*)lse, (const __nv_bfloat16*)o,
               (const __nv_bfloat16*)dout,
               reinterpret_cast<float*>(ws + w.lse2),
               reinterpret_cast<float*>(ws + w.delta), (__nv_bfloat16*)dq,
               nullptr, Hq, Hkv, T, stat_rows(T), S, D, causal, window,
               softcap, scale};
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      QR::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_bf16<DP><<<dim3((T + 127) / 128, Hq, B), kBwdThreads, QR::SMEM,
                    stream>>>(q_q, q_do, q_k, q_v, args);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  args.out1 = (__nv_bfloat16*)dv;
  args.out2 = (__nv_bfloat16*)dk;
  const auto dkv = flash_bwd_dkv_bf16<DP>;
  if ((e = cudaFuncSetAttribute(dkv,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                KV::SMEM)) != cudaSuccess)
    return (int)e;
  dkv<<<dim3((S + KV::R - 1) / KV::R, Hkv, B), kBwdThreads,
        KV::SMEM, stream>>>(kv_q, kv_do, kv_k, kv_v, args);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the workspace mvgc_flash_backward needs: the row statistics
// and, in float32, the split copies and the transposed operands.
extern "C" long long mvgc_flash_backward_workspace(int B, int Hq, int Hkv,
                                                   int T, int S, int D,
                                                   int is_bf16) {
  return Work(B, Hq, Hkv, T, S, pad_dim(D), is_bf16 != 0).total;
}

// q, o, dout [B, Hq, T, DP]; k, v [B, Hkv, S, DP], contiguous and 16-byte
// aligned, bf16 or float32 (is_bf16), DP = 64, 128 or 256 the head dim D
// padded with zeros (the wrapper pads); lse float32 [B, Hq, T] (K6's);
// work of mvgc_flash_backward_workspace bytes; dq [B, Hq, T, D] and dk, dv
// [B, Hkv, S, D] in the inputs' dtype, written whole; 0 < D <= 256,
// Hq % Hkv == 0, B, Hq, T, S >= 1 (the wrapper checks all of it); scale is
// 1 / sqrt(D).
extern "C" int mvgc_flash_backward(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* work, void* dq, void* dk, void* dv,
                                   int B, int Hq, int Hkv, int T, int S,
                                   int D, int causal, int window,
                                   float softcap, float scale, int is_bf16,
                                   cudaStream_t stream) {
  if (D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int DP = pad_dim(D);
#define MVGC_BWD(FN, DPV)                                                   \
  return FN<DPV>(q, k, v, o, dout, lse, work, dq, dk, dv, B, Hq, Hkv, T, S, \
                 D, causal, window, softcap, scale, stream)
  if (is_bf16) {
    if (DP == 64) MVGC_BWD(launch_bwd_bf16, 64);
    if (DP == 128) MVGC_BWD(launch_bwd_bf16, 128);
    MVGC_BWD(launch_bwd_bf16, 256);
  }
  if (DP == 64) MVGC_BWD(launch_bwd_f32, 64);
  if (DP == 128) MVGC_BWD(launch_bwd_f32, 128);
  MVGC_BWD(launch_bwd_f32, 256);
#undef MVGC_BWD
}
