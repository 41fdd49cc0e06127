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
// Kernels, launched in this order on the caller's stream:
//   bwd_delta: delta = rowsum(dO * O) in float32, a warp per row;
//   bwd_split (float32 route): lo = x - hi of q, dO, k and v, where hi
//     is x with its low 13 mantissa bits cleared, the tf32 value the
//     tensor cores read from x itself (a tf32 operand is the top 19 bits
//     of each 32-bit word), so x stands for its own hi and only lo is
//     copied;
//   bwd_transpose: Q^T, dO^T and K^T, [heads][D][rows]: wgmma reads a
//     float32 (tf32) operand K-major only (the descriptor's transpose bit
//     is for 16-bit types), and three of the five products contract over
//     rows, which run across the [B, H, T, D] layout; the bf16 route uses
//     the same copies, so both routes share one kernel;
//   flash_bwd_kernel<KV_ROWS = true>, dK and dV: a block per (b, KV head,
//     64-row KV tile, half of the head dim at D 256) loops over the G query
//     heads and the query tiles that can see its rows (skipped by the
//     causal and window bounds, as K6 skips them) and computes S^T = K Q^T
//     and dP^T = V dO^T with the KV tile as wgmma's M, then P^T and dX^T in
//     the accumulator layout, fed from registers to dV += P^T dO and
//     dK += dX^T Q;
//   flash_bwd_kernel<KV_ROWS = false>, dQ: a block per (b, query head,
//     64-row query tile) loops over the KV tiles its rows can see and
//     computes S = Q K^T, dP = dO V^T and dQ += dX K.
// That is 7 products of T x S x D per query head where the backward needs
// 5 (S and dP are computed by both kernels), and 9 at D 256, where the two
// float32 accumulators of dK and dV (2 x 128 registers a thread) do not
// fit in one warpgroup, so each half of the head dim is a block of its
// own and recomputes S and dP (128-row KV tiles over two consumer
// warpgroups would not recompute them, but would halve the blocks at
// T 4096 and leave no warpgroup to overlap exp with the products).  The
// split is the design because it was measured against the one that saves
// the two products: the dK/dV kernel also writing each KV tile's share of
// dQ to float32 partials, which a second pass adds in KV-tile order.  On
// an H100 that design was level with the split in float32 and slower in
// bf16 at gemma2-2b's training layer and minitron-4b's heads: reading the
// partials back (a float32 per head dim for every 64 visible pairs,
// 1.09 GB at T 4096, D 256, causal) costs about what the split's dQ
// kernel does (PERF.md).  An ordered accumulation into one float32 dQ (a
// block waiting on a per-query-tile counter before its add) saves that
// traffic but chains the KV tiles of a head: under a causal mask every
// block of a head would wait as long as its longest one.
// Each element of dQ, dK and dV is summed in a fixed order by one thread
// of one block, with no atomics, so two calls give the same bits.
// Left for later (ROADMAP.md): a producer warp feeding the rings by TMA
// (its setmaxnreg split would leave the consumers 240 registers, where the
// dK/dV kernel already spills at 255, tools/k6b_ptxas.py); each 64-row
// block streams every column tile its rows see from L2.
//
// The split operands, the transpose pre-pass's tile, the unit ring and its
// cp.async loaders are flash_tf32.cuh's, shared with K6's float32 route.
// Both main kernels run one code path, templated on the element type:
//   bf16: the operands bf16, products accumulated in float32; P and dX
//     rounded to bf16 for their products (as K6's forward rounds P); dK, dV
//     and dQ accumulated in float32 over every query head and tile and
//     rounded once;
//   float32 (split-TF32): x = hi + lo with hi = tf32(x), and a product is
//     hi.hi + hi.lo + lo.hi on the tf32 tensor cores (m64nNk8): about
//     float32's accuracy, where one tf32 pass keeps about three digits.
//     In memory the hi operand is x itself (the tensor cores read only
//     its top 19 bits; on an H100 that gave the same bits as a copy with
//     the low 13 cleared), and lo = x - hi a copy; in registers both are
//     made from x (split4).
// A block is two warpgroups over one copy of its own rows (the KV tile, or
// the query tile, loaded once into shared memory): warpgroup w takes steps
// w, w + 2, ... of the block's loop, each with its own ring of units, so
// one warpgroup's exp and tanh overlap the other's products (one
// warpgroup alone leaves the tensor cores idle while it computes them); at
// the end warpgroup 1 hands its sums to warpgroup 0 through shared memory,
// which adds them in that fixed order.  The other side streams through
// each ring (2 to 6 units of 16 KB, as shared memory allows) by cp.async,
// zero-filled past the last row: a unit is a 128-byte slice of the head
// dim of the two score operands (in float32, each and its lo copy), or a
// [64 dims][128 bytes] tile of one transposed operand, and a step's lse
// and delta ride with its last slice.
// bf16 reads both score operands from shared memory (wgmma SS); float32
// reads the block's own rows into registers, splits them there and takes
// the register-A form.  The second products take P and dX from the
// accumulator registers as wgmma's A: in bf16 as K6 packs P; in tf32 the
// fragment wants columns t and t + 4 of each 8 where a thread holds 2t and
// 2t + 1, so bwd_transpose stores the rows of each group of 8 in the order
// (0, 2, 4, 6, 1, 3, 5, 7), which the contraction does not see.  A unit's
// products are waited for before its slot is refilled, and each unit's
// second product starts from zero and is added to its sum in float32
// registers: the tensor cores truncate a product's terms to the largest
// one's exponent, and over 4096 rows that bias alone put the float32
// route's dV outside FLASH_BWD_TOL (chip_smoke.py).  The exp runs in base
// 2 (ex2.approx) and tanh as 1 - 2 / (1 + e^2y), within a few float32
// ulps, cheaper than libm's tanhf and expf.
// Tiles: 64 rows (wgmma's M) by 64 columns in bf16 and 32 in float32 (128
// bytes either way, one 128-byte swizzle atom, so K-major tiles need no
// other layout).
//
// Bound on the H100: operations, in the unit the route runs on: the 5
// products of the backward over the visible pairs, 10 B Hq D pairs
// operations, at 989 TFLOP/s (bf16) or three times them at 495 TFLOP/s
// (split-TF32), against reading q, k, v, o, dO and writing dq, dk, dv
// once: at gemma2-2b's training layer (T 4096, D 256) about 1000
// operations per byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_tf32.cuh"

namespace {

constexpr int kStat = 512;           // a step's lse and delta, 2 x 64 floats

struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kBytes = 2, kCopies = 1, kBN = 64, kK = 16;
};
struct Tf32x3 {
  using T = float;
  static constexpr int kBytes = 4, kCopies = 2, kBN = 32, kK = 8;
};

template <typename E, int DP, bool KV_ROWS>
struct Cfg {
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

// The query tiles of BN columns that KV tile j (rows 64 j..) has a visible
// pair with: tiles t_lo .. t_lo + n_t - 1 (query rows q >= kv when causal,
// q < kv + window)
__device__ __forceinline__ void kv_tile_cols(int j, int nk, int nq,
                                             int causal, int window, int BN,
                                             int& t_lo, int& n_t) {
  const int row0 = j * kBM;
  const int row_last = (row0 + kBM < nk ? row0 + kBM : nk) - 1;
  const int c_lo = causal ? row0 : 0;
  const int c_hi = window > 0 && row_last + window < nq ? row_last + window
                                                        : nq;
  t_lo = c_lo / BN;
  n_t = c_hi > c_lo ? (c_hi + BN - 1) / BN - t_lo : 0;
}

template <typename E, int DP, bool KV_ROWS>
__global__ void __launch_bounds__(kWG * kThreads, 1)
flash_bwd_kernel(const BwdArgs a) {
  using C = Cfg<E, DP, KV_ROWS>;
  constexpr int STAGES = C::STAGES;
  constexpr int BN = C::BN, NCB = C::NCB, NA = C::NA;
  constexpr int NACC = KV_ROWS ? 2 : 1;          // acc tiles per 64 dims
  constexpr int UPS = NCB + NA * NACC;           // units per step
  constexpr int ESZ = E::kBytes;
  constexpr bool BF16 = E::kCopies == 1;

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
    kv_tile_cols(blockIdx.x, a.nk, a.nq, a.causal, a.window, BN, t_lo, n_t);
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
      if constexpr (BF16) {
        fence_regs(sacc);
        fence_regs(pacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRow / 32; ++kk) {
          const int first = cb == 0 && kk == 0 ? 0 : 1;
          const uint32_t off = kk * 32;
          Wgmma<64>::ss_k(sacc, sw128_desc(sA1 + cb * C::TILE + off, 16, 1024),
                          sw128_desc(slot + off, 16, 1024), first);
          Wgmma<64>::ss_k(pacc, sw128_desc(sA2 + cb * C::TILE + off, 16, 1024),
                          sw128_desc(slot + BN * kRow + off, 16, 1024),
                          first);
        }
      } else {
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

    // x (dX or P) as wgmma's A operand
    constexpr int NK = BN / E::kK;   // k steps over the tile's columns
    auto frags = [&](const float (&x)[BN / 2], uint32_t (&h)[NK][4],
                     uint32_t (&l)[NK][4]) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if constexpr (BF16) {
          // K6's packing: (lr0, 16 kk + 2t..), (lr1, ..), (lr0, +8),
          // (lr1, +8)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int j = 2 * kk + h2;
            h[kk][2 * h2] = pack_bf16(x[4 * j], x[4 * j + 1]);
            h[kk][2 * h2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
          }
        } else {
          // tf32 slots (lr0, t), (lr1, t), (lr0, t + 4), (lr1, t + 4) take
          // columns 2t, 2t, 2t + 1, 2t + 1: the transposed copies hold
          // their rows in that order
          const float x4[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1],
                               x[4 * kk + 3]};
          split4(x4, h[kk], l[kk]);
        }
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
        if constexpr (BF16) {
          Wgmma<64>::rs_k(part, ah[kk], bh, kk > 0);
        } else {
          const uint64_t bl = sw128_desc(slot + C::TILE + kk * 32, 16, 1024);
          WgmmaTf32<64>::rs(part, al[kk], bh, kk > 0);
          WgmmaTf32<64>::rs(part, ah[kk], bl, 1);
          WgmmaTf32<64>::rs(part, ah[kk], bh, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
      ++u;
    };
    // acc2 += dX T1, then (KV_ROWS) acc1 += P T2, 64 dims a unit.  The
    // float32 fragments of P are made after dX's are used, so one set of
    // 32 registers lives at a time (bf16 packs P at once: 16 registers,
    // where keeping P would hold 32)
    uint32_t xh[NK][4], xl[NK][4], ph[NK][4], pl[NK][4];
    frags(pacc, xh, xl);
    if constexpr (BF16 && KV_ROWS) frags(sacc, ph, pl);
#pragma unroll
    for (int at = 0; at < NA; ++at) accumulate(acc2[at], xh, xl);
    if constexpr (KV_ROWS) {
      if constexpr (!BF16) frags(sacc, ph, pl);
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
  using T = typename E::T;
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
          static_cast<T*>(a.out1)[o] =
              T(acc1[at][i] + red[(32 * (NA + at) + i) * kThreads + tid]);
        }
        static_cast<T*>(a.out2)[o] =
            T((acc2[at][i] + red[(32 * at + i) * kThreads + tid]) * a.scale);
      }
}

// delta[row] = sum_d dO[row][d] O[row][d] in float32, a warp per row
template <typename T>
__global__ void bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, long long rows, int DP) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < DP; d += 32)
    acc = fmaf(float(dout[row * DP + d]), float(o[row * DP + d]), acc);
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

// out [heads][DP][rows_p] = x [heads][rows][DP] transposed, zeros past
// `rows`; with SPLIT, also the tf32 lo copy (out0 is tf32's hi), the rows
// of each group of 8 stored in the order (0, 2, 4, 6, 1, 3, 5, 7)
template <typename T, bool SPLIT>
__global__ void bwd_transpose(const T* __restrict__ x, T* __restrict__ out0,
                              T* __restrict__ out1, int rows, int rows_p,
                              int DP) {
  transpose_tile<T, SPLIT>(x, out0, out1, rows, rows_p, DP);
}

// Byte offsets of the workspace's parts, each 256-byte aligned.
struct Work {
  long long delta, split[4], tq[2], tdo[2], tk[2], total;
  Work(int B, int Hq, int Hkv, int T, int S, int DP, bool bf16) {
    const int esz = bf16 ? 2 : 4, copies = bf16 ? 1 : 2;
    long long at = 0;
    auto take = [&](long long bytes) {
      const long long p = at;
      at += (bytes + 255) / 256 * 256;
      return p;
    };
    delta = take(4LL * B * Hq * T);
    const long long q_el = (long long)B * Hq * T * DP;
    const long long k_el = (long long)B * Hkv * S * DP;
    for (int i = 0; i < 4; ++i)   // lo of q, dO, k, v
      split[i] = bf16 ? -1 : take(4 * (i < 2 ? q_el : k_el));
    const long long tq_el = (long long)B * Hq * DP * round_up(T, 64);
    const long long tk_el = (long long)B * Hkv * DP * round_up(S, 64);
    for (int c = 0; c < 2; ++c) {
      tq[c] = c < copies ? take(esz * tq_el) : -1;
      tdo[c] = c < copies ? take(esz * tq_el) : -1;
      tk[c] = c < copies ? take(esz * tk_el) : -1;
    }
    total = at;
  }
};

template <typename E, int DP, bool KV_ROWS>
int launch_main(const BwdArgs& args, int B, cudaStream_t stream) {
  using C = Cfg<E, DP, KV_ROWS>;
  const auto kernel = flash_bwd_kernel<E, DP, KV_ROWS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int rows = KV_ROWS ? args.nk : args.nq;
  const int heads = KV_ROWS ? args.Hkv : args.Hq;
  const dim3 grid((rows + kBM - 1) / kBM, heads * C::SPLIT, B);
  kernel<<<grid, kWG * kThreads, C::SMEM, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename E, int DP>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* work, void* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int T, int S,
               int D, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  using T_ = typename E::T;
  constexpr bool bf16 = E::kCopies == 1;
  const Work w(B, Hq, Hkv, T, S, DP, bf16);
  char* ws = static_cast<char*>(work);
  float* delta = reinterpret_cast<float*>(ws + w.delta);
  const long long q_rows = (long long)B * Hq * T;
  bwd_delta<T_><<<(unsigned)((q_rows + 7) / 8), 256, 0, stream>>>(
      (const T_*)o, (const T_*)dout, delta, q_rows, DP);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // the streamed score operands: q, dO, k, v themselves (bf16, and
  // tf32's hi) and, in float32, their lo copies
  const void* src[4] = {q, dout, k, v};
  const char* sc[4][2];
  for (int i = 0; i < 4; ++i) {
    sc[i][0] = sc[i][1] = static_cast<const char*>(src[i]);
    if (bf16) continue;
    const long long n = (long long)B * (i < 2 ? Hq * T : Hkv * S) * DP;
    float* lo = reinterpret_cast<float*>(ws + w.split[i]);
    bwd_split<<<(unsigned)min((n + 255) / 256, 4096LL), 256, 0, stream>>>(
        (const float*)src[i], lo, n);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    sc[i][1] = reinterpret_cast<const char*>(lo);
  }

  // Q^T, dO^T and K^T
  const int Tp = round_up(T, 64), Sp = round_up(S, 64);
  const long long toff[3][2] = {{w.tq[0], w.tq[1]}, {w.tdo[0], w.tdo[1]},
                                {w.tk[0], w.tk[1]}};
  const void* tsrc[3] = {q, dout, k};
  const char* tr[3][2];
  for (int i = 0; i < 3; ++i) {
    const int rows = i < 2 ? T : S, rows_p = i < 2 ? Tp : Sp;
    const int heads = B * (i < 2 ? Hq : Hkv);
    T_* o0 = reinterpret_cast<T_*>(ws + toff[i][0]);
    T_* o1 = bf16 ? o0 : reinterpret_cast<T_*>(ws + toff[i][1]);
    const dim3 grid(rows_p / 32, DP / 32, heads), block(32, 8);
    bwd_transpose<T_, !bf16><<<grid, block, 0, stream>>>(
        (const T_*)tsrc[i], o0, o1, rows, rows_p, DP);
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
  if ((e = (cudaError_t)launch_main<E, DP, true>(args, B, stream)) !=
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
  return launch_main<E, DP, false>(args, B, stream);
}

}  // namespace

// Bytes of the workspace mvgc_flash_backward needs (the row statistics,
// the split copies and the transposed operands).
extern "C" long long mvgc_flash_backward_workspace(int B, int Hq, int Hkv,
                                                   int T, int S, int D,
                                                   int is_bf16) {
  return Work(B, Hq, Hkv, T, S, pad_dim(D), is_bf16 != 0).total;
}

// q, o, dout [B, Hq, T, DP]; k, v [B, Hkv, S, DP], contiguous, bf16 or
// float32 (is_bf16), DP = 64, 128 or 256 the head dim D padded with zeros
// (the wrapper pads); lse float32 [B, Hq, T] (K6's); work of
// mvgc_flash_backward_workspace bytes; dq [B, Hq, T, D] and dk, dv
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
#define MVGC_BWD(E, DPV)                                                    \
  return launch_bwd<E, DPV>(q, k, v, o, dout, lse, work, dq, dk, dv, B, Hq, \
                            Hkv, T, S, D, causal, window, softcap, scale,   \
                            stream)
  if (is_bf16) {
    if (DP == 64) MVGC_BWD(Bf16, 64);
    if (DP == 128) MVGC_BWD(Bf16, 128);
    MVGC_BWD(Bf16, 256);
  }
  if (DP == 64) MVGC_BWD(Tf32x3, 64);
  if (DP == 128) MVGC_BWD(Tf32x3, 128);
  MVGC_BWD(Tf32x3, 256);
#undef MVGC_BWD
}
