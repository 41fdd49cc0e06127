// Blockwise causal flash attention for prefill, with GQA, a sliding window
// and a tanh logit softcap.
//
// Replaces the Pallas kernel flash_attention_pallas of
// repro/kernels/flash_prefill/kernel.py.  The TPU grid (B, Hq, T/BT, S/BS)
// runs its KV-block dimension in order and carries (m, l, acc) in VMEM
// across it; here a block per (b, query head h, query tile) loops over the
// KV tiles itself and keeps (m, l, acc) in registers.  Query head h reads
// kv head h / G (G = Hq / Hkv), so K/V are never repeated per query head.
// Only the tiles that hold a visible column are loaded: the loop starts at
// the first column inside the window of the tile's first row and stops
// after the last column the causal mask lets its last row see, as pl.when
// skips whole blocks in the Pallas kernel.  A masked logit gives
// probability exactly 0 and a row that sees no column gives 0 (l == 0).
// Every sum runs in a fixed order and no atomics are used, so two calls
// give the same bits.
//
// Bound on the H100: operations.  A causal prefill does about T^2 D
// multiply-adds per query head against 2 (Hq + Hkv) T D elements moved per
// batch row: at the serving shape (T 2048, D 128) about 1000 operations
// per byte, over three times the 295 at which the bf16 tensor cores, not
// device memory, become the limit.  Two kernels, chosen by dtype, both on
// the tensor cores:
//
// bf16: flash_prefill_kernel_wgmma, the FlashAttention-3 shape for Hopper.
//   A block of three warpgroups owns one (b, h) and 128 query rows.
//   Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and one
//   thread issues TMA loads (cp.async.bulk.tensor) of the Q tile and of a
//   ring of K and V tiles (3 stages, 4 at D 256) into 128-byte-swizzled
//   shared memory, each stage's arrival reported to an mbarrier; the
//   consumers free a stage after using it (the TMA and mbarrier helpers
//   are tma.cuh's, shared with K6b's bf16 route).  Warpgroups 1 and 2 are
//   consumers of 64 rows each (wgmma's M): S = Q K^T by wgmma with both
//   operands in shared memory, the masked online softmax in float32
//   registers (the statistics of a row are reduced across the four threads
//   that share it in the accumulator layout), P rounded to bf16 in
//   registers and fed as the register A operand of the P V wgmma, with V
//   read MN-major (the descriptor's transpose bit), O accumulated in
//   float32 registers.  S of the next tile is issued in the same wgmma
//   stage as P V of this one.  l sums P in float32 before the rounding, as
//   FlashAttention does (the TPU kernel keeps P in float32 for the product;
//   FlashAttention and SDPA round it to bf16 as here).  The head dim is
//   padded in shared memory to DP of 64, 128 or 256 by the TMA's zero fill;
//   a KV tile is 96 columns at DP 128, 128 at 64 and 32 at 256, the widths
//   that timed best on the H100 within the registers ptxas gives a thread
//   of this 384-thread block (168, setmaxnreg or not: O alone is DP / 2 of
//   them).  Given an lse pointer (a training step's forward), the epilogue
//   writes each row's log-sum-exp m + log l for K6b: l sums P before its
//   rounding, so it is the LSE of the float32 logits, as the float32
//   route's.  The tensor maps are 3-d (D, rows, B * heads), so rows past S
//   or T load as zeros and never spill into the next head: a weight of 0
//   never meets a NaN, as the TPU kernel's zeroing of padded KV rows
//   ensures.  The row stride must be a multiple of 16 bytes (the wrapper
//   pads D to a multiple of 8).
//
// float32: flash_prefill_kernel_tf32, split-TF32 on wgmma.m64nNk8 tf32
//   (flash_tf32.cuh, shared with K6b's float32 route): x = hi + lo with
//   hi = tf32(x), each product hi.hi + hi.lo + lo.hi, about float32's
//   accuracy.  It replaces the first float32 kernel, on the CUDA cores (a
//   block of 16 x 16 threads computing 4 x 4 outer products from shared
//   memory), which reached 11-36 % of its CUDA-core bound and took 1.40x
//   float32 SDPA at whisper-tiny's encoder.  Bound: the two products three
//   times over at 495 TFLOP/s, 12 B Hq D operations per visible pair, 2.4x
//   below the CUDA cores' 4 at 67 TFLOP/s (launch/roofline.py,
//   flash_prefill_bound).  The shape of K6b's dQ kernel: a block of two
//   warpgroups owns 64 query rows (wgmma's M) of one head, longest causal
//   rows first; the warpgroups take alternate 32-column KV steps (128
//   bytes of float32, one swizzle atom), each with its own (m, l, O) and
//   its own ring of 16 KB cp.async units, so one's exp and tanh overlap the
//   other's products; at the end warpgroup 1 hands its state to warpgroup 0
//   through shared memory, which merges the two in that fixed order (no
//   atomics: two calls give the same bits).  Layouts: both operands of S
//   are K-major as they lie, [rows][D]: Q's 64 rows sit in shared memory
//   for the whole block and are split into registers a slice at a time
//   (the register-A form: an SS product at N 32 would read more shared
//   memory than the tensor cores can use), K and its lo copy stream in
//   128-byte head-dim slices.  P V contracts over KV rows and tf32 has no
//   transpose bit, so V is read from a copy V^T [D][rows] whose rows in
//   each group of 8 are in the order (0, 2, 4, 6, 1, 3, 5, 7): P's
//   accumulator registers are then wgmma's A fragment as they lie, split
//   in registers.  A pre-pass (flash_prefill_split) writes lo(K), V^T and
//   lo(V^T) into the wrapper's workspace; Q's lo is made in registers.
//   The tensor cores sum a product's terms by truncating them to the
//   largest one's exponent, which biases a long sum: each step's P V
//   starts from a zeroed accumulator and is added to O alpha in float32
//   (K6b's dV left its tolerance over 4096 rows without this), hi.hi of
//   S starts from zero in each unit and is added in float32, and the two
//   correction products of S sum in an accumulator of their own.  l sums
//   P before its split, and the exp runs in base 2.  Registers (ptxas,
//   tools/k6b_ptxas.py --source on an H100's toolkit, CUDA 12.8): 255 a
//   thread at D 256, where O alone is 128, with 8 bytes spilled (one score
//   slice a unit there: two slices' split Q fragments, 64 registers, spill
//   more); 247 at D 128 and 186 at D 64, no spills.  Accuracy: at logits
//   of about N(0, 12^2) (tools/time_flash_prefill.py) this kernel is
//   1.1-1.8x the 1e-5 limit from a float64 evaluation, where the float32
//   plain version itself is 2.0x; one accumulator for all of S (a first
//   version) was further off.
//
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_tf32.cuh"
#include "tma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int kTcRows = 128;      // query rows per block: 2 warpgroups x 64
constexpr int kTcThreads = 384;   // producer warpgroup + 2 consumers
// setmaxnreg: 128 x 40 + 256 x 232 = 384 x 168, the launch's registers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSwizzleRow = 128;  // bytes of a swizzled row: 64 bf16

template <int DP>
struct Tc {
  // KV columns a tile (see the note at the top)
  static constexpr int BK = DP == 256 ? 32 : DP == 128 ? 96 : 128;
  static constexpr int STAGES = DP == 256 ? 4 : 3;  // K/V ring depth
  static constexpr int NKB = DP / 64;               // 64-dim column blocks
  static constexpr int Q_BYTES = kTcRows * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;      // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // 1 KB of slack to align the tiles to the 1024-byte swizzle pattern
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);
  static_assert(SMEM <= 232448, "shared memory of a block on the H100");
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
// butterfly: the four lanes of a row end with the same bits
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared memory: Q [NKB][128 rows][128 B], then per stage K and V
// [NKB][BK rows][128 B], each 64-dim column block one TMA box written with
// the 128-byte swizzle; then the mbarriers full[STAGES], empty[STAGES]
// and the Q barrier.  The accumulator layout of wgmma m64nN (f32): thread
// t of a warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) at columns
// 8 j + 2 (t % 4) (+ 1) in d[4 j .. 4 j + 3].
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_prefill_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int Hq, int Hkv, int nq,
                           int nk, int Dp, int causal, int window,
                           float softcap, float scale) {
  using C = Tc<DP>;
  constexpr int BK = C::BK;
  const float kNegInf = -INFINITY;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;                // + stage * KV_BYTES
  const uint32_t sV = sK + C::STAGES * C::KV_BYTES;
  const uint32_t bar_full = sQ + C::BAR_OFF;          // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;  // + 8 * stage
  const uint32_t bar_q = bar_empty + 8 * C::STAGES;

  const int n_t = (nq + kTcRows - 1) / kTcRows;
  const int qt = n_t - 1 - (int)blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kTcRows;
  // the KV tiles with a column some row of this block can see
  int kv_lo = 0, kv_hi = nk;
  if (causal) kv_hi = min(nk, q0 + kTcRows);
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  const int t_lo = kv_lo / BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + BK - 1) / BK - t_lo : 0;

  const int tid = threadIdx.x;
  // the warpgroup, warp-uniform as the compiler sees it (a broadcast), so
  // that each branch runs its setmaxnreg as a whole warpgroup
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int kb = 0; kb < C::NKB; ++kb)
        tma_load_3d(sQ + kb * kTcRows * kSwizzleRow, &tm_q, bar_q, kb * 64,
                    q0, b * Hq + h);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES, r = i / C::STAGES;
        if (r > 0) mbar_wait(bar_empty + 8 * s, (r - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        const int c0 = (t_lo + i) * BK;
        for (int kb = 0; kb < C::NKB; ++kb) {
          const uint32_t off = s * C::KV_BYTES + kb * BK * kSwizzleRow;
          tma_load_3d(sK + off, &tm_k, full, kb * 64, c0, b * Hkv + hk);
          tma_load_3d(sV + off, &tm_v, full, kb * 64, c0, b * Hkv + hk);
        }
      }
    }
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;                      // 0 or 1
  const int lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32;
  const int rw0 = q0 + cw * 64;               // this warpgroup's first row
  const int r0 = rw0 + warp * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);              // its first column in an n8
  const bool capped = softcap > 0.f;
  // logits into the log2 domain: x * sl after the cap
  const float x_scale = capped ? scale / softcap : scale * kLog2e;
  const float sl = capped ? softcap * kLog2e : x_scale;

  float o[DP / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // log2 domain

  // S = Q K^T of tile i into sc (after wait_tile(i))
  const uint32_t a_base = sQ + cw * 64 * kSwizzleRow;
  auto wait_tile = [&](int i) {
    mbar_wait(bar_full + 8 * (i % C::STAGES), (i / C::STAGES) & 1);
  };
  auto issue_s = [&](int i) {
    const uint32_t kt = sK + (i % C::STAGES) * C::KV_BYTES;
#pragma unroll
    for (int k = 0; k < DP / 16; ++k) {
      const uint32_t off = (k % 4) * 32;   // 16 dims inside a 128 B row
      const uint64_t da = sw128_desc(
          a_base + (k / 4) * kTcRows * kSwizzleRow + off, 16, 1024);
      const uint64_t db =
          sw128_desc(kt + (k / 4) * BK * kSwizzleRow + off, 16, 1024);
      Wgmma<BK>::ss(sc, da, db, k > 0);
    }
  };
  if (n_tiles > 0) {
    mbar_wait(bar_q, 0);
    wait_tile(0);
    fence_regs(sc);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
  }
  // Tile i: softmax of S_i, then O += P V_i and, when `next` holds,
  // S_{i+1}, in one wgmma stage.  The last tile is peeled off so that no
  // branch sits inside a wgmma stage (ptxas would serialize the wgmma).
  auto tile = [&](int i, auto next) {
    const int s = i % C::STAGES;
    const int c0 = (t_lo + i) * BK;
    // cap, mask and the row maxima (in the raw units of sc, times sl)
    if (capped) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = tanhf(sc[e] * x_scale);
    }
    const bool masked = (causal && c0 + BK - 1 > rw0) ||
                        (window > 0 && c0 <= rw0 + 63 - window) ||
                        c0 + BK > nk;
    if (masked) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1;
          const int col = c0 + 8 * j + cq + (e & 1);
          const bool vis = col < nk && (!causal || col <= row) &&
                           (window <= 0 || col > row - window);
          if (!vis) sc[4 * j + e] = kNegInf;
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * sl);
    const float mn1 = fmaxf(m1, quad_max(mx1) * sl);
    // a row that has seen nothing yet subtracts 0: exp2(-inf) = 0
    const float mu0 = mn0 == kNegInf ? 0.f : mn0;
    const float mu1 = mn1 == kNegInf ? 0.f : mn1;
    const float alpha0 = ex2(m0 - mu0), alpha1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;

    // P in bf16 pairs, laid out as wgmma's register A operand: for the
    // k16 step kk, (r0, 16kk + cq..), (r1, ..), (r0, 16kk + 8 + cq..),
    // (r1, ..).  l sums P in float32 before the rounding, as
    // FlashAttention does.
    uint32_t pa[BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = 2 * kk + h2;
        const float a = ex2(fmaf(sc[4 * j], sl, -mu0));
        const float c = ex2(fmaf(sc[4 * j + 1], sl, -mu0));
        const float d = ex2(fmaf(sc[4 * j + 2], sl, -mu1));
        const float f = ex2(fmaf(sc[4 * j + 3], sl, -mu1));
        ps0 += a + c;
        ps1 += d + f;
        pa[kk][2 * h2] = pack_bf16(a, c);
        pa[kk][2 * h2 + 1] = pack_bf16(d, f);
      }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // O += P V of tile i and S of tile i + 1
    if constexpr (decltype(next)::value) wait_tile(i + 1);
    fence_regs(o);
    fence_regs(sc);
    fence_regs(pa);
    wgmma_fence();
    const uint32_t vt = sV + s * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // 16 KV rows per step; the next 64 head dims are BK rows on
      const uint64_t dv =
          sw128_desc(vt + kk * 16 * kSwizzleRow, BK * kSwizzleRow, 1024);
      Wgmma<DP>::rs(o, pa[kk], dv);
    }
    if constexpr (decltype(next)::value) issue_s(i + 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(sc);
    mbar_arrive(bar_empty + 8 * s);
  };
  for (int i = 0; i + 1 < n_tiles; ++i) tile(i, std::true_type{});
  if (n_tiles > 0) tile(n_tiles - 1, std::false_type{});

  const float lt0 = quad_sum(l0), lt1 = quad_sum(l1);
  const float inv0 = lt0 == 0.f ? 0.f : 1.f / lt0;
  const float inv1 = lt1 == 0.f ? 0.f : 1.f / lt1;
  const long long head = ((long long)b * Hq + h) * (long long)nq;
  // the row's log-sum-exp for the backward (K6b), in natural units of the
  // scaled, capped float32 logits (m and l are in the log2 domain, l summed
  // before P's rounding); +inf for a row that sees no column
  if (lse != nullptr && lane % 4 == 0) {
    if (r0 < nq)
      lse[head + r0] = lt0 == 0.f ? INFINITY : (m0 + log2f(lt0)) / kLog2e;
    if (r1 < nq)
      lse[head + r1] = lt1 == 0.f ? INFINITY : (m1 + log2f(lt1)) / kLog2e;
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= Dp) continue;
    if (r0 < nq)
      *reinterpret_cast<__nv_bfloat162*>(out + (head + r0) * Dp + col) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < nq)
      *reinterpret_cast<__nv_bfloat162*>(out + (head + r1) * Dp + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int Hq, int Hkv, int nq, int nk, int Dp,
              int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  using C = Tc<DP>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, Dp, nq, B * Hq, kTcRows) ||
      !make_map(&mk, k, Dp, nk, B * Hkv, C::BK) ||
      !make_map(&mv, v, Dp, nk, B * Hkv, C::BK))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel_wgmma<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nq + kTcRows - 1) / kTcRows, Hq, B);
  flash_prefill_kernel_wgmma<DP><<<grid, kTcThreads, C::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, (float*)lse, Hq, Hkv, nq, nk, Dp,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: split-TF32 on wgmma
// ---------------------------------------------------------------------------
constexpr int kBN = 32;   // KV rows a step: 128 bytes of float32, one atom

template <int DP>
struct Tf {
  static constexpr int NCB = DP / 32;    // 128-byte slices of the head dim
  // slices of K (hi and lo) a score unit: at D 256 one, so that the
  // registers of the split Q fragments leave O's 128 unspilled
  static constexpr int SPU = DP == 256 ? 1 : 2;
  static constexpr int NSU = NCB / SPU;  // score units a step
  static constexpr int NA = DP / 64;     // V^T units a step, 64 dims each
  static constexpr int UPS = NSU + NA;   // units a step
  static constexpr int TILE = kBM * kRow;         // one [64][128 B] tile
  static constexpr int FIXED = 1024 + NCB * TILE;  // the block's Q rows
  static constexpr int STAGES = ring_stages(FIXED, kUnit);
  static constexpr int SMEM = FIXED + kWG * STAGES * kUnit;
  static_assert(NCB % SPU == 0 && SPU * 2 * kBN * kRow <= kUnit,
                "score unit too big");
  static_assert(2 * TILE <= kUnit, "V^T unit too big");
  static_assert(STAGES >= 2 && SMEM <= kSmemBlock,
                "shared memory of a block on the H100");
  // warpgroup 1's O, m and l, [values][thread], fit in the rings
  static_assert((DP / 2 + 4) * kThreads * 4 <= kWG * STAGES * kUnit,
                "no room to merge the warpgroups' states");
};

struct FwdArgs {
  const float* q;       // [B * Hq][nq][DP]
  const float* k;       // [B * Hkv][nk][DP], tf32's hi
  const float* k_lo;    // its lo copy
  const float* vt;      // V^T [B * Hkv][DP][nk_p], rows in split order
  const float* vt_lo;   // its lo copy
  float* out;           // [B * Hq][nq][DP]
  float* lse;           // [B * Hq][nq] or null
  int Hq, Hkv, nq, nk, nk_p, causal, window;
  float softcap, scale;
};

// The accumulator layout of wgmma m64nN (f32): thread t of a warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) at columns 8 j + 2 (t % 4)
// (+ 1) in d[4 j .. 4 j + 3].  Shared memory: the block's Q rows [NCB]
// [64 rows][128 B], then each warpgroup's ring of STAGES units: a score
// unit holds SPU slices of K's 32 rows, each as hi [32][128 B] then lo; a
// V^T unit holds 64 head dims of V^T's 32 columns, hi [64][128 B] then lo;
// all 128-byte swizzled.
template <int DP>
__global__ void __launch_bounds__(kWG * kThreads, 1)
flash_prefill_kernel_tf32(const FwdArgs a) {
  using C = Tf<DP>;
  constexpr int STAGES = C::STAGES, NCB = C::NCB, SPU = C::SPU;
  constexpr int NSU = C::NSU, NA = C::NA, UPS = C::UPS;
  constexpr long long kRowBytes = DP * 4;
  const float kNegInf = -INFINITY;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sRings = sQ + NCB * C::TILE;
  // warpgroup wg takes steps wg, wg + kWG, ... with a ring of its own
  const int wg = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const uint32_t sRing = sRings + wg * STAGES * kUnit;

  const int h = blockIdx.y, b = blockIdx.z;
  const int n_qt = (a.nq + kBM - 1) / kBM;
  const int row0 = (n_qt - 1 - (int)blockIdx.x) * kBM;  // longest rows first
  const int row_last = min(row0 + kBM, a.nq) - 1;
  // the KV steps with a column some row of this block can see: columns
  // kv <= q (causal) and kv > q - window
  const int c_hi = a.causal ? min(a.nk, row_last + 1) : a.nk;
  const int c_lo = a.window > 0 ? max(0, row0 - a.window + 1) : 0;
  const int t_lo = c_lo / kBN;
  const int n_t = c_hi > c_lo ? (c_hi + kBN - 1) / kBN - t_lo : 0;
  const int my_steps = n_t > wg ? (n_t - wg + kWG - 1) / kWG : 0;
  const int n_units = my_steps * UPS;

  const long long q_head = (long long)b * a.Hq + h;
  const long long kv_head = (long long)b * a.Hkv + h / (a.Hq / a.Hkv);
  {
    const char* src = reinterpret_cast<const char*>(a.q) +
                      q_head * a.nq * kRowBytes;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      load_tile<kBM, kWG * kThreads>(sQ + cb * C::TILE, src, kRowBytes, row0,
                                     a.nq, cb * kRow, threadIdx.x);
    cp_async_commit();
  }
  const char* k_src[2] = {
      reinterpret_cast<const char*>(a.k) + kv_head * a.nk * kRowBytes,
      reinterpret_cast<const char*>(a.k_lo) + kv_head * a.nk * kRowBytes};
  const long long t_stride = (long long)a.nk_p * 4;
  const char* vt_src[2] = {
      reinterpret_cast<const char*>(a.vt) + kv_head * DP * t_stride,
      reinterpret_cast<const char*>(a.vt_lo) + kv_head * DP * t_stride};
  // issues the loads of unit v into its ring slot (nothing past the end)
  auto issue = [&](int v) {
    if (v < n_units) {
      const uint32_t slot = sRing + (v % STAGES) * kUnit;
      const int col0 = (t_lo + wg + (v / UPS) * kWG) * kBN;
      const int k = v % UPS;
      if (k < NSU) {   // SPU slices of K's head dim, hi and lo
#pragma unroll
        for (int i = 0; i < SPU; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            load_tile<kBN, kThreads>(slot + (2 * i + c) * kBN * kRow,
                                     k_src[c], kRowBytes, col0, a.nk,
                                     (SPU * k + i) * kRow, tid);
      } else {         // 64 dims x 32 columns of V^T, hi and lo
#pragma unroll
        for (int c = 0; c < 2; ++c)
          load_tile<kBM, kThreads>(slot + c * C::TILE, vt_src[c], t_stride,
                                   64 * (k - NSU), DP, col0 * 4, tid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int v = 0; v < STAGES - 1; ++v) issue(v);
  // the block's Q rows in place for both warpgroups
  cp_async_wait<STAGES - 1>();
  fence_async_smem();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // the thread's tile rows
  const int rA = row0 + lr0, rB = row0 + lr1;    // and their indices
  const bool capped = a.softcap > 0.f;
  // the logit in the log2 domain: tanh(s x_scale) cap_l2 with a cap, else
  // s x_scale
  const float x_scale = capped ? a.scale / a.softcap : a.scale * kLog2e;
  const float cap_l2 = a.softcap * kLog2e;

  float o[NA][32], sacc[kBN / 2];
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[at][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // log2 domain
  int u = 0;   // units consumed
  auto begin_unit = [&]() -> uint32_t {
    return ring_begin<STAGES>(sRing, u, 1 + wg, issue);
  };

  for (int s = 0; s < my_steps; ++s) {
    const int col0 = (t_lo + wg + s * kWG) * kBN;
    // S = Q K^T over the head dim, SPU slices a unit.  Q's rows from shared
    // memory into tf32 fragments: rows lr0 and lr1 at dims 8 kk + t and
    // 8 kk + t + 4 of a slice.  The tensor cores sum a product's terms by
    // truncating them to the largest one's exponent, so a long sum into a
    // large accumulator drifts: hi.hi starts from zero in each unit and is
    // added to S in float32, and the two correction products, about 2^-10
    // of it, sum apart in their own accumulator, added at the end
    float part[kBN / 2], corr[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sacc[i] = 0.f;
#pragma unroll 1
    for (int su = 0; su < NSU; ++su) {
      const uint32_t slot = begin_unit();
      uint32_t qh[SPU][4][4], ql[SPU][4][4];
#pragma unroll
      for (int i = 0; i < SPU; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e & 1 ? lr1 : lr0;
            const int chunk = 2 * kk + (e >> 1);
            const uint32_t off = (SPU * su + i) * C::TILE + r * kRow +
                                 ((chunk ^ (r & 7)) << 4) + t * 4;
            asm volatile("ld.shared.f32 %0, [%1];\n"
                         : "=f"(x[e]) : "r"(sQ + off));
          }
          split4(x, qh[i][kk], ql[i][kk]);
        }
      fence_regs(part);
      fence_regs(corr);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < SPU; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t kt = slot + 2 * i * kBN * kRow + kk * 32;
          const uint64_t bh = sw128_desc(kt, 16, 1024);
          const uint64_t bl = sw128_desc(kt + kBN * kRow, 16, 1024);
          const int more = i > 0 || kk > 0;   // not the unit's first k step
          WgmmaTf32<kBN>::rs(corr, ql[i][kk], bh, su > 0 || more);
          WgmmaTf32<kBN>::rs(corr, qh[i][kk], bl, 1);
          WgmmaTf32<kBN>::rs(part, qh[i][kk], bh, more);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      fence_regs(corr);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sacc[i] += part[i];
      ++u;
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sacc[i] += corr[i];

    // cap, mask and the online softmax in the log2 domain: rows lr0
    // (e < 2) and lr1, columns col0 + 8 j + 2 t + (e & 1)
    const bool all_seen = col0 + kBN <= a.nk &&
                          (!a.causal || col0 + kBN - 1 <= row0) &&
                          (a.window <= 0 || col0 > row_last - a.window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? rA : rB;
        const int c = col0 + 8 * j + 2 * t + (e & 1);
        const bool vis = all_seen ||
                         (c < a.nk && (!a.causal || c <= r) &&
                          (a.window <= 0 || c > r - a.window));
        const float y = sacc[4 * j + e] * x_scale;
        const float x = vis ? (capped ? tanhf(y) * cap_l2 : y) : kNegInf;
        sacc[4 * j + e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // a row that has seen nothing yet subtracts 0: exp2(-inf) = 0
    const float mu0 = mn0 == kNegInf ? 0.f : mn0;
    const float mu1 = mn1 == kNegInf ? 0.f : mn1;
    const float alpha0 = ex2(m0 - mu0), alpha1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(sacc[4 * j + e] - (e < 2 ? mu0 : mu1));
        sacc[4 * j + e] = p;
        if (e < 2)
          ps0 += p;
        else
          ps1 += p;
      }
    // l sums P before its split
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;

    // P as wgmma's A operand: tf32 slots (lr0, t), (lr1, t), (lr0, t + 4),
    // (lr1, t + 4) take columns 2t, 2t, 2t + 1, 2t + 1, the order in which
    // V^T's split copy holds its columns
    uint32_t ph[kBN / 8][4], pl[kBN / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) {
      const float x4[4] = {sacc[4 * kk], sacc[4 * kk + 2], sacc[4 * kk + 1],
                           sacc[4 * kk + 3]};
      split4(x4, ph[kk], pl[kk]);
    }
    // O = O alpha + P V, 64 dims a unit.  The tensor cores sum a product's
    // terms by truncating them to the largest one's exponent, which biases
    // a long sum, so each unit's product starts from zero and is added to
    // O in float32
#pragma unroll
    for (int at = 0; at < NA; ++at) {
      const uint32_t slot = begin_unit();
      float part[32];
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 8; ++kk) {
        const uint64_t bh = sw128_desc(slot + kk * 32, 16, 1024);
        const uint64_t bl = sw128_desc(slot + C::TILE + kk * 32, 16, 1024);
        WgmmaTf32<64>::rs(part, pl[kk], bh, kk > 0);
        WgmmaTf32<64>::rs(part, ph[kk], bl, 1);
        WgmmaTf32<64>::rs(part, ph[kk], bh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[at][i] = fmaf(o[at][i], i % 4 < 2 ? alpha0 : alpha1, part[i]);
      ++u;
    }
  }
  cp_async_wait<0>();

  // warpgroup 1 hands its (m, l, O) to warpgroup 0 through the rings;
  // warpgroup 0 merges the two in that fixed order and writes the rows
  float* red = reinterpret_cast<float*>(smem_raw + (sRings - raw));
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        red[(32 * at + i) * kThreads + tid] = o[at][i];
    red[(DP / 2) * kThreads + tid] = m0;
    red[(DP / 2 + 1) * kThreads + tid] = m1;
    red[(DP / 2 + 2) * kThreads + tid] = l0;
    red[(DP / 2 + 3) * kThreads + tid] = l1;
  }
  __syncthreads();
  if (wg == 1) return;
  const float* theirs = red + (DP / 2) * kThreads + tid;  // m0, m1, l0, l1
  const float M0 = fmaxf(m0, theirs[0]), M1 = fmaxf(m1, theirs[kThreads]);
  const float mu0 = M0 == kNegInf ? 0.f : M0, mu1 = M1 == kNegInf ? 0.f : M1;
  const float a0 = ex2(m0 - mu0), b0 = ex2(theirs[0] - mu0);
  const float a1 = ex2(m1 - mu1), b1 = ex2(theirs[kThreads] - mu1);
  const float lt0 = quad_sum(l0 * a0 + theirs[2 * kThreads] * b0);
  const float lt1 = quad_sum(l1 * a1 + theirs[3 * kThreads] * b1);
  // the row's log-sum-exp for the backward (K6b), in natural units of the
  // scaled, capped logits; +inf for a row that sees no column
  if (a.lse != nullptr && t == 0) {
    if (rA < a.nq)
      a.lse[q_head * a.nq + rA] =
          lt0 == 0.f ? INFINITY : (M0 + log2f(lt0)) / kLog2e;
    if (rB < a.nq)
      a.lse[q_head * a.nq + rB] =
          lt1 == 0.f ? INFINITY : (M1 + log2f(lt1)) / kLog2e;
  }
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 64 * at + 8 * j + 2 * t;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float other = red[(32 * at + 4 * j + e) * kThreads + tid];
        const float lt = e < 2 ? lt0 : lt1;
        v[e] = lt == 0.f ? 0.f
                         : fmaf(o[at][4 * j + e], e < 2 ? a0 : a1,
                                other * (e < 2 ? b0 : b1)) / lt;
      }
      if (rA < a.nq)
        *reinterpret_cast<float2*>(a.out + (q_head * a.nq + rA) * DP + d) =
            make_float2(v[0], v[1]);
      if (rB < a.nq)
        *reinterpret_cast<float2*>(a.out + (q_head * a.nq + rB) * DP + d) =
            make_float2(v[2], v[3]);
    }
}

// The split copies the kernel streams: lo(K) [heads][nk][DP] and V^T,
// lo(V^T) [heads][DP][nk_p], the columns of each group of 8 in split
// order; a 32 x 32 tile of each a (32, 8) block over (nk_p / 32, DP / 32,
// heads)
__global__ void flash_prefill_split(const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    float* __restrict__ k_lo,
                                    float* __restrict__ vt,
                                    float* __restrict__ vt_lo, int rows,
                                    int rows_p, int DP) {
  transpose_tile(v, vt, vt_lo, rows, rows_p, DP);
  const long long head = (long long)blockIdx.z * rows * DP;
  const int d = blockIdx.y * 32 + threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = blockIdx.x * 32 + i;
    if (r < rows) {
      const long long at = head + (long long)r * DP + d;
      k_lo[at] = tf32_lo(k[at]);
    }
  }
}

// Byte offsets of the float32 route's workspace: lo(K), V^T and lo(V^T),
// each 256-byte aligned.
struct TfWork {
  long long k_lo, vt, vt_lo, total;
  TfWork(int B, int Hkv, int S, int DP) {
    long long at = 0;
    auto take = [&](long long bytes) {
      const long long p = at;
      at += (bytes + 255) / 256 * 256;
      return p;
    };
    k_lo = take(4LL * B * Hkv * S * DP);
    const long long t_bytes = 4LL * B * Hkv * DP * round_up(S, 64);
    vt = take(t_bytes);
    vt_lo = take(t_bytes);
    total = at;
  }
};

template <int DP>
int launch_tf32(const void* q, const void* k, const void* v, void* out,
                void* lse, void* work, int B, int Hq, int Hkv, int nq,
                int nk, int causal, int window, float softcap, float scale,
                cudaStream_t stream) {
  using C = Tf<DP>;
  const TfWork w(B, Hkv, nk, DP);
  char* ws = static_cast<char*>(work);
  FwdArgs args{};
  args.q = (const float*)q;
  args.k = (const float*)k;
  args.k_lo = reinterpret_cast<float*>(ws + w.k_lo);
  args.vt = reinterpret_cast<float*>(ws + w.vt);
  args.vt_lo = reinterpret_cast<float*>(ws + w.vt_lo);
  args.out = (float*)out;
  args.lse = (float*)lse;
  args.Hq = Hq;
  args.Hkv = Hkv;
  args.nq = nq;
  args.nk = nk;
  args.nk_p = round_up(nk, 64);
  args.causal = causal;
  args.window = window;
  args.softcap = softcap;
  args.scale = scale;
  flash_prefill_split<<<dim3(args.nk_p / 32, DP / 32, B * Hkv), dim3(32, 8),
                        0, stream>>>(
      (const float*)k, (const float*)v, (float*)args.k_lo, (float*)args.vt,
      (float*)args.vt_lo, nk, args.nk_p, DP);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_prefill_kernel_tf32<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nq + kBM - 1) / kBM, Hq, B);
  flash_prefill_kernel_tf32<DP><<<grid, kWG * kThreads, C::SMEM, stream>>>(
      args);
  return (int)cudaGetLastError();
}

__global__ void fill_inf(float* __restrict__ p, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = INFINITY;
}

}  // namespace

// Bytes of the workspace mvgc_flash_prefill needs: the float32 route's
// split copies of k and v (none for bf16).
extern "C" long long mvgc_flash_prefill_workspace(int B, int Hkv, int S,
                                                  int D, int is_bf16) {
  return is_bf16 ? 0 : TfWork(B, Hkv, S, pad_dim(D)).total;
}

// q [B, Hq, T, D], k/v [B, Hkv, S, D], out [B, Hq, T, D]; 0 < D <= 256,
// Hq % Hkv == 0, B, Hq, T >= 1 (the wrapper checks all of it); scale is
// 1 / sqrt of the unpadded head dim; 16-byte aligned pointers.  bf16 takes
// the wgmma+TMA kernel (D a multiple of 8), float32 the split-TF32 kernel
// (D 64, 128 or 256: the wrapper pads; work of
// mvgc_flash_prefill_workspace bytes).  lse, float32 [B, Hq, T] or null,
// receives each row's log-sum-exp of its (scaled, capped) float32 logits
// for the backward (K6b), on both routes.
extern "C" int mvgc_flash_prefill(const void* q, const void* k, const void* v,
                                  void* out, void* lse, void* work, int B,
                                  int Hq, int Hkv, int T, int S, int D,
                                  int causal, int window, float softcap,
                                  float scale, int is_bf16,
                                  cudaStream_t stream) {
  if (D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 ||
      (is_bf16 ? D % 8 != 0 : D != pad_dim(D)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) {   // no column to see: every row is 0, its LSE +inf
    if (lse != nullptr) {
      const long long n = (long long)B * Hq * T;
      fill_inf<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>((float*)lse,
                                                                n);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaMemsetAsync(out, 0,
                                (size_t)B * Hq * T * D * (is_bf16 ? 2 : 4),
                                stream);
  }
  if (is_bf16) {
    if (D <= 64)
      return launch_tc<64>(q, k, v, out, lse, B, Hq, Hkv, T, S, D, causal,
                           window, softcap, scale, stream);
    if (D <= 128)
      return launch_tc<128>(q, k, v, out, lse, B, Hq, Hkv, T, S, D, causal,
                            window, softcap, scale, stream);
    return launch_tc<256>(q, k, v, out, lse, B, Hq, Hkv, T, S, D, causal,
                          window, softcap, scale, stream);
  }
  if (D == 64)
    return launch_tf32<64>(q, k, v, out, lse, work, B, Hq, Hkv, T, S, causal,
                           window, softcap, scale, stream);
  if (D == 128)
    return launch_tf32<128>(q, k, v, out, lse, work, B, Hq, Hkv, T, S,
                            causal, window, softcap, scale, stream);
  return launch_tf32<256>(q, k, v, out, lse, work, B, Hq, Hkv, T, S, causal,
                          window, softcap, scale, stream);
}
