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
// device memory, become the limit.  Two kernels, chosen by dtype:
//
// bf16: flash_prefill_kernel_wgmma, the FlashAttention-3 shape for Hopper.
//   A block of three warpgroups owns one (b, h) and 128 query rows.
//   Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and one
//   thread issues TMA loads (cp.async.bulk.tensor) of the Q tile and of a
//   ring of K and V tiles (3 stages, 4 at D 256) into 128-byte-swizzled
//   shared memory, each stage's arrival reported to an mbarrier; the
//   consumers free a stage after using it.  Warpgroups 1 and 2 are
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
// float32: flash_prefill_kernel, the first version, on the CUDA cores
//   (tensor cores on float32 would be TF32): one block per (b, h, 64-row
//   query tile), 256 threads as 16 x 16 computing 4 x 4 outer products
//   from float32 tiles in shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key columns per KV tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLd = kBQ + 4;    // padded row (floats) of Q^T, K^T and P^T

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// A butterfly sum: every lane adds the same pairs (in swapped order, and
// float addition is commutative), so all 16 lanes end with the same bits.
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DP * kLd + kBK * DP + kBK * kLd);
}

// Thread (ty, tx) computes the 4 x 4 logits of query rows ty*4.. and key
// columns tx*4.. of a tile from Q^T and K^T in shared memory and owns
// output rows ty*4.. at head dims g*64 + tx*4.. .  The 16 threads of a row
// group are one half-warp: the row max is reduced with xor shuffles inside
// it, the row sum is kept per thread and reduced once at the end.  The
// probabilities go through shared memory (P^T) for the P V product.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse,
                     int Hq, int Hkv, int nq, int nk, int D, int causal,
                     int window, float softcap, float scale) {
  constexpr int NG = DP / 64;   // float4 groups of output dims per thread
  const float kNegInf = -INFINITY;
  const int n_t = (nq + kBQ - 1) / kBQ;
  const int qt = n_t - 1 - (int)blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = qt * kBQ;

  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [DP][kLd] Q^T
  float* kT = qT + DP * kLd;                    // [DP][kLd] K^T of a tile
  float* vS = kT + DP * kLd;                    // [kBK][DP] V of a tile
  float* pT = vS + kBK * DP;                    // [kBK][kLd] P^T of a tile

  const long long q_base = ((long long)b * Hq + h) * (long long)nq * D;
  const long long kv_base = ((long long)b * Hkv + hk) * (long long)nk * D;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, row = q0 + r;
    qT[d * kLd + r] =
        (row < nq && d < D) ? q[q_base + (long long)row * D + d] : 0.f;
  }

  // the KV tiles with a column some row of this tile can see
  int kv_lo = 0, kv_hi = nk;
  if (causal) kv_hi = min(nk, q0 + kBQ);
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  const int t_lo = kv_lo / kBK;
  const int t_hi = (kv_hi + kBK - 1) / kBK;

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NG; ++e) acc[i][e] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * kBK;
    __syncthreads();   // Q^T is written; the last tile's readers are done
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int c = i / DP, d = i % DP, col = c0 + c;
      const bool in = col < nk && d < D;
      const long long src = kv_base + (long long)col * D + d;
      kT[d * kLd + c] = in ? k[src] : 0.f;
      vS[c * DP + d] = in ? v[src] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * kLd + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&kT[d * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        const bool vis = col < nk && (!causal || col <= row) &&
                         (window <= 0 || col > row - window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[i][j] = vis ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = (m_new == kNegInf) ? 1.f : expf(m[i] - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == kNegInf) ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        lsum += p;
      }
      l[i] = l[i] * alpha + lsum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * NG; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pT[(tx * 4 + j) * kLd + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pT[c * kLd + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 w =
            *reinterpret_cast<const float4*>(&vS[c * DP + g * 64 + tx * 4]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(pv[i], wv[e], acc[i][g * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = half_warp_sum(l[i]);
    const int row = q0 + ty * 4 + i;
    if (row >= nq) continue;
    // the row's log-sum-exp for the backward (K6b); +inf for a row that
    // sees no column, so that exp(s - lse) is 0 there
    if (lse != nullptr && tx == 0)
      lse[((long long)b * Hq + h) * nq + row] =
          lt == 0.f ? INFINITY : m[i] + logf(lt);
    float* dst = out + q_base + (long long)row * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        if (d < D) dst[d] = lt == 0.f ? 0.f : acc[i][g * 4 + e] / lt;
      }
  }
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Hq, int Hkv, int nq, int nk, int D,
               int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nq + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_kernel<DP><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, Hq, Hkv, nq, nk, D, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int kTcRows = 128;      // query rows per block: 2 warpgroups x 64
constexpr int kTcThreads = 384;   // producer warpgroup + 2 consumers
// setmaxnreg: 128 x 40 + 256 x 232 = 384 x 168, the launch's registers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSwizzleRow = 128;  // bytes of a swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of the given parity to complete.  A wait that lasts
// about 10 s at the H100's clock can only be a fault: it traps, so the
// launch fails and the wrapper raises instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
// butterfly: the four lanes of a row end with the same bits
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-d map (Dp, rows, heads) of a contiguous bf16 [heads, rows, Dp]
// tensor, read in boxes of 64 dims x box_rows rows, 128-byte swizzled;
// out-of-range elements load as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int Dp, int rows, int heads,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Dp, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)Dp * 2,
                                 (cuuint64_t)Dp * 2 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__global__ void fill_inf(float* __restrict__ p, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = INFINITY;
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int Hq, int Hkv, int nq, int nk, int Dp,
              int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  using C = Tc<DP>;
  if (nk == 0) {   // no column to see: every row is 0, its LSE +inf
    if (lse != nullptr) {
      const long long n = (long long)B * Hq * nq;
      fill_inf<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>((float*)lse,
                                                                n);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaMemsetAsync(out, 0, (size_t)B * Hq * nq * Dp * 2, stream);
  }
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

}  // namespace

// q [B, Hq, T, D], k/v [B, Hkv, S, D], out [B, Hq, T, D]; 0 < D <= 256,
// Hq % Hkv == 0, B, Hq, T >= 1 (the wrapper checks all of it); scale is
// 1 / sqrt of the unpadded head dim.  bf16 takes the wgmma kernel (D a
// multiple of 8, 16-byte aligned pointers), float32 the CUDA-core kernel.
// lse, float32 [B, Hq, T] or null, receives each row's log-sum-exp of its
// (scaled, capped) float32 logits for the backward (K6b), on both routes.
extern "C" int mvgc_flash_prefill(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int Hq,
                                  int Hkv, int T, int S, int D, int causal,
                                  int window, float softcap, float scale,
                                  int is_bf16, cudaStream_t stream) {
  if (D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (D % 8 != 0) return (int)cudaErrorInvalidValue;
    if (D <= 64)
      return launch_tc<64>(q, k, v, out, lse, B, Hq, Hkv, T, S, D, causal,
                           window, softcap, scale, stream);
    if (D <= 128)
      return launch_tc<128>(q, k, v, out, lse, B, Hq, Hkv, T, S, D, causal,
                            window, softcap, scale, stream);
    return launch_tc<256>(q, k, v, out, lse, B, Hq, Hkv, T, S, D, causal,
                          window, softcap, scale, stream);
  }
  if (D <= 64)
    return launch_f32<64>(q, k, v, out, lse, B, Hq, Hkv, T, S, D, causal,
                          window, softcap, scale, stream);
  if (D <= 128)
    return launch_f32<128>(q, k, v, out, lse, B, Hq, Hkv, T, S, D, causal,
                           window, softcap, scale, stream);
  return launch_f32<256>(q, k, v, out, lse, B, Hq, Hkv, T, S, D, causal,
                         window, softcap, scale, stream);
}
