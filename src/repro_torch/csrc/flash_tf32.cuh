// What K6's float32 route (flash_prefill.cu) and K6b (flash_backward.cu)
// share: the split-TF32 operands, the pre-passes that copy them, and the
// warpgroup's ring of cp.async units that streams them.  One copy for both
// kernels' files; sm_90a only.
//
// Split-TF32: x = hi + lo with hi = tf32(x), the top 19 bits of x (the
// tensor cores read only those of a 32-bit word, so x itself stands for hi
// in memory and only lo is copied), and a product is hi.hi + hi.lo + lo.hi
// on the tf32 tensor cores (WgmmaTf32 in wgmma.cuh): about float32's
// accuracy, where one tf32 pass keeps about three digits.
//
// A wgmma tf32 operand in shared memory is K-major only (the descriptor's
// transpose bit is for 16-bit types), so a product that contracts over
// rows of a [heads][rows][D] tensor reads a transposed copy, [heads][D]
// [rows_p].  Its A operand from registers wants columns t and t + 4 of
// each 8 where a thread of the m64nN accumulator holds columns 2t and
// 2t + 1, so the split copies store the rows of each group of 8 in the
// order (0, 2, 4, 6, 1, 3, 5, 7), which the contraction does not see.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;        // a warpgroup
constexpr int kWG = 2;               // warpgroups of a block
constexpr int kBM = 64;              // rows of a block (wgmma's M)
constexpr int kUnit = 16384;         // bytes of a ring unit
constexpr int kMaxStages = 12;       // units in flight, at most
constexpr int kRow = 128;            // bytes of a swizzled tile row
constexpr int kSmemBlock = 232448;   // the most a block may use
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A [nrows][128 B] tile, 128-byte swizzled (16-byte chunk c of row r at
// chunk c ^ (r % 8)), from rows row0.. of a row-major source whose rows are
// `stride` bytes apart, bytes col.. col + 127 of each; rows at or past
// `valid` load as zeros.
template <int NROWS, int NTHR>
__device__ __forceinline__ void load_tile(uint32_t dst, const char* src,
                                          long long stride, int row0,
                                          int valid, int col, int tid) {
#pragma unroll
  for (int i = tid; i < NROWS * 8; i += NTHR) {
    const int r = i / 8, c = i % 8;
    const bool ok = row0 + r < valid;
    const char* s = ok ? src + (row0 + r) * stride + col + c * 16 : src;
    cp_async16(dst + r * kRow + ((c ^ (r & 7)) << 4), s, ok);
  }
}

// The ring of a warpgroup: STAGES units of kUnit bytes from `ring`, one
// cp.async group a unit, filled by issue(v) for unit v.  Waits for unit u,
// syncs the warpgroup on named barrier `bar` (every thread's copies are
// then in place, and every thread is done with unit u - 1), refills the
// slot unit u - 1 used, and returns unit u's slot.
template <int STAGES, typename Issue>
__device__ __forceinline__ uint32_t ring_begin(uint32_t ring, int u, int bar,
                                               Issue& issue) {
  cp_async_wait<STAGES - 2>();
  fence_async_smem();
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kThreads) : "memory");
  issue(u + STAGES - 1);
  return ring + (u % STAGES) * kUnit;
}

// Units of each warpgroup's ring when `fixed` bytes of the block's shared
// memory hold other things and each stage takes `per_stage` more per
// warpgroup: as many as fit, at most kMaxStages
constexpr int ring_stages(int fixed, int per_stage) {
  return (kSmemBlock - fixed) / (kWG * per_stage) < kMaxStages
             ? (kSmemBlock - fixed) / (kWG * per_stage)
             : kMaxStages;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}
__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(tf32_hi(x));
}

// hi and lo of a tf32 fragment of four floats.  hi could be x itself (the
// tensor cores read its top 19 bits), but then ptxas serializes the wgmma
// "due to insufficient register resources" (C7511 in tools/k6b_ptxas.py's
// report), which slowed K6b's float32 route, so hi is a register of its own
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_hi(x[i]);
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
  }
}

// One 32 x 32 tile of a transpose pre-pass, for a (32, 8) thread block over
// the grid (rows_p / 32, DP / 32, heads): out0 [heads][DP][rows_p] = x
// [heads][rows][DP] transposed (tf32's hi), zeros past `rows`, and out1 the
// tf32 lo copy, the rows of each group of 8 stored in the order (0, 2, 4,
// 6, 1, 3, 5, 7)
__device__ __forceinline__ void transpose_tile(const float* __restrict__ x,
                                               float* __restrict__ out0,
                                               float* __restrict__ out1,
                                               int rows, int rows_p, int DP) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const long long head = blockIdx.z;
  const float* src = x + head * rows * (long long)DP;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i;
    tile[i][threadIdx.x] =
        r < rows ? src[(long long)r * DP + c0 + threadIdx.x] : 0.f;
  }
  __syncthreads();
  const long long obase = head * DP * (long long)rows_p;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int d = c0 + i, oc = threadIdx.x;
    const int src_r =
        (oc & ~7) + ((oc & 4) ? 2 * (oc & 3) + 1 : 2 * (oc & 3));
    const float v = tile[src_r][i];
    const long long dst = obase + (long long)d * rows_p + r0 + oc;
    out0[dst] = v;
    out1[dst] = tf32_lo(v);
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// the padded head dim of the float32 kernels: 64, 128 or 256
int pad_dim(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

}  // namespace
