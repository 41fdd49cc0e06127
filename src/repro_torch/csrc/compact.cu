// Compact: the needed-sweep of the version slabs in one launch (K1's main
// path), the fused needed(A, now) + splice over an [R, V] row batch (K1's
// parity op), and the needed(A, now) mask alone over an [S, V] slab (K5).
//
// K1 replaces the Pallas kernel compact_pallas / _fused_compact_kernel of
// repro/kernels/compact/kernel.py; K5 replaces needed_pallas /
// _compact_kernel of the same file.  Every kernel here runs one thread per
// (row, v) entry; each block copies the sorted announcement board A[P]
// into shared memory (P is reader lanes plus extra pins: tens to a few
// thousand), and every thread evaluates
//     need = ts != EMPTY && (succ > now || exists a in A: ts <= a < succ)
// as a lower-bound binary search for ts in A.  The TPU kernel's broadcast
// compare over all of A needs no order; the binary search needs A sorted
// (TS_MAX-padded), which is what the ops' contract (sort_announcements)
// already gives.  A board above kMaxAnn entries is refused.  Each thread
// issues its entry's loads and the load of `now` before the barrier that
// publishes the staged board, so the two round trips overlap.
//
// sweep_kernel is the store's whole needed-sweep (vstore._sweep_slots and
// _sweep_all_needed), which before took a chain of gathers, this file's
// compact kernel, a count memset and three scatters.  Its grid has two
// roles, no count and no atomics:
//   * slab blocks, one thread per entry of the [S, V] slab, write the new
//     slab: an entry of a swept slot is killed if it is not needed (EMPTY /
//     TS_MAX / EMPTY), every other entry is copied.  With lane ids, a block
//     learns which of its slots are swept by scanning (slot_ids, mask) into
//     a shared flag per slot of its own range (at most kThreads + 1 slots,
//     whatever R is); without them every slot is swept and the slab blocks
//     also write `freed` [S * V].
//   * lane blocks, one thread per (lane, v) of the [R, V] lane batch, write
//     `freed` [R * V] from the original rows: lanes that name the same slot
//     read the same read-only entry and report the same handles, as the
//     gathered composite did.  Every write-back of a slot is computed from
//     its original row, never from one lane's copy, so duplicate lanes
//     cannot race (trap C1); unmasked lanes write nothing and free nothing.
// K1's parity op (compact_kernel) kills the masked entries of its rows and
// counts them with __syncthreads_count plus one integer atomicAdd per
// block: integer addition is order-independent, so the count is exact.
// K5 writes the mask straight into a bool (one byte) output.
//
// Bound on the H100: bytes (the sweep: 12 read and 12 written per slab
// entry, 5 read per lane and 4 written per freed handle, and the board;
// K5: 8 read and 1 written per entry) against log2(P) compares in shared
// memory.  At serving sizes (a few thousand entries) all are at the
// launch floor, so the sweep's gain is the chain of launches it replaces.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kTsMax = 2147483647;
constexpr int kThreads = 256;
constexpr int kMaxAnn = 12 * 1024;  // 48 KB: the default dynamic limit
// the sweep's per-slot flags: a slab block of kThreads entries spans at
// most kThreads + 1 slots; kept in ints ahead of the board
constexpr int kFlagWords = (kThreads + 1 + 3) / 4;
// lanes per thread a slab block loads before its first barrier, all at
// once: at 256 threads all of the slrt flush at serving size (R = 4096),
// so the scan costs one round trip, not one per loop iteration
constexpr int kPrefetch = 16;
constexpr int kDefaultSmem = 48 * 1024;

// Copies the board into shared memory; every thread of the block calls it.
__device__ __forceinline__ void stage_board(int* sA, const int* ann, int P) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) sA[i] = ann[i];
  __syncthreads();
}

// needed(A, now) of one entry [t, s) against the staged sorted board.
__device__ __forceinline__ bool needed_entry(int t, int s, const int* sA,
                                             int P, int now) {
  // first index with A[idx] >= t
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sA[mid] < t) lo = mid + 1; else hi = mid;
  }
  const bool pinned = lo < P && sA[lo] < s;
  return t != kEmpty && (pinned || s > now);
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const int* __restrict__ ts, const int* __restrict__ succ,
             const int* __restrict__ pay, const int* __restrict__ slot_ids,
             const uint8_t* __restrict__ mask, const int* __restrict__ ann,
             const int* __restrict__ now_p, int now_val,
             int* __restrict__ out_ts, int* __restrict__ out_succ,
             int* __restrict__ out_pay, int* __restrict__ out_freed, int S,
             int V, int R, int P, bool lanes, int slab_blocks) {
  extern __shared__ int smem[];
  uint8_t* flag = reinterpret_cast<uint8_t*>(smem);
  int* sA = smem + kFlagWords;
  const int now = now_p != nullptr ? *now_p : now_val;
  int t = kEmpty, s = kTsMax, p = kEmpty;

  if (blockIdx.x < slab_blocks) {  // slab role: the new [S, V] slab
    const long long n = (long long)S * V;
    const long long first = (long long)blockIdx.x * kThreads;
    const long long e = first + threadIdx.x;
    if (e < n) {
      t = ts[e];
      s = succ[e];
      p = pay[e];
    }
    // this block's slots [s0, s1)
    const int s0 = (int)(first / V);
    const int s1 = (int)((min(n, first + kThreads) - 1) / V) + 1;
    // the first kPrefetch lanes of each thread are loaded before the
    // barrier, all at once; the rest after it, eight at a time
    int pre_sid[kPrefetch];
    uint8_t pre_m[kPrefetch];
    if (lanes) {
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) {
        const int r = threadIdx.x + k * kThreads;
        pre_sid[k] = r < R ? slot_ids[r] : -1;
        pre_m[k] = r < R ? mask[r] : 0;
      }
      for (int i = threadIdx.x; i < s1 - s0; i += kThreads) flag[i] = 0;
    }
    stage_board(sA, ann, P);
    if (lanes) {
      // every writer stores the same 1: no order can change the flags
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k)
        if (pre_m[k] && pre_sid[k] >= s0 && pre_sid[k] < s1)
          flag[pre_sid[k] - s0] = 1;
#pragma unroll 8
      for (int r = threadIdx.x + kPrefetch * kThreads; r < R; r += kThreads) {
        const int sid = slot_ids[r];
        const uint8_t m = mask[r];
        if (m && sid >= s0 && sid < s1) flag[sid - s0] = 1;
      }
      __syncthreads();
    }
    if (e < n) {
      const bool swept = !lanes || flag[(int)(e / V) - s0];
      const bool kill = swept && t != kEmpty &&
                        !needed_entry(t, s, sA, P, now);
      out_ts[e] = kill ? kEmpty : t;
      out_succ[e] = kill ? kTsMax : s;
      out_pay[e] = kill ? kEmpty : p;
      if (!lanes) out_freed[e] = kill ? p : kEmpty;
    }
    return;
  }

  // lane role: freed [R, V] from the original rows the lanes name
  const long long n = (long long)R * V;
  const long long e =
      (long long)(blockIdx.x - slab_blocks) * kThreads + threadIdx.x;
  bool live = false;
  if (e < n) {
    const int r = (int)(e / V);
    const int sid = slot_ids[r];
    live = mask[r] != 0 && sid >= 0 && sid < S;
    if (live) {
      const long long src = (long long)sid * V + (e - (long long)r * V);
      t = ts[src];
      s = succ[src];
      p = pay[src];
    }
  }
  stage_board(sA, ann, P);
  if (e < n) {
    const bool kill = live && t != kEmpty && !needed_entry(t, s, sA, P, now);
    out_freed[e] = kill ? p : kEmpty;
  }
}

__global__ void compact_kernel(const int* __restrict__ ts,
                               const int* __restrict__ succ,
                               const int* __restrict__ pay,
                               const uint8_t* __restrict__ mask,
                               const int* __restrict__ ann,
                               const int* __restrict__ now_p,
                               int* __restrict__ out_ts,
                               int* __restrict__ out_succ,
                               int* __restrict__ out_pay,
                               int* __restrict__ out_freed,
                               int* __restrict__ count, int R, int V, int P) {
  extern __shared__ int sA[];  // P ints
  const long long n = (long long)R * V;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int now = *now_p;
  int t = kEmpty, s = kTsMax, p = kEmpty;
  bool masked = false;
  if (e < n) {
    t = ts[e];
    s = succ[e];
    p = pay[e];
    masked = mask[e / V] != 0;
  }
  stage_board(sA, ann, P);
  int kill = 0;
  if (e < n) {
    kill = (masked && t != kEmpty && !needed_entry(t, s, sA, P, now)) ? 1
                                                                       : 0;
    out_ts[e] = kill ? kEmpty : t;
    out_succ[e] = kill ? kTsMax : s;
    out_pay[e] = kill ? kEmpty : p;
    out_freed[e] = kill ? p : kEmpty;
  }
  const int block_kills = __syncthreads_count(kill);
  if (threadIdx.x == 0 && block_kills) atomicAdd(count, block_kills);
}

__global__ void needed_kernel(const int* __restrict__ ts,
                              const int* __restrict__ succ,
                              const int* __restrict__ ann,
                              const int* __restrict__ now_p,
                              bool* __restrict__ out, long long n, int P) {
  extern __shared__ int sA[];  // P ints
  stage_board(sA, ann, P);
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = needed_entry(ts[e], succ[e], sA, P, *now_p);
}

}  // namespace

// every_slot: every slot is swept, slot_ids / mask are not read and
// out_freed is [S * V]; otherwise the slots that masked lanes name are
// swept and out_freed is [R * V].  now_p null: `now` is now_val.  Lane ids
// outside [0, S) are dropped (the wrapper's contract asks for [0, S)).
extern "C" int mvgc_sweep(const int* ts, const int* succ, const int* pay,
                          const int* slot_ids, const uint8_t* mask,
                          const int* ann, const int* now_p, int now_val,
                          int* out_ts, int* out_succ, int* out_pay,
                          int* out_freed, int S, int V, int R, int P,
                          int every_slot, cudaStream_t stream) {
  if (P > kMaxAnn) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kFlagWords + P) * sizeof(int);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_slab = (long long)S * V;
  const long long n_lane = every_slot ? 0 : (long long)R * V;
  const int slab_blocks = (int)((n_slab + kThreads - 1) / kThreads);
  const int lane_blocks = (int)((n_lane + kThreads - 1) / kThreads);
  if (slab_blocks + lane_blocks > 0) {
    sweep_kernel<<<slab_blocks + lane_blocks, kThreads, smem, stream>>>(
        ts, succ, pay, slot_ids, mask, ann, now_p, now_val, out_ts, out_succ,
        out_pay, out_freed, S, V, R, P, every_slot == 0, slab_blocks);
  }
  return (int)cudaGetLastError();
}

extern "C" int mvgc_compact(const int* ts, const int* succ, const int* pay,
                            const uint8_t* mask, const int* ann,
                            const int* now, int* out_ts, int* out_succ,
                            int* out_pay, int* out_freed, int* count, int R,
                            int V, int P, cudaStream_t stream) {
  const long long n = (long long)R * V;
  if (P > kMaxAnn) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (int)((n + kThreads - 1) / kThreads);
    compact_kernel<<<blocks, kThreads, P * sizeof(int), stream>>>(
        ts, succ, pay, mask, ann, now, out_ts, out_succ, out_pay, out_freed,
        count, R, V, P);
  }
  return (int)cudaGetLastError();
}

extern "C" int mvgc_needed(const int* ts, const int* succ, const int* ann,
                           const int* now, bool* out, int S, int V, int P,
                           cudaStream_t stream) {
  const long long n = (long long)S * V;
  if (P > kMaxAnn) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (int)((n + kThreads - 1) / kThreads);
    needed_kernel<<<blocks, kThreads, P * sizeof(int), stream>>>(
        ts, succ, ann, now, out, n, P);
  }
  return (int)cudaGetLastError();
}
