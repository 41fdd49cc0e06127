// Compact: the needed-sweep of the version slabs in one launch (K1's main
// path), the fused needed(A, now) + splice over an [R, V] row batch (K1's
// parity op), and the needed(A, now) mask alone over an [S, V] slab (K5).
//
// K1 replaces the Pallas kernel compact_pallas / _fused_compact_kernel of
// repro/kernels/compact/kernel.py; K5 replaces needed_pallas /
// _compact_kernel of the same file.  Every kernel copies the sorted
// announcement board A[P] (P is reader lanes plus extra pins: tens to a few
// thousand) into shared memory and evaluates, per (row, v) entry,
//     need = ts != EMPTY && (succ > now || exists a in A: ts <= a < succ)
// as a lower-bound search for ts in A.  The TPU kernel's broadcast compare
// over all of A needs no order; the search needs A sorted (TS_MAX-padded),
// which is what the ops' contract (sort_announcements) already gives.
//
// Any board size runs.  A board that fits the block's shared memory (up to
// the device's opt-in limit, cudaDevAttrMaxSharedMemoryPerBlockOptin: 227 KB
// on the H100, so about 58000 entries sorted, or an Eytzinger tree of 2^15
// nodes) is staged there, as above.  A larger one is searched where it
// lies, sorted in global memory, through the read-only path (__ldg): the
// same lower bound, its first probes shared by every thread and kept in L1
// and L2.  Each kernel takes the route as a template flag (kGlobal).
//
// K1's kernels run one thread per entry and search the board as it is
// sorted; each thread issues its entry's loads and the load of `now` before
// the barrier that publishes the staged board, so the round trips overlap.
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
//   Lane ids follow JAX's index rules: an id in [-S, 0) means id + S; an
//   id still outside [0, S) reads its row clamped into [0, S) (the lane
//   role reports that row's kills, as JAX's gather does) and writes
//   nothing (the slab role drops it, as JAX's scatter does).
// K1's parity op (compact_kernel) kills the masked entries of its rows and
// counts them with __syncthreads_count plus one integer atomicAdd per
// block: integer addition is order-independent, so the count is exact.
//
// K5 (needed_kernel) is bound by bytes, so it is built to stream them:
// each thread issues its entries' loads, and the load of `now`, before
// the board barrier.  It has two layouts, chosen by the slab's size.  A
// large slab (at least 4 x 256 entries per SM) is streamed in runs of
// kRun = 4 consecutive entries per thread, loaded with one 16-byte load of
// ts and one of succ, whose 4 bools leave in one 4-byte store (a warp
// stores 128 contiguous bytes); blocks are as wide as spreads the runs
// over the SMs (up to 1024 threads, at most kBlocksPerSm blocks per SM
// walking any further runs with a grid stride), so the board is staged
// about once per SM instead of once per 256 entries, and it is staged in
// Eytzinger (breadth-first) order of a perfect tree of 2^L - 1 nodes,
// TS_MAX-padded: the search is L branch-free shared loads, and the nodes
// of one level are consecutive words, so the lanes of a warp meet in a
// bank only from the sixth level on, where the sorted layout's probes at
// a level lie a power of two apart, all in one bank.  A smaller slab keeps
// one entry per thread (there, more threads beat fewer wider ones) and
// the board as it is sorted, which costs less to stage.
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
// the sweep's per-slot flags: a slab block of kThreads entries spans at
// most kThreads + 1 slots; kept in ints ahead of the board
constexpr int kFlagWords = (kThreads + 1 + 3) / 4;
// lanes per thread a slab block loads before its first barrier, all at
// once: at 256 threads all of the slrt flush at serving size (R = 4096),
// so the scan costs one round trip, not one per loop iteration
constexpr int kPrefetch = 16;
constexpr int kDefaultSmem = 48 * 1024;
// K5: entries per thread on a large slab, block widths, blocks per SM
constexpr int kRun = 4;
constexpr int kMinThreads = 32;
constexpr int kMaxThreads = 1024;
constexpr int kBlocksPerSm = 2;

// A lane id in [-S, 0) means id + S (JAX's index rule).
__device__ __forceinline__ int wrap(int sid, int S) {
  return sid < 0 ? sid + S : sid;
}

// Copies the board into shared memory (nothing when it stays in global
// memory: P = 0); every thread of the block calls it, for its barrier.
__device__ __forceinline__ void stage_board(int* sA, const int* ann, int P) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) sA[i] = ann[i];
  __syncthreads();
}

// Entry i of the board: staged in shared memory, or read-only from global.
template <bool kGlobal>
__device__ __forceinline__ int board_at(const int* b, int i) {
  if constexpr (kGlobal) return __ldg(b + i);
  return b[i];
}

// needed(A, now) of one entry [t, s) against the sorted board b (staged,
// or in global memory with kGlobal).
template <bool kGlobal>
__device__ __forceinline__ bool needed_entry(int t, int s, const int* b,
                                             int P, int now) {
  // first index with A[idx] >= t
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (board_at<kGlobal>(b, mid) < t) lo = mid + 1; else hi = mid;
  }
  const bool pinned = lo < P && board_at<kGlobal>(b, lo) < s;
  return t != kEmpty && (pinned || s > now);
}

template <bool kGlobal>
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
  const int* board = kGlobal ? ann : sA;
  const int Ps = kGlobal ? 0 : P;  // entries staged
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
        pre_sid[k] = r < R ? wrap(slot_ids[r], S) : -1;
        pre_m[k] = r < R ? mask[r] : 0;
      }
      for (int i = threadIdx.x; i < s1 - s0; i += kThreads) flag[i] = 0;
    }
    stage_board(sA, ann, Ps);
    if (lanes) {
      // every writer stores the same 1: no order can change the flags
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k)
        if (pre_m[k] && pre_sid[k] >= s0 && pre_sid[k] < s1)
          flag[pre_sid[k] - s0] = 1;
#pragma unroll 8
      for (int r = threadIdx.x + kPrefetch * kThreads; r < R; r += kThreads) {
        const int sid = wrap(slot_ids[r], S);
        const uint8_t m = mask[r];
        if (m && sid >= s0 && sid < s1) flag[sid - s0] = 1;
      }
      __syncthreads();
    }
    if (e < n) {
      const bool swept = !lanes || flag[(int)(e / V) - s0];
      const bool kill = swept && t != kEmpty &&
                        !needed_entry<kGlobal>(t, s, board, P, now);
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
    // JAX's gather rule: wrapped, then clamped into [0, S)
    const int sid = min(max(wrap(slot_ids[r], S), 0), S - 1);
    live = mask[r] != 0;
    if (live) {
      const long long src = (long long)sid * V + (e - (long long)r * V);
      t = ts[src];
      s = succ[src];
      p = pay[src];
    }
  }
  stage_board(sA, ann, Ps);
  if (e < n) {
    const bool kill = live && t != kEmpty &&
                      !needed_entry<kGlobal>(t, s, board, P, now);
    out_freed[e] = kill ? p : kEmpty;
  }
}

template <bool kGlobal>
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
  extern __shared__ int sA[];  // P ints, none with kGlobal
  const int* board = kGlobal ? ann : sA;
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
  stage_board(sA, ann, kGlobal ? 0 : P);
  int kill = 0;
  if (e < n) {
    kill = (masked && t != kEmpty &&
            !needed_entry<kGlobal>(t, s, board, P, now)) ? 1 : 0;
    out_ts[e] = kill ? kEmpty : t;
    out_succ[e] = kill ? kTsMax : s;
    out_pay[e] = kill ? kEmpty : p;
    out_freed[e] = kill ? p : kEmpty;
  }
  const int block_kills = __syncthreads_count(kill);
  if (threadIdx.x == 0 && block_kills) atomicAdd(count, block_kills);
}

// Stages the sorted board A[P] into b[1 .. 2^L - 1] in Eytzinger order
// (node i at depth d = floor(log2 i), position j = i - 2^d, holds the
// sorted entry of rank (2j + 1) 2^(L-1-d) - 1), TS_MAX past P; b[0] =
// TS_MAX stands for "no entry >= t".  No barrier: the caller syncs.
__device__ __forceinline__ void stage_eytzinger(int* b, const int* ann,
                                                int P, int L) {
  const int n = (1 << L) - 1;
  for (int i = threadIdx.x; i <= n; i += blockDim.x) {
    int v = kTsMax;
    if (i > 0) {
      const int d = 31 - __clz(i);
      const int r = ((2 * (i - (1 << d)) + 1) << (L - 1 - d)) - 1;
      if (r < P) v = ann[r];
    }
    b[i] = v;
  }
}

// The run of RUN entries at e0: 16-byte loads when RUN is a multiple of 4,
// `vec` and the run is whole, else one entry at a time (EMPTY past n).
template <int RUN>
__device__ __forceinline__ void load_run(const int* __restrict__ ts,
                                         const int* __restrict__ succ,
                                         long long e0, long long n, int vec,
                                         int* t, int* s) {
  if (RUN % 4 == 0 && vec && e0 + RUN <= n) {
    const int4* t4 = reinterpret_cast<const int4*>(ts + e0);
    const int4* s4 = reinterpret_cast<const int4*>(succ + e0);
#pragma unroll
    for (int w = 0; w < RUN / 4; ++w) {
      const int4 a = t4[w], c = s4[w];
      t[4 * w] = a.x; t[4 * w + 1] = a.y; t[4 * w + 2] = a.z;
      t[4 * w + 3] = a.w;
      s[4 * w] = c.x; s[4 * w + 1] = c.y; s[4 * w + 2] = c.z;
      s[4 * w + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const bool in = e0 + j < n;
      t[j] = in ? ts[e0 + j] : kEmpty;
      s[j] = in ? succ[e0 + j] : kTsMax;
    }
  }
}

// needed(A, now) of a run.  kWide: runs of kRun entries, the board staged
// in Eytzinger order (stage_eytzinger) and each search L branch-free
// levels; otherwise one entry per thread, the board staged sorted and
// searched by needed_entry.  kGlobal: the board too large for shared
// memory, searched sorted where it lies (needed_entry<true>), in runs of
// kRun entries with kWide.  One byte per entry, little-endian in 32-bit
// words, then one store of RUN bytes (4 entries or 1).
template <bool kWide, bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads)
needed_kernel(const int* __restrict__ ts, const int* __restrict__ succ,
              const int* __restrict__ ann, const int* __restrict__ now_p,
              int now_val, uint8_t* __restrict__ out, long long n, int P,
              int L, int vec) {
  constexpr int RUN = kWide ? kRun : 1;
  extern __shared__ int b[];  // the board: 2^L ints (kWide) or P
  const long long stride = (long long)gridDim.x * blockDim.x * RUN;
  long long e0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * RUN;
  int t[RUN], s[RUN];
  if (e0 < n) load_run<RUN>(ts, succ, e0, n, vec, t, s);
  const int now = now_p != nullptr ? *now_p : now_val;
  if constexpr (kGlobal) {
    // nothing to stage
  } else if (kWide) {
    stage_eytzinger(b, ann, P, L);
  } else {
    for (int i = threadIdx.x; i < P; i += blockDim.x) b[i] = ann[i];
  }
  __syncthreads();
  for (; e0 < n; e0 += stride) {
    uint32_t word = 0;
    if constexpr (kGlobal) {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        word |= (uint32_t)needed_entry<true>(t[j], s[j], ann, P, now)
                << (8 * j);
    } else if constexpr (kWide) {
      // lower bound of t[j] in the board: k walks down the tree
      int k[RUN];
#pragma unroll
      for (int j = 0; j < RUN; ++j) k[j] = 1;
      for (int d = 0; d < L; ++d) {
#pragma unroll
        for (int j = 0; j < RUN; ++j) k[j] = 2 * k[j] + (b[k[j]] < t[j]);
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const int lb = k[j] >> __ffs(~k[j]);  // 0: every entry < t[j]
        const bool need = t[j] != kEmpty && (s[j] > now || b[lb] < s[j]);
        word |= (uint32_t)need << (8 * j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        word |= (uint32_t)needed_entry<false>(t[j], s[j], b, P, now)
                << (8 * j);
    }
    if (RUN == 1) {
      out[e0] = (uint8_t)word;
    } else if (vec && e0 + RUN <= n) {
      *reinterpret_cast<uint32_t*>(out + e0) = word;
    } else {
      for (int j = 0; j < RUN && e0 + j < n; ++j)
        out[e0 + j] = (uint8_t)((word >> (8 * j)) & 1);
    }
    if (e0 + stride < n) load_run<RUN>(ts, succ, e0 + stride, n, vec, t, s);
  }
}

// The most dynamic shared memory a block may opt in to (227 KB on the
// H100); 48 KB, the default, if the device will not say.
size_t smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      bytes = kDefaultSmem;
  }
  return (size_t)bytes;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (past the
// default 48 KB).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <bool kWide, bool kGlobal>
cudaError_t launch_needed(const int* ts, const int* succ, const int* ann,
                          const int* now_p, int now_val, uint8_t* out,
                          long long n, int P, int L, int vec,
                          cudaStream_t stream) {
  constexpr int RUN = kWide ? kRun : 1;
  const size_t smem =
      kGlobal ? 0 : (kWide ? ((size_t)1 << L) : (size_t)P) * sizeof(int);
  const cudaError_t err = allow_smem(needed_kernel<kWide, kGlobal>, smem);
  if (err != cudaSuccess) return err;
  // as many threads per block (a power of two, kMinThreads to
  // kMaxThreads) as spread the runs over the SMs, then as many blocks as
  // the runs need, at most kBlocksPerSm per SM (blocks walk any further
  // runs with a grid stride)
  const long long runs = (n + RUN - 1) / RUN;
  const int sms = sm_count();
  const long long per_sm = (runs + sms - 1) / sms;
  int threads = kMinThreads;
  while (threads < kMaxThreads && threads < per_sm) threads *= 2;
  const long long want = (runs + threads - 1) / threads;
  const long long cap = (long long)sms * kBlocksPerSm;
  needed_kernel<kWide, kGlobal><<<(int)(want < cap ? want : cap), threads,
                                   smem, stream>>>(ts, succ, ann, now_p,
                                                   now_val, out, n, P, L,
                                                   vec);
  return cudaSuccess;
}

// The needed-sweep's launch on one board route.
template <bool kGlobal>
cudaError_t launch_sweep(const int* ts, const int* succ, const int* pay,
                         const int* slot_ids, const uint8_t* mask,
                         const int* ann, const int* now_p, int now_val,
                         int* out_ts, int* out_succ, int* out_pay,
                         int* out_freed, int S, int V, int R, int P,
                         int every_slot, cudaStream_t stream) {
  const size_t smem = (size_t)(kFlagWords + (kGlobal ? 0 : P)) * sizeof(int);
  const cudaError_t err = allow_smem(sweep_kernel<kGlobal>, smem);
  if (err != cudaSuccess) return err;
  const long long n_slab = (long long)S * V;
  const long long n_lane = every_slot ? 0 : (long long)R * V;
  const int slab_blocks = (int)((n_slab + kThreads - 1) / kThreads);
  const int lane_blocks = (int)((n_lane + kThreads - 1) / kThreads);
  if (slab_blocks + lane_blocks > 0) {
    sweep_kernel<kGlobal><<<slab_blocks + lane_blocks, kThreads, smem,
                            stream>>>(
        ts, succ, pay, slot_ids, mask, ann, now_p, now_val, out_ts, out_succ,
        out_pay, out_freed, S, V, R, P, every_slot == 0, slab_blocks);
  }
  return cudaSuccess;
}

}  // namespace

// every_slot: every slot is swept, slot_ids / mask are not read and
// out_freed is [S * V]; otherwise the slots that masked lanes name are
// swept and out_freed is [R * V].  now_p null: `now` is now_val.  Lane ids
// follow JAX's index rules (see the top of this file).
extern "C" int mvgc_sweep(const int* ts, const int* succ, const int* pay,
                          const int* slot_ids, const uint8_t* mask,
                          const int* ann, const int* now_p, int now_val,
                          int* out_ts, int* out_succ, int* out_pay,
                          int* out_freed, int S, int V, int R, int P,
                          int every_slot, cudaStream_t stream) {
  if (!every_slot && R > 0 && S <= 0) return (int)cudaErrorInvalidValue;
  const bool shared =
      (size_t)(kFlagWords + P) * sizeof(int) <= smem_optin();
  const cudaError_t err =
      shared ? launch_sweep<false>(ts, succ, pay, slot_ids, mask, ann, now_p,
                                   now_val, out_ts, out_succ, out_pay,
                                   out_freed, S, V, R, P, every_slot, stream)
             : launch_sweep<true>(ts, succ, pay, slot_ids, mask, ann, now_p,
                                  now_val, out_ts, out_succ, out_pay,
                                  out_freed, S, V, R, P, every_slot, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int mvgc_compact(const int* ts, const int* succ, const int* pay,
                            const uint8_t* mask, const int* ann,
                            const int* now, int* out_ts, int* out_succ,
                            int* out_pay, int* out_freed, int* count, int R,
                            int V, int P, cudaStream_t stream) {
  const long long n = (long long)R * V;
  if (n > 0) {
    const int blocks = (int)((n + kThreads - 1) / kThreads);
    const size_t smem = (size_t)P * sizeof(int);
    if (smem <= smem_optin()) {
      const cudaError_t err = allow_smem(compact_kernel<false>, smem);
      if (err != cudaSuccess) return (int)err;
      compact_kernel<false><<<blocks, kThreads, smem, stream>>>(
          ts, succ, pay, mask, ann, now, out_ts, out_succ, out_pay,
          out_freed, count, R, V, P);
    } else {
      compact_kernel<true><<<blocks, kThreads, 0, stream>>>(
          ts, succ, pay, mask, ann, now, out_ts, out_succ, out_pay,
          out_freed, count, R, V, P);
    }
  }
  return (int)cudaGetLastError();
}

// K5.  now_p null: `now` is now_val.  vec: 1 when ts, succ and out are
// 16-byte aligned.
extern "C" int mvgc_needed(const int* ts, const int* succ, const int* ann,
                           const int* now_p, int now_val, uint8_t* out, int S,
                           int V, int P, int vec, cudaStream_t stream) {
  const long long n = (long long)S * V;
  if (n > 0) {
    int L = 0;  // the smallest perfect tree that holds the board
    while ((1LL << L) - 1 < P) ++L;
    // the wide layout once its runs still give every SM a full block of
    // 256 threads; one entry per thread below that, where more threads
    // beat fewer wider ones.  Each keeps the board in global memory when
    // its staged copy would not fit the opt-in shared memory.
    const bool wide = n >= (long long)kRun * sm_count() * 256;
    const size_t staged =
        (wide ? ((size_t)1 << L) : (size_t)P) * sizeof(int);
    const bool global = staged > smem_optin();
    cudaError_t err;
    if (wide && global)
      err = launch_needed<true, true>(ts, succ, ann, now_p, now_val, out, n,
                                      P, L, vec, stream);
    else if (wide)
      err = launch_needed<true, false>(ts, succ, ann, now_p, now_val, out,
                                       n, P, L, vec, stream);
    else if (global)
      err = launch_needed<false, true>(ts, succ, ann, now_p, now_val, out,
                                       n, P, L, vec, stream);
    else
      err = launch_needed<false, false>(ts, succ, ann, now_p, now_val, out,
                                        n, P, L, vec, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
