// Compact: fused needed(A, now) + splice over an [R, V] descriptor batch
// (K1), and the needed(A, now) mask alone over an [S, V] slab (K5).
//
// K1 replaces the Pallas kernel compact_pallas / _fused_compact_kernel of
// repro/kernels/compact/kernel.py; K5 replaces needed_pallas /
// _compact_kernel of the same file.  Both run one thread per (row, v)
// entry; each block first copies the sorted announcement board A[P] into
// shared memory (P is reader lanes plus extra pins: tens to a few
// thousand), then every thread evaluates
//     need = ts != EMPTY && (succ > now || exists a in A: ts <= a < succ)
// as a lower-bound binary search for ts in A.  The TPU kernel's broadcast
// compare over all of A needs no order; the binary search needs A sorted
// (TS_MAX-padded), which is what the ops' contract (sort_announcements)
// already gives.
//
// K1 then kills the masked entries that are not needed (EMPTY / TS_MAX /
// EMPTY), writes the freed payload handle, and the block adds its kill
// count with __syncthreads_count plus one integer atomicAdd.  Integer
// addition is order-independent, so the count is exact; threads past R*V
// (the ragged last block) count nothing.  K5 writes the mask straight into
// a bool (one byte) output.
//
// Bound on the H100: bytes (K1: 12 read and 16 written per entry; K5: 8
// read and 1 written) against log2(P) compares in shared memory.  The
// design streams each entry once, coalesced, and reads A from global
// memory once per block.  A board above kMaxAnn entries is refused.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kTsMax = 2147483647;
constexpr int kThreads = 256;
constexpr int kMaxAnn = 12 * 1024;  // 48 KB: the default dynamic limit

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
  stage_board(sA, ann, P);

  const int now = *now_p;
  const long long n = (long long)R * V;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int kill = 0;
  if (e < n) {
    const int r = (int)(e / V);
    const int t = ts[e], s = succ[e], p = pay[e];
    const bool need = needed_entry(t, s, sA, P, now);
    kill = (t != kEmpty && !need && mask[r] != 0) ? 1 : 0;
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
