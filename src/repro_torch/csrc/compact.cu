// Compact: fused needed(A, now) + splice over an [R, V] descriptor batch.
//
// Replaces the Pallas kernel compact_pallas / _fused_compact_kernel of
// repro/kernels/compact/kernel.py.  One thread per (row, v) entry; each
// block first copies the sorted announcement board A[P] into shared memory
// (P is reader lanes plus extra pins: tens to a few thousand), then every
// thread evaluates
//     need = ts != EMPTY && (succ > now || exists a in A: ts <= a < succ)
// as a lower-bound binary search for ts in A, kills the masked entries that
// are not needed (EMPTY / TS_MAX / EMPTY), writes the freed payload handle,
// and the block adds its kill count with __syncthreads_count plus one
// integer atomicAdd.  Integer addition is order-independent, so the count
// is exact; threads past R*V (the ragged last block) count nothing.
//
// Bound on the H100: bytes (12 read and 16 written per entry against
// log2(P) compares in shared memory).  The design streams each entry once,
// coalesced, and reads A from global memory once per block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kTsMax = 2147483647;
constexpr int kThreads = 256;
constexpr int kMaxAnn = 12 * 1024;  // 48 KB: the default dynamic limit

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
  for (int i = threadIdx.x; i < P; i += blockDim.x) sA[i] = ann[i];
  __syncthreads();

  const int now = *now_p;
  const long long n = (long long)R * V;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int kill = 0;
  if (e < n) {
    const int r = (int)(e / V);
    const int t = ts[e], s = succ[e], p = pay[e];
    // first index with A[idx] >= t
    int lo = 0, hi = P;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sA[mid] < t) lo = mid + 1; else hi = mid;
    }
    const bool valid = t != kEmpty;
    const bool pinned = lo < P && sA[lo] < s;
    const bool need = valid && (pinned || s > now);
    kill = (valid && !need && mask[r] != 0) ? 1 : 0;
    out_ts[e] = kill ? kEmpty : t;
    out_succ[e] = kill ? kTsMax : s;
    out_pay[e] = kill ? kEmpty : p;
    out_freed[e] = kill ? p : kEmpty;
  }
  const int block_kills = __syncthreads_count(kill);
  if (threadIdx.x == 0 && block_kills) atomicAdd(count, block_kills);
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
