// Version search: batched search(t) over [S, V] version slabs, optionally
// fused with the gather of the value row the resolved payload indexes.
//
// Replaces the Pallas kernels search_pallas (without the gather) and
// search_gather_pallas (with it) of repro/kernels/version_search/kernel.py.
// One warp per query (slot, t): the lanes scan the slot's V entries
// (V = 8-32, so one or two loads per lane) for the largest ts <= t, with
// the smallest index winning a tie as jnp.argmax does, and reduce with
// warp shuffles.  Lane 0 writes the payload and the found flag; with the
// gather the warp then copies the M-wide value row (for snapshot_view: the
// page table plus its length, M = MP + 1) with coalesced loads, or fills it
// with EMPTY when nothing was found.
//
// Bound on the H100: bytes (2V + M int32 read and M + 2 written per query,
// no arithmetic to speak of).  At serving batch sizes the launch dominates.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kWarpsPerBlock = 8;

__global__ void search_kernel(const int* __restrict__ ts,
                              const int* __restrict__ pay,
                              const int* __restrict__ values,
                              const int* __restrict__ slot_ids,
                              const int* __restrict__ tq,
                              int* __restrict__ out_rows,
                              int* __restrict__ out_pay,
                              uint8_t* __restrict__ out_found, int V, int T,
                              int M, int B) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;  // the whole warp leaves together
  const long long row = (long long)slot_ids[q] * V;
  const int t = tq[q];

  int best_ts = INT_MIN, best_v = V;  // best_v == V: nothing found yet
  for (int v = lane; v < V; v += 32) {
    const int x = ts[row + v];
    if (x != kEmpty && x <= t && (x > best_ts || best_v == V)) {
      best_ts = x;
      best_v = v;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int o_ts = __shfl_down_sync(0xffffffffu, best_ts, off);
    const int o_v = __shfl_down_sync(0xffffffffu, best_v, off);
    if (o_v < V && (best_v == V || o_ts > best_ts ||
                    (o_ts == best_ts && o_v < best_v))) {
      best_ts = o_ts;
      best_v = o_v;
    }
  }
  best_v = __shfl_sync(0xffffffffu, best_v, 0);
  const bool found = best_v < V;
  const int p = found ? pay[row + best_v] : kEmpty;
  if (lane == 0) {
    out_pay[q] = p;
    out_found[q] = found ? 1 : 0;
  }
  if (out_rows != nullptr) {
    const long long src = (long long)min(max(p, 0), T - 1) * M;
    int* dst = out_rows + (long long)q * M;
    for (int m = lane; m < M; m += 32) dst[m] = found ? values[src + m] : kEmpty;
  }
}

}  // namespace

// values / out_rows may be null (search without the gather, M = T = 0).
extern "C" int mvgc_search_gather(const int* ts, const int* pay,
                                  const int* values, const int* slot_ids,
                                  const int* t, int* out_rows, int* out_pay,
                                  uint8_t* out_found, int S, int V, int T,
                                  int M, int B, cudaStream_t stream) {
  (void)S;
  if (B > 0) {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    search_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        ts, pay, values, slot_ids, t, out_rows, out_pay, out_found, V, T, M,
        B);
  }
  return (int)cudaGetLastError();
}
