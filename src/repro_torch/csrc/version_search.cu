// Version search: batched search(t) over [S, V] version slabs (K3), fused
// with the gather of the value row the resolved payload indexes (K2's
// parity op), and the snapshot view (K2's main path): search(t) per
// sequence, then the resolved version's page-table row and length.
//
// Replaces the Pallas kernels search_pallas (without the gather) and
// search_gather_pallas (with it) of repro/kernels/version_search/kernel.py.
// One warp per query (slot, t).  The lanes v < V load the ts AND the
// payload of their entries in one round trip (V = 8-32, so one or two
// entries per lane), take the largest ts <= t, with the smallest index
// winning a tie as jnp.argmax does, and reduce (ts, v, payload) with warp
// shuffles, so the winner's payload reaches every lane without a second
// load.  The chain of dependent loads per query is: slot id, the slab row,
// the value row.  A found payload is clamped into [0, T) before it
// indexes a row.
//
// The view reads the table row and the length straight from tables[T, MP]
// and lengths[T] (no [T, MP + 1] copy of them), copies the row with 16-byte
// loads and stores where MP % 4 == 0 and both bases are 16-byte aligned
// (scalar otherwise), and writes NO_PAGE (-1) rows and length 0 where
// nothing was found.  The timestamp t is one value passed by value, or a
// device array read with stride 0 (one t) or 1 (one per query).
//
// Bound on the H100: bytes (2V int32 of slab row, the found rows and
// lengths read; the outputs written; no arithmetic to speak of).  At
// serving batch sizes the launch dominates, so the view's gain is the
// launches and the copy of the whole table that it replaces.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ int query_t(const int* t_ptr, int t_val,
                                       int t_stride, int q) {
  return t_ptr != nullptr ? t_ptr[(long long)q * t_stride] : t_val;
}

// search(t) of one slot's row by one warp: the winner's payload on every
// lane (EMPTY when no entry has ts <= t), and whether one was found.
__device__ __forceinline__ int resolve(const int* __restrict__ ts,
                                       const int* __restrict__ pay,
                                       long long row, int V, int t, int lane,
                                       bool* found) {
  int best_ts = INT_MIN, best_v = V, best_p = kEmpty;  // best_v == V: none
  for (int v = lane; v < V; v += 32) {
    const int x = ts[row + v];
    const int p = pay[row + v];
    if (x != kEmpty && x <= t && (x > best_ts || best_v == V)) {
      best_ts = x;
      best_v = v;
      best_p = p;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int o_ts = __shfl_down_sync(0xffffffffu, best_ts, off);
    const int o_v = __shfl_down_sync(0xffffffffu, best_v, off);
    const int o_p = __shfl_down_sync(0xffffffffu, best_p, off);
    if (o_v < V && (best_v == V || o_ts > best_ts ||
                    (o_ts == best_ts && o_v < best_v))) {
      best_ts = o_ts;
      best_v = o_v;
      best_p = o_p;
    }
  }
  *found = __shfl_sync(0xffffffffu, best_v, 0) < V;
  return __shfl_sync(0xffffffffu, best_p, 0);  // EMPTY when none was found
}

__global__ void search_kernel(const int* __restrict__ ts,
                              const int* __restrict__ pay,
                              const int* __restrict__ values,
                              const int* __restrict__ slot_ids,
                              const int* __restrict__ t_ptr, int t_val,
                              int t_stride, int* __restrict__ out_rows,
                              int* __restrict__ out_pay,
                              uint8_t* __restrict__ out_found, int V, int T,
                              int M, int B) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;  // the whole warp leaves together
  const long long row = (long long)slot_ids[q] * V;
  bool found;
  const int p = resolve(ts, pay, row, V, query_t(t_ptr, t_val, t_stride, q),
                        lane, &found);
  if (lane == 0) {
    out_pay[q] = p;
    out_found[q] = found ? 1 : 0;
  }
  if (out_rows != nullptr) {
    const long long src = (long long)min(max(p, 0), T - 1) * M;
    int* dst = out_rows + (long long)q * M;
    for (int m = lane; m < M; m += 32)
      dst[m] = found ? values[src + m] : kEmpty;
  }
}

__global__ void view_kernel(const int* __restrict__ ts,
                            const int* __restrict__ pay,
                            const int* __restrict__ tables,
                            const int* __restrict__ lengths,
                            const int* __restrict__ slot_ids,
                            const int* __restrict__ t_ptr, int t_val,
                            int t_stride, int* __restrict__ out_rows,
                            int* __restrict__ out_len, int V, int T, int MP,
                            int B, int vec) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;
  const long long row = (long long)slot_ids[q] * V;
  bool found;
  const int p = resolve(ts, pay, row, V, query_t(t_ptr, t_val, t_stride, q),
                        lane, &found);
  const int tbl = min(max(p, 0), T - 1);
  if (lane == 0) out_len[q] = found ? lengths[tbl] : 0;
  const long long src = (long long)tbl * MP;
  int* dst = out_rows + (long long)q * MP;
  if (vec) {
    const int4* src4 = reinterpret_cast<const int4*>(tables + src);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    const int4 none = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    for (int m = lane; m < MP / 4; m += 32) dst4[m] = found ? src4[m] : none;
  } else {
    for (int m = lane; m < MP; m += 32)
      dst[m] = found ? tables[src + m] : kEmpty;
  }
}

int blocks_for(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

// values / out_rows may be null (search without the gather, M = T = 0).
// t_ptr null: every query's t is t_val.
extern "C" int mvgc_search_gather(const int* ts, const int* pay,
                                  const int* values, const int* slot_ids,
                                  const int* t_ptr, int t_val, int t_stride,
                                  int* out_rows, int* out_pay,
                                  uint8_t* out_found, int S, int V, int T,
                                  int M, int B, cudaStream_t stream) {
  (void)S;
  if (B > 0) {
    search_kernel<<<blocks_for(B), kWarpsPerBlock * 32, 0, stream>>>(
        ts, pay, values, slot_ids, t_ptr, t_val, t_stride, out_rows, out_pay,
        out_found, V, T, M, B);
  }
  return (int)cudaGetLastError();
}

// vec: 1 when MP % 4 == 0 and tables / out_rows are 16-byte aligned.
extern "C" int mvgc_view(const int* ts, const int* pay, const int* tables,
                         const int* lengths, const int* slot_ids,
                         const int* t_ptr, int t_val, int t_stride,
                         int* out_rows, int* out_len, int S, int V, int T,
                         int MP, int B, int vec, cudaStream_t stream) {
  (void)S;
  if (B > 0) {
    view_kernel<<<blocks_for(B), kWarpsPerBlock * 32, 0, stream>>>(
        ts, pay, tables, lengths, slot_ids, t_ptr, t_val, t_stride, out_rows,
        out_len, V, T, MP, B, vec);
  }
  return (int)cudaGetLastError();
}
