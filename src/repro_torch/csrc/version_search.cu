// Version search: batched search(t) over [S, V] version slabs (K3), the
// same search fused with the gather of the value row the resolved payload
// indexes (K2's parity op), and the snapshot view (K2's main path):
// search(t) per sequence, then the resolved version's page-table row and
// length.
//
// K3 replaces the Pallas kernel search_pallas, K2 search_gather_pallas, of
// repro/kernels/version_search/kernel.py.
//
// Slot ids follow JAX's gather rule: an id in [-S, 0) means id + S, and an
// id still outside [0, S) is clamped into it, so no id reads out of
// bounds.  A null id array queries every slot (query q is slot q).
//
// K3 (search_kernel) gives each query a group of G = min(32,
// next_pow2(V)) lanes, so 32 / G queries share a warp (at V = 8, four): the
// group's lanes load the ts AND the payload of their entries in one round
// trip, take the largest ts <= t with the smallest index winning a tie (as
// jnp.argmax), and reduce (ts, v, payload) with shuffles over the group.
// It writes either the payload (EMPTY where nothing was found) and the
// found flag (search, the parity op) or the payload with 0 where nothing
// was found (value_at, the main path's op: no second pass to mask it).
//
// K2 (search_gather_kernel, view_kernel) keeps one warp per query: after
// the search the warp copies a value row of M or MP ints, which a group of
// eight lanes would copy four times slower.  The view reads the table row
// and the length straight from tables[T, MP] and lengths[T] (no
// [T, MP + 1] copy of them), copies the row with 16-byte loads and stores
// where MP % 4 == 0 and both bases are 16-byte aligned (scalar otherwise),
// and writes NO_PAGE (-1) rows and length 0 where nothing was found.  A
// found payload is clamped into [0, T) before it indexes a row.
//
// The timestamp t is one value passed by value, or a device array read
// with stride 0 (one t) or 1 (one per query).
//
// Bound on the H100: bytes (the slot ids, 2V int32 of slab row per query,
// K2's found rows; the outputs; no arithmetic to speak of).  At serving
// batch sizes the launch dominates, so the gain of K3's design is in its
// wrapper (one allocation, no id array, no masking pass) and K2's is the
// launches and the copy of the whole table that it replaces.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ int query_t(const int* t_ptr, int t_val,
                                       int t_stride, int q) {
  return t_ptr != nullptr ? t_ptr[(long long)q * t_stride] : t_val;
}

// The slab row of query q: JAX's gather rule on the id (wrap, then clamp).
__device__ __forceinline__ int slot_of(const int* __restrict__ slot_ids,
                                       int q, int S) {
  if (slot_ids == nullptr) return q;
  const int sid = slot_ids[q];
  return min(max(sid < 0 ? sid + S : sid, 0), S - 1);
}

// One lane's share of search(t) over entries v = lane, lane + width, ...,
// then the (ts, v, payload) reduction over `width` lanes (a power of two,
// at most 32; every lane of the warp takes part).  best_v == V: none.
// Returns the winner's payload in lane 0 of each group of `width` lanes.
template <int kWidth>
__device__ __forceinline__ int search_lanes(const int* __restrict__ ts,
                                            const int* __restrict__ pay,
                                            long long row, bool active,
                                            int V, int t, int lane,
                                            bool* found) {
  int best_ts = INT_MIN, best_v = V, best_p = kEmpty;
  if (active) {
    for (int v = lane; v < V; v += kWidth) {
      const int x = ts[row + v];
      const int p = pay[row + v];
      if (x != kEmpty && x <= t && (x > best_ts || best_v == V)) {
        best_ts = x;
        best_v = v;
        best_p = p;
      }
    }
  }
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) {
    const int o_ts = __shfl_down_sync(0xffffffffu, best_ts, off, kWidth);
    const int o_v = __shfl_down_sync(0xffffffffu, best_v, off, kWidth);
    const int o_p = __shfl_down_sync(0xffffffffu, best_p, off, kWidth);
    if (o_v < V && (best_v == V || o_ts > best_ts ||
                    (o_ts == best_ts && o_v < best_v))) {
      best_ts = o_ts;
      best_v = o_v;
      best_p = o_p;
    }
  }
  *found = best_v < V;
  return best_p;
}

// search(t) of one slot's row by a whole warp, the winner on every lane.
__device__ __forceinline__ int resolve(const int* __restrict__ ts,
                                       const int* __restrict__ pay,
                                       long long row, int V, int t, int lane,
                                       bool* found) {
  bool f;
  const int p = search_lanes<32>(ts, pay, row, true, V, t, lane, &f);
  *found = __shfl_sync(0xffffffffu, f ? 1 : 0, 0) != 0;
  return __shfl_sync(0xffffffffu, p, 0);  // EMPTY when none was found
}

template <int G>
__global__ void __launch_bounds__(kThreads)
search_kernel(const int* __restrict__ ts, const int* __restrict__ pay,
              const int* __restrict__ slot_ids,
              const int* __restrict__ t_ptr, int t_val, int t_stride,
              int* __restrict__ out_val, uint8_t* __restrict__ out_found,
              int miss, int S, int V, int B) {
  const int q = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) / G);
  const int lane = threadIdx.x & (G - 1);
  const bool active = q < B;
  long long row = 0;
  int t = 0;
  if (active) {
    row = (long long)slot_of(slot_ids, q, S) * V;
    t = query_t(t_ptr, t_val, t_stride, q);
  }
  bool found;
  const int p = search_lanes<G>(ts, pay, row, active, V, t, lane, &found);
  if (active && lane == 0) {
    out_val[q] = found ? p : miss;
    if (out_found != nullptr) out_found[q] = found ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
search_gather_kernel(const int* __restrict__ ts, const int* __restrict__ pay,
                     const int* __restrict__ values,
                     const int* __restrict__ slot_ids,
                     const int* __restrict__ t_ptr, int t_val, int t_stride,
                     int* __restrict__ out_rows, int* __restrict__ out_pay,
                     uint8_t* __restrict__ out_found, int S, int V, int T,
                     int M, int B) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;  // the whole warp leaves together
  const long long row = (long long)slot_of(slot_ids, q, S) * V;
  bool found;
  const int p = resolve(ts, pay, row, V, query_t(t_ptr, t_val, t_stride, q),
                        lane, &found);
  if (lane == 0) {
    out_pay[q] = p;
    out_found[q] = found ? 1 : 0;
  }
  const long long src = (long long)min(max(p, 0), T - 1) * M;
  int* dst = out_rows + (long long)q * M;
  for (int m = lane; m < M; m += 32)
    dst[m] = found ? values[src + m] : kEmpty;
}

__global__ void __launch_bounds__(kThreads)
view_kernel(const int* __restrict__ ts, const int* __restrict__ pay,
            const int* __restrict__ tables, const int* __restrict__ lengths,
            const int* __restrict__ slot_ids, const int* __restrict__ t_ptr,
            int t_val, int t_stride, int* __restrict__ out_rows,
            int* __restrict__ out_len, int S, int V, int T, int MP, int B,
            int vec) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;
  const long long row = (long long)slot_of(slot_ids, q, S) * V;
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

int warp_blocks(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

template <int G>
void launch_search(const int* ts, const int* pay, const int* slot_ids,
                   const int* t_ptr, int t_val, int t_stride, int* out_val,
                   uint8_t* out_found, int miss, int S, int V, int B,
                   cudaStream_t stream) {
  const long long threads = (long long)B * G;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  search_kernel<G><<<blocks, kThreads, 0, stream>>>(
      ts, pay, slot_ids, t_ptr, t_val, t_stride, out_val, out_found, miss, S,
      V, B);
}

}  // namespace

// K3.  slot_ids null: every slot, B = S.  out_found null: out_val holds the
// payload or `miss` where nothing was found (value_at); otherwise the
// payload or `miss` (EMPTY for search) and the found flags.
// t_ptr null: every query's t is t_val.
extern "C" int mvgc_search(const int* ts, const int* pay, const int* slot_ids,
                           const int* t_ptr, int t_val, int t_stride,
                           int* out_val, uint8_t* out_found, int miss, int S,
                           int V, int B, cudaStream_t stream) {
  if (B > 0 && (S <= 0 || V <= 0)) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    // G = min(32, next_pow2(V))
    const int g = V > 16 ? 32 : V > 8 ? 16 : V > 4 ? 8 : V > 2 ? 4 : V;
    switch (g) {
      case 1: launch_search<1>(ts, pay, slot_ids, t_ptr, t_val, t_stride,
                               out_val, out_found, miss, S, V, B, stream);
        break;
      case 2: launch_search<2>(ts, pay, slot_ids, t_ptr, t_val, t_stride,
                               out_val, out_found, miss, S, V, B, stream);
        break;
      case 4: launch_search<4>(ts, pay, slot_ids, t_ptr, t_val, t_stride,
                               out_val, out_found, miss, S, V, B, stream);
        break;
      case 8: launch_search<8>(ts, pay, slot_ids, t_ptr, t_val, t_stride,
                               out_val, out_found, miss, S, V, B, stream);
        break;
      case 16: launch_search<16>(ts, pay, slot_ids, t_ptr, t_val, t_stride,
                                 out_val, out_found, miss, S, V, B, stream);
        break;
      default: launch_search<32>(ts, pay, slot_ids, t_ptr, t_val, t_stride,
                                 out_val, out_found, miss, S, V, B, stream);
    }
  }
  return (int)cudaGetLastError();
}

// K2's parity op.  t_ptr null: every query's t is t_val.
extern "C" int mvgc_search_gather(const int* ts, const int* pay,
                                  const int* values, const int* slot_ids,
                                  const int* t_ptr, int t_val, int t_stride,
                                  int* out_rows, int* out_pay,
                                  uint8_t* out_found, int S, int V, int T,
                                  int M, int B, cudaStream_t stream) {
  if (B > 0 && (S <= 0 || T <= 0)) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    search_gather_kernel<<<warp_blocks(B), kThreads, 0, stream>>>(
        ts, pay, values, slot_ids, t_ptr, t_val, t_stride, out_rows, out_pay,
        out_found, S, V, T, M, B);
  }
  return (int)cudaGetLastError();
}

// K2's main path.  vec: 1 when MP % 4 == 0 and tables / out_rows are
// 16-byte aligned.
extern "C" int mvgc_view(const int* ts, const int* pay, const int* tables,
                         const int* lengths, const int* slot_ids,
                         const int* t_ptr, int t_val, int t_stride,
                         int* out_rows, int* out_len, int S, int V, int T,
                         int MP, int B, int vec, cudaStream_t stream) {
  if (B > 0 && (S <= 0 || T <= 0)) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    view_kernel<<<warp_blocks(B), kThreads, 0, stream>>>(
        ts, pay, tables, lengths, slot_ids, t_ptr, t_val, t_stride, out_rows,
        out_len, S, V, T, MP, B, vec);
  }
  return (int)cudaGetLastError();
}
