// Paged flash-decode: one query token per sequence over its paged KV cache.
//
// Replaces the Pallas kernel paged_decode_pallas of
// repro/kernels/decode_attention/kernel.py.  Only the pages p with
// p * PS < lengths[b] are read: a page table row from snapshot_view is
// NO_PAGE (-1) past the visible length, and a not-found row is -1
// throughout with length 0, so no padding entry is ever read.  An entry
// inside the visible length that names no page of the pool (page < 0 or
// page >= N) is a corrupt view: all G heads of that (sequence, kv head)
// give NaN, so the fault shows instead of a plausible output.  Length 0
// gives zeros.  Float32 or bfloat16 pages; float32 arithmetic.
//
// Bound on the H100: bytes.  Each visible K and V element is read once and
// feeds only 2G multiply-adds (G = Hq / Hkv query heads per kv head): for
// minitron-4b's G = 3, 6 operations per 2-byte element, far under the 295
// per byte at which the card becomes compute-bound.  So the kernel stays
// on the CUDA cores and is built to keep many loads in flight:
//
// * Split KV.  paged_decode_kernel runs on a grid (B * Hkv, n_split,
//   head groups): each block streams a fixed chunk of one sequence's pages
//   for one kv head and writes a partial (m, l, acc[G, D]) in float32 to
//   scratch; a block whose chunk starts past the length exits at once.
//   n_split is chosen on the host from B * Hkv, MP and the SM count (the
//   wrapper; it never reads the lengths), so a small batch fills the card
//   too.  paged_decode_kernel_combine then merges the partials of each
//   (sequence, query head) in split order.
// * Inside a block, each of 4 warps owns whole pages (warp, warp + 4, ...
//   of the chunk; the chunk's page ids are staged in shared memory first,
//   where a corrupt entry is found before any K/V is read).  A token's head
//   row is read by a group of lanes, 16 bytes a lane and two 16-byte
//   vectors each (128 bf16 dims: 8 lanes, four tokens per warp load).
//   Each lane stages its own vectors of the next two steps in a 3-deep
//   cp.async ring in shared memory while it computes on the current one,
//   and reads back only what it staged, so the ring needs no barrier.  The
//   G query heads live in registers (G of 1-4 exactly, else groups of 8),
//   pre-scaled by 1/sqrt(D) log2(e) so the softmax runs in exp2.  Logits
//   are reduced across the lane group with xor shuffles.  Each lane group
//   keeps its own (m, l, acc), rescaled only when the max grows, with no
//   __syncthreads per page; the lane groups of a warp merge by xor
//   shuffles, the warps once through shared memory in warp order.
//
// The constants below were chosen by timing variants on the H100 at the
// serving shape (256 sequences, Hkv 8, D 128, pages of 16 bf16 tokens): 2
// vectors a lane, 4 slots a lane a step (two tokens), a 3-deep ring (48 KB
// a block; registers allow three blocks an SM), and in the wrapper's
// split_plan 1024 tokens a split, rounded to whole waves of blocks.
//
// Every merge runs in a fixed order with no atomics, so two calls give the
// same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kStages = 3;   // steps a warp has in its cp.async ring
constexpr int kSlots = 4;    // vectors of K (and of V) a lane stages a step
constexpr int kBf16Vecs = 2;  // 16-byte vectors of a bf16 head row a lane reads
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// V elements of T read by one load: 16 bytes, or one element
template <typename T, int V>
struct Pack;
template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static void to_float(const Raw& r, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <>
struct Pack<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static void to_float(const Raw& r, float (&f)[4]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};
template <>
struct Pack<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ __forceinline__ static void to_float(const Raw& r, float (&f)[1]) {
    f[0] = __bfloat162float(r);
  }
};
template <>
struct Pack<float, 1> {
  using Raw = float;
  __device__ __forceinline__ static void to_float(const Raw& r, float (&f)[1]) {
    f[0] = r;
  }
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// exp2(x - mu), with mu = 0 for a max that is still -inf (exp2(-inf) = 0)
__device__ __forceinline__ float base_of(float m) {
  return m == -INFINITY ? 0.f : m;
}

// Stages a V-element vector of one token's K or V row in shared memory:
// a 16-byte cp.async (zero-filled when the token is not read), or for a
// one-element vector a plain load and store.
template <typename Raw>
__device__ __forceinline__ void stage_in(Raw* dst, const Raw* src, bool ok) {
  if constexpr (sizeof(Raw) == 16) {
    asm volatile(
        "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
            static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
        "l"(src), "r"(ok ? 16 : 0)
        : "memory");
  } else {
    *dst = ok ? *src : Raw{};
  }
}
__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (b * Hkv + j, split, head group): pages [split * chunk, ...) of
// sequence b for kv head j and query heads j * G + g0 .. + MAXG.  A lane
// group of `lpt` lanes (a power of two) reads a token's head row, lane sub
// the vectors v * lpt + sub (v < NV), RS tokens per lane group per step.
// Each lane stages its own vectors of a step in a kStages-deep ring in
// shared memory (16-byte cp.async), and reads back only what it staged, so
// the ring needs no barrier.  Writes part_o [B * Hq, n_split, D] and
// part_ml [B * Hq, n_split, 2] (m in the log2 domain, NaN for a corrupt
// view; l).
template <typename T, int V, int NV, int MAXG>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lengths, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int N, int Hq, int Hkv, int D,
                    int PS, int MP, int chunk, int n_split, int lpt,
                    float q_scale) {
  using P = Pack<T, V>;
  using Raw = typename P::Raw;
  constexpr int RS = kSlots / NV > 0 ? kSlots / NV : 1;
  constexpr int kThreadsD = kWarps * 32;
  const float kNegInf = -INFINITY;
  const int b = blockIdx.x / Hkv, j = blockIdx.x % Hkv;
  const int split = blockIdx.y;
  const int G = Hq / Hkv;
  const int g0 = blockIdx.z * MAXG;
  const int len = lengths[b];
  const int n_pages = min(MP, (len + PS - 1) / PS);
  const int p_begin = split * chunk;
  if (p_begin >= n_pages) return;   // nothing of this sequence here
  const int p_end = min(n_pages, p_begin + chunk);
  const int tid = threadIdx.x;

  __shared__ float sm_m[kWarps][MAXG], sm_l[kWarps][MAXG];
  __shared__ int sm_bad;
  extern __shared__ uint4 smem[];
  Raw* ring = reinterpret_cast<Raw*>(smem);   // [kStages][2][RS * NV][lanes]
  float* sm_acc = reinterpret_cast<float*>(
      ring + kStages * 2 * RS * NV * kThreadsD);   // [kWarps][MAXG][D]
  int* sm_pages = reinterpret_cast<int*>(sm_acc + kWarps * MAXG * D);

  // this chunk's page ids; any entry that names no page of the pool makes
  // the view corrupt (every thread that sees one writes the same 1)
  if (tid == 0) sm_bad = 0;
  __syncthreads();
  for (int i = tid; i < p_end - p_begin; i += kThreadsD) {
    const int page = table[(long long)b * MP + p_begin + i];
    if (page < 0 || page >= N) sm_bad = 1;
    sm_pages[i] = page;
  }
  __syncthreads();
  const bool bad = sm_bad != 0;

  const int warp = tid / 32, lane = tid % 32;
  const int tpw = 32 / lpt;          // tokens a warp reads at once
  const int tok = lane / lpt, sub = lane % lpt;
  const int nvec = D / V;

  float qr[MAXG][NV][V], acc[MAXG][NV][V], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    const bool have = g0 + g < G;
    const T* src = q + ((long long)b * Hq + (long long)j * G + g0 + g) * D;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int vi = v * lpt + sub;
      float f[V];
      if (have && vi < nvec) {
        P::to_float(*reinterpret_cast<const Raw*>(src + vi * V), f);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        qr[g][v][e] = f[e] * q_scale;
        acc[g][v][e] = 0.f;
      }
    }
  }

  // this warp's steps: pages warp, warp + kWarps, ... of the chunk, each
  // cut into steps of tpw * RS tokens
  const int step_tokens = tpw * RS;
  const int steps_per_page = (PS + step_tokens - 1) / step_tokens;
  const int my_pages = !bad && warp < p_end - p_begin
                           ? (p_end - p_begin - warp + kWarps - 1) / kWarps
                           : 0;
  const int n_steps = my_pages * steps_per_page;

  // slot of (stage, K or V, r, v) for this lane: lanes fastest, so a warp's
  // 16-byte accesses are consecutive
  auto slot = [&](int stage, int kv, int r, int v) {
    return ring + ((stage * 2 + kv) * RS * NV + r * NV + v) * kThreadsD + tid;
  };
  // token of round r of the step at page index pk (of this warp) and part
  auto token = [&](int pk, int part, int r) {
    return part * step_tokens + r * tpw + tok;
  };
  auto visible = [&](int pk, int t) {
    const int p = p_begin + warp + pk * kWarps;
    return t < PS && p * PS + t < len;
  };
  auto issue = [&](int s, int pk, int part) {
    const int page = sm_pages[warp + pk * kWarps];
    const int stage = s % kStages;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int t = token(pk, part, r);
      const bool ok = visible(pk, t);
      const long long row = (((long long)page * PS + t) * Hkv + j) * D;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int vi = v * lpt + sub;
        const bool in = ok && vi < nvec;
        const long long off = in ? row + vi * V : 0;
        stage_in(slot(stage, 0, r, v), reinterpret_cast<const Raw*>(kp + off),
                 in);
        stage_in(slot(stage, 1, r, v), reinterpret_cast<const Raw*>(vp + off),
                 in);
      }
    }
  };
  auto compute = [&](int s, int pk, int part) {
    const int stage = s % kStages;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const bool ok = visible(pk, token(pk, part, r));
      float kf[NV][V];
#pragma unroll
      for (int v = 0; v < NV; ++v) P::to_float(*slot(stage, 0, r, v), kf[v]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float x = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < V; ++e) x = fmaf(qr[g][v][e], kf[v][e], x);
        for (int off = lpt / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (!ok) continue;
        if (x > m[g]) {   // a new max: rescale what is summed so far
          const float a = ex2(m[g] - x);
          l[g] *= a;
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[g][v][e] *= a;
          m[g] = x;
        }
        const float p = ex2(x - m[g]);
        l[g] += p;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float vf[V];
          P::to_float(*slot(stage, 1, r, v), vf);
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[g][v][e] = fmaf(p, vf[e], acc[g][v][e]);
        }
      }
    }
  };

  // kStages - 1 steps in flight ahead of the one computed
  int ipk = 0, ipart = 0, cpk = 0, cpart = 0;
  auto advance = [&](int& pk, int& part) {
    if (++part == steps_per_page) {
      part = 0;
      ++pk;
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) {
      issue(s, ipk, ipart);
      advance(ipk, ipart);
    }
    stage_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    if (s + kStages - 1 < n_steps) {
      issue(s + kStages - 1, ipk, ipart);
      advance(ipk, ipart);
    }
    stage_commit();
    stage_wait<kStages - 1>();
    compute(s, cpk, cpart);
    advance(cpk, cpart);
  }

  // merge the lane groups of the warp (xor butterflies: both lanes of a
  // pair add the same two products, so they end with the same bits)
  for (int off = lpt; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo), mu = base_of(mx);
      const float a = ex2(m[g] - mu), c = ex2(mo - mu);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][v][e], off);
          acc[g][v][e] = acc[g][v][e] * a + ao * c;
        }
      m[g] = mx;
    }
  }
  if (tok == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int vi = v * lpt + sub;
        if (vi < nvec)
#pragma unroll
          for (int e = 0; e < V; ++e)
            sm_acc[(warp * MAXG + g) * D + vi * V + e] = acc[g][v][e];
      }
      if (sub == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps in warp order and write this split's partial
  const int ng = min(MAXG, G - g0);
  const float nan = __int_as_float(0x7fc00000);
  for (int i = tid; i < ng * D; i += kThreadsD) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    const float mu = base_of(mx);
    float o = 0.f, lsum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = ex2(sm_m[w][g] - mu);
      lsum = fmaf(sm_l[w][g], c, lsum);
      o = fmaf(sm_acc[(w * MAXG + g) * D + d], c, o);
    }
    const long long row =
        ((long long)b * Hq + (long long)j * G + g0 + g) * n_split + split;
    part_o[row * D + d] = o;
    if (d == 0) {
      part_ml[row * 2] = bad ? nan : mx;
      part_ml[row * 2 + 1] = lsum;
    }
  }
}

// Block b * Hq + h: merges the partials of the splits that hold visible
// tokens, in split order; NaN if any of them met a corrupt entry, 0 for
// length 0.
template <typename T>
__global__ void paged_decode_kernel_combine(const float* __restrict__ part_o,
                                            const float* __restrict__ part_ml,
                                            const int* __restrict__ lengths,
                                            T* __restrict__ out, int Hq, int D,
                                            int PS, int MP, int chunk,
                                            int n_split) {
  const int bh = blockIdx.x, b = bh / Hq;
  const int len = lengths[b];
  const int n_pages = min(MP, (len + PS - 1) / PS);
  const int n_act = (n_pages + chunk - 1) / chunk;
  const float* ml = part_ml + (long long)bh * n_split * 2;
  const float* po = part_o + (long long)bh * n_split * D;
  float mx = -INFINITY;
  bool bad = false;
  for (int s = 0; s < n_act; ++s) {
    bad |= isnan(ml[2 * s]);
    mx = fmaxf(mx, ml[2 * s]);
  }
  const float mu = base_of(mx);
  const float nan = __int_as_float(0x7fc00000);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_act; ++s) {
      const float c = ex2(ml[2 * s] - mu);
      den = fmaf(ml[2 * s + 1], c, den);
      num = fmaf(po[(long long)s * D + d], c, num);
    }
    out[(long long)bh * D + d] =
        from_f<T>(bad ? nan : den == 0.f ? 0.f : num / den);
  }
}

// lanes per token: the power of two that covers a head row in NV vectors
// a lane
int lanes_per_token(int nvec, int nv) {
  int lpt = 1;
  while (lpt * nv < nvec) lpt *= 2;
  return lpt;
}

template <typename T, int V, int NV, int MAXG>
int launch_split(const void* q, const void* kp, const void* vp,
                 const int* table, const int* lengths, float* part_o,
                 float* part_ml, int B, int N, int Hq, int Hkv, int D, int PS,
                 int MP, int chunk, int n_split, cudaStream_t stream) {
  using Raw = typename Pack<T, V>::Raw;
  constexpr int RS = kSlots / NV > 0 ? kSlots / NV : 1;
  const int G = Hq / Hkv;
  const dim3 grid(B * Hkv, n_split, (G + MAXG - 1) / MAXG);
  const size_t smem = sizeof(Raw) * kStages * 2 * RS * NV * kWarps * 32 +
                      sizeof(float) * kWarps * MAXG * D + sizeof(int) * chunk;
  auto kernel = paged_decode_kernel<T, V, NV, MAXG>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, table, lengths, part_o, part_ml,
      N, Hq, Hkv, D, PS, MP, chunk, n_split, lanes_per_token(D / V, NV),
      kLog2e / std::sqrt((float)D));
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte lane loads (V16 elements, NV16 vectors a lane) where every head
// row starts on a 16-byte boundary, with the query heads of a kv head held
// exactly (G <= 4) or in groups of 8; else one element a lane
template <typename T, int V16, int NV16>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lengths, void* out, float* part_o, float* part_ml, int B,
           int N, int Hq, int Hkv, int D, int PS, int MP, int n_split,
           cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || Hq <= 0) return (int)cudaGetLastError();
  const int chunk = MP > 0 ? (MP + n_split - 1) / n_split : 1;
  const int G = Hq / Hkv;
  int err;
#define MVGC_SPLIT(V_, NV_, G_)                                              \
  launch_split<T, V_, NV_, G_>(q, kp, vp, table, lengths, part_o, part_ml, B, \
                               N, Hq, Hkv, D, PS, MP, chunk, n_split, stream)
  if (D % V16 == 0 && aligned16(q) && aligned16(kp) && aligned16(vp)) {
    err = G == 1   ? MVGC_SPLIT(V16, NV16, 1)
          : G == 2 ? MVGC_SPLIT(V16, NV16, 2)
          : G == 3 ? MVGC_SPLIT(V16, NV16, 3)
          : G == 4 ? MVGC_SPLIT(V16, NV16, 4)
                   : MVGC_SPLIT(V16, NV16, 8);
  } else {
    err = MVGC_SPLIT(1, 8, 8);
  }
#undef MVGC_SPLIT
  if (err != 0) return err;
  paged_decode_kernel_combine<T><<<B * Hq, 128, 0, stream>>>(
      part_o, part_ml, lengths, (T*)out, Hq, D, PS, MP, chunk, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, D], k/v pages [N, PS, Hkv, D], page_table i32 [B, MP], lengths
// i32 [B], out [B, Hq, D]; part_o f32 [B * Hq * n_split * D] and part_ml
// f32 [B * Hq * n_split * 2] are scratch; D <= 256, Hq % Hkv == 0 (the
// wrapper checks it).  Two launches: the split pass and the combine.
extern "C" int mvgc_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const int* page_table,
                                 const int* lengths, void* out, void* part_o,
                                 void* part_ml, int B, int N, int Hq, int Hkv,
                                 int D, int PS, int MP, int n_split,
                                 int is_bf16, cudaStream_t stream) {
  if (D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 || n_split <= 0 ||
      PS <= 0)
    return (int)cudaErrorInvalidValue;
  float* po = (float*)part_o;
  float* pm = (float*)part_ml;
  return is_bf16 ? launch<__nv_bfloat16, 8, kBf16Vecs>(
                       q, k_pages, v_pages, page_table, lengths, out, po, pm,
                       B, N, Hq, Hkv, D, PS, MP, n_split, stream)
                 : launch<float, 4, 2>(q, k_pages, v_pages, page_table,
                                       lengths, out, po, pm, B, N, Hq, Hkv, D,
                                       PS, MP, n_split, stream);
}
