// Blockwise causal flash attention for prefill, with GQA, a sliding window
// and a tanh logit softcap.
//
// Replaces the Pallas kernel flash_attention_pallas of
// repro/kernels/flash_prefill/kernel.py.  The TPU grid (B, Hq, T/BT, S/BS)
// runs its KV-block dimension in order and carries (m, l, acc) in VMEM
// across it; here one block per (b, query head h, 64-row query tile) loops
// over the 64-column KV tiles itself and keeps (m, l, acc) in registers.
// Query head h reads kv head h / G (G = Hq / Hkv), so K/V are never
// repeated per query head.  Only the tiles that hold a visible column are
// loaded: the loop starts at the first column inside the window of the
// tile's first row and stops after the last column the causal mask lets its
// last row see, as pl.when skips whole blocks in the Pallas kernel.
// Columns past S and head dims past D load as 0, so any S and any D up to
// 256 work (D is padded to a tile width DP of 64, 128 or 256).
//
// Layout of a block: 256 threads as 16 x 16; thread (ty, tx) computes the
// 4 x 4 logits of query rows ty*4.. and key columns tx*4.. of a tile from
// Q^T and K^T in shared memory (float4 reads: one for the 4 rows, one for
// the 4 columns, 16 multiply-adds), and owns output rows ty*4.. at head
// dims g*64 + tx*4.. .  The 16 threads of a row group are one half-warp;
// the row max is reduced with xor shuffles inside it, the row sum is kept
// per thread and reduced the same way once at the end.  The probabilities
// go through shared memory (P^T) for the P V product.  A masked logit gives
// probability exactly 0, and a row that sees no column gives 0 (l == 0).
// Every sum runs in a fixed order and no atomics are used, so two calls
// give the same bits.  Templates cover float32 and bfloat16 inputs; all
// arithmetic, the softmax statistics and the accumulator are float32.
//
// Bound on the H100: operations (about T^2 D multiply-adds per causal
// query head against 2 (Hq + Hkv) T D elements moved per batch row).  This
// first version runs on the CUDA cores in float32: no tensor cores, no
// cp.async or TMA, one block per SM at these tile sizes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key columns per KV tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLd = kBQ + 4;    // padded row (floats) of Q^T, K^T and P^T

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

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

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Hq,
                     int Hkv, int nq, int nk, int D, int causal, int window,
                     float softcap, float scale) {
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
    qT[d * kLd + r] = (row < nq && d < D)
                          ? to_f(q[q_base + (long long)row * D + d])
                          : 0.f;
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
      kT[d * kLd + c] = in ? to_f(k[src]) : 0.f;
      vS[c * DP + d] = in ? to_f(v[src]) : 0.f;
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
    T* dst = out + q_base + (long long)row * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        if (d < D) dst[d] = from_f<T>(lt == 0.f ? 0.f : acc[i][g * 4 + e] / lt);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int nq, int nk, int D, int causal, int window,
           float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nq + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, nq, nk, D,
      causal, window, softcap, (float)(1.0 / std::sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int nq, int nk, int D, int causal, int window,
             float softcap, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, Hq, Hkv, nq, nk, D, causal,
                         window, softcap, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, Hq, Hkv, nq, nk, D, causal,
                          window, softcap, stream);
  return launch<T, 256>(q, k, v, out, B, Hq, Hkv, nq, nk, D, causal, window,
                        softcap, stream);
}

}  // namespace

// q [B, Hq, T, D], k/v [B, Hkv, S, D], out [B, Hq, T, D]; 0 < D <= 256,
// Hq % Hkv == 0, B, Hq, T >= 1 (the wrapper checks all of it).
extern "C" int mvgc_flash_prefill(const void* q, const void* k, const void* v,
                                  void* out, int B, int Hq, int Hkv, int T,
                                  int S, int D, int causal, int window,
                                  float softcap, int is_bf16,
                                  cudaStream_t stream) {
  if (D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, T, S, D,
                                           causal, window, softcap, stream)
                 : dispatch<float>(q, k, v, out, B, Hq, Hkv, T, S, D, causal,
                                   window, softcap, stream);
}
