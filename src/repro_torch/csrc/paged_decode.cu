// Paged flash-decode: one query token per sequence over its paged KV cache.
//
// Replaces the Pallas kernel paged_decode_pallas of
// repro/kernels/decode_attention/kernel.py.  One block per (sequence b,
// kv head j) holds the G = Hq / Hkv query heads that share head j.  It
// walks only the pages p with p * PS < lengths[b]: a page table row from
// snapshot_view is NO_PAGE (-1) past the visible length, and a not-found
// row is -1 throughout with length 0, so no padding entry is ever read.
// An entry inside the visible length that names no page of the pool
// (page < 0 or page >= N) is a corrupt view: the block stops and writes
// NaN to all G heads, so the fault shows instead of a plausible output.
// For each page the block stages the K and V tiles [PS, D] of head j in
// shared memory as float32, computes the G x PS logits (masked past the
// length), and updates the running max m, sum l and accumulator acc of an
// online softmax, also in shared memory.  The output is acc / l, or zeros
// when l == 0 (length 0).  Every sum runs in a fixed order with no atomics,
// so the result is deterministic: the same inputs give the same bits.
// Templates cover float32 and bfloat16 pages; arithmetic is float32.
//
// Bound on the H100: bytes (each visible K/V element is read once and used
// for 2G multiply-adds).  This first version is plain CUDA-core code: one
// thread per logit and per output element, no tensor cores, no cp.async.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

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

template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ kp,
                                    const T* __restrict__ vp,
                                    const int* __restrict__ table,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int N, int Hq,
                                    int Hkv, int D, int PS, int MP,
                                    float scale) {
  const int b = blockIdx.x / Hkv;
  const int j = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [G, D]
  float* acc_s = q_s + G * D;          // [G, D]
  float* k_s = acc_s + G * D;          // [PS, D + 1] (padded: no conflicts)
  float* v_s = k_s + PS * (D + 1);     // [PS, D]
  float* p_s = v_s + PS * D;           // [G, PS]
  float* m_s = p_s + G * PS;           // [G]
  float* l_s = m_s + G;                // [G]
  float* a_s = l_s + G;                // [G] rescale of the previous acc

  const int len = lengths[b];
  const long long qoff = ((long long)b * Hq + (long long)j * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    q_s[i] = to_f(q[qoff + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int n_pages = min(MP, (len + PS - 1) / PS);
  bool corrupt = false;
  for (int p = 0; p < n_pages; ++p) {
    const int page = table[(long long)b * MP + p];
    if (page < 0 || page >= N) {  // the same entry for every thread
      corrupt = true;
      break;
    }
    for (int i = tid; i < PS * D; i += blockDim.x) {
      const int tok = i / D, d = i % D;
      const long long src = (((long long)page * PS + tok) * Hkv + j) * D + d;
      k_s[tok * (D + 1) + d] = to_f(kp[src]);
      v_s[tok * D + d] = to_f(vp[src]);
    }
    __syncthreads();
    for (int i = tid; i < G * PS; i += blockDim.x) {
      const int g = i / PS, tok = i % PS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += q_s[g * D + d] * k_s[tok * (D + 1) + d];
      p_s[i] = (p * PS + tok < len) ? s * scale : kNegInf;
    }
    __syncthreads();
    for (int g = tid; g < G; g += blockDim.x) {
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int tok = 0; tok < PS; ++tok) m_new = fmaxf(m_new, p_s[g * PS + tok]);
      const float alpha = expf(m_prev - m_new);
      float l = l_s[g] * alpha;
      for (int tok = 0; tok < PS; ++tok) {
        const float e = expf(p_s[g * PS + tok] - m_new);
        p_s[g * PS + tok] = e;
        l += e;
      }
      m_s[g] = m_new;
      l_s[g] = l;
      a_s[g] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      float a = acc_s[i] * a_s[g];
      for (int tok = 0; tok < PS; ++tok) a += p_s[g * PS + tok] * v_s[tok * D + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }
  const float nan = __int_as_float(0x7fc00000);
  for (int i = tid; i < G * D; i += blockDim.x) {
    const float l = l_s[i / D];
    out[qoff + i] = from_f<T>(corrupt ? nan : l == 0.f ? 0.f : acc_s[i] / l);
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lengths, void* out, int B, int N, int Hq, int Hkv,
           int D, int PS, int MP, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * (2 * G * D + PS * (D + 1) + PS * D + G * PS + 3 * G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0 && Hkv > 0) {
    paged_decode_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
        (const T*)q, (const T*)kp, (const T*)vp, table, lengths, (T*)out, N,
        Hq, Hkv, D, PS, MP, 1.0f / std::sqrt((float)D));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mvgc_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const int* page_table,
                                 const int* lengths, void* out, int B, int N,
                                 int Hq, int Hkv, int D, int PS, int MP,
                                 int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<__nv_bfloat16>(q, k_pages, v_pages, page_table,
                                         lengths, out, B, N, Hq, Hkv, D, PS,
                                         MP, stream)
                 : launch<float>(q, k_pages, v_pages, page_table, lengths,
                                 out, B, N, Hq, Hkv, D, PS, MP, stream);
}
