// K6b: the gradient of blockwise flash attention (K6), float32 on the CUDA
// cores, with GQA, a sliding window and a tanh logit softcap.
//
// The JAX package has no Pallas kernel for it: JAX differentiates its
// attention (_xla_flash, repro/models/attention.py) by autodiff, with each
// KV block checkpointed so that the backward recomputes the probabilities
// instead of storing them.  This is the same contract by hand: K6 stores
// each row's log-sum-exp (lse), and the backward recomputes P tile by tile
// from q, k and lse, never holding a [T, S] matrix.  With
//   x = scale q.k,  s = cap tanh(x / cap) (s = x without a cap),
//   P = exp(s - lse) (0 where the mask hides the column),
//   delta_i = dO_i . O_i,  dP = dO V^T,  dS = P (dP - delta),
//   dX = dS (1 - tanh^2)  (dX = dS without a cap),
// it returns dV = P^T dO, dQ = scale dX K and dK = scale dX^T Q, where dK
// and dV sum over the G = Hq / Hkv query heads that read each KV head.
//
// Two kernels, launched in this order on the caller's stream, and no
// atomics, so two calls give the same bits:
//   flash_bwd_dq_kernel: one block per (b, query head, 64-row query tile)
//     computes delta for its rows (written out for the next kernel), then
//     loops over the KV tiles its rows can see (skipped by the causal and
//     window bounds, as K6 skips them) and accumulates dQ in registers;
//   flash_bwd_dkdv_kernel: one block per (b, KV head, KV tile) loops over
//     the G query heads of its group and, for each, over the query tiles
//     whose rows can see a column of its tile, and accumulates dK and dV in
//     registers.
// Each recomputes S = Q K^T and dP = dO V^T for its tiles, so the pair
// does 7 products of T x S x D per query head where one fused kernel with
// atomics would do 5.
//
// Bound on the H100: operations (float32 on the CUDA cores, 67 TFLOP/s):
// the 5 products of the backward over the visible pairs against reading
// q, k, v, o, dO and writing dq, dk, dv once: at gemma2-2b's training layer
// (T 4096, D 256) about 1000 operations per byte.
//
// Tiles.  Every operand tile lives in shared memory row-major with rows
// padded to DP + 4 floats, so a float4 along the head dim is one 16-byte
// load and eight consecutive rows fall on distinct banks.  A query tile is
// 64 rows; a KV tile is 64 columns at DP 64 and 128 and 32 at DP 256, where
// two float32 KV tiles of 64 columns (128 KB) with the query tiles would
// not fit in the 227 KB a block may use.  The S and dP tiles are computed
// by 16 x 16 threads, each owning rows ty + 16 i and columns tx + 16 j; the
// accumulators [rows][DP] by threads that own float4 groups of the head
// dim (32 consecutive threads on 32 consecutive groups) and a few rows.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;

template <int DP>
struct Bwd {
  static constexpr int BQ = 64;                   // query rows of a tile
  static constexpr int BK = DP == 256 ? 32 : 64;  // KV columns of a tile
  static constexpr int LDD = DP + 4;              // row of a [rows][DP] tile
  static constexpr int LDP = BK + 4;              // row of a [BQ][BK] tile
  static constexpr int RM = BQ / 16;              // S rows per thread
  static constexpr int CN = BK / 16;              // S columns per thread
  static constexpr int TD = DP / 4 < 32 ? DP / 4 : 32;  // threads along d
  static constexpr int TR = kThreads / TD;        // thread rows
  static constexpr int NG = DP / 4 / TD;          // float4 groups a thread
  // floats of shared memory
  static constexpr int DQ_SMEM = 2 * BQ * LDD + 2 * BK * LDD + BQ * LDP
                                 + 2 * BQ;
  static constexpr int DKDV_SMEM = 2 * BK * LDD + 2 * BQ * LDD
                                   + 2 * BQ * LDP + 2 * BQ;
};

static_assert(Bwd<256>::DKDV_SMEM * 4 <= 232448, "dkdv tile too large");
static_assert(Bwd<256>::DQ_SMEM * 4 <= 232448, "dq tile too large");
static_assert(Bwd<128>::DKDV_SMEM * 4 <= 232448, "dkdv tile too large");

// dst[r][d] (rows padded to DP + 4) = src[row0 + r][d], 0 past nrows or D
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int nrows, int D) {
  for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, row = row0 + r;
    dst[r * (DP + 4) + d] =
        (row < nrows && d < D) ? src[(long long)row * D + d] : 0.f;
  }
}

// acc[i][j] = A[ty + 16 i] . Bm[tx + 16 j] over the DP dims
template <int DP, int RM, int CN>
__device__ __forceinline__ void tile_dots(const float* A, const float* Bm,
                                          int ty, int tx,
                                          float (&acc)[RM][CN]) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 a[RM], c[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + d]);
#pragma unroll
    for (int j = 0; j < CN; ++j)
      c[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, c[j].x, s);
        s = fmaf(a[i].y, c[j].y, s);
        s = fmaf(a[i].z, c[j].z, s);
        s = fmaf(a[i].w, c[j].w, s);
        acc[i][j] = s;
      }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

// The probabilities and dX of a thread's RM x CN elements of a tile from
// its S (scaled below) and dP dot products; rows and columns are absolute
// positions of the tile's first row and column.
template <int RM, int CN>
__device__ __forceinline__ void probs_and_dx(
    float (&s)[RM][CN], float (&dp)[RM][CN], const float* lse_s,
    const float* delta_s, int q0, int c0, int ty, int tx, int nq, int nk,
    int causal, int window, float softcap, float scale) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int col = c0 + tx + 16 * j;
      const bool vis = row < nq && col < nk && (!causal || col <= row) &&
                       (window <= 0 || col > row - window);
      float x = s[i][j] * scale, dsdx = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(x / softcap);
        x = t * softcap;
        dsdx = 1.f - t * t;
      }
      const float p = vis ? expf(x - lse) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta) * dsdx;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int Hq, int Hkv, int nq, int nk,
                    int D, int causal, int window, float softcap,
                    float scale) {
  using C = Bwd<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, LDD = C::LDD, LDP = C::LDP;
  constexpr int RA = BQ / C::TR;   // accumulator rows a thread
  const int n_t = (nq + BQ - 1) / BQ;
  const int qt = n_t - 1 - (int)blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int td = tid % C::TD, tr = tid / C::TD;
  const int q0 = qt * BQ;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LDD]
  float* dOs = Qs + BQ * LDD;                   // [BQ][LDD]
  float* Ks = dOs + BQ * LDD;                   // [BK][LDD]
  float* Vs = Ks + BK * LDD;                    // [BK][LDD]
  float* dXs = Vs + BK * LDD;                   // [BQ][LDP]
  float* lse_s = dXs + BQ * LDP;                // [BQ]
  float* delta_s = lse_s + BQ;                  // [BQ]

  const long long row_base = ((long long)b * Hq + h) * nq;
  const long long q_base = row_base * D;
  const long long kv_base = ((long long)b * Hkv + hk) * (long long)nk * D;
  load_rows<DP, BQ>(Qs, q + q_base, q0, nq, D);
  load_rows<DP, BQ>(dOs, dout + q_base, q0, nq, D);
  __syncthreads();

  // delta = rowsum(dO * O), a warp per row, summed by a butterfly (every
  // lane ends with the same bits)
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < nq)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(dOs[r * LDD + d], o[q_base + (long long)row * D + d], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = row < nq ? lse[row_base + row] : INFINITY;
      if (row < nq) delta[row_base + row] = acc;
    }
  }

  // the KV tiles with a column some row of this tile can see
  int kv_lo = 0, kv_hi = nk;
  if (causal) kv_hi = min(nk, q0 + BQ);
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  const int t_lo = kv_lo / BK, t_hi = (kv_hi + BK - 1) / BK;

  float4 acc[RA][C::NG];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int g = 0; g < C::NG; ++g)
      acc[a][g] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = t_lo; t < t_hi; ++t) {
    const int c0 = t * BK;
    __syncthreads();   // the last tile's readers of K and dX are done
    load_rows<DP, BK>(Ks, k + kv_base, c0, nk, D);
    load_rows<DP, BK>(Vs, v + kv_base, c0, nk, D);
    __syncthreads();

    float s[C::RM][C::CN], dp[C::RM][C::CN];
    tile_dots<DP>(Qs, Ks, ty, tx, s);
    tile_dots<DP>(dOs, Vs, ty, tx, dp);
    probs_and_dx(s, dp, lse_s, delta_s, q0, c0, ty, tx, nq, nk, causal,
                 window, softcap, scale);
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::CN; ++j)
        dXs[(ty + 16 * i) * LDP + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ += dX K
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float w[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) w[a] = dXs[(tr + C::TR * a) * LDP + c];
#pragma unroll
      for (int g = 0; g < C::NG; ++g) {
        const float4 kk = *reinterpret_cast<const float4*>(
            &Ks[c * LDD + 4 * (td + C::TD * g)]);
#pragma unroll
        for (int a = 0; a < RA; ++a) fma4(acc[a][g], w[a], kk);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int row = q0 + tr + C::TR * a;
    if (row >= nq) continue;
    float* dst = dq + q_base + (long long)row * D;
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      const int d = 4 * (td + C::TD * g);
      const float vals[4] = {acc[a][g].x, acc[a][g].y, acc[a][g].z,
                             acc[a][g].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < D) dst[d + e] = vals[e] * scale;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Hq,
                      int Hkv, int nq, int nk, int D, int causal, int window,
                      float softcap, float scale) {
  using C = Bwd<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, LDD = C::LDD, LDP = C::LDP;
  constexpr int RA = BK / C::TR;   // accumulator rows (KV columns) a thread
  const int c0 = blockIdx.x * BK;  // the most causal rows first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int td = tid % C::TD, tr = tid / C::TD;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][LDD]
  float* Vs = Ks + BK * LDD;                    // [BK][LDD]
  float* Qs = Vs + BK * LDD;                    // [BQ][LDD]
  float* dOs = Qs + BQ * LDD;                   // [BQ][LDD]
  float* Ps = dOs + BQ * LDD;                   // [BQ][LDP]
  float* dXs = Ps + BQ * LDP;                   // [BQ][LDP]
  float* lse_s = dXs + BQ * LDP;                // [BQ]
  float* delta_s = lse_s + BQ;                  // [BQ]

  const long long kv_base = ((long long)b * Hkv + hk) * (long long)nk * D;
  load_rows<DP, BK>(Ks, k + kv_base, c0, nk, D);
  load_rows<DP, BK>(Vs, v + kv_base, c0, nk, D);

  // the query rows that can see a column of this tile
  int r_lo = 0, r_hi = nq;
  if (causal) r_lo = c0;
  if (window > 0) r_hi = min(nq, c0 + BK - 1 + window);
  const int t_lo = r_lo / BQ, t_hi = r_lo < r_hi ? (r_hi + BQ - 1) / BQ : 0;

  float4 adk[RA][C::NG], adv[RA][C::NG];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      adk[a][g] = make_float4(0.f, 0.f, 0.f, 0.f);
      adv[a][g] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int gh = 0; gh < G; ++gh) {
    const int h = hk * G + gh;
    const long long row_base = ((long long)b * Hq + h) * nq;
    const long long q_base = row_base * D;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * BQ;
      __syncthreads();   // the last tile's readers are done
      load_rows<DP, BQ>(Qs, q + q_base, q0, nq, D);
      load_rows<DP, BQ>(dOs, dout + q_base, q0, nq, D);
      for (int r = tid; r < BQ; r += kThreads) {
        const int row = q0 + r;
        lse_s[r] = row < nq ? lse[row_base + row] : INFINITY;
        delta_s[r] = row < nq ? delta[row_base + row] : 0.f;
      }
      __syncthreads();

      float s[C::RM][C::CN], dp[C::RM][C::CN];
      tile_dots<DP>(Qs, Ks, ty, tx, s);
      tile_dots<DP>(dOs, Vs, ty, tx, dp);
      probs_and_dx(s, dp, lse_s, delta_s, q0, c0, ty, tx, nq, nk, causal,
                   window, softcap, scale);
#pragma unroll
      for (int i = 0; i < C::RM; ++i)
#pragma unroll
        for (int j = 0; j < C::CN; ++j) {
          Ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
          dXs[(ty + 16 * i) * LDP + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dV += P^T dO, dK += dX^T Q
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pw[RA], xw[RA];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          pw[a] = Ps[r * LDP + tr + C::TR * a];
          xw[a] = dXs[r * LDP + tr + C::TR * a];
        }
#pragma unroll
        for (int g = 0; g < C::NG; ++g) {
          const int d = 4 * (td + C::TD * g);
          const float4 o4 =
              *reinterpret_cast<const float4*>(&dOs[r * LDD + d]);
          const float4 q4 =
              *reinterpret_cast<const float4*>(&Qs[r * LDD + d]);
#pragma unroll
          for (int a = 0; a < RA; ++a) {
            fma4(adv[a][g], pw[a], o4);
            fma4(adk[a][g], xw[a], q4);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int col = c0 + tr + C::TR * a;
    if (col >= nk) continue;
    float* dk_row = dk + kv_base + (long long)col * D;
    float* dv_row = dv + kv_base + (long long)col * D;
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      const int d = 4 * (td + C::TD * g);
      const float kv[4] = {adk[a][g].x, adk[a][g].y, adk[a][g].z,
                           adk[a][g].w};
      const float vv[4] = {adv[a][g].x, adv[a][g].y, adv[a][g].z,
                           adv[a][g].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < D) {
          dk_row[d + e] = kv[e] * scale;
          dv_row[d + e] = vv[e];
        }
    }
  }
}

template <int DP>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int nq, int nk,
               int D, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  using C = Bwd<DP>;
  constexpr size_t dq_smem = sizeof(float) * C::DQ_SMEM;
  constexpr size_t dkdv_smem = sizeof(float) * C::DKDV_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkdv_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((nq + C::BQ - 1) / C::BQ, Hq, B);
  flash_bwd_dq_kernel<DP><<<grid_q, kThreads, dq_smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, (const float*)lse, (float*)delta, (float*)dq, Hq,
      Hkv, nq, nk, D, causal, window, softcap, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_kv((nk + C::BK - 1) / C::BK, Hkv, B);
  flash_bwd_dkdv_kernel<DP><<<grid_kv, kThreads, dkdv_smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, Hq, Hkv,
      nq, nk, D, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// float32, contiguous: q, o, dout, dq [B, Hq, T, D]; k, v, dk, dv
// [B, Hkv, S, D]; lse (K6's) and delta (scratch, written here) [B, Hq, T];
// 0 < D <= 256, Hq % Hkv == 0, B, Hq, T, S >= 1 (the wrapper checks all of
// it); scale is 1 / sqrt(D).  Launches the dq kernel, then the dk/dv
// kernel, which reads the delta the first one wrote.
extern "C" int mvgc_flash_backward(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Hq, int Hkv, int T, int S,
                                   int D, int causal, int window,
                                   float softcap, float scale,
                                   cudaStream_t stream) {
  if (D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                          Hkv, T, S, D, causal, window, softcap, scale,
                          stream);
  if (D <= 128)
    return launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                           Hkv, T, S, D, causal, window, softcap, scale,
                           stream);
  return launch_bwd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                         Hkv, T, S, D, causal, window, softcap, scale,
                         stream);
}
