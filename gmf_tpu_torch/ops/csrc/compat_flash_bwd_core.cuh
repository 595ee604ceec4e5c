// Core of the STREAMING compat-modulated flash attention BACKWARD kernels
// for Hopper, sm_90a: the gradient of compat_flash_core.cuh's streaming
// forward with respect to q, k and v, recomputed from the forward's base-2
// log-sum-exp. Compat is rebuilt from the keypoints with compat_stream(),
// the very function the forward used (compat_flash_attention_bwd.cu). Its
// only instances are Compat::kStream (the template keeps the parameters
// MODE, CT, cache and ld, unused, so those kernels keep their names and
// code); the cached backward is compat_flash_bwd_tc.cuh's, on the tensor
// cores.
//
// For pair b, query i and key j (qs = q * scale * log2(e), folded as in the
// forward; lse and delta per query row):
//
//   s       = compat * (qs_i . k_j)        masked keys: -1e9 AFTER the
//   p       = exp2(s - lse_i)              multiply, as in the forward
//   dp      = do_i . v_j
//   dlogits = p * (dp - delta_i) * compat * scale
//   dV_j = sum_i p * do_i,  dK_j = sum_i dlogits * q_i,  dQ_i = sum_j
//   dlogits * k_j
//
// with plain `scale` in dlogits: the ln 2 of d exp2 cancels the folded
// log2(e). delta_i = rowsum(do_i * out_i) comes from the caller, and so
// does lse_i = 1e9 on masked query rows, which makes their p exactly 0.
// Keys past N carry no weight; nothing is padded.
//
// Tiles: BWD_BQ = 64 queries x BWD_BK = 32 keys. bwd_tile() computes p and
// dlogits of one tile into shared memory, each of the 256 threads owning
// a 2 x 4 patch (the forward's logits layout, so the products q.k are
// summed in the forward's order). Two kernels use it:
//
//   compat_flash_bwd_dkv  one block per (key tile, pair) keeps its 32 keys'
//                         k, v resident and loops over the query tiles;
//                         each thread accumulates 2 keys x D/16 columns of
//                         dK and dV in registers;
//   compat_flash_bwd_dq   one block per (query tile, pair) keeps its 64
//                         queries resident and loops over the key tiles;
//                         each thread accumulates 4 rows x D/16 columns of
//                         dQ (the forward's output layout).
//
// No atomics: each block owns its outputs, so results are deterministic.
// Arithmetic is f32 on the CUDA cores. Under bf16 the operands are rounded
// to bf16 before each product where the TPU kernel casts to its matmul
// type: qs (and k, v, do, q, which arrive in bf16), p before dV, dlogits
// before dK and dQ.

#pragma once

#include "compat_flash_core.cuh"

namespace {

constexpr int BWD_BQ = 64;  // queries per tile
constexpr int BWD_BK = 32;  // keys per tile
constexpr int BWD_PP = BWD_BK + 1;

// Per-row side data in shared memory, 8 floats a row:
//   query rows: s.xyz, t.xyz, lse, delta
//   key rows:   s.xyz, t.xyz, key state (1 valid, 0 masked, -1 past N)
constexpr int SIDE = 8;

// rows [r0, r0 + rows) of a [N, D] tensor into a [rows][D + 1] f32 tile,
// times `mul` and rounded to T (exact for mul = 1: the values are T's own);
// rows past N are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int rows, int N, float mul) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, d = e % D, i = r0 + r;
    const float x = i < N ? load_f32(src + (size_t)i * D + d) : 0.f;
    dst[r * (D + 1) + d] = round_to<T>(x * mul);
  }
}

// query side rows: coordinates (kStream), lse and delta
template <bool kCoords>
__device__ __forceinline__ void load_query_side(float* dst, const float* src,
                                                const float* tgt,
                                                const float* lse,
                                                const float* delta, int q0,
                                                int N) {
  for (int e = threadIdx.x; e < BWD_BQ * SIDE; e += THREADS) {
    const int r = e / SIDE, c = e % SIDE, i = q0 + r;
    float x = 0.f;
    if (i < N) {
      if (c == 6)
        x = lse[i];
      else if (c == 7)
        x = delta[i];
      else if (kCoords)
        x = c < 3 ? src[(size_t)i * 3 + c] : tgt[(size_t)i * 3 + c - 3];
    }
    dst[e] = x;
  }
}

// key side rows: coordinates (kStream) and the key state
template <bool kCoords>
__device__ __forceinline__ void load_key_side(float* dst, const float* src,
                                              const float* tgt,
                                              const float* mask, int k0,
                                              int N) {
  for (int e = threadIdx.x; e < BWD_BK * SIDE; e += THREADS) {
    const int r = e / SIDE, c = e % SIDE, j = k0 + r;
    float x = 0.f;
    if (c == 6)
      x = j >= N ? -1.f : (mask[j] > 0.f ? 1.f : 0.f);
    else if (kCoords && c < 6 && j < N)
      x = c < 3 ? src[(size_t)j * 3 + c] : tgt[(size_t)j * 3 + c - 3];
    dst[e] = x;
  }
}

// p (when sP is given) and dlogits of the tile (queries q0.., keys k0..)
// into [BWD_BQ][BWD_PP] shared arrays, rounded to T. sQs, sDO: [BWD_BQ]
// [D + 1]; sK, sV: [BWD_BK][D + 1]; side rows as above. cache, ld: unused.
template <typename T, int D, Compat MODE, typename CT>
__device__ __forceinline__ void bwd_tile(
    const float* sQs, const float* sDO, const float* sK, const float* sV,
    const float* sQside, const float* sKside, const CT* __restrict__ cache,
    int ld, int N, int q0, int k0, float inv_sigma_sq, float scale,
    float* sP, float* sDS) {
  constexpr int DP = D + 1;
  const int tid = threadIdx.x;
  const int r1 = (tid / 8) * 2;
  const int c1 = (tid % 8) * 4;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) s[rr][cc] = dp[rr][cc] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float a0 = sQs[r1 * DP + d], a1 = sQs[(r1 + 1) * DP + d];
    const float g0 = sDO[r1 * DP + d], g1 = sDO[(r1 + 1) * DP + d];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float kv = sK[(c1 + cc) * DP + d];
      const float vv = sV[(c1 + cc) * DP + d];
      s[0][cc] = fmaf(a0, kv, s[0][cc]);
      s[1][cc] = fmaf(a1, kv, s[1][cc]);
      dp[0][cc] = fmaf(g0, vv, dp[0][cc]);
      dp[1][cc] = fmaf(g1, vv, dp[1][cc]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float* qside = sQside + (r1 + rr) * SIDE;
    const bool row_in = q0 + r1 + rr < N;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* kside = sKside + (c1 + cc) * SIDE;
      const float state = kside[6];
      float p = 0.f, ds = 0.f;
      if (row_in && state >= 0.f) {
        const float compat = compat_stream(qside, kside, inv_sigma_sq);
        float logit = compat * s[rr][cc];
        if (state == 0.f) logit = MASKED;
        p = exp2f(logit - qside[6]);
        ds = p * (dp[rr][cc] - qside[7]) * compat * scale;
      }
      if (sP != nullptr) sP[(r1 + rr) * BWD_PP + c1 + cc] = round_to<T>(p);
      sDS[(r1 + rr) * BWD_PP + c1 + cc] = round_to<T>(ds);
    }
  }
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * BWD_BK * (D + 1) + BWD_BK * SIDE + 3 * BWD_BQ * (D + 1) +
         BWD_BQ * SIDE + 2 * BWD_BQ * BWD_PP;
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * BWD_BQ * (D + 1) + BWD_BQ * SIDE + 2 * BWD_BK * (D + 1) +
         BWD_BK * SIDE + BWD_BQ * BWD_PP;
}

// q, k, v, dout: [B, N, D] of T; lse, delta, mask: [B, N] f32; src, tgt:
// [B, N, 3] (kStream); cache, ld: unused -> dk, dv [B, N, D].
template <typename T, int D, Compat MODE, typename CT>
__global__ void __launch_bounds__(THREADS)
compat_flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ src,
                     const float* __restrict__ tgt,
                     const float* __restrict__ mask,
                     const CT* __restrict__ cache, T* __restrict__ dk,
                     T* __restrict__ dv, int N, int ld, float inv_sigma_sq,
                     float qscale, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr bool kCoords = MODE == Compat::kStream;
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;                      // [BWD_BK][DP], resident
  float* sV = sK + BWD_BK * DP;          // [BWD_BK][DP], resident
  float* sKside = sV + BWD_BK * DP;      // [BWD_BK][SIDE], resident
  float* sQs = sKside + BWD_BK * SIDE;   // [BWD_BQ][DP] q * qscale
  float* sQ = sQs + BWD_BQ * DP;         // [BWD_BQ][DP] q
  float* sDO = sQ + BWD_BQ * DP;         // [BWD_BQ][DP]
  float* sQside = sDO + BWD_BQ * DP;     // [BWD_BQ][SIDE]
  float* sP = sQside + BWD_BQ * SIDE;    // [BWD_BQ][BWD_PP]
  float* sDS = sP + BWD_BQ * BWD_PP;     // [BWD_BQ][BWD_PP]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BWD_BK;
  const size_t base = (size_t)blockIdx.y * N;
  q += base * D;
  k += base * D;
  v += base * D;
  dout += base * D;
  dk += base * D;
  dv += base * D;
  lse += base;
  delta += base;
  mask += base;
  if constexpr (kCoords) {
    src += base * 3;
    tgt += base * 3;
  }

  load_rows<T, D>(sK, k, k0, BWD_BK, N, 1.f);
  load_rows<T, D>(sV, v, k0, BWD_BK, N, 1.f);
  load_key_side<kCoords>(sKside, src, tgt, mask, k0, N);

  // this thread's outputs: keys jk, jk + 1; columns c3 + 16 t
  const int jk = (tid / 16) * 2;
  const int c3 = tid % 16;
  float acc_k[2][CPT], acc_v[2][CPT];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int t = 0; t < CPT; ++t) acc_k[jj][t] = acc_v[jj][t] = 0.f;

  for (int q0 = 0; q0 < N; q0 += BWD_BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(sQs, q, q0, BWD_BQ, N, qscale);
    load_rows<T, D>(sQ, q, q0, BWD_BQ, N, 1.f);
    load_rows<T, D>(sDO, dout, q0, BWD_BQ, N, 1.f);
    load_query_side<kCoords>(sQside, src, tgt, lse, delta, q0, N);
    __syncthreads();
    bwd_tile<T, D, MODE, CT>(sQs, sDO, sK, sV, sQside, sKside, cache, ld, N,
                             q0, k0, inv_sigma_sq, scale, sP, sDS);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BWD_BQ; ++i) {
      const float p0 = sP[i * BWD_PP + jk], p1 = sP[i * BWD_PP + jk + 1];
      const float d0 = sDS[i * BWD_PP + jk], d1 = sDS[i * BWD_PP + jk + 1];
#pragma unroll
      for (int t = 0; t < CPT; ++t) {
        const float g = sDO[i * DP + c3 + 16 * t];
        const float x = sQ[i * DP + c3 + 16 * t];
        acc_v[0][t] = fmaf(p0, g, acc_v[0][t]);
        acc_v[1][t] = fmaf(p1, g, acc_v[1][t]);
        acc_k[0][t] = fmaf(d0, x, acc_k[0][t]);
        acc_k[1][t] = fmaf(d1, x, acc_k[1][t]);
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = k0 + jk + jj;
    if (j >= N) continue;
#pragma unroll
    for (int t = 0; t < CPT; ++t) {
      store_from_f32(dk + (size_t)j * D + c3 + 16 * t, acc_k[jj][t]);
      store_from_f32(dv + (size_t)j * D + c3 + 16 * t, acc_v[jj][t]);
    }
  }
}

// the same inputs -> dq [B, N, D]
template <typename T, int D, Compat MODE, typename CT>
__global__ void __launch_bounds__(THREADS)
compat_flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ src,
                    const float* __restrict__ tgt,
                    const float* __restrict__ mask,
                    const CT* __restrict__ cache, T* __restrict__ dq, int N,
                    int ld, float inv_sigma_sq, float qscale, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr bool kCoords = MODE == Compat::kStream;
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* sQs = smem;                     // [BWD_BQ][DP], resident
  float* sDO = sQs + BWD_BQ * DP;        // [BWD_BQ][DP], resident
  float* sQside = sDO + BWD_BQ * DP;     // [BWD_BQ][SIDE], resident
  float* sK = sQside + BWD_BQ * SIDE;    // [BWD_BK][DP]
  float* sV = sK + BWD_BK * DP;          // [BWD_BK][DP]
  float* sKside = sV + BWD_BK * DP;      // [BWD_BK][SIDE]
  float* sDS = sKside + BWD_BK * SIDE;   // [BWD_BQ][BWD_PP]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BWD_BQ;
  const size_t base = (size_t)blockIdx.y * N;
  q += base * D;
  k += base * D;
  v += base * D;
  dout += base * D;
  dq += base * D;
  lse += base;
  delta += base;
  mask += base;
  if constexpr (kCoords) {
    src += base * 3;
    tgt += base * 3;
  }

  load_rows<T, D>(sQs, q, q0, BWD_BQ, N, qscale);
  load_rows<T, D>(sDO, dout, q0, BWD_BQ, N, 1.f);
  load_query_side<kCoords>(sQside, src, tgt, lse, delta, q0, N);

  // this thread's outputs: rows r3 .. r3 + 3; columns c3 + 16 t
  const int r3 = (tid / 16) * 4;
  const int c3 = tid % 16;
  float acc[4][CPT];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int t = 0; t < CPT; ++t) acc[rr][t] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BWD_BK) {
    __syncthreads();
    load_rows<T, D>(sK, k, k0, BWD_BK, N, 1.f);
    load_rows<T, D>(sV, v, k0, BWD_BK, N, 1.f);
    load_key_side<kCoords>(sKside, src, tgt, mask, k0, N);
    __syncthreads();
    bwd_tile<T, D, MODE, CT>(sQs, sDO, sK, sV, sQside, sKside, cache, ld, N,
                             q0, k0, inv_sigma_sq, scale, nullptr, sDS);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BWD_BK; ++j) {
      float g[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) g[rr] = sDS[(r3 + rr) * BWD_PP + j];
#pragma unroll
      for (int t = 0; t < CPT; ++t) {
        const float kv = sK[j * DP + c3 + 16 * t];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          acc[rr][t] = fmaf(g[rr], kv, acc[rr][t]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = q0 + r3 + rr;
    if (i >= N) continue;
#pragma unroll
    for (int t = 0; t < CPT; ++t)
      store_from_f32(dq + (size_t)i * D + c3 + 16 * t, acc[rr][t]);
  }
}

// Launch one backward kernel. dq_kernel selects compat_flash_bwd_dq (out0
// = dq) over compat_flash_bwd_dkv (out0 = dk, out1 = dv).
template <typename T, int D, Compat MODE, typename CT>
cudaError_t launch_bwd(bool dq_kernel, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* delta, const float* src,
                       const float* tgt, const float* mask, const CT* cache,
                       void* out0, void* out1, int B, int N, int ld,
                       float inv_sigma_sq, float qscale, float scale,
                       cudaStream_t stream) {
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* tdo = static_cast<const T*>(dout);
  if (dq_kernel) {
    const size_t bytes = dq_smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        compat_flash_bwd_dq<T, D, MODE, CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + BWD_BQ - 1) / BWD_BQ, B);
    compat_flash_bwd_dq<T, D, MODE, CT><<<grid, THREADS, bytes, stream>>>(
        tq, tk, tv, tdo, lse, delta, src, tgt, mask, cache,
        static_cast<T*>(out0), N, ld, inv_sigma_sq, qscale, scale);
  } else {
    const size_t bytes = dkv_smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        compat_flash_bwd_dkv<T, D, MODE, CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + BWD_BK - 1) / BWD_BK, B);
    compat_flash_bwd_dkv<T, D, MODE, CT><<<grid, THREADS, bytes, stream>>>(
        tq, tk, tv, tdo, lse, delta, src, tgt, mask, cache,
        static_cast<T*>(out0), static_cast<T*>(out1), N, ld, inv_sigma_sq,
        qscale, scale);
  }
  return cudaGetLastError();
}

// q/k/v element type (f32 or bf16) and head width (32 or 128)
template <Compat MODE, typename CT>
cudaError_t dispatch_bwd(bool dq_kernel, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* delta, const void* src, const void* tgt,
                         const void* mask, const CT* cache, void* out0,
                         void* out1, int B, int N, int D, int ld, int is_bf16,
                         float inv_sigma_sq, float qscale, float scale,
                         void* stream) {
  const auto* l = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* s = static_cast<const float*>(src);
  const auto* t = static_cast<const float*>(tgt);
  const auto* m = static_cast<const float*>(mask);
  auto st = static_cast<cudaStream_t>(stream);
#define GMF_BWD_CASE(T, WIDTH)                                              \
  return launch_bwd<T, WIDTH, MODE, CT>(dq_kernel, q, k, v, dout, l, dl, s, \
                                        t, m, cache, out0, out1, B, N, ld,  \
                                        inv_sigma_sq, qscale, scale, st)
  if (D == 32) {
    if (is_bf16) GMF_BWD_CASE(__nv_bfloat16, 32);
    GMF_BWD_CASE(float, 32);
  }
  if (D == 128) {
    if (is_bf16) GMF_BWD_CASE(__nv_bfloat16, 128);
    GMF_BWD_CASE(float, 128);
  }
#undef GMF_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
