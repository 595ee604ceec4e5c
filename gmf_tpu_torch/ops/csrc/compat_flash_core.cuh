// Shared core of the compat-modulated flash attention kernels (forward)
// for Hopper, sm_90a, and the compat arithmetic of the cache kernels.
//
// One kernel template, three ways to obtain the compat tile:
//
//   Compat::kStream  rebuild it from the keypoints in every layer
//                    (compat_flash_attention.cu),
//   Compat::kBuild   compute the int8 code, store it to the cache and
//                    attend on the DEQUANTIZED code
//                    (compat_flash_attention_build.cu),
//   Compat::kCached  load it from a cache of f32, bf16 or int8 codes
//                    (compat_flash_attention_cached.cu),
//
// and four more forms of the compat arithmetic that the attention-variant
// microbenchmark compares (compat_flash_variants.cu): kNone (compat 1,
// plain attention), kStreamOneSqrt (difference form, one sqrt), kNormId
// and kNormIdOneSqrt (squared distances by the norm identity
// |a|^2 + |b|^2 - 2 a.b, two sqrt or one).
//
// For one pair,
//
//   out[i] = softmax_j(compat[i,j] * q_i.k_j / sqrt(D)) @ v
//
// with masked keys set to -1e9 AFTER the compat multiply (a compat of 0
// does not exclude a key). Each block owns BQ query rows of one pair and
// streams key tiles of BK rows through shared memory, with an online
// base-2 softmax whose scale*log2(e) is folded into q once. The batch is
// the grid's y dimension; keys past N carry zero weight, so no padding to
// a block multiple is needed. q/k/v may be f32 or bf16; arithmetic is f32.
// Under bf16 the scaled q and the probabilities p are rounded to bf16
// before their products, as the TPU kernels do.
//
// The cache is [B, N, ld]: row i of a pair holds its N compat entries and
// ld - N pad entries (zeros), ld chosen so every row starts 16-byte
// aligned. A thread owns 4 neighbouring keys of 2 query rows, so it moves
// its part of a cache row with one vector access (4 x int8 = 4 bytes,
// 4 x bf16 = 8 bytes, 4 x f32 = 16 bytes), and the 8 threads of a row
// cover 32 contiguous entries.
//
// The int8 code and the f32/bf16 compat are computed with explicitly
// rounded operations (no FMA contraction, IEEE sqrt and division), so the
// standalone cache kernel, the build+attend kernel and the plain PyTorch
// version agree in every byte.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per streamed tile
constexpr int THREADS = 256;
constexpr float MASKED = -1e9f;

enum class Compat {
  kStream,
  kBuild,
  kCached,
  kNone,
  kStreamOneSqrt,
  kNormId,
  kNormIdOneSqrt
};

// cache element types as the C entry points number them
constexpr int CACHE_F32 = 0, CACHE_BF16 = 1, CACHE_INT8 = 2;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---- compat arithmetic of the cache (a, b: s.xyz then t.xyz) -----------

__device__ __forceinline__ void squared_dists(const float* a, const float* b,
                                              float& ds2, float& dt2) {
  const float dx = __fsub_rn(a[0], b[0]), dy = __fsub_rn(a[1], b[1]),
              dz = __fsub_rn(a[2], b[2]);
  const float ex = __fsub_rn(a[3], b[3]), ey = __fsub_rn(a[4], b[4]),
              ez = __fsub_rn(a[5], b[5]);
  ds2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                  __fmul_rn(dz, dz));
  dt2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                  __fmul_rn(ez, ez));
}

// squared distance of a and b (3 coordinates) by the norm identity
// |a|^2 + |b|^2 - 2 a.b, clamped at 0: it cancels where the points are
// close against their distance from the origin
__device__ __forceinline__ float norm_id_sq(const float* a, const float* b) {
  const float na = __fadd_rn(__fadd_rn(__fmul_rn(a[0], a[0]),
                                       __fmul_rn(a[1], a[1])),
                             __fmul_rn(a[2], a[2]));
  const float nb = __fadd_rn(__fadd_rn(__fmul_rn(b[0], b[0]),
                                       __fmul_rn(b[1], b[1])),
                             __fmul_rn(b[2], b[2]));
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]),
                                        __fmul_rn(a[1], b[1])),
                              __fmul_rn(a[2], b[2]));
  return fmaxf(__fsub_rn(__fadd_rn(na, nb), __fmul_rn(2.f, dot)), 0.f);
}

// compat from the squared distances, one-sqrt form:
// (sqrt(a) - sqrt(b))^2 = a + b - 2 sqrt(ab)
__device__ __forceinline__ float compat_one_sqrt_of(float ds2, float dt2,
                                                    float sigma_sq) {
  const float root = __fsqrt_rn(__fmul_rn(ds2, dt2));
  const float dd2 = fmaxf(
      __fsub_rn(__fadd_rn(ds2, dt2), __fmul_rn(2.f, root)), 0.f);
  return fmaxf(__fsub_rn(1.f, __fdiv_rn(dd2, sigma_sq)), 0.f);
}

// compat from the squared distances, two-sqrt difference form
__device__ __forceinline__ float compat_two_sqrt_of(float ds2, float dt2,
                                                    float sigma_sq) {
  const float dd = __fsub_rn(__fsqrt_rn(ds2), __fsqrt_rn(dt2));
  return fmaxf(__fsub_rn(1.f, __fdiv_rn(__fmul_rn(dd, dd), sigma_sq)), 0.f);
}

// int8 cache: the one-sqrt form, then code = round_half_even(254 c - 127),
// returned as a float in [-127, 127].
__device__ __forceinline__ float compat_i8_code(const float* a,
                                                const float* b,
                                                float sigma_sq) {
  float ds2, dt2;
  squared_dists(a, b, ds2, dt2);
  const float c = compat_one_sqrt_of(ds2, dt2, sigma_sq);
  return rintf(__fsub_rn(__fmul_rn(c, 254.f), 127.f));
}

// f32 and bf16 caches: the two-sqrt difference form.
__device__ __forceinline__ float compat_two_sqrt(const float* a,
                                                 const float* b,
                                                 float sigma_sq) {
  float ds2, dt2;
  squared_dists(a, b, ds2, dt2);
  return compat_two_sqrt_of(ds2, dt2, sigma_sq);
}

// the microbenchmark's compat forms of query a and key b (s.xyz then
// t.xyz), every operation rounded on its own as in the plain version
template <Compat MODE>
__device__ __forceinline__ float compat_variant(const float* a,
                                                const float* b,
                                                float sigma_sq) {
  if constexpr (MODE == Compat::kNone) {
    return 1.f;
  } else {
    float ds2, dt2;
    if constexpr (MODE == Compat::kStreamOneSqrt) {
      squared_dists(a, b, ds2, dt2);
    } else {
      ds2 = norm_id_sq(a, b);
      dt2 = norm_id_sq(a + 3, b + 3);
    }
    if constexpr (MODE == Compat::kNormId)
      return compat_two_sqrt_of(ds2, dt2, sigma_sq);
    return compat_one_sqrt_of(ds2, dt2, sigma_sq);
  }
}

// streaming compat of query a and key b (s.xyz then t.xyz): the exact
// per-coordinate distances with IEEE sqrt. The forward and the backward
// kernels both take it from here, so the backward recomputes the very
// logits whose log-sum-exp the forward stored.
__device__ __forceinline__ float compat_stream(const float* a, const float* b,
                                               float inv_sigma_sq) {
  const float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  const float ex = a[3] - b[3], ey = a[4] - b[4], ez = a[5] - b[5];
  const float ds = sqrtf(dx * dx + dy * dy + dz * dz);
  const float dt = sqrtf(ex * ex + ey * ey + ez * ez);
  const float diff = ds - dt;
  return fmaxf(1.f - diff * diff * inv_sigma_sq, 0.f);
}

// code / 254 + 0.5 as one FMA (127 / 254 is exactly 0.5)
__device__ __forceinline__ float dequant_i8(float code) {
  return fmaf(code, 1.f / 254.f, 0.5f);
}

// ---- 4 neighbouring cache entries per access ----------------------------

__device__ __forceinline__ void load4(const float* p, float (&c)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  c[0] = x.x; c[1] = x.y; c[2] = x.z; c[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&c)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  c[0] = __uint_as_float(raw.x << 16);
  c[1] = __uint_as_float(raw.x & 0xffff0000u);
  c[2] = __uint_as_float(raw.y << 16);
  c[3] = __uint_as_float(raw.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const int8_t* p, float (&c)[4]) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  c[0] = dequant_i8((float)x.x); c[1] = dequant_i8((float)x.y);
  c[2] = dequant_i8((float)x.z); c[3] = dequant_i8((float)x.w);
}

__device__ __forceinline__ void store4(float* p, const float (&c)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(c[0], c[1], c[2], c[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&c)[4]) {
  uint2 raw;
  raw.x = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(c[0])) |
          ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(c[1])) << 16);
  raw.y = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(c[2])) |
          ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(c[3])) << 16);
  *reinterpret_cast<uint2*>(p) = raw;
}
// c holds integral codes in [-127, 127]
__device__ __forceinline__ void store4(int8_t* p, const float (&c)[4]) {
  *reinterpret_cast<char4*>(p) = make_char4(
      (signed char)(int)c[0], (signed char)(int)c[1], (signed char)(int)c[2],
      (signed char)(int)c[3]);
}

// ---- the attention kernel -------------------------------------------------

template <int D>
constexpr size_t smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + BK * 8 +
         BQ * 8 + BQ;
}

// sigma_arg: 1 / sigma^2 (kStream), unused (kCached, kNone), sigma^2
// (the others). cache: written (kBuild), read (kCached), unused (the
// others).
template <typename T, int D, Compat MODE, typename CT>
__global__ void __launch_bounds__(THREADS)
compat_flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ src,
                 const float* __restrict__ tgt,
                 const float* __restrict__ mask, T* __restrict__ out,
                 float* __restrict__ lse, CT* __restrict__ cache, int N,
                 int ld, float sigma_arg, float qscale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr bool kCoords = MODE != Compat::kCached && MODE != Compat::kNone;
  constexpr bool kCache = MODE == Compat::kBuild || MODE == Compat::kCached;
  constexpr int DP = D + 1;  // padded strides: column reads hit 32 banks
  constexpr int PP = BK + 1;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][DP] q * scale * log2(e)
  float* sK = sQ + BQ * DP;    // [BK][DP]
  float* sV = sK + BK * DP;    // [BK][D]
  float* sP = sV + BK * D;     // [BQ][PP] logits, then probabilities
  float* sKp = sP + BQ * PP;   // [BK][8] s.xyz, t.xyz, key state
  float* sQp = sKp + BK * 8;   // [BQ][8] s.xyz, t.xyz
  float* sRow = sQp + BQ * 8;  // [BQ] alpha per tile, then l

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * N;
  q += base * D;
  k += base * D;
  v += base * D;
  out += base * D;
  mask += base;
  if (lse != nullptr) lse += base;
  if constexpr (kCoords) {
    src += base * 3;
    tgt += base * 3;
  }
  if constexpr (kCache) cache += base * ld;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, i = q0 + r;
    const float x = i < N ? load_f32(q + (size_t)i * D + d) : 0.f;
    sQ[r * DP + d] = round_to<T>(x * qscale);
  }
  if constexpr (kCoords) {
    for (int e = tid; e < BQ * 6; e += THREADS) {
      const int r = e / 6, c = e % 6, i = q0 + r;
      float x = 0.f;
      if (i < N)
        x = c < 3 ? src[(size_t)i * 3 + c] : tgt[(size_t)i * 3 + c - 3];
      sQp[r * 8 + c] = x;
    }
  }
  __syncthreads();

  // phase 1 (logits): a 2 x 4 patch per thread
  const int r1 = (tid / 8) * 2;
  const int c1 = (tid % 8) * 4;
  float qp[2][6];
  if constexpr (kCoords) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int c = 0; c < 6; ++c) qp[rr][c] = sQp[(r1 + rr) * 8 + c];
  }
  // phase 2 (softmax): 4 neighbouring lanes per row, 8 keys each
  const int r2 = tid / 4;
  const int c2 = (tid % 4) * 8;
  float m_run = -INFINITY, l_run = 0.f;
  // phase 3 (p @ v): 4 rows x CPT strided columns per thread
  const int r3 = (tid / 16) * 4;
  const int c3 = tid % 16;
  float acc[4][CPT];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[rr][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D, j = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (j < N) {
        kx = load_f32(k + (size_t)j * D + d);
        vx = load_f32(v + (size_t)j * D + d);
      }
      sK[c * DP + d] = kx;
      sV[c * D + d] = vx;
    }
    if (tid < BK) {
      const int j = k0 + tid;
      const bool in = j < N;
      if constexpr (kCoords) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sKp[tid * 8 + c] = in ? src[(size_t)j * 3 + c] : 0.f;
          sKp[tid * 8 + 3 + c] = in ? tgt[(size_t)j * 3 + c] : 0.f;
        }
      }
      // key state: 1 valid, 0 masked (logit -1e9), -1 past N (weight 0)
      sKp[tid * 8 + 6] = !in ? -1.f : (mask[j] > 0.f ? 1.f : 0.f);
    }
    // this thread's part of the cache tile: in flight during the q.k loop
    const int j0 = k0 + c1;
    float tile[2][4];
    if constexpr (MODE == Compat::kCached) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = q0 + r1 + rr;
        if (i < N && j0 < ld) {
          load4(cache + (size_t)i * ld + j0, tile[rr]);
        } else {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) tile[rr][cc] = 0.f;
        }
      }
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[rr][cc] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float a0 = sQ[r1 * DP + d];
      const float a1 = sQ[(r1 + 1) * DP + d];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float kv = sK[(c1 + cc) * DP + d];
        s[0][cc] = fmaf(a0, kv, s[0][cc]);
        s[1][cc] = fmaf(a1, kv, s[1][cc]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* kp = sKp + (c1 + cc) * 8;
      const float state = kp[6];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float compat;
        if constexpr (MODE == Compat::kStream) {
          compat = compat_stream(qp[rr], kp, sigma_arg);
        } else if constexpr (MODE == Compat::kBuild) {
          // pad columns (past N) hold code 0
          const float code =
              state < 0.f ? 0.f : compat_i8_code(qp[rr], kp, sigma_arg);
          tile[rr][cc] = code;
          compat = dequant_i8(code);
        } else if constexpr (MODE == Compat::kCached) {
          compat = tile[rr][cc];
        } else {
          compat = compat_variant<MODE>(qp[rr], kp, sigma_arg);
        }
        float logit = compat * s[rr][cc];
        if (state == 0.f) logit = MASKED;
        if (state < 0.f) logit = -INFINITY;
        sP[(r1 + rr) * PP + c1 + cc] = logit;
      }
    }
    if constexpr (MODE == Compat::kBuild) {
      // every (i, j) is visited once: this block owns its BQ x BK tile
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = q0 + r1 + rr;
        if (i < N && j0 < ld) store4(cache + (size_t)i * ld + j0, tile[rr]);
      }
    }
    __syncthreads();

    {
      float x[8];
      float mloc = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = sP[r2 * PP + c2 + i];
        mloc = fmaxf(mloc, x[i]);
      }
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
      const float m_next = fmaxf(m_run, mloc);
      const float alpha = m_run == -INFINITY ? 0.f : exp2f(m_run - m_next);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = exp2f(x[i] - m_next);
        psum += p;
        sP[r2 * PP + c2 + i] = round_to<T>(p);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run = alpha * l_run + psum;
      m_run = m_next;
      if ((tid & 3) == 0) sRow[r2] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float al = sRow[r3 + rr];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[rr][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) p[rr] = sP[(r3 + rr) * PP + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = sV[kk * D + c3 + 16 * j];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) acc[rr][j] = fmaf(p[rr], vv, acc[rr][j]);
      }
    }
    __syncthreads();
  }

  if ((tid & 3) == 0) {
    const float l = fmaxf(l_run, 1e-30f);
    sRow[r2] = l;
    // base-2 log-sum-exp of the row, as the TPU kernel stores it
    if (lse != nullptr && q0 + r2 < N) lse[q0 + r2] = m_run + log2f(l);
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = q0 + r3 + rr;
    if (i >= N) continue;
    const float l = sRow[r3 + rr];
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      store_from_f32(out + (size_t)i * D + c3 + 16 * j, acc[rr][j] / l);
  }
}

template <typename T, int D, Compat MODE, typename CT>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         const float* src, const float* tgt,
                         const float* mask, void* out, float* lse,
                         CT* cache, int B, int N, int ld, float sigma_arg,
                         float qscale, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      compat_flash_fwd<T, D, MODE, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, B);
  compat_flash_fwd<T, D, MODE, CT><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), src, tgt, mask, static_cast<T*>(out), lse,
      cache, N, ld, sigma_arg, qscale);
  return cudaGetLastError();
}

// q/k/v element type (f32 or bf16) and head width (32 or 128)
template <Compat MODE, typename CT>
cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                           const void* src, const void* tgt,
                           const void* mask, void* out, void* lse,
                           CT* cache, int B, int N, int D, int ld,
                           int is_bf16, float sigma_arg, float qscale,
                           void* stream) {
  const auto* s = static_cast<const float*>(src);
  const auto* t = static_cast<const float*>(tgt);
  const auto* m = static_cast<const float*>(mask);
  auto* l = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
#define GMF_FLASH_CASE(T, WIDTH)                                          \
  return launch_flash<T, WIDTH, MODE, CT>(q, k, v, s, t, m, out, l, cache, \
                                          B, N, ld, sigma_arg, qscale, st)
  if (D == 32) {
    if (is_bf16) GMF_FLASH_CASE(__nv_bfloat16, 32);
    GMF_FLASH_CASE(float, 32);
  }
  if (D == 128) {
    if (is_bf16) GMF_FLASH_CASE(__nv_bfloat16, 128);
    GMF_FLASH_CASE(float, 128);
  }
#undef GMF_FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
