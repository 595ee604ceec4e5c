// Streaming compat-modulated flash attention (forward) for Hopper, sm_90a.
//
// Replaces gmf_tpu/ops/fused_attention.py::_fwd_kernel with _compat_block
// (the pallas_call in _forward_call, fused_attention.py:241): the
// attention of every PointDSC NonLocal layer when no compat cache is kept.
// For one pair,
//
//   compat[i,j] = max(0, 1 - (|s_i - s_j| - |t_i - t_j|)^2 / sigma^2)
//   out[i]      = softmax_j(compat[i,j] * q_i.k_j / sqrt(D)) @ v
//
// with masked keys set to -1e9 AFTER the compat multiply (a compat of 0
// does not exclude a key). The [N, N] compat and logits never reach device
// memory: each block owns BQ query rows of one pair and streams key tiles
// of BK rows through shared memory (K, V and both keypoint sets), with an
// online base-2 softmax whose scale*log2(e) is folded into q once. The
// batch is the grid's y dimension; keys past N carry zero weight, so no
// padding to a block multiple is needed.
//
// Compat uses per-coordinate differences (as the dense reference does)
// rather than the TPU kernel's norm identity |a|^2 + |b|^2 - 2a.b, which
// cancels at metre-scale extents and only paid off on the TPU's MXU.
// q/k/v may be f32 or bf16; arithmetic is f32. Under bf16 the scaled q and
// the probabilities p are rounded to bf16 before their products, as the
// TPU kernel does (fused_attention.py:122, :144-146).
//
// Bound on this card: per (i, j) the kernel does 2*D FMAs (q.k and p.v),
// ~20 f32 ALU ops of compat, 2 sqrt and 1 exp2 on the SFU; bytes are
// O(N*D) per pair. This first version keeps everything on the CUDA cores
// (no mma/wgmma), so the 2*D FMAs bound it: f32-ALU bound. Register
// micro-tiles (2x4 logits, 4xD/16 accumulators per thread) keep the
// shared-memory reads per FMA low; tensor cores are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per streamed tile
constexpr int THREADS = 256;
constexpr float MASKED = -1e9f;

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

template <int D>
constexpr size_t smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + BK * 8 +
         BQ * 8 + BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
compat_flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ src,
                 const float* __restrict__ tgt,
                 const float* __restrict__ mask, T* __restrict__ out, int N,
                 float inv_sigma_sq, float qscale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
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
  src += base * 3;
  tgt += base * 3;
  mask += base;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, i = q0 + r;
    const float x = i < N ? load_f32(q + (size_t)i * D + d) : 0.f;
    sQ[r * DP + d] = round_to<T>(x * qscale);
  }
  for (int e = tid; e < BQ * 6; e += THREADS) {
    const int r = e / 6, c = e % 6, i = q0 + r;
    float x = 0.f;
    if (i < N) x = c < 3 ? src[(size_t)i * 3 + c] : tgt[(size_t)i * 3 + c - 3];
    sQp[r * 8 + c] = x;
  }
  __syncthreads();

  // phase 1 (logits): a 2 x 4 patch per thread
  const int r1 = (tid / 8) * 2;
  const int c1 = (tid % 8) * 4;
  float qp[2][6];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int c = 0; c < 6; ++c) qp[rr][c] = sQp[(r1 + rr) * 8 + c];
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
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sKp[tid * 8 + c] = in ? src[(size_t)j * 3 + c] : 0.f;
        sKp[tid * 8 + 3 + c] = in ? tgt[(size_t)j * 3 + c] : 0.f;
      }
      // key state: 1 valid, 0 masked (logit -1e9), -1 past N (weight 0)
      sKp[tid * 8 + 6] = !in ? -1.f : (mask[j] > 0.f ? 1.f : 0.f);
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
        const float dx = qp[rr][0] - kp[0], dy = qp[rr][1] - kp[1],
                    dz = qp[rr][2] - kp[2];
        const float ex = qp[rr][3] - kp[3], ey = qp[rr][4] - kp[4],
                    ez = qp[rr][5] - kp[5];
        const float ds = sqrtf(dx * dx + dy * dy + dz * dz);
        const float dt = sqrtf(ex * ex + ey * ey + ez * ez);
        const float diff = ds - dt;
        const float compat = fmaxf(1.f - diff * diff * inv_sigma_sq, 0.f);
        float logit = compat * s[rr][cc];
        if (state == 0.f) logit = MASKED;
        if (state < 0.f) logit = -INFINITY;
        sP[(r1 + rr) * PP + c1 + cc] = logit;
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

  if ((tid & 3) == 0) sRow[r2] = fmaxf(l_run, 1e-30f);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* src, const float* tgt, const float* mask,
                   void* out, int B, int N, float inv_sigma_sq, float qscale,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      compat_flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, B);
  compat_flash_fwd<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), src, tgt, mask, static_cast<T*>(out), N,
      inv_sigma_sq, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* src, const float* tgt, const float* mask,
                     void* out, int B, int N, int D, float inv_sigma_sq,
                     float qscale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, src, tgt, mask, out, B, N, inv_sigma_sq,
                           qscale, stream);
    case 128:
      return launch<T, 128>(q, k, v, src, tgt, mask, out, B, N, inv_sigma_sq,
                            qscale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, N, D] (f32, or bf16 when is_bf16); src, tgt: [B, N, 3]
// f32; mask: [B, N] f32 (> 0 valid). qscale = log2(e) / sqrt(D).
extern "C" int gmf_compat_flash_attention(
    const void* q, const void* k, const void* v, const void* src,
    const void* tgt, const void* mask, void* out, int B, int N, int D,
    int is_bf16, float sigma_sq, float qscale, void* stream) {
  if (B <= 0 || N <= 0) return cudaErrorInvalidValue;  // nothing to launch
  const float inv_sigma_sq = 1.f / sigma_sq;
  const auto* s = static_cast<const float*>(src);
  const auto* t = static_cast<const float*>(tgt);
  const auto* m = static_cast<const float*>(mask);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, s, t, m, out, B, N, D,
                                        inv_sigma_sq, qscale, st)
              : dispatch<float>(q, k, v, s, t, m, out, B, N, D, inv_sigma_sq,
                                qscale, st);
  return static_cast<int>(err);
}
