// Standalone compat cache for Hopper, sm_90a.
//
// Replaces gmf_tpu/ops/fused_attention.py::_compat_pre_kernel (the
// pallas_call in _build_compat_cache_jit, fused_attention.py:625): the
// [N, N] spatial-consistency matrix of a pair, computed once and shared by
// the attention layers,
//
//   f32, bf16:  c = max(1 - (sqrt(ds2) - sqrt(dt2))^2 / sigma^2, 0)
//   int8:       dd2  = max(ds2 + dt2 - 2 sqrt(ds2 dt2), 0)
//               code = round_half_even(254 max(1 - dd2 / sigma^2, 0) - 127)
//
// with ds2, dt2 the squared distances from per-coordinate differences. The
// two forms are kept apart as the TPU kernel keeps them: the one-sqrt
// identity is safe only beneath the int8 step. The arithmetic is the
// __device__ functions of compat_flash_core.cuh, explicitly rounded, so
// the int8 cache equals the build+attend kernel's and the plain version's
// in every byte.
//
// The cache is [B, N, ld] with 16-byte aligned rows; pad columns N..ld-1
// are written as 0. A thread owns 4 neighbouring columns (its keys'
// coordinates stay in registers) and walks ROWS query rows, whose
// coordinates come from shared memory; a warp stores 128 neighbouring
// entries of a row at once.
//
// Bound on this card: one store of B*N*ld elements; per entry ~25 f32 ALU
// ops and 1 or 2 sqrt and a division. At int8 the SFU/ALU work bounds it,
// at f32 the bytes come close.

#include "compat_flash_core.cuh"

namespace {

constexpr int ROWS = 32;  // query rows per block

template <typename CT>
__global__ void __launch_bounds__(THREADS)
build_compat_cache_kernel(const float* __restrict__ src,
                          const float* __restrict__ tgt,
                          CT* __restrict__ cache, int N, int ld,
                          float sigma_sq) {
  __shared__ float sQ[ROWS][6];
  const size_t base = (size_t)blockIdx.z * N;
  src += base * 3;
  tgt += base * 3;
  cache += base * ld;
  const int row0 = blockIdx.y * ROWS;
  for (int e = threadIdx.x; e < ROWS * 6; e += THREADS) {
    const int r = e / 6, c = e % 6, i = row0 + r;
    float x = 0.f;
    if (i < N) x = c < 3 ? src[(size_t)i * 3 + c] : tgt[(size_t)i * 3 + c - 3];
    sQ[r][c] = x;
  }
  const int j0 = (blockIdx.x * THREADS + threadIdx.x) * 4;
  float kp[4][6];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const int j = j0 + cc;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      kp[cc][c] = j < N ? src[(size_t)j * 3 + c] : 0.f;
      kp[cc][3 + c] = j < N ? tgt[(size_t)j * 3 + c] : 0.f;
    }
  }
  __syncthreads();
  if (j0 >= ld) return;
  const int rows = min(ROWS, N - row0);
  for (int r = 0; r < rows; ++r) {
    float vals[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float x = 0.f;  // pad columns
      if (j0 + cc < N) {
        if constexpr (sizeof(CT) == 1)
          x = compat_i8_code(sQ[r], kp[cc], sigma_sq);
        else
          x = compat_two_sqrt(sQ[r], kp[cc], sigma_sq);
      }
      vals[cc] = x;
    }
    store4(cache + (size_t)(row0 + r) * ld + j0, vals);
  }
}

template <typename CT>
cudaError_t launch_build(const float* src, const float* tgt, void* cache,
                         int B, int N, int ld, float sigma_sq,
                         cudaStream_t stream) {
  const dim3 grid((ld + 4 * THREADS - 1) / (4 * THREADS),
                  (N + ROWS - 1) / ROWS, B);
  build_compat_cache_kernel<CT><<<grid, THREADS, 0, stream>>>(
      src, tgt, static_cast<CT*>(cache), N, ld, sigma_sq);
  return cudaGetLastError();
}

}  // namespace

// src, tgt: [B, N, 3] f32; cache: [B, N, ld] of cache_type (0 f32, 1 bf16,
// 2 int8), rows 16-byte aligned.
extern "C" int gmf_build_compat_cache(const void* src, const void* tgt,
                                      void* cache, int B, int N, int ld,
                                      int cache_type, float sigma_sq,
                                      void* stream) {
  if (B <= 0 || N <= 0 || ld < N || B > 65535)
    return cudaErrorInvalidValue;
  const auto* s = static_cast<const float*>(src);
  const auto* t = static_cast<const float*>(tgt);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (cache_type == CACHE_F32 && ld % 4 == 0)
    err = launch_build<float>(s, t, cache, B, N, ld, sigma_sq, st);
  else if (cache_type == CACHE_BF16 && ld % 8 == 0)
    err = launch_build<__nv_bfloat16>(s, t, cache, B, N, ld, sigma_sq, st);
  else if (cache_type == CACHE_INT8 && ld % 16 == 0)
    err = launch_build<int8_t>(s, t, cache, B, N, ld, sigma_sq, st);
  return static_cast<int>(err);
}
