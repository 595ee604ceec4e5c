// Compat-modulated flash attention (forward) on a precomputed compat
// cache, for Hopper, sm_90a.
//
// Replaces gmf_tpu/ops/fused_attention.py::_fwd_kernel_cached (the
// pallas_call in _forward_call_cached, fused_attention.py:847): the
// attention of the PointDSC NonLocal layers that share one compat matrix.
// The cache tile takes the place of the compat arithmetic; an int8 cache is
// dequantized as code / 254 + 0.5 (one FMA), bf16 and f32 are widened. The
// tile is the only O(N^2) stream read from device memory: each thread
// fetches 4 neighbouring entries of a row with one vector load, started
// before the q.k loop so that it is in flight during the products. Masked
// keys are excluded by the mask, as in the streaming kernel; the cache
// holds entries for them. The kernel is the Compat::kCached instance of
// compat_flash_core.cuh.
//
// Bound on this card: 2*D FMAs and one exp2 per (i, j); bytes are the
// cache, B*N*ld elements, plus O(N*D) per pair. On the CUDA cores the FMAs
// bound it (f32-ALU bound); with the products on the tensor cores an int8
// cache at D=128 would be bound by its bytes.

#include "compat_flash_core.cuh"

// q, k, v, out: [B, N, D] (f32, or bf16 when is_bf16); mask: [B, N] f32;
// cache: [B, N, ld] of cache_type (0 f32, 1 bf16, 2 int8), rows 16-byte
// aligned. lse: [B, N] f32 base-2 log-sum-exp for the backward, or null.
extern "C" int gmf_compat_flash_attention_cached(
    const void* q, const void* k, const void* v, const void* cache,
    const void* mask, void* out, void* lse, int B, int N, int D, int ld,
    int is_bf16, int cache_type, float qscale, void* stream) {
  if (B <= 0 || N <= 0 || ld < N) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  void* c = const_cast<void*>(cache);
  if (cache_type == CACHE_F32 && ld % 4 == 0)
    err = dispatch_flash<Compat::kCached, float>(
        q, k, v, nullptr, nullptr, mask, out, lse, static_cast<float*>(c), B,
        N, D, ld, is_bf16, 0.f, qscale, stream);
  else if (cache_type == CACHE_BF16 && ld % 8 == 0)
    err = dispatch_flash<Compat::kCached, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, mask, out, lse,
        static_cast<__nv_bfloat16*>(c), B, N, D, ld, is_bf16, 0.f, qscale,
        stream);
  else if (cache_type == CACHE_INT8 && ld % 16 == 0)
    err = dispatch_flash<Compat::kCached, int8_t>(
        q, k, v, nullptr, nullptr, mask, out, lse, static_cast<int8_t*>(c), B,
        N, D, ld, is_bf16, 0.f, qscale, stream);
  return static_cast<int>(err);
}
