// Compat-modulated flash attention (forward) on a precomputed compat
// cache, for Hopper, sm_90a.
//
// Replaces gmf_tpu/ops/fused_attention.py::_fwd_kernel_cached (the
// pallas_call in _forward_call_cached, fused_attention.py:847): the
// attention of the PointDSC NonLocal layers that share one compat matrix.
// The cache tile takes the place of the compat arithmetic; an int8 cache is
// dequantized as code / 254 + 0.5 (one FMA), bf16 and f32 are widened. The
// tile is the only O(N^2) stream read from device memory. bf16: the block's
// cache tile (128 x 128 int8 entries, 128 x 64 bf16 or f32) travels by
// cp.async with K and V, one tile ahead of its use, and each thread reads its entries from shared memory in the
// S fragment's layout; f32: the producer warpgroup stages the 64 x 32
// tile beside the k and v terms, read in the same layout. Masked keys are
// excluded by the mask, as in the streaming kernel; the cache holds
// entries for them. The kernel is the Compat::kCached instance of
// compat_flash_core.cuh.
//
// Bound on this card: 2*D multiply-adds and one exp2 per (i, j); bytes are
// the cache, B*N*ld elements, plus O(N*D) per pair. bf16: the products on
// the tensor cores bound it at D=128 (0.83 ms at 64 x 5000), the int8
// cache's bytes next (0.48 ms), a bf16 or f32 cache's bytes first. f32:
// the products as six bf16 products of a three-term split on the tensor
// cores (989 / 6 TFLOP/s) bound it (0.050 ms at 16 x 1000, 0.62 ms at 8 x
// 5000).

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
