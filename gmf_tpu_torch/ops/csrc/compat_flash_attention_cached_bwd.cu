// Compat-modulated flash attention on a compat cache, BACKWARD, for
// Hopper, sm_90a.
//
// Replaces gmf_tpu/ops/fused_attention.py::_bwd_dkv_kernel_cached (the
// pallas_call at fused_attention.py:982) and ::_bwd_dq_kernel_cached
// (fused_attention.py:1009), both over _bwd_tile_cached: the custom_vjp
// backward (_flash_cached_bwd) of the cached attention, which the PointDSC
// NonLocal layers run in training when they share one compat matrix. The
// kernels are the Compat::kCached instances of compat_flash_bwd_tc.cuh:
// every product on the tensor cores (wgmma), f32 q/k/v split into three
// bf16 terms and six products, bf16 as one term. They read the forward's [B, N, ld] cache (rows are
// queries), f32 and bf16 widened, int8 dequantized as code / 254 + 0.5
// with the forward's one FMA, so p = exp2(s - lse) recomputes the
// forward's probabilities. The cache carries no gradient.
//
// Bound on this card, per (i, j): 4 products of depth D (dK/dV kernel,
// 8 D flop) or 3 (dQ kernel, 6 D flop), ~9 f32 ALU ops (dequantize, logit,
// p, dlogits) and 1 exp2. Bytes: the cache, B N ld elements, read once by
// each kernel, plus O(N D) per pair. At D = 128 the products bound both:
// in bf16 at 989 TFLOP/s, in f32 at 989 / 6 (six bf16 products per f32
// product, the faster of that and the CUDA cores' 67 TFLOP/s): at B = 16,
// N = 1000, about 0.10 ms (dK/dV) and 0.075 ms (dQ) in f32; the 4-byte
// f32 cache (64 MB) takes 0.02 ms to read.

#include "compat_flash_bwd_tc.cuh"

namespace {

template <typename CT>
cudaError_t cached_bwd(bool dq_kernel, const void* q, const void* k,
                       const void* v, const void* dout, const void* lse,
                       const void* delta, const void* cache, const void* mask,
                       void* out0, void* out1, int B, int N, int D, int ld,
                       int is_bf16, float qscale, float scale, void* stream) {
  return dispatch_bwd_tc<CT, Compat::kCached>(
      dq_kernel, q, k, v, dout, lse, delta, mask,
      static_cast<const CT*>(cache), out0, out1, B, N, D, ld, is_bf16,
      qscale, scale, nullptr, nullptr, 0.f, stream);
}

// cache element type (0 f32, 1 bf16, 2 int8); rows 16-byte aligned; q,
// k, v, dout and the cache must start 16-byte aligned
cudaError_t cached_bwd_any(bool dq_kernel, const void* q, const void* k,
                           const void* v, const void* dout, const void* lse,
                           const void* delta, const void* cache,
                           const void* mask, void* out0, void* out1, int B,
                           int N, int D, int ld, int is_bf16, int cache_type,
                           float qscale, float scale, void* stream) {
  if (B <= 0 || N <= 0 || ld < N) return cudaErrorInvalidValue;
  if (cache_type == CACHE_F32 && ld % 4 == 0)
    return cached_bwd<float>(dq_kernel, q, k, v, dout, lse, delta, cache,
                             mask, out0, out1, B, N, D, ld, is_bf16, qscale,
                             scale, stream);
  if (cache_type == CACHE_BF16 && ld % 8 == 0)
    return cached_bwd<__nv_bfloat16>(dq_kernel, q, k, v, dout, lse, delta,
                                     cache, mask, out0, out1, B, N, D, ld,
                                     is_bf16, qscale, scale, stream);
  if (cache_type == CACHE_INT8 && ld % 16 == 0)
    return cached_bwd<int8_t>(dq_kernel, q, k, v, dout, lse, delta, cache,
                              mask, out0, out1, B, N, D, ld, is_bf16, qscale,
                              scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout: [B, N, D] (f32, or bf16 when is_bf16); lse: [B, N] f32
// base-2 log-sum-exp of the forward, 1e9 on masked query rows; delta:
// [B, N] f32 rowsum(dout * out); cache: [B, N, ld] of cache_type; mask:
// [B, N] f32. qscale = log2(e) / sqrt(D), scale = 1 / sqrt(D).
// dk, dv: [B, N, D] of q's type.
extern "C" int gmf_compat_flash_attention_cached_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* cache, const void* mask,
    void* dk, void* dv, int B, int N, int D, int ld, int is_bf16,
    int cache_type, float qscale, float scale, void* stream) {
  return static_cast<int>(cached_bwd_any(
      false, q, k, v, dout, lse, delta, cache, mask, dk, dv, B, N, D, ld,
      is_bf16, cache_type, qscale, scale, stream));
}

// the same inputs -> dq: [B, N, D] of q's type
extern "C" int gmf_compat_flash_attention_cached_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* cache, const void* mask,
    void* dq, int B, int N, int D, int ld, int is_bf16, int cache_type,
    float qscale, float scale, void* stream) {
  return static_cast<int>(cached_bwd_any(
      true, q, k, v, dout, lse, delta, cache, mask, dq, nullptr, B, N, D, ld,
      is_bf16, cache_type, qscale, scale, stream));
}
