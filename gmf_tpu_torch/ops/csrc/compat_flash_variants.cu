// Forward variants of the compat-modulated flash attention, for the
// attention-variant microbenchmark (gmf_tpu_torch/tools/
// bench_flash_variants.py), for Hopper, sm_90a.
//
// Replaces scripts/bench_flash_variants.py::make_variant (the pallas_call
// at :183 over _fwd_kernel :105) for its variants that compute the compat
// term in a new way. Each is an instance of compat_flash_core.cuh:
//
//   v0  Compat::kNormId          squared distances by the norm identity
//                                |a|^2 + |b|^2 - 2 a.b (clamped at 0),
//                                compat from the two-sqrt difference
//   v1  Compat::kNone            no compat (plain attention)
//   v3  Compat::kStreamOneSqrt   per-coordinate squared distances,
//                                compat from one sqrt:
//                                max(ds2 + dt2 - 2 sqrt(ds2 dt2), 0)
//   v6  Compat::kNormIdOneSqrt   norm identity, one sqrt
//
// then compat = max(1 - dd^2 / sigma^2, 0). The other variants launch the
// existing instances: v2 (two-sqrt difference form) is the streaming
// kernel (compat_flash_attention.cu), v4 and v5 (a bf16 or f32 cache) the
// cached kernel (compat_flash_attention_cached.cu) on the standalone cache
// (build_compat_cache.cu, which also replaces the script's precompute,
// :214). The TPU kernel formed v0's and v6's dot products over the
// coordinates padded to 128 columns, on the MXU; here they are three
// products and two sums in f32, each rounded on its own, as the plain
// version rounds them, so the two compute the same compat bit for bit.
//
// Bound on this card: per (i, j) 2*D multiply-adds for q.k and p.v, 0-27
// f32 ALU ops and 1-4 SFU ops (sqrt, division, exp2) of compat and
// softmax; bytes are O(N*D) per pair. bf16: the products run on the tensor
// cores, so v1 is bound by them and the others by their compat's SFU or
// ALU ops; f32: the products, six bf16 products of a three-term split
// each (989 / 6 TFLOP/s), bound every variant. The
// microbenchmark times them beside each other to show what each compat
// form adds.

#include "compat_flash_core.cuh"

// q, k, v, out: [B, N, D] (f32, or bf16 when is_bf16); src, tgt: [B, N, 3]
// f32 (unused by v1, may be null); mask: [B, N] f32 (> 0 valid).
// variant: 0, 1, 3 or 6 as above. qscale = scale * log2(e).
extern "C" int gmf_compat_flash_variant(
    const void* q, const void* k, const void* v, const void* src,
    const void* tgt, const void* mask, void* out, int B, int N, int D,
    int variant, int is_bf16, float sigma_sq, float qscale, void* stream) {
  if (B <= 0 || N <= 0) return cudaErrorInvalidValue;  // nothing to launch
  cudaError_t err = cudaErrorInvalidValue;
#define GMF_VARIANT_CASE(ID, MODE)                                         \
  case ID:                                                                 \
    err = dispatch_flash<MODE, int8_t>(q, k, v, src, tgt, mask, out,       \
                                       nullptr, nullptr, B, N, D, 0,       \
                                       is_bf16, sigma_sq, qscale, stream); \
    break
  switch (variant) {
    GMF_VARIANT_CASE(0, Compat::kNormId);
    GMF_VARIANT_CASE(1, Compat::kNone);
    GMF_VARIANT_CASE(3, Compat::kStreamOneSqrt);
    GMF_VARIANT_CASE(6, Compat::kNormIdOneSqrt);
    default:
      break;
  }
#undef GMF_VARIANT_CASE
  return static_cast<int>(err);
}
