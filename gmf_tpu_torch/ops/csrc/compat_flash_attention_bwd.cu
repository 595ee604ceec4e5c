// Streaming compat-modulated flash attention, BACKWARD, for Hopper, sm_90a.
//
// Replaces gmf_tpu/ops/fused_attention.py::_bwd_dkv_kernel (the pallas_call
// at fused_attention.py:310) and ::_bwd_dq_kernel (fused_attention.py:328),
// both over _bwd_tile: the custom_vjp backward (_flash_bwd) of the
// streaming attention that every PointDSC NonLocal layer runs in training
// when no compat cache is kept. The kernels are the Compat::kStream
// instances of compat_flash_bwd_tc.cuh, the cached backward's kernels:
// every product on the tensor cores (wgmma), f32 q/k/v split into three
// bf16 terms and six products, bf16 as one term. Compat is rebuilt per
// (i, j) from the keypoints by compat_flash_core.cuh's compat_stream(), the
// forward's own function on the same operands, so p = exp2(s - lse)
// recomputes the forward's probabilities.
//
// Bound on this card, per (i, j): the dK/dV kernel does 4 products of depth
// D (s, dp, dV, dK: 8 D flop), the dQ kernel 3 (6 D flop); each adds ~20
// f32 ALU ops of compat, ~6 of p and dlogits, 2 sqrt and 1 exp2. Bytes are
// O(N D) per pair. At D = 128 the products bound both: in bf16 at 989
// TFLOP/s, in f32 at 989 / 6 (six bf16 products per f32 product): at B =
// 16, N = 1000, about 0.10 ms (dK/dV) and 0.075 ms (dQ) in f32. The compat
// of a slot is formed on the CUDA cores while its S and dP products run.

#include "compat_flash_bwd_tc.cuh"

// q, k, v, dout: [B, N, D] (f32, or bf16 when is_bf16); lse: [B, N] f32
// base-2 log-sum-exp of the forward, 1e9 on masked query rows; delta:
// [B, N] f32 rowsum(dout * out); src, tgt: [B, N, 3] f32; mask: [B, N] f32
// (> 0 valid). qscale = log2(e) / sqrt(D), scale = 1 / sqrt(D).
// dk, dv: [B, N, D] of q's type.
extern "C" int gmf_compat_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* src, const void* tgt,
    const void* mask, void* dk, void* dv, int B, int N, int D, int is_bf16,
    float sigma_sq, float qscale, float scale, void* stream) {
  if (B <= 0 || N <= 0) return cudaErrorInvalidValue;  // nothing to launch
  return static_cast<int>(dispatch_bwd_tc<int8_t, Compat::kStream>(
      false, q, k, v, dout, lse, delta, mask, nullptr, dk, dv, B, N, D, 0,
      is_bf16, qscale, scale, src, tgt, 1.f / sigma_sq, stream));
}

// the same inputs -> dq: [B, N, D] of q's type
extern "C" int gmf_compat_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* src, const void* tgt,
    const void* mask, void* dq, int B, int N, int D, int is_bf16,
    float sigma_sq, float qscale, float scale, void* stream) {
  if (B <= 0 || N <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(dispatch_bwd_tc<int8_t, Compat::kStream>(
      true, q, k, v, dout, lse, delta, mask, nullptr, dq, nullptr, B, N, D,
      0, is_bf16, qscale, scale, src, tgt, 1.f / sigma_sq, stream));
}
