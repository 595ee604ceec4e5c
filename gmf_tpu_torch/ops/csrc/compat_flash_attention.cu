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
// The [N, N] compat and logits never reach device memory. The kernel is the
// Compat::kStream instance of compat_flash_core.cuh, which describes the
// tiling and the online softmax shared with the cache kernels.
//
// Compat uses per-coordinate differences (as the dense reference does)
// rather than the TPU kernel's norm identity |a|^2 + |b|^2 - 2a.b, which
// cancels at metre-scale extents and only paid off on the TPU's MXU.
//
// Bound on this card: per (i, j) the kernel does 2*D multiply-adds (q.k
// and p.v), ~20 f32 ALU ops of compat, 2 sqrt and 1 exp2 on the SFU;
// bytes are O(N*D) per pair. bf16: the products run on the tensor cores
// (wgmma), so the SFU's 3 ops per (i, j) bound it, the products next;
// compat is computed on S's fragment in registers. f32: the products run
// on the tensor cores as six bf16 products of a three-term split (989 / 6
// TFLOP/s), which bound it.

#include "compat_flash_core.cuh"

// q, k, v, out: [B, N, D] (f32, or bf16 when is_bf16); src, tgt: [B, N, 3]
// f32; mask: [B, N] f32 (> 0 valid). qscale = log2(e) / sqrt(D).
// lse: [B, N] f32, the rows' base-2 log-sum-exp for the backward, or null
// (inference: nothing is written).
extern "C" int gmf_compat_flash_attention(
    const void* q, const void* k, const void* v, const void* src,
    const void* tgt, const void* mask, void* out, void* lse, int B, int N,
    int D, int is_bf16, float sigma_sq, float qscale, void* stream) {
  if (B <= 0 || N <= 0) return cudaErrorInvalidValue;  // nothing to launch
  return static_cast<int>(dispatch_flash<Compat::kStream, int8_t>(
      q, k, v, src, tgt, mask, out, lse, nullptr, B, N, D, 0, is_bf16,
      1.f / sigma_sq, qscale, stream));
}
