// Layer-1 attention that also emits the int8 compat cache, for Hopper,
// sm_90a.
//
// Replaces gmf_tpu/ops/fused_attention.py::_fwd_kernel_build (the
// pallas_call in _compat_flash_attention_build_jit, fused_attention.py:766).
// For every (i, j) of a pair it computes the int8 code of the compat entry
// with the standalone cache kernel's formula (build_compat_cache.cu shares
// the __device__ function in compat_flash_core.cuh),
//
//   dd2  = max(ds2 + dt2 - 2 sqrt(ds2 dt2), 0)
//   code = round_half_even(254 max(1 - dd2 / sigma^2, 0) - 127),
//
// stores it to cache[b, i, j] and attends on the DEQUANTIZED value
// code / 254 + 0.5, not on the unquantized compat. That makes layer 1
// consistent with the layers that stream the cache: the cache equals the
// standalone int8 cache in every byte and the output equals the cached
// kernel's on that cache. Each block writes its own BQ x BK tiles (every
// (i, j) is visited once); pad columns N..ld-1 are written as 0. The
// kernel is the Compat::kBuild instance of compat_flash_core.cuh.
//
// Bound on this card: the streaming kernel's 2*D FMAs per (i, j) plus one
// sqrt, one division and one exp2; the cache store adds B*N*ld bytes. On
// the CUDA cores the FMAs bound it (f32-ALU bound).

#include "compat_flash_core.cuh"

// q, k, v, out: [B, N, D] (f32, or bf16 when is_bf16); src, tgt: [B, N, 3]
// f32; mask: [B, N] f32; cache: [B, N, ld] int8, ld a multiple of 16.
extern "C" int gmf_compat_flash_attention_build(
    const void* q, const void* k, const void* v, const void* src,
    const void* tgt, const void* mask, void* out, void* cache, int B, int N,
    int D, int ld, int is_bf16, float sigma_sq, float qscale, void* stream) {
  if (B <= 0 || N <= 0 || ld < N || ld % 16 != 0)
    return cudaErrorInvalidValue;
  return static_cast<int>(dispatch_flash<Compat::kBuild, int8_t>(
      q, k, v, src, tgt, mask, out, nullptr, static_cast<int8_t*>(cache), B,
      N, D, ld, is_bf16, sigma_sq, qscale, stream));
}
