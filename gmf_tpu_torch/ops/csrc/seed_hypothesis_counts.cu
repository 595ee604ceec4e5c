// Inlier count of every seed hypothesis, sm_90a.
//
// Replaces gmf_tpu/ops/fused_scoring.py::_kernel (the pallas_call in
// _counts_jit, fused_scoring.py:138): for every seed transform (R_s, t_s)
// of a pair,
//
//   count[s] = #{ n : |R_s src_n + t_s - tgt_n|^2 < thr^2  AND  mask_n > 0 }
//
// The TPU kernel expands the residual into a 17-wide bilinear form so the
// MXU can do the work, which cancels |coords|^2-sized terms and loses
// ~eps*|coords|^2 at the threshold (fused_scoring.py:33-45). On CUDA cores
// the direct residual is cheaper and exact in intent: 9 FMAs for R*s + t,
// 3 subtractions and 3 FMAs for the squared norm. One block serves SPB
// seeds of one pair and reduces over N; the [S, N] residuals never reach
// device memory. Counts are returned as integers.
//
// Bound on this card: ~16 f32 ALU ops per (seed, point) and O(S + N)
// bytes, so it is f32-ALU bound.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPB = 8;

__global__ void __launch_bounds__(THREADS)
seed_hypothesis_counts_kernel(const float* __restrict__ trans,
                              const float* __restrict__ src,
                              const float* __restrict__ tgt,
                              const float* __restrict__ mask,
                              int* __restrict__ counts, int S, int N,
                              float thr_sq) {
  __shared__ float sT[SPB][12];  // top 3 rows of each [4, 4]
  __shared__ int red[SPB][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * SPB;
  const int ns = min(SPB, S - s0);
  const size_t base = (size_t)b * N;
  src += base * 3;
  tgt += base * 3;
  mask += base;
  if (tid < ns * 12) {
    const int s = tid / 12, e = tid % 12;
    sT[s][e] = trans[((size_t)b * S + s0 + s) * 16 + e];
  }
  __syncthreads();

  int cnt[SPB];
#pragma unroll
  for (int s = 0; s < SPB; ++s) cnt[s] = 0;
  for (int n = tid; n < N; n += THREADS) {
    if (!(mask[n] > 0.f)) continue;
    const float x = src[(size_t)n * 3], y = src[(size_t)n * 3 + 1],
                z = src[(size_t)n * 3 + 2];
    const float u = tgt[(size_t)n * 3], w = tgt[(size_t)n * 3 + 1],
                h = tgt[(size_t)n * 3 + 2];
#pragma unroll
    for (int s = 0; s < SPB; ++s) {
      if (s >= ns) break;
      const float* T = sT[s];
      const float px = fmaf(T[0], x, fmaf(T[1], y, fmaf(T[2], z, T[3]))) - u;
      const float py = fmaf(T[4], x, fmaf(T[5], y, fmaf(T[6], z, T[7]))) - w;
      const float pz = fmaf(T[8], x, fmaf(T[9], y, fmaf(T[10], z, T[11]))) - h;
      cnt[s] += fmaf(px, px, fmaf(py, py, pz * pz)) < thr_sq;
    }
  }
#pragma unroll
  for (int s = 0; s < SPB; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt[s] += __shfl_xor_sync(0xffffffffu, cnt[s], off);
    if (lane == 0) red[s][warp] = cnt[s];
  }
  __syncthreads();
  if (tid < ns) {
    int total = 0;
    for (int w = 0; w < WARPS; ++w) total += red[tid][w];
    counts[(size_t)b * S + s0 + tid] = total;
  }
}

}  // namespace

// trans: [B, S, 4, 4] f32; src, tgt: [B, N, 3] f32; mask: [B, N] f32;
// counts: [B, S] int32.
extern "C" int gmf_seed_hypothesis_counts(const void* trans, const void* src,
                                          const void* tgt, const void* mask,
                                          void* counts, int B, int S, int N,
                                          float thr_sq, void* stream) {
  if (B <= 0 || S <= 0)
    return cudaErrorInvalidValue;  // nothing to launch
  const dim3 grid((S + SPB - 1) / SPB, B);
  seed_hypothesis_counts_kernel<<<grid, THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(trans), static_cast<const float*>(src),
      static_cast<const float*>(tgt), static_cast<const float*>(mask),
      static_cast<int*>(counts), S, N, thr_sq);
  return static_cast<int>(cudaGetLastError());
}
