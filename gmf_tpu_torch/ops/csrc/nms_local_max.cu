// Score-NMS local maxima for Hopper, sm_90a.
//
// Replaces gmf_tpu/ops/fused_nms.py::_kernel (the pallas_call in
// nms_local_max, fused_nms.py:69): for every correspondence i of a pair,
//
//   is_local_max[i] = NOT OR_j ( |s_i - s_j|^2 < R^2  AND  score_j > score_i )
//
// A key suppresses only when its score is STRICTLY higher, so equal scores
// never suppress. One thread owns one query point and loops over key tiles
// staged in shared memory; the [N, N] distance and relation matrices never
// exist. The batch is the grid's y dimension and keys past N are skipped by
// the loop bound, so no 1e6-far padding points are needed. Distances are
// the per-coordinate difference form with explicitly rounded products and
// sums (no FMA contraction), the same operations the plain version does.
//
// Bound on this card: ~10 f32 ALU ops per (i, j) and O(N) bytes per pair,
// so it is f32-ALU bound; the comparison stops once a row is suppressed.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
nms_local_max_kernel(const float* __restrict__ keypts,
                     const float* __restrict__ scores,
                     float* __restrict__ out, int N, float radius_sq) {
  __shared__ float sx[THREADS], sy[THREADS], sz[THREADS], ss[THREADS];
  const size_t base = (size_t)blockIdx.y * N;
  keypts += base * 3;
  scores += base;
  out += base;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f, si = 0.f;
  if (i < N) {
    xi = keypts[(size_t)i * 3 + 0];
    yi = keypts[(size_t)i * 3 + 1];
    zi = keypts[(size_t)i * 3 + 2];
    si = scores[i];
  }
  bool suppressed = false;
  for (int j0 = 0; j0 < N; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    if (j < N) {
      sx[threadIdx.x] = keypts[(size_t)j * 3 + 0];
      sy[threadIdx.x] = keypts[(size_t)j * 3 + 1];
      sz[threadIdx.x] = keypts[(size_t)j * 3 + 2];
      ss[threadIdx.x] = scores[j];
    }
    __syncthreads();
    const int cnt = min(THREADS, N - j0);
    for (int jj = 0; jj < cnt && !suppressed; ++jj) {
      const float dx = __fsub_rn(xi, sx[jj]);
      const float dy = __fsub_rn(yi, sy[jj]);
      const float dz = __fsub_rn(zi, sz[jj]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      suppressed = (d2 < radius_sq) && (ss[jj] > si);
    }
    __syncthreads();
  }
  if (i < N) out[i] = suppressed ? 0.f : 1.f;
}

}  // namespace

// keypts: [B, N, 3] f32; scores: [B, N] f32; out: [B, N] f32 (1 = local max)
extern "C" int gmf_nms_local_max(const void* keypts, const void* scores,
                                 void* out, int B, int N, float radius_sq,
                                 void* stream) {
  if (B <= 0 || N <= 0)
    return cudaErrorInvalidValue;  // nothing to launch
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  nms_local_max_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keypts), static_cast<const float*>(scores),
      static_cast<float*>(out), N, radius_sq);
  return static_cast<int>(cudaGetLastError());
}
