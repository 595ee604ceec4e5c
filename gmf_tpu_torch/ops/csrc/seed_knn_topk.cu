// Seed kNN in feature space: exact top-K by inner product, sm_90a.
//
// Replaces gmf_tpu/ops/fused_topk.py::_kernel (the pallas_call in
// _seed_knn_topk_jit, fused_topk.py:108): for every seed row of a pair,
// the K keys with the largest f32 inner product seed.feat, in the order
// jax.lax.top_k gives them:
//
//   - descending score; equal scores (compared with ==, so +0 ties -0)
//     break toward the smaller key index;
//   - masked keys score -inf and stay selectable, so a row with fewer than
//     K valid keys fills in ascending index order (fused_topk.py:17-21);
//   - an index that finds no key at all is clamped to N-1 (:88-90).
//
// One block serves up to SPB seeds of one pair. Phase 1: one warp per key
// row reads the row once (coalesced) and forms the f32 dot with each of
// the block's seeds; the N scores per seed sit in shared memory
// (N * 4 bytes, 20 KB at N=5000). Phase 2: K rounds of block-wide
// (max value, min index) selection; the winner is retired by writing NaN,
// which no comparison selects. The [S, N] score matrix never reaches
// device memory.
//
// Bound on this card: S*N*C FMAs per pair (f32 CUDA cores) plus K passes
// over the N scores in shared memory; bytes are O((S + N) * C).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPB = 4;
constexpr int BIG = 1 << 30;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS)
seed_knn_topk_kernel(const float* __restrict__ seeds,
                     const float* __restrict__ feats,
                     const float* __restrict__ mask, int* __restrict__ idx_out,
                     float* __restrict__ val_out, int S, int N, int C, int K,
                     int spb) {
  extern __shared__ float smem[];
  float* sSeed = smem;             // [spb][C]
  float* sScore = smem + spb * C;  // [spb][N]
  __shared__ float redV[MAX_SPB][WARPS];
  __shared__ int redI[MAX_SPB][WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, S - s0);
  feats += (size_t)b * N * C;
  mask += (size_t)b * N;
  const float* seed_rows = seeds + ((size_t)b * S + s0) * C;
  for (int e = tid; e < ns * C; e += THREADS) sSeed[e] = seed_rows[e];
  __syncthreads();

  for (int n = warp; n < N; n += WARPS) {
    const float* f = feats + (size_t)n * C;
    float acc[MAX_SPB] = {0.f, 0.f, 0.f, 0.f};
    for (int c = lane; c < C; c += 32) {
      const float x = f[c];
#pragma unroll
      for (int s = 0; s < MAX_SPB; ++s)
        if (s < ns) acc[s] = fmaf(x, sSeed[s * C + c], acc[s]);
    }
#pragma unroll
    for (int s = 0; s < MAX_SPB; ++s)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
    if (lane == 0) {
      const bool valid = mask[n] > 0.f;
      for (int s = 0; s < ns; ++s) sScore[s * N + n] = valid ? acc[s] : -INFINITY;
    }
  }
  __syncthreads();

  for (int t = 0; t < K; ++t) {
#pragma unroll
    for (int s = 0; s < MAX_SPB; ++s) {
      if (s >= ns) break;
      float bv = -INFINITY;
      int bi = BIG;
      const float* row = sScore + s * N;
      for (int n = tid; n < N; n += THREADS) {
        const float v = row[n];
        if (!isnan(v) && better(v, n, bv, bi)) {
          bv = v;
          bi = n;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        redV[s][warp] = bv;
        redI[s][warp] = bi;
      }
    }
    __syncthreads();
    if (tid < ns) {
      float bv = redV[tid][0];
      int bi = redI[tid][0];
      for (int w = 1; w < WARPS; ++w)
        if (better(redV[tid][w], redI[tid][w], bv, bi)) {
          bv = redV[tid][w];
          bi = redI[tid][w];
        }
      const size_t o = ((size_t)b * S + s0 + tid) * K + t;
      idx_out[o] = min(bi, N - 1);
      val_out[o] = bv;
      if (bi < N) sScore[tid * N + bi] = __int_as_float(0x7fc00000);  // NaN
    }
    __syncthreads();
  }
}

}  // namespace

// seeds: [B, S, C] f32; feats: [B, N, C] f32; mask: [B, N] f32;
// idx: [B, S, K] int32; val: [B, S, K] f32.
extern "C" int gmf_seed_knn_topk(const void* seeds, const void* feats,
                                 const void* mask, void* idx, void* val,
                                 int B, int S, int N, int C, int K,
                                 void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || K <= 0)
    return cudaErrorInvalidValue;  // nothing to launch
  if (K > N) return static_cast<int>(cudaErrorInvalidValue);
  // as many seeds per block as fit in 200 KB of shared memory
  int spb = MAX_SPB;
  while (spb > 1 && (size_t)spb * (N + C) * sizeof(float) > 200 * 1024) --spb;
  const size_t bytes = (size_t)spb * (N + C) * sizeof(float);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      seed_knn_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + spb - 1) / spb, B);
  seed_knn_topk_kernel<<<grid, THREADS, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seeds), static_cast<const float*>(feats),
      static_cast<const float*>(mask), static_cast<int*>(idx),
      static_cast<float*>(val), S, N, C, K, spb);
  return static_cast<int>(cudaGetLastError());
}
