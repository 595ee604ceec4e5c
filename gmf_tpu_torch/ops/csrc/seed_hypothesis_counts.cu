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
// ~eps*|coords|^2 at the threshold (fused_scoring.py:33-45). Here the
// residual is formed directly, with explicitly rounded operations in one
// fixed order, per coordinate ((R0 x + R1 y) + R2 z) + t - u, then
// (px^2 + py^2) + pz^2, no contraction into FMAs. The plain version
// (ops/fused_scoring.py) performs the same operations in the same order,
// so the two agree on every count.
//
// Bound on this card: the function needs ~16 f32 ALU ops per (seed,
// point) with fused multiply-adds and O(S + N) bytes, so it is ALU bound
// (B=8, N=5000, S=500: 0.0096 ms). The exact-rounding form issues ~28
// instructions per (seed, point): 21 for the residual, 5 for its square,
// a compare and a count, so its best time is ~1.7x that bound.
//
// Design. A block takes a tile of up to 512 seeds of one pair (4 seeds a
// thread, their 12 coefficients in registers) and a chunk of the pair's
// points; the grid is chunks x seed tiles x pairs, the chunk sized so that
// the grid holds about 32 warps per SM at B=8, B=16 and b=64 alike (on the
// card 7% faster at b=64 than 16 warps, the same at B=8). The
// chunk is staged once in shared memory in structure-of-arrays form
// (x, y, z, u, v, w), read from device memory with 16-byte coalesced loads
// where aligned; a masked point, and the padding past N, gets u = NaN, so
// its residual is NaN and it never counts: the sweep has no branch. Every
// thread sweeps the chunk with broadcast 16-byte shared reads, four points
// a read, so the loop is bounded by the ALU, not by loads. Each thread
// adds its seeds' partial counts to the zeroed output with one atomicAdd
// per seed and chunk; integer sums do not depend on their order, so two
// launches give the same counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPT = 4;                    // seeds per thread
constexpr int MAX_THREADS = 128;
constexpr int MAX_TILE = SPT * MAX_THREADS;  // seeds per block
constexpr int MIN_CHUNK = 64;             // points per block
constexpr int MAX_CHUNK = 1024;
constexpr int WARPS_PER_SM = 32;          // the grid's target

// n floats from g (4-byte aligned) into three rows of the
// structure-of-arrays tile: float f of the run is coordinate f % 3 of point
// f / 3, at rows[(f % 3) * MAX_CHUNK + f / 3]. 16-byte loads from the first
// 16-byte boundary on, single floats before it and after the last whole
// vector.
__device__ __forceinline__ void stage_points(const float* __restrict__ g,
                                             int n, float* rows) {
  const int head = min(
      n, (int)(((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) >> 2));
  const int vecs = (n - head) >> 2;
  const int tail = head + 4 * vecs;
  for (int f = threadIdx.x; f < head; f += blockDim.x)
    rows[(f % 3) * MAX_CHUNK + f / 3] = g[f];
  const float4* gv = reinterpret_cast<const float4*>(g + head);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const float4 v = gv[i];
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = head + 4 * i + q;
      rows[(f % 3) * MAX_CHUNK + f / 3] = e[q];
    }
  }
  for (int f = tail + threadIdx.x; f < n; f += blockDim.x)
    rows[(f % 3) * MAX_CHUNK + f / 3] = g[f];
}

__device__ __forceinline__ float coord(const float (&T)[12], int r, float x,
                                       float y, float z, float u) {
  return __fsub_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[4 * r], x),
                                    __fmul_rn(T[4 * r + 1], y)),
                          __fmul_rn(T[4 * r + 2], z)),
                T[4 * r + 3]),
      u);
}

__global__ void __launch_bounds__(MAX_THREADS)
seed_hypothesis_counts_kernel(const float* __restrict__ trans,
                              const float* __restrict__ src,
                              const float* __restrict__ tgt,
                              const float* __restrict__ mask,
                              int* __restrict__ counts, int S, int N,
                              int tile_seeds, int chunk, float thr_sq) {
  // x, y, z of src and u, v, w of tgt for the chunk's points
  __shared__ __align__(16) float sp[6][MAX_CHUNK];
  const int b = blockIdx.z;
  const int n0 = blockIdx.x * chunk;
  const int here = min(chunk, N - n0);
  const int padded = (here + 3) & ~3;
  const size_t first = (size_t)b * N + n0;
  stage_points(src + first * 3, here * 3, sp[0]);
  stage_points(tgt + first * 3, here * 3, sp[3]);

  // this thread's seeds: t, t + blockDim.x, ... of the tile
  float T[SPT][12];
  int s_of[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int in_tile = threadIdx.x + j * blockDim.x;
    const int s = blockIdx.y * tile_seeds + in_tile;
    s_of[j] = (in_tile < tile_seeds && s < S) ? s : -1;
    const float4* row = reinterpret_cast<const float4*>(
        trans + ((size_t)b * S + max(s_of[j], 0)) * 16);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float4 v = s_of[j] >= 0 ? row[r] : make_float4(0, 0, 0, 0);
      T[j][4 * r] = v.x; T[j][4 * r + 1] = v.y;
      T[j][4 * r + 2] = v.z; T[j][4 * r + 3] = v.w;
    }
  }
  __syncthreads();
  // a point that must not count: masked, or padding past the chunk's end
  for (int p = threadIdx.x; p < padded; p += blockDim.x) {
    const bool valid = p < here && (mask == nullptr || mask[first + p] > 0.f);
    if (p >= here) sp[0][p] = sp[1][p] = sp[2][p] = sp[4][p] = sp[5][p] = 0.f;
    if (!valid) sp[3][p] = __int_as_float(0x7fc00000);  // NaN
  }
  __syncthreads();

  int cnt[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) cnt[j] = 0;
  for (int p = 0; p < padded; p += 4) {
    float4 c[6];
#pragma unroll
    for (int a = 0; a < 6; ++a)
      c[a] = *reinterpret_cast<const float4*>(&sp[a][p]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x = (&c[0].x)[q], y = (&c[1].x)[q], z = (&c[2].x)[q];
      const float u = (&c[3].x)[q], v = (&c[4].x)[q], w = (&c[5].x)[q];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float px = coord(T[j], 0, x, y, z, u);
        const float py = coord(T[j], 1, x, y, z, v);
        const float pz = coord(T[j], 2, x, y, z, w);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(px, px),
                                             __fmul_rn(py, py)),
                                   __fmul_rn(pz, pz));
        cnt[j] += d2 < thr_sq;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    if (s_of[j] >= 0 && cnt[j] > 0)
      atomicAdd(counts + (size_t)b * S + s_of[j], cnt[j]);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace

// trans: [B, S, 4, 4] f32, 16-byte aligned; src, tgt: [B, N, 3] f32;
// mask: [B, N] f32 or null (every point valid); counts: [B, S] int32,
// zeroed here before the launch.
extern "C" int gmf_seed_hypothesis_counts(const void* trans, const void* src,
                                          const void* tgt, const void* mask,
                                          void* counts, int B, int S, int N,
                                          float thr_sq, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || B > 65535 ||
      (reinterpret_cast<uintptr_t>(trans) & 15))
    return cudaErrorInvalidValue;  // nothing to launch, or misaligned
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * B * S, st);
  if (err != cudaSuccess) return err;
  const int tiles = (S + MAX_TILE - 1) / MAX_TILE;
  const int tile_seeds = (S + tiles - 1) / tiles;
  const int threads = ((tile_seeds + SPT - 1) / SPT + 31) / 32 * 32;
  const long long want_blocks =
      ((long long)sm_count() * WARPS_PER_SM * 32 + threads - 1) / threads;
  const long long want_chunks = (want_blocks + (long long)B * tiles - 1) /
                                ((long long)B * tiles);
  int chunk = (int)((N + want_chunks - 1) / want_chunks);
  chunk = (chunk + 3) & ~3;
  chunk = max(MIN_CHUNK, min(MAX_CHUNK, chunk));
  const dim3 grid((N + chunk - 1) / chunk, tiles, B);
  seed_hypothesis_counts_kernel<<<grid, threads, 0, st>>>(
      static_cast<const float*>(trans), static_cast<const float*>(src),
      static_cast<const float*>(tgt), static_cast<const float*>(mask),
      static_cast<int*>(counts), S, N, tile_seeds, chunk, thr_sq);
  return static_cast<int>(cudaGetLastError());
}
