// Score-NMS local maxima for Hopper, sm_90a.
//
// Replaces gmf_tpu/ops/fused_nms.py::_kernel (the pallas_call in
// nms_local_max, fused_nms.py:69): for every correspondence i of a pair,
//
//   is_local_max[i] = NOT OR_j ( |s_i - s_j|^2 < R^2  AND  score_j > score_i )
//
// A key suppresses only when its score is STRICTLY higher, so equal scores
// never suppress. Distances are the per-coordinate difference form with
// explicitly rounded products and sums (no FMA contraction), the same
// operations the plain version does, so the result is its result in every
// bit; the [N, N] distance and relation matrices never exist.
//
// A sweep along x. nms_sort_kernel puts each pair's points in x order
// (ties by index) and packs each as a float4 (x, y, z, score): one block
// a run of up to NMS_RUN points of a pair, a bitonic sort of (x's order as
// an integer, index) in shared memory. A pair of one run is packed there;
// a longer one is merged, two neighbouring runs a pass (nms_merge_kernel:
// each entry finds its place by a binary search in the other run; all
// entries differ, by their index), then packed (nms_pack_kernel). Then
// nms_local_max_kernel: a
// block owns NMS_ROWS consecutive points of that order (one a thread) and
// scans only the keys whose x lies near its own: key j is skipped when
// round(round(x_first - x_j)^2) >= R^2 for the block's smallest x (keys
// before it) or round(round(x_j - x_last)^2) >= R^2 for its largest (keys
// after it). Rounding is monotone and the squared distance's rounded sum
// is at least its x term, so every skipped key has a rounded distance of
// at least R^2 to every row of the block, as the plain version computes
// it: skipping it changes no bit. The bounds of the scanned range come
// from two binary searches over the sorted x: the predicate is monotone
// along every x but NaN, so a search skips a key only below (or above)
// one it has tested, or a NaN key, which never suppresses. The keys of
// the range stream through shared memory in tiles of NMS_ROWS float4,
// four at a time a thread with no early exit among them; a thread stops
// comparing at its first suppressor, but the block walks the whole range
// (an exit once every row of the block is suppressed saved nothing at
// the serving shapes, where most blocks hold a local maximum). The result is written back in the pair's own order.
//
// Bound on this card: ~10 f32 ALU ops per (i, j) compared and 20 bytes a
// point; to prove a local maximum it is compared with every key within
// the radius, another row with one key (its first suppressor). The sweep
// compares more: a local maximum meets every key of its block's range,
// at 3DMatch's density (5000 points in a few metres, R = 0.10 m) about a
// tenth of the pair. torch.sort of the keys took 0.2-0.6 ms on an H100 at
// 8 and at 64 pairs of 5000 (a segmented sort along N, or one sort of
// 64-bit keys), 5-20 times the scan: hence the sort in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NMS_ROWS = 128;  // sorted points a block owns; its threads
constexpr int SORT_THREADS = 1024;
// points of a run nms_sort_kernel sorts: 8 bytes each in shared memory
constexpr int NMS_RUN = 16384;
constexpr int MERGE_THREADS = 256;

// x's bits as an unsigned integer of the same order: negative floats
// reversed, -0 before +0, a NaN with its sign bit first, others last
__device__ __forceinline__ uint32_t x_order(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// keypts: [B, N, 3], scores: [B, N]; block (run, pair) sorts the run's
// points, [run NMS_RUN, +NMS_RUN) of the pair, by (x order, index). P is
// the power of two >= the run's length of the shared entries (x order
// << 32 | index; entries past the run all ones, so they sort last). With
// ent null (one run a pair) it writes keys: [B, N] float4 (x, y, z,
// score) in x order and order: [B, N], the pair index of each; else the
// sorted entries to ent: [B, N].
__global__ void __launch_bounds__(SORT_THREADS)
nms_sort_kernel(const float* __restrict__ keypts,
                const float* __restrict__ scores, float4* __restrict__ keys,
                int* __restrict__ order, unsigned long long* __restrict__ ent,
                int N, int P) {
  extern __shared__ unsigned long long sh[];
  const size_t base = (size_t)blockIdx.y * N;
  const int r0 = blockIdx.x * NMS_RUN, n = min(NMS_RUN, N - r0);
  keypts += base * 3;
  scores += base;
  for (int i = threadIdx.x; i < P; i += SORT_THREADS)
    sh[i] = i < n ? (unsigned long long)x_order(keypts[(size_t)(r0 + i) * 3])
                            << 32 |
                        (unsigned)(r0 + i)
                  : ~0ull;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P / 2; i += SORT_THREADS) {
        const int a = 2 * i - (i & (j - 1)), c = a + j;  // this exchange
        const unsigned long long x = sh[a], y = sh[c];
        if ((x > y) == ((a & k) == 0)) {
          sh[a] = y;
          sh[c] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < n; r += SORT_THREADS) {
    if (ent != nullptr) {
      ent[base + r0 + r] = sh[r];
    } else {
      const int i = (int)(sh[r] & 0xffffffffu);
      const float* p = keypts + (size_t)i * 3;
      keys[base + r] = make_float4(p[0], p[1], p[2], scores[i]);
      order[base + r] = i;
    }
  }
}

// src: [B, N] entries, sorted in runs of len; merges each two neighbouring
// runs into one of dst, or with dst null (the last pass) writes each
// entry's index to order: [B, N]. An entry's place is its place in its
// run plus the entries of the other run below it.
__global__ void __launch_bounds__(MERGE_THREADS)
nms_merge_kernel(const unsigned long long* __restrict__ src,
                 unsigned long long* __restrict__ dst, int* __restrict__ order,
                 int N, long long len) {
  const long long r = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (r >= N) return;
  const size_t base = (size_t)blockIdx.y * N;
  const unsigned long long e = src[base + r];
  const long long run = r / len, lo = (run ^ 1) * len;
  long long a = lo, b = max(lo, min(lo + len, (long long)N));
  while (a < b) {
    const long long mid = a + (b - a) / 2;
    if (src[base + mid] < e) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  const long long dest = min(run, run ^ 1) * len + (r - run * len) + (a - lo);
  if (dst != nullptr) {
    dst[base + dest] = e;
  } else {
    order[base + dest] = (int)(e & 0xffffffffu);
  }
}

// keys: [B, N] float4 (x, y, z, score) of each point of order: [B, N]
__global__ void __launch_bounds__(MERGE_THREADS)
nms_pack_kernel(const float* __restrict__ keypts,
                const float* __restrict__ scores, float4* __restrict__ keys,
                const int* __restrict__ order, int N) {
  const int r = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (r >= N) return;
  const size_t base = (size_t)blockIdx.y * N;
  const size_t i = base + order[base + r];
  keys[base + r] =
      make_float4(keypts[i * 3], keypts[i * 3 + 1], keypts[i * 3 + 2],
                  scores[i]);
}

// index of the first key of [lo, hi) in x order for which skip(x) is
// false; skip must be true on a prefix of [lo, hi) (binary search)
template <typename Skip>
__device__ int first_kept(const float4* keys, int lo, int hi, Skip skip) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (skip(keys[mid].x)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// keys: [B, N] float4 (x, y, z, score), each pair sorted by x; order:
// [B, N] int32, the pair index of each sorted point; out: [B, N] f32 in
// the pair's own order, 1 = local maximum
__global__ void __launch_bounds__(NMS_ROWS)
nms_local_max_kernel(const float4* __restrict__ keys,
                     const int* __restrict__ order, float* __restrict__ out,
                     int N, float radius_sq) {
  __shared__ float4 tile[NMS_ROWS];
  __shared__ int range[2];
  const size_t base = (size_t)blockIdx.y * N;
  keys += base;
  order += base;
  out += base;
  const int r0 = blockIdx.x * NMS_ROWS;
  const int last = min(r0 + NMS_ROWS, N) - 1;
  const int i = r0 + threadIdx.x;

  // the scanned range [start, end): warp 0 finds start, warp 1 end
  if (threadIdx.x == 0) {
    const float x_first = keys[r0].x;
    range[0] = first_kept(keys, 0, r0, [&](float x) {
      const float d = __fsub_rn(x_first, x);
      return __fmul_rn(d, d) >= radius_sq;
    });
  } else if (threadIdx.x == 32) {
    const float x_last = keys[last].x;
    // keys after the block: kept while round(x - x_last)^2 < R^2
    range[1] = first_kept(keys, last + 1, N, [&](float x) {
      const float d = __fsub_rn(x, x_last);
      return !(__fmul_rn(d, d) >= radius_sq);
    });
  }
  float4 me = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < N) me = keys[i];
  __syncthreads();
  const int start = range[0], end = range[1];

  bool suppressed = false;
  for (int j0 = start; j0 < end; j0 += NMS_ROWS) {
    const int j = j0 + threadIdx.x;
    // past the range: a score of -inf never suppresses
    tile[threadIdx.x] =
        j < end ? keys[j] : make_float4(0.f, 0.f, 0.f, -INFINITY);
    __syncthreads();
    const int cnt = min(NMS_ROWS, end - j0);
    for (int jj = 0; jj < cnt && !suppressed; jj += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 kj = tile[jj + u];
        const float dx = __fsub_rn(me.x, kj.x);
        const float dy = __fsub_rn(me.y, kj.y);
        const float dz = __fsub_rn(me.z, kj.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        suppressed |= (d2 < radius_sq) && (kj.w > me.w);
      }
    }
    __syncthreads();  // before the next tile overwrites this one
  }
  if (i < N) out[order[i]] = suppressed ? 0.f : 1.f;
}

}  // namespace

// keypts: [B, N, 3] f32, scores: [B, N] f32 -> keys: [B, N, 4] f32 (x, y,
// z, score), each pair sorted by x (ties by index), and order: [B, N]
// int32, the pair index of each sorted point. A pair of more than NMS_RUN
// points is merged through keys' memory, two [B, N] entry buffers.
extern "C" int gmf_nms_sort(const void* keypts, const void* scores,
                            void* keys, void* order, int B, int N,
                            void* stream) {
  if (B <= 0 || N <= 0)
    return cudaErrorInvalidValue;  // nothing to launch
  auto st = static_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const float*>(keypts);
  const auto* sc = static_cast<const float*>(scores);
  auto* packed = static_cast<float4*>(keys);
  auto* idx = static_cast<int*>(order);
  const int runs = (N + NMS_RUN - 1) / NMS_RUN;
  int P = 2;
  while (P < min(N, NMS_RUN)) P <<= 1;
  const size_t bytes = (size_t)P * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      nms_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long* ent[2] = {
      static_cast<unsigned long long*>(keys),
      static_cast<unsigned long long*>(keys) + (size_t)B * N};
  nms_sort_kernel<<<dim3(runs, B), SORT_THREADS, bytes, st>>>(
      kp, sc, packed, idx, runs > 1 ? ent[0] : nullptr, N, P);
  if (runs == 1) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + MERGE_THREADS - 1) / MERGE_THREADS, B);
  int cur = 0;
  for (long long len = NMS_RUN; len < N; len *= 2, cur ^= 1)
    nms_merge_kernel<<<grid, MERGE_THREADS, 0, st>>>(
        ent[cur], 2 * len >= N ? nullptr : ent[cur ^ 1], idx, N, len);
  nms_pack_kernel<<<grid, MERGE_THREADS, 0, st>>>(kp, sc, packed, idx, N);
  return static_cast<int>(cudaGetLastError());
}

// keys: [B, N, 4] f32 and order: [B, N] int32 as gmf_nms_sort leaves them
// -> out: [B, N] f32 (1 = local max), in the pair's own order.
extern "C" int gmf_nms_scan(const void* keys, const void* order, void* out,
                            int B, int N, float radius_sq, void* stream) {
  if (B <= 0 || N <= 0)
    return cudaErrorInvalidValue;  // nothing to launch
  const dim3 grid((N + NMS_ROWS - 1) / NMS_ROWS, B);
  nms_local_max_kernel<<<grid, NMS_ROWS, 0, static_cast<cudaStream_t>(
                                             stream)>>>(
      static_cast<const float4*>(keys), static_cast<const int*>(order),
      static_cast<float*>(out), N, radius_sq);
  return static_cast<int>(cudaGetLastError());
}
