// Fused seed-local spectral matching for Hopper, sm_90a.
//
// Replaces gmf_tpu/ops/fused_seed_solver.py::_kernel (the pallas_call in
// _weights_jit, fused_seed_solver.py:163). For every seed, from its k
// gathered neighbours (features f, source and target coordinates s, t):
//
//   feat_M[i,j]    = max(0, 1 - (1 - <f_i, f_j>) / sigma^2)
//   spatial_M[i,j] = max(0, 1 - (|s_i - s_j| - |t_i - t_j|)^2 / sigma_d^2)
//   M              = feat_M * spatial_M, zero diagonal
//   V              = num_iters power iterations on M from the all-ones vector
//   unit           = V / (|V| + 1e-6),  w = unit / (sum(unit) + 1e-6)
//
// One block per seed: the k x C features, the coordinates and the k x k
// matrix M live in shared memory, and none of the [*, k, k] tensors of the
// plain chain reaches device memory. All accumulation is f32 whatever the
// feature type. The iteration count is fixed (no convergence test). Each
// step rescales V by its largest entry against overflow; the TPU kernel
// takes that maximum over the several seeds of its tile, this kernel over
// its own seed. The rescale changes only V's length, which the final
// per-seed normalisation removes, so the two agree.
//
// The TPU kernel's rows-compact layout, band-collapse matmuls and segment
// matmuls served the TPU's matrix unit and tiling and are not carried over.
//
// Bound on this card: k*k*C FMAs per seed for the Gram block (f32-ALU
// bound); bytes are one read of the k x C features.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_seed_weights_kernel(const T* __restrict__ feats,
                          const float* __restrict__ src_knn,
                          const float* __restrict__ tgt_knn,
                          const float* __restrict__ sigma,
                          float* __restrict__ out, int k, int C,
                          float sigma_d_sq, int num_iters) {
  extern __shared__ float smem[];
  const int CP = C + 1, KP = k + 1;
  float* sF = smem;          // [k][CP]
  float* sC = sF + k * CP;   // [k][8] s.xyz, t.xyz
  float* sM = sC + k * 8;    // [k][KP]
  float* sV = sM + k * KP;   // [k]
  float* sU = sV + k;        // [k]

  const int tid = threadIdx.x;
  const size_t seed = blockIdx.x;
  feats += seed * k * C;
  src_knn += seed * k * 3;
  tgt_knn += seed * k * 3;
  out += seed * k;

  for (int e = tid; e < k * C; e += THREADS)
    sF[(e / C) * CP + e % C] = to_f32(feats[e]);
  for (int e = tid; e < k * 3; e += THREADS) {
    sC[(e / 3) * 8 + e % 3] = src_knn[e];
    sC[(e / 3) * 8 + 3 + e % 3] = tgt_knn[e];
  }
  if (tid < k) sV[tid] = 1.f;
  __syncthreads();

  const float sig = sigma[0];
  const float sig_sq = sig * sig;
  for (int e = tid; e < k * k; e += THREADS) {
    const int i = e / k, j = e % k;
    float m = 0.f;
    if (i != j) {
      const float* fi = sF + i * CP;
      const float* fj = sF + j * CP;
      float dot = 0.f;
      for (int d = 0; d < C; ++d) dot = fmaf(fi[d], fj[d], dot);
      const float feat = fmaxf(1.f - (1.f - dot) / sig_sq, 0.f);
      const float* a = sC + i * 8;
      const float* b = sC + j * 8;
      const float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
      const float ex = a[3] - b[3], ey = a[4] - b[4], ez = a[5] - b[5];
      const float dd = sqrtf(dx * dx + dy * dy + dz * dz) -
                       sqrtf(ex * ex + ey * ey + ez * ez);
      m = feat * fmaxf(1.f - dd * dd / sigma_d_sq, 0.f);
    }
    sM[i * KP + j] = m;
  }
  __syncthreads();

  for (int it = 0; it < num_iters; ++it) {
    if (tid < k) {
      float u = 0.f;
      for (int j = 0; j < k; ++j) u = fmaf(sM[tid * KP + j], sV[j], u);
      sU[tid] = u;
    }
    __syncthreads();
    if (tid < k) {
      float top = sU[0];
      for (int j = 1; j < k; ++j) top = fmaxf(top, sU[j]);
      sV[tid] = sU[tid] / fmaxf(top, 1e-30f);
    }
    __syncthreads();
  }

  if (tid < k) {
    float sq = 0.f;
    for (int j = 0; j < k; ++j) sq = fmaf(sV[j], sV[j], sq);
    const float nrm = sqrtf(sq + 1e-24f) + 1e-6f;
    float total = 0.f;
    for (int j = 0; j < k; ++j) total += sV[j] / nrm;
    out[tid] = (sV[tid] / nrm) / (total + 1e-6f);
  }
}

template <typename T>
cudaError_t launch(const void* feats, const float* src_knn,
                   const float* tgt_knn, const float* sigma, float* out,
                   int n_seeds, int k, int C, float sigma_d_sq, int num_iters,
                   cudaStream_t stream) {
  const size_t bytes =
      ((size_t)k * (C + 1) + k * 8 + (size_t)k * (k + 1) + 2 * k) *
      sizeof(float);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_seed_weights_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  fused_seed_weights_kernel<T><<<n_seeds, THREADS, bytes, stream>>>(
      static_cast<const T*>(feats), src_knn, tgt_knn, sigma, out, k, C,
      sigma_d_sq, num_iters);
  return cudaGetLastError();
}

}  // namespace

// feats: [n_seeds, k, C] (f32, or bf16 when is_bf16); src_knn, tgt_knn:
// [n_seeds, k, 3] f32; sigma: 1 f32 on the device; out: [n_seeds, k] f32.
extern "C" int gmf_fused_seed_weights(const void* feats, const void* src_knn,
                                      const void* tgt_knn, const void* sigma,
                                      void* out, int n_seeds, int k, int C,
                                      int is_bf16, float sigma_d_sq,
                                      int num_iters, void* stream) {
  if (n_seeds <= 0 || k <= 0 || k > THREADS || C <= 0 || num_iters < 0)
    return cudaErrorInvalidValue;
  const auto* s = static_cast<const float*>(src_knn);
  const auto* t = static_cast<const float*>(tgt_knn);
  const auto* sg = static_cast<const float*>(sigma);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(feats, s, t, sg, o, n_seeds, k, C,
                                      sigma_d_sq, num_iters, st)
              : launch<float>(feats, s, t, sg, o, n_seeds, k, C, sigma_d_sq,
                              num_iters, st);
  return static_cast<int>(err);
}
