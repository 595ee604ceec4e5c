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
// None of the [*, k, k] tensors of the plain chain reaches device memory.
// The iteration count is fixed (no convergence test). Each round rescales V
// by its largest entry against overflow; the TPU kernel takes that maximum
// over the several seeds of its tile, this kernel over its own seed. The
// rescale changes only V's length, which the final per-seed normalisation
// removes, so the two agree. The TPU kernel's rows-compact layout,
// band-collapse and segment matmuls served its matrix unit and tiling and
// are not carried over.
//
// Bound on this card: the bytes, one read of the k x C features (f32 at
// B=8, S=500, k=40, C=128: 82 MB, 0.026 ms), ahead of the Gram's k*k*C
// multiply-adds per seed on the tensor cores.
//
// Design. One warp per seed, several seeds (warps) per block, no block-wide
// barrier: a warp streams its seed's features through a two-slot ring of
// 32-column chunks in shared memory with 16-byte cp.async (zero-filled past
// k and C; element loads where the rows are not 16-byte aligned), the next
// chunk in flight while the warp multiplies the present one.
//   - The Gram on the tensor cores, mma.sync m16n8k16 (bf16 in, f32 sums):
//     k padded to a multiple of 16 rows, C to the chunk, with zeros. A
//     40 x 40 Gram is 3 x 6 tiles of 16 x 8; wgmma's 64-row tiles would
//     waste 37% of it at k = 40 and need a warpgroup per seed. As the Gram
//     is symmetric, only the tiles that reach the upper triangle are formed
//     (12 of 18 at k = 40) and each entry i < j is written to M twice.
//     bf16 features: one term, a bf16 x bf16 product is exact in f32. f32
//     features: each operand split into three bf16 terms (hi = bf16(x),
//     mid = bf16(x - hi), lo = bf16(x - hi - mid)) as the f32 attention
//     kernels do (compat_flash_bwd_tc.cuh), six term products summed
//     smallest first (lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi) into
//     the f32 accumulator, which keeps f32 accuracy
//     (tests/test_torch_ops.py models it on the CPU). The split is taken
//     when a fragment is read from shared memory: each k-step splits the
//     column tiles' B fragments once and each row tile's A fragment once,
//     and issues products outer, tiles inner, so that neighbouring mma
//     are independent while each tile keeps its products' order.
//   - k <= 64: every tile's accumulator stays in registers through one pass
//     over the features (instances KP = 16, 32, 48, 64), and M, formed
//     after it, overlays the ring. 64 < k <= 128: one pass per 16-row
//     tile, the features streamed again from L2, M beside the ring.
//   - M's entries are formed from the Gram in registers with the spatial
//     term from the coordinates in shared memory, and stored in shared
//     memory; the power iteration runs inside the warp: lane r holds rows
//     r, r + 32, ... of M V (k <= 64: those rows of M in registers, V read
//     from shared memory as broadcast float4), the maximum and the final
//     sums by __shfl_xor_sync, V in shared memory between rounds behind
//     __syncwarp.
// Any k <= 128 and any C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int MAX_K = 128;
constexpr int MAX_WARPS = 4;  // seeds per block
constexpr int CC = 32;        // feature columns per chunk: two k-steps
constexpr int RS = CC + 8;    // chunk row stride in elements: conflict-free
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__host__ __device__ constexpr int terms() {
  return std::is_same<T, float>::value ? 3 : 1;
}
// the products in the order they are summed, smallest first, as (a term,
// b term) with 0 hi, 1 mid, 2 lo: lo.hi, hi.lo, mid.mid, mid.hi, hi.mid,
// hi.hi; one term: hi.hi alone
__host__ __device__ constexpr int term_a(int p) {
  return p == 0 ? 2 : p == 2 || p == 3 ? 1 : 0;
}
__host__ __device__ constexpr int term_b(int p) {
  return p == 1 ? 2 : p == 2 || p == 4 ? 1 : 0;
}

// bytes of one warp's region: the ring and M (one-pass instances: M
// overlays the ring, which is free once the Gram is formed), then the
// coordinates and V
template <typename T>
__host__ __device__ constexpr size_t ring_bytes(int kp) {
  return 2 * (size_t)kp * RS * sizeof(T);
}
__host__ __device__ constexpr size_t m_bytes(int kp) {
  return 4 * (size_t)kp * (kp + 1);
}
template <typename T>
__host__ __device__ constexpr size_t ring_m_bytes(int kp, bool one_pass) {
  return one_pass ? (ring_bytes<T>(kp) > m_bytes(kp) ? ring_bytes<T>(kp)
                                                     : m_bytes(kp))
                  : ring_bytes<T>(kp) + m_bytes(kp);
}
template <typename T>
__host__ __device__ constexpr size_t warp_bytes(int kp, bool one_pass) {
  return ring_m_bytes<T>(kp, one_pass) + 4 * ((size_t)kp * 8 + kp);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}
// two neighbouring elements as the bf16 terms of an mma fragment register
__device__ __forceinline__ void frag_terms(const float* p, uint32_t (&r)[3]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.x, x.y);
  const float r0 = x.x - __low2float(hi), r1 = x.y - __high2float(hi);
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  r[0] = pack(hi);
  r[1] = pack(mid);
  r[2] = pack(__floats2bfloat162_rn(r0 - __low2float(mid),
                                    r1 - __high2float(mid)));
}
__device__ __forceinline__ void frag_terms(const __nv_bfloat16* p,
                                           uint32_t (&r)[1]) {
  r[0] = *reinterpret_cast<const uint32_t*>(p);
}

// d += a b: a 16 x 16 (rows), b 16 x 8 (columns), bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// columns [c0, c0 + CC) of the seed's kp rows into a ring slot: 16-byte
// cp.async where the rows are aligned (zero-filled past k and C), element
// loads otherwise
template <typename T>
__device__ __forceinline__ void issue_chunk(const T* __restrict__ f, T* slot,
                                            int k, int kp, int C, int c0,
                                            bool aligned, int lane) {
  if (aligned) {
    constexpr int PER = 16 / sizeof(T);  // elements per 16 bytes
    constexpr int SEGS = CC / PER;
    for (int e = lane; e < kp * SEGS; e += 32) {
      const int row = e / SEGS, col = c0 + (e % SEGS) * PER;
      const bool valid = row < k && col < C;
      cp_async16(smem_u32(slot + row * RS + (e % SEGS) * PER),
                 valid ? f + (size_t)row * C + col : f, valid);
    }
  } else {
    for (int e = lane; e < kp * CC; e += 32) {
      const int row = e / CC, col = c0 + e % CC;
      slot[row * RS + e % CC] =
          row < k && col < C ? f[(size_t)row * C + col] : T(0.f);
    }
  }
  cp_async_commit();
}

// KP: the padded neighbour count of a one-pass instance (16, 32, 48, 64),
// or MAX_K for the instance that takes any kp <= 128, one 16-row tile a
// pass
template <typename T, int KP>
__global__ void __launch_bounds__(32 * MAX_WARPS)
fused_seed_weights_kernel(const T* __restrict__ feats,
                          const float* __restrict__ src_knn,
                          const float* __restrict__ tgt_knn,
                          const float* __restrict__ sigma,
                          float* __restrict__ out, int n_seeds, int k, int C,
                          int aligned, float sigma_d_sq, int num_iters) {
  constexpr int TERMS = terms<T>();
  constexpr bool ONE_PASS = KP <= 64;
  constexpr int RT = ONE_PASS ? KP / 16 : 1;  // row tiles per pass
  constexpr int CT = KP / 8;                  // column tiles
  constexpr int JG = ONE_PASS ? CT : 4;       // column tiles a B load
  const int kp = ONE_PASS ? KP : (k + 15) & ~15;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seed = blockIdx.x * (blockDim.x >> 5) + warp;
  if (seed >= n_seeds) return;  // the warp's own seed; no block barrier

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = smem + warp * warp_bytes<T>(kp, ONE_PASS);
  T* ring = reinterpret_cast<T*>(base);
  float* sM = reinterpret_cast<float*>(
      base + (ONE_PASS ? 0 : ring_bytes<T>(kp)));
  float* sC = reinterpret_cast<float*>(base + ring_m_bytes<T>(kp, ONE_PASS));
  float* sV = sC + kp * 8;  // sC: [kp][8], s.xyz, t.xyz
  const int ld = kp + 1;

  feats += (size_t)seed * k * C;
  src_knn += (size_t)seed * k * 3;
  tgt_knn += (size_t)seed * k * 3;
  for (int e = lane; e < k * 3; e += 32) {
    sC[(e / 3) * 8 + e % 3] = src_knn[e];
    sC[(e / 3) * 8 + 3 + e % 3] = tgt_knn[e];
  }
  for (int i = lane; i < kp; i += 32) sV[i] = i < k ? 1.f : 0.f;
  const float sig = sigma[0];
  const float inv_sig_sq = 1.f / (sig * sig);
  const float inv_sd_sq = 1.f / sigma_d_sq;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int chunks = (C + CC - 1) / CC;
  const int passes = ONE_PASS ? 1 : kp / 16;
  // the tiles that reach the upper triangle: 8 J + 7 >= 16 I
  auto needed = [&](int I, int J) {
    return J >= 2 * I && (ONE_PASS || J < kp / 8);
  };

  for (int pass = 0; pass < passes; ++pass) {
    float acc[RT][CT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

    issue_chunk(feats, ring, k, kp, C, 0, aligned, lane);
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + 1 < chunks) {
        issue_chunk(feats, ring + ((ch + 1) & 1) * kp * RS, k, kp, C,
                    (ch + 1) * CC, aligned, lane);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const T* slot = ring + (ch & 1) * kp * RS;
#pragma unroll
      for (int ks = 0; ks < CC; ks += 16) {
#pragma unroll
        for (int jg = 0; jg < CT; jg += JG) {
          if (!ONE_PASS && (jg >= kp / 8 || jg + JG - 1 < 2 * pass))
            continue;  // no tile of this pass's row in the group
          // B: JG column tiles (rows below kp), each split once
          uint32_t bb[JG][TERMS][2];
#pragma unroll
          for (int jj = 0; jj < JG; ++jj) {
            const T* brow = slot + (8 * (jg + jj) + g) * RS + ks + 2 * t;
            uint32_t b0[TERMS] = {}, b1[TERMS] = {};
            if (ONE_PASS || jg + jj < kp / 8) {
              frag_terms(brow, b0);
              frag_terms(brow + 8, b1);
            }
#pragma unroll
            for (int q = 0; q < TERMS; ++q) {
              bb[jj][q][0] = b0[q];
              bb[jj][q][1] = b1[q];
            }
          }
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const int I = ONE_PASS ? r : pass;
            if (jg + JG - 1 < 2 * I) continue;  // J >= 2 I for none
            const T* arow = slot + (16 * I + g) * RS + ks + 2 * t;
            uint32_t a[4][TERMS], aa[TERMS][4];
            frag_terms(arow, a[0]);
            frag_terms(arow + 8 * RS, a[1]);
            frag_terms(arow + 8, a[2]);
            frag_terms(arow + 8 * RS + 8, a[3]);
#pragma unroll
            for (int q = 0; q < TERMS; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) aa[q][e] = a[e][q];
            // products outer, tiles inner: neighbouring mma are
            // independent, each tile's products in the fixed order
#pragma unroll
            for (int p = TERMS == 3 ? 0 : 5; p < 6; ++p)
#pragma unroll
              for (int jj = 0; jj < JG; ++jj)
                if (needed(I, jg + jj))
                  mma(acc[r][jg + jj], aa[term_a(p)], bb[jj][term_b(p)]);
          }
        }
      }
      __syncwarp();  // the slot is free for the chunk after next
    }

    // M's entries i < j of this pass's tiles, written to both triangles
    // (one-pass: over the ring, every lane done with it)
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int I = ONE_PASS ? r : pass;
#pragma unroll
      for (int J = 0; J < CT; ++J) {
        if (!needed(I, J)) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * I + g + (e >> 1) * 8, j = 8 * J + 2 * t + (e & 1);
          if (!(i < j && j < k)) continue;
          const float feat =
              fmaxf(1.f - (1.f - acc[r][J][e]) * inv_sig_sq, 0.f);
          const float* a = sC + i * 8;
          const float* b = sC + j * 8;
          const float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
          const float ex = a[3] - b[3], ey = a[4] - b[4], ez = a[5] - b[5];
          const float dd = sqrtf(dx * dx + dy * dy + dz * dz) -
                           sqrtf(ex * ex + ey * ey + ez * ez);
          const float m = feat * fmaxf(1.f - dd * dd * inv_sd_sq, 0.f);
          sM[i * ld + j] = m;
          sM[j * ld + i] = m;
        }
      }
    }
  }
  for (int i = lane; i < k; i += 32) sM[i * ld + i] = 0.f;
  __syncwarp();

  // power iteration: lane holds rows lane, lane + 32, ... of M V; V in
  // shared memory, read as broadcast float4
  constexpr int RPL = ((ONE_PASS ? KP : MAX_K) + 31) / 32;  // rows a lane
  float v[RPL];
  if constexpr (ONE_PASS) {
    // the lane's rows of M in registers (zero past k)
    float m[RPL][KP];
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int row = lane + 32 * q;
#pragma unroll
      for (int j = 0; j < KP; ++j)
        m[q][j] = row < k && j < k ? sM[row * ld + j] : 0.f;
      v[q] = row < k ? 1.f : 0.f;
    }
    for (int it = 0; it < num_iters; ++it) {
      float u[RPL][2];
#pragma unroll
      for (int q = 0; q < RPL; ++q) u[q][0] = u[q][1] = 0.f;
#pragma unroll
      for (int j = 0; j < KP; j += 4) {
        const float4 w = *reinterpret_cast<const float4*>(sV + j);
#pragma unroll
        for (int q = 0; q < RPL; ++q) {
          u[q][0] = fmaf(m[q][j], w.x, u[q][0]);
          u[q][1] = fmaf(m[q][j + 1], w.y, u[q][1]);
          u[q][0] = fmaf(m[q][j + 2], w.z, u[q][0]);
          u[q][1] = fmaf(m[q][j + 3], w.w, u[q][1]);
        }
      }
      float top = 0.f;
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        v[q] = u[q][0] + u[q][1];
        top = fmaxf(top, v[q]);
      }
      const float inv = 1.f / fmaxf(warp_max(top), 1e-30f);
      __syncwarp();  // every lane has read V
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        v[q] *= inv;
        if (lane + 32 * q < kp) sV[lane + 32 * q] = v[q];
      }
      __syncwarp();
    }
  } else {
#pragma unroll
    for (int q = 0; q < RPL; ++q) v[q] = lane + 32 * q < k ? 1.f : 0.f;
    for (int it = 0; it < num_iters; ++it) {
      float top = 0.f;
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int row = lane + 32 * q;
        if (row >= k) continue;
        const float* m = sM + row * ld;
        float u0 = 0.f, u1 = 0.f;
        int j = 0;
        for (; j + 1 < k; j += 2) {
          u0 = fmaf(m[j], sV[j], u0);
          u1 = fmaf(m[j + 1], sV[j + 1], u1);
        }
        if (j < k) u0 = fmaf(m[j], sV[j], u0);
        v[q] = u0 + u1;
        top = fmaxf(top, v[q]);
      }
      const float inv = 1.f / fmaxf(warp_max(top), 1e-30f);
      __syncwarp();  // every lane has read V
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int row = lane + 32 * q;
        v[q] = row < k ? v[q] * inv : 0.f;
        if (row < k) sV[row] = v[q];
      }
      __syncwarp();
    }
  }

  float sq = 0.f;
#pragma unroll
  for (int q = 0; q < RPL; ++q) sq = fmaf(v[q], v[q], sq);
  const float nrm = sqrtf(warp_sum(sq) + 1e-24f) + 1e-6f;
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < RPL; ++q) total += v[q] / nrm;
  total = warp_sum(total);
  out += (size_t)seed * k;
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int row = lane + 32 * q;
    if (row < k) out[row] = (v[q] / nrm) / (total + 1e-6f);
  }
}

template <typename T, int KP>
cudaError_t launch(const void* feats, const float* src_knn,
                   const float* tgt_knn, const float* sigma, float* out,
                   int n_seeds, int k, int C, float sigma_d_sq, int num_iters,
                   cudaStream_t stream) {
  const int kp = KP <= 64 ? KP : (k + 15) & ~15;
  const size_t per_warp = warp_bytes<T>(kp, KP <= 64);
  const int warps =
      (int)std::min<size_t>(MAX_WARPS, (size_t)227 * 1024 / per_warp);
  const size_t bytes = per_warp * warps;
  auto kernel = fused_seed_weights_kernel<T, KP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int aligned =
      (reinterpret_cast<uintptr_t>(feats) % 16 == 0) &&
      ((size_t)C * sizeof(T)) % 16 == 0;
  kernel<<<(n_seeds + warps - 1) / warps, 32 * warps, bytes, stream>>>(
      static_cast<const T*>(feats), src_knn, tgt_knn, sigma, out, n_seeds, k,
      C, aligned, sigma_d_sq, num_iters);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* feats, const float* s, const float* t,
                     const float* sg, float* o, int n_seeds, int k, int C,
                     float sd, int iters, cudaStream_t st) {
  const int kp = (k + 15) & ~15;
  switch (kp) {
    case 16: return launch<T, 16>(feats, s, t, sg, o, n_seeds, k, C, sd, iters, st);
    case 32: return launch<T, 32>(feats, s, t, sg, o, n_seeds, k, C, sd, iters, st);
    case 48: return launch<T, 48>(feats, s, t, sg, o, n_seeds, k, C, sd, iters, st);
    case 64: return launch<T, 64>(feats, s, t, sg, o, n_seeds, k, C, sd, iters, st);
    default:
      return launch<T, MAX_K>(feats, s, t, sg, o, n_seeds, k, C, sd, iters, st);
  }
}

}  // namespace

// feats: [n_seeds, k, C] (f32, or bf16 when is_bf16); src_knn, tgt_knn:
// [n_seeds, k, 3] f32; sigma: 1 f32 on the device; out: [n_seeds, k] f32.
extern "C" int gmf_fused_seed_weights(const void* feats, const void* src_knn,
                                      const void* tgt_knn, const void* sigma,
                                      void* out, int n_seeds, int k, int C,
                                      int is_bf16, float sigma_d_sq,
                                      int num_iters, void* stream) {
  if (n_seeds <= 0 || k <= 0 || k > MAX_K || C <= 0 || num_iters < 0)
    return cudaErrorInvalidValue;
  const auto* s = static_cast<const float*>(src_knn);
  const auto* t = static_cast<const float*>(tgt_knn);
  const auto* sg = static_cast<const float*>(sigma);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(feats, s, t, sg, o, n_seeds, k, C,
                                        sigma_d_sq, num_iters, st)
              : dispatch<float>(feats, s, t, sg, o, n_seeds, k, C, sigma_d_sq,
                                num_iters, st);
  return static_cast<int>(err);
}
