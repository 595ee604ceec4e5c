// Shared core of the compat-modulated flash attention kernels (forward)
// for Hopper, sm_90a, and the compat arithmetic of the cache kernels.
//
// One kernel template, three ways to obtain the compat tile:
//
//   Compat::kStream  rebuild it from the keypoints in every layer
//                    (compat_flash_attention.cu),
//   Compat::kBuild   compute the int8 code, store it to the cache and
//                    attend on the DEQUANTIZED code
//                    (compat_flash_attention_build.cu),
//   Compat::kCached  load it from a cache of f32, bf16 or int8 codes
//                    (compat_flash_attention_cached.cu),
//
// and four more forms of the compat arithmetic that the attention-variant
// microbenchmark compares (compat_flash_variants.cu): kNone (compat 1,
// plain attention), kStreamOneSqrt (difference form, one sqrt), kNormId
// and kNormIdOneSqrt (squared distances by the norm identity
// |a|^2 + |b|^2 - 2 a.b, two sqrt or one).
//
// For one pair,
//
//   out[i] = softmax_j(compat[i,j] * q_i.k_j / sqrt(D)) @ v
//
// with masked keys set to -1e9 AFTER the compat multiply (a compat of 0
// does not exclude a key) and keys past N at weight 0, so nothing is
// padded to a tile multiple. A block owns a tile of query rows of one pair
// (the batch is the grid's y dimension) and streams key tiles through
// shared memory with an online base-2 softmax whose scale*log2(e) is
// folded into q once. It writes out in q's type and, when asked, the rows'
// base-2 log-sum-exp m + log2(max(l, 1e-30)) that the backward reads.
//
// Two kernels, both on the tensor cores, chosen by q's element type in
// launch_flash: one bf16 term per operand, or three:
//
//   bf16  compat_flash_fwd_tc: both products on the tensor cores (wgmma),
//         K/V and cache tiles by cp.async in a two-slot ring, compat and
//         softmax on the S accumulator in registers (design below, before
//         the kernel). q * scale * log2(e) and p are rounded to bf16 before
//         their products, as the TPU kernels do; l sums the unrounded p.
//         Bound: the products, 4 D flop per (i, j) at 989 TFLOP/s, next to
//         one exp2 per (i, j) on the SFU.
//   f32   compat_flash_fwd_split: the same products and softmax on the
//         tensor cores with every operand split into three bf16 terms (six
//         products each), a producer warpgroup splitting k and v on their
//         way into shared memory (design below, before the kernel). Within
//         1e-5 of the plain version, not equal to it in every bit. TF32
//         keeps 10 mantissa bits and would change the training path's
//         numbers. Bound: the products at 989 / 6 TFLOP/s.
//
// The cache is [B, N, ld]: row i of a pair holds its N compat entries and
// ld - N pad entries (zeros), ld chosen so every row starts 16-byte
// aligned, so 16-byte copies never straddle a row.
//
// The int8 code and the f32/bf16 compat are computed with explicitly
// rounded operations (no FMA contraction, IEEE sqrt and division), so the
// standalone cache kernel, the build+attend kernel and the plain PyTorch
// version agree in every byte.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float MASKED = -1e9f;

enum class Compat {
  kStream,
  kBuild,
  kCached,
  kNone,
  kStreamOneSqrt,
  kNormId,
  kNormIdOneSqrt
};

// cache element types as the C entry points number them
constexpr int CACHE_F32 = 0, CACHE_BF16 = 1, CACHE_INT8 = 2;

// ---- compat arithmetic of the cache (a, b: s.xyz then t.xyz) -----------

__device__ __forceinline__ void squared_dists(const float* a, const float* b,
                                              float& ds2, float& dt2) {
  const float dx = __fsub_rn(a[0], b[0]), dy = __fsub_rn(a[1], b[1]),
              dz = __fsub_rn(a[2], b[2]);
  const float ex = __fsub_rn(a[3], b[3]), ey = __fsub_rn(a[4], b[4]),
              ez = __fsub_rn(a[5], b[5]);
  ds2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                  __fmul_rn(dz, dz));
  dt2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                  __fmul_rn(ez, ez));
}

// squared distance of a and b (3 coordinates) by the norm identity
// |a|^2 + |b|^2 - 2 a.b, clamped at 0: it cancels where the points are
// close against their distance from the origin
__device__ __forceinline__ float norm_id_sq(const float* a, const float* b) {
  const float na = __fadd_rn(__fadd_rn(__fmul_rn(a[0], a[0]),
                                       __fmul_rn(a[1], a[1])),
                             __fmul_rn(a[2], a[2]));
  const float nb = __fadd_rn(__fadd_rn(__fmul_rn(b[0], b[0]),
                                       __fmul_rn(b[1], b[1])),
                             __fmul_rn(b[2], b[2]));
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]),
                                        __fmul_rn(a[1], b[1])),
                              __fmul_rn(a[2], b[2]));
  return fmaxf(__fsub_rn(__fadd_rn(na, nb), __fmul_rn(2.f, dot)), 0.f);
}

// compat from the squared distances, one-sqrt form:
// (sqrt(a) - sqrt(b))^2 = a + b - 2 sqrt(ab)
__device__ __forceinline__ float compat_one_sqrt_of(float ds2, float dt2,
                                                    float sigma_sq) {
  const float root = __fsqrt_rn(__fmul_rn(ds2, dt2));
  const float dd2 = fmaxf(
      __fsub_rn(__fadd_rn(ds2, dt2), __fmul_rn(2.f, root)), 0.f);
  return fmaxf(__fsub_rn(1.f, __fdiv_rn(dd2, sigma_sq)), 0.f);
}

// compat from the squared distances, two-sqrt difference form
__device__ __forceinline__ float compat_two_sqrt_of(float ds2, float dt2,
                                                    float sigma_sq) {
  const float dd = __fsub_rn(__fsqrt_rn(ds2), __fsqrt_rn(dt2));
  return fmaxf(__fsub_rn(1.f, __fdiv_rn(__fmul_rn(dd, dd), sigma_sq)), 0.f);
}

// int8 cache: the one-sqrt form, then code = round_half_even(254 c - 127),
// returned as a float in [-127, 127].
__device__ __forceinline__ float compat_i8_code(const float* a,
                                                const float* b,
                                                float sigma_sq) {
  float ds2, dt2;
  squared_dists(a, b, ds2, dt2);
  const float c = compat_one_sqrt_of(ds2, dt2, sigma_sq);
  return rintf(__fsub_rn(__fmul_rn(c, 254.f), 127.f));
}

// f32 and bf16 caches: the two-sqrt difference form.
__device__ __forceinline__ float compat_two_sqrt(const float* a,
                                                 const float* b,
                                                 float sigma_sq) {
  float ds2, dt2;
  squared_dists(a, b, ds2, dt2);
  return compat_two_sqrt_of(ds2, dt2, sigma_sq);
}

// the microbenchmark's compat forms of query a and key b (s.xyz then
// t.xyz), every operation rounded on its own as in the plain version
template <Compat MODE>
__device__ __forceinline__ float compat_variant(const float* a,
                                                const float* b,
                                                float sigma_sq) {
  if constexpr (MODE == Compat::kNone) {
    return 1.f;
  } else {
    float ds2, dt2;
    if constexpr (MODE == Compat::kStreamOneSqrt) {
      squared_dists(a, b, ds2, dt2);
    } else {
      ds2 = norm_id_sq(a, b);
      dt2 = norm_id_sq(a + 3, b + 3);
    }
    if constexpr (MODE == Compat::kNormId)
      return compat_two_sqrt_of(ds2, dt2, sigma_sq);
    return compat_one_sqrt_of(ds2, dt2, sigma_sq);
  }
}

// streaming compat of query a and key b (s.xyz then t.xyz): the exact
// per-coordinate distances with IEEE sqrt. The forward and the backward
// kernels both take it from here, so the backward recomputes the very
// logits whose log-sum-exp the forward stored.
__device__ __forceinline__ float compat_stream(const float* a, const float* b,
                                               float inv_sigma_sq) {
  const float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  const float ex = a[3] - b[3], ey = a[4] - b[4], ez = a[5] - b[5];
  const float ds = sqrtf(dx * dx + dy * dy + dz * dz);
  const float dt = sqrtf(ex * ex + ey * ey + ez * ez);
  const float diff = ds - dt;
  return fmaxf(1.f - diff * diff * inv_sigma_sq, 0.f);
}

// code / 254 + 0.5 as one FMA (127 / 254 is exactly 0.5)
__device__ __forceinline__ float dequant_i8(float code) {
  return fmaf(code, 1.f / 254.f, 0.5f);
}

// ---- the bf16 instances: products on the tensor cores --------------------
//
// A block is TC_WARPGROUPS warpgroups of 128 threads; each owns 64 query
// rows (wgmma's M) and walks the key tiles of its pair. The K and V tiles
// (bf16) and, for kCached, the block's cache tile arrive by cp.async in a
// ring of TC_STAGES slots: tile t + 1 is copied while tile t is multiplied.
// Per tile and warpgroup:
//
//   S = Qs K^T   D / 16 wgmma m64n{128|64}k16, both operands in shared
//                memory (K-major); S stays in registers;
//   compat, masks, online softmax on S's fragment: a thread holds rows
//                r and r + 8 of its warp's 16 and two neighbouring columns
//                of every 8, and the 4 lanes of a row reduce by shuffles;
//   O += P V     P rounded to bf16 into wgmma's A registers (the
//                accumulator's layout is the A operand's), V read from its
//                row-major tile through the descriptor's transpose bit.
//
// The only block-wide barrier per tile is the ring's: it publishes tile t
// and certifies that every warpgroup is done with the slot tile t + 1
// will overwrite. Rows and keys past N arrive as zeros (cp.async's
// zero-fill), so a tile never reads the next pair.

constexpr int TC_WARPGROUPS = 2;
constexpr int TC_BQ = 64 * TC_WARPGROUPS;  // query rows per block
constexpr int TC_THREADS = 128 * TC_WARPGROUPS;
constexpr int TC_STAGES = 2;               // ring slots
constexpr int KEY_FIELDS = 8;              // per key: s.xyz, t.xyz, mask

// Keys per tile: 128, or 64 beside a bf16 or f32 cache, whose two tiles
// of 128 x 128 entries would not fit in shared memory next to the K and V
// ring. On the H100 128 keys took 2-14% less time than 64 wherever both
// fit (int8 cache, no cache; scripts/compare_forward_builds.py against a
// copy with 64). The modes without a cache take CT = int8_t.
template <typename CT>
__host__ __device__ constexpr int tc_bk() {
  return sizeof(CT) == 1 ? 128 : 64;
}

// Bytes of one row of a staged cache (or kBuild code) tile: tc_bk entries
// and a pad that puts the 8 rows a warp reads in fragment layout in
// different banks.
template <typename CT>
__host__ __device__ constexpr int tc_cache_row() {
  return tc_bk<CT>() * (int)sizeof(CT) + (sizeof(CT) == 4 ? 32 : 16);
}

// A bf16 tile of `rows` x D in shared memory in wgmma's swizzled layout:
// column blocks of RB-byte rows (D = 128: two blocks of 64 columns, 128-byte
// swizzle; D = 32: one block of 64-byte rows, 64-byte swizzle), each block
// `rows` x RB bytes, the 16-byte chunks of a row permuted by address bits
// 7-9 (7-8). Every tile starts 1024-byte aligned, so the pattern lines up
// with the one the descriptor names.
template <int D>
struct TcTile {
  static constexpr int RB = D >= 64 ? 128 : 64;
  static constexpr int CPR = RB / 16;                  // chunks per row
  static constexpr uint64_t SWIZZLE = RB == 128 ? 1 : 2;  // descriptor mode
  static __device__ __forceinline__ uint32_t offset(int row, int chunk,
                                                    int rows) {
    const uint32_t off = row * RB + (chunk % CPR) * 16;
    return (chunk / CPR) * rows * RB +
           (off ^ (((off >> 7) & (CPR - 1)) << 4));
  }
  // wgmma's shared-memory matrix descriptor. K-major operands (Q, K): sbo
  // is the stride of 8-row groups, lbo unused. MN-major (V): lbo is the
  // stride of the column blocks, sbo that of 8-row groups along K.
  static __device__ __forceinline__ uint64_t desc(uint32_t addr,
                                                  uint32_t lbo,
                                                  uint32_t sbo) {
    return (uint64_t)((addr & 0x3ffff) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (SWIZZLE << 62);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, asynchronously; zeros where !valid (the
// source is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// orders the accumulator's uses after the wgmma.wait that completes it
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2 neighbouring cache entries as compat (int8: dequantized)
__device__ __forceinline__ void load2(const float* p, float (&c)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  c[0] = x.x; c[1] = x.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&c)[2]) {
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
  c[0] = __uint_as_float(raw << 16);
  c[1] = __uint_as_float(raw & 0xffff0000u);
}
__device__ __forceinline__ void load2(const int8_t* p, float (&c)[2]) {
  const char2 x = *reinterpret_cast<const char2*>(p);
  c[0] = dequant_i8((float)x.x); c[1] = dequant_i8((float)x.y);
}
// d += A B: A 64 x 16 (shared, K-major), B 16 x 64 (shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32],
                                         uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d += A B: A 64 x 16 (shared, K-major), B 16 x 128 (shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64],
                                                uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d += A B: A 64 x 16 (registers), B 16 x 32 (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B: A 64 x 16 (registers), B 16 x 128 (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D, Compat MODE, typename CT>
constexpr size_t tc_smem_bytes() {
  return 1024 /* alignment */ + TC_BQ * D * 2 +
         TC_STAGES * (2 * tc_bk<CT>() * D * 2 +
                      tc_bk<CT>() * KEY_FIELDS * 4) +
         (MODE == Compat::kCached  ? TC_STAGES * TC_BQ * tc_cache_row<CT>()
          : MODE == Compat::kBuild ? TC_BQ * tc_cache_row<CT>()
                                   : 0);
}

// The bf16 attention. q, k, v, out: [B, N, D]; src, tgt: [B, N, 3] (the
// modes that compute compat); mask: [B, N]; lse: [B, N] or null.
// sigma_arg: 1 / sigma^2 (kStream), unused (kCached, kNone), sigma^2 (the
// others). cache: written (kBuild), read (kCached), unused (the others).
template <int D, Compat MODE, typename CT>
__global__ void __launch_bounds__(TC_THREADS, 1)
compat_flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ src,
                    const float* __restrict__ tgt,
                    const float* __restrict__ mask,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    CT* __restrict__ cache, int N, int ld, float sigma_arg,
                    float qscale) {
  using Tile = TcTile<D>;
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr bool kCoords = MODE != Compat::kCached && MODE != Compat::kNone;
  constexpr bool kCache = MODE == Compat::kBuild || MODE == Compat::kCached;
  constexpr int RB = Tile::RB;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks of a q/k/v row
  constexpr int KEYS = tc_bk<CT>();  // keys per tile
  constexpr int KV_BYTES = KEYS * D * 2;
  constexpr int CROW = tc_cache_row<CT>();
  constexpr int NS = KEYS / 8;  // 8-column groups of S
  constexpr int NO = D / 8;      // of O
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* sQ = tc_smem + ((1024u - (smem_u32(tc_smem) & 1023u)) & 1023u);
  uint8_t* sK = sQ + TC_BQ * D * 2;       // [TC_STAGES][KV_BYTES]
  uint8_t* sV = sK + TC_STAGES * KV_BYTES;  // [TC_STAGES][KV_BYTES]
  float* sKey = reinterpret_cast<float*>(sV + TC_STAGES * KV_BYTES);
  // kCached: [TC_STAGES][TC_BQ][CROW] cache tiles; kBuild: [TC_BQ][CROW]
  // codes on their way to the cache
  uint8_t* sC = reinterpret_cast<uint8_t*>(sKey + TC_STAGES * KEYS *
                                                      KEY_FIELDS);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int wg = warp / 4;
  const int row0 = warp * 16 + lane / 4;  // this thread's rows: row0, +8
  const int q0 = blockIdx.x * TC_BQ;
  const size_t base = (size_t)blockIdx.y * N;
  q += base * D;
  k += base * D;
  v += base * D;
  out += base * D;
  mask += base;
  if (lse != nullptr) lse += base;
  if constexpr (kCoords) {
    src += base * 3;
    tgt += base * 3;
  }
  if constexpr (kCache) cache += base * ld;

  // tile t's K, V, key data (and cache tile) into ring slot `stage`
  auto load_tile = [&](int t, int stage) {
    const int k0 = t * KEYS;
    const uint32_t dk = smem_u32(sK + stage * KV_BYTES);
    const uint32_t dv = smem_u32(sV + stage * KV_BYTES);
    for (int e = tid; e < KEYS * CHUNKS; e += TC_THREADS) {
      const int r = e / CHUNKS, ch = e % CHUNKS, j = k0 + r;
      const bool in = j < N;
      const size_t g = (size_t)(in ? j : 0) * D + ch * 8;
      const uint32_t off = Tile::offset(r, ch, KEYS);
      cp_async16(dk + off, k + g, in);
      cp_async16(dv + off, v + g, in);
    }
    const uint32_t dkey = smem_u32(sKey + stage * KEYS * KEY_FIELDS);
    for (int r = tid; r < KEYS; r += TC_THREADS) {
      const int j = k0 + r;
      cp_async4(dkey + (r * KEY_FIELDS + 6) * 4, mask + (j < N ? j : 0),
                j < N);
    }
    if constexpr (kCoords) {
      for (int e = tid; e < KEYS * 6; e += TC_THREADS) {
        const int r = e / 6, c = e % 6, j = k0 + r;
        const size_t jj = j < N ? j : 0;
        cp_async4(dkey + (r * KEY_FIELDS + c) * 4,
                  c < 3 ? src + jj * 3 + c : tgt + jj * 3 + c - 3, j < N);
      }
    }
    if constexpr (MODE == Compat::kCached) {
      constexpr int EPC = 16 / (int)sizeof(CT);  // entries per chunk
      constexpr int CPT = KEYS / EPC;           // chunks per tile row
      const uint32_t dc = smem_u32(sC + stage * TC_BQ * CROW);
      for (int e = tid; e < TC_BQ * CPT; e += TC_THREADS) {
        const int r = e / CPT, ch = e % CPT, i = q0 + r, jc = k0 + ch * EPC;
        const bool in = i < N && jc < ld;
        cp_async16(dc + r * CROW + ch * 16,
                   cache + (in ? (size_t)i * ld + jc : 0), in);
      }
    }
  };

  // prologue: Q and tile 0 in flight, then q * scale * log2(e) rounded to
  // bf16 in place (each thread rescales the chunks it copied itself)
  for (int e = tid; e < TC_BQ * CHUNKS; e += TC_THREADS) {
    const int r = e / CHUNKS, ch = e % CHUNKS, i = q0 + r;
    cp_async16(smem_u32(sQ) + Tile::offset(r, ch, TC_BQ),
               q + (size_t)(i < N ? i : 0) * D + ch * 8, i < N);
  }
  load_tile(0, 0);
  cp_async_commit();
  float qp[2][6];
  if constexpr (kCoords) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = q0 + row0 + 8 * rr;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        qp[rr][c] = i < N ? src[(size_t)i * 3 + c] : 0.f;
        qp[rr][3 + c] = i < N ? tgt[(size_t)i * 3 + c] : 0.f;
      }
    }
  }
  cp_async_wait_all();
  for (int e = tid; e < TC_BQ * CHUNKS; e += TC_THREADS) {
    uint4* p = reinterpret_cast<uint4*>(
        sQ + Tile::offset(e / CHUNKS, e % CHUNKS, TC_BQ));
    uint4 x = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 f = __bfloat1622float2(h[c]);
      h[c] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
    }
    *p = x;
  }
  fence_proxy_async();

  float o[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  // running max and sum of rows row0 and row0 + 8
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(sQ) + wg * 64 * RB;
  const int tiles = (N + KEYS - 1) / KEYS;

  for (int t = 0; t < tiles; ++t) {
    const int stage = t % TC_STAGES;
    const int k0 = t * KEYS;
    if (t > 0) {
      cp_async_wait_all();
      fence_proxy_async();
    }
    __syncthreads();
    if (t + 1 < tiles) {
      load_tile(t + 1, (t + 1) % TC_STAGES);
      cp_async_commit();
    }

    // S = Qs K^T, this warpgroup's 64 rows x KEYS keys
    float s[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
    const uint32_t k_addr = smem_u32(sK + stage * KV_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t blk = ks * 32 / RB, col = ks * 32 % RB;
      wgmma_ss(s, Tile::desc(q_addr + blk * TC_BQ * RB + col, 16, 8 * RB),
               Tile::desc(k_addr + blk * KEYS * RB + col, 16, 8 * RB));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // compat and the key state on the fragment: masked keys -1e9 after
    // the multiply, keys past N -inf (weight 0)
    const float* key = sKey + stage * KEYS * KEY_FIELDS;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jg = 0; jg < NS; ++jg) {
      const int c0 = jg * 8 + 2 * quad;
      float cc[2][2];
      if constexpr (MODE == Compat::kCached) {
        const uint8_t* tile = sC + stage * TC_BQ * CROW;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          load2(reinterpret_cast<const CT*>(tile + (row0 + 8 * rr) * CROW) +
                    c0,
                cc[rr]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* kp = key + (c0 + e) * KEY_FIELDS;
        const bool past = k0 + c0 + e >= N;
        const bool masked = !(kp[6] > 0.f);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float compat;
          if constexpr (MODE == Compat::kStream) {
            compat = compat_stream(qp[rr], kp, sigma_arg);
          } else if constexpr (MODE == Compat::kBuild) {
            // pad columns (past N) hold code 0
            cc[rr][e] = past ? 0.f : compat_i8_code(qp[rr], kp, sigma_arg);
            compat = dequant_i8(cc[rr][e]);
          } else if constexpr (MODE == Compat::kCached) {
            compat = cc[rr][e];
          } else {
            compat = compat_variant<MODE>(qp[rr], kp, sigma_arg);
          }
          float logit = compat * s[jg * 4 + rr * 2 + e];
          if (masked) logit = MASKED;
          if (past) logit = -INFINITY;
          s[jg * 4 + rr * 2 + e] = logit;
          mt[rr] = fmaxf(mt[rr], logit);
        }
      }
      if constexpr (MODE == Compat::kBuild) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<char2*>(sC + (row0 + 8 * rr) * CROW + c0) =
              make_char2((signed char)(int)cc[rr][0],
                         (signed char)(int)cc[rr][1]);
      }
    }
    if constexpr (MODE == Compat::kBuild) {
      // this warp's 16 rows of codes, 16 bytes a lane: every (i, j < ld)
      // of the pair is written once, by the block that owns row i
      __syncwarp();
      for (int e = lane; e < 16 * (KEYS / 16); e += 32) {
        const int r = warp * 16 + e / (KEYS / 16);
        const int j = k0 + (e % (KEYS / 16)) * 16;
        const int i = q0 + r;
        if (i < N && j < ld)
          *reinterpret_cast<uint4*>(cache + (size_t)i * ld + j) =
              *reinterpret_cast<const uint4*>(sC + r * CROW + (j - k0));
      }
    }

    // online base-2 softmax: the tile's sum of the unrounded p of a row,
    // over its 4 lanes, joins the running sum once per tile
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
      const float m_next = fmaxf(m_run[rr], mt[rr]);
      const float alpha =
          m_run[rr] == -INFINITY ? 0.f : exp2f(m_run[rr] - m_next);
      m_run[rr] = m_next;
      float psum = 0.f;
#pragma unroll
      for (int jg = 0; jg < NS; ++jg)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[jg * 4 + rr * 2 + e] - m_next);
          psum += p;
          s[jg * 4 + rr * 2 + e] = p;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run[rr] = alpha * l_run[rr] + psum;
#pragma unroll
      for (int jg = 0; jg < NO; ++jg) {
        o[jg * 4 + rr * 2] *= alpha;
        o[jg * 4 + rr * 2 + 1] *= alpha;
      }
    }

    // O += P V: p rounded to bf16 into the A fragments of KEYS / 16
    // k-steps (the accumulator's column groups 2 kk and 2 kk + 1)
    uint32_t pa[KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    const uint32_t v_addr = smem_u32(sV + stage * KV_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
      wgmma_rs(o, pa[kk],
               Tile::desc(v_addr + kk * 16 * RB, KEYS * RB, 8 * RB));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = fmaxf(l_run[rr], 1e-30f);
    const int i = q0 + row0 + 8 * rr;
    if (i >= N) continue;
    // base-2 log-sum-exp of the row, as the TPU kernel stores it
    if (lse != nullptr && quad == 0) lse[i] = m_run[rr] + log2f(l);
#pragma unroll
    for (int jg = 0; jg < NO; ++jg)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)i * D + jg * 8 +
                                         2 * quad) =
          __floats2bfloat162_rn(o[jg * 4 + rr * 2] / l,
                                o[jg * 4 + rr * 2 + 1] / l);
  }
}

// ---- the f32 instances: a three-term bf16 split on the tensor cores ------
//
// f32 q, k, v keep f32 accuracy on the bf16 tensor cores: on its way into
// shared memory (and, for p, in registers) x becomes hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), both subtractions exact in f32,
// and each product is the six terms lo.hi + hi.lo + mid.mid + mid.hi +
// hi.mid + hi.hi, summed smallest first in an f32 accumulator: some 2^-24
// of the operands' scale, as f32 itself (the terms dropped, mid.lo, lo.mid
// and lo.lo, are below 2^-24). The tensor cores' f32 accumulation
// truncates, so a sum over many slots goes into a zeroed tile sum per slot
// and is added with rounded f32 adds (mma_rs). Plain TF32 keeps 10 bits
// and misses the 1e-5 limit the f32 path is held to. The cached backward
// (compat_flash_bwd_tc.cuh) shares this machinery.
//
// A block is two warpgroups: warpgroup 1 produces, warpgroup 0 consumes.
// The producer loads each tile with 16-byte loads into registers, splits
// it and stores the terms swizzled into a ring of BT_STAGES slots; rows
// past N are stored as zeros, so the last tile of a pair never reads the
// next pair. Named barriers hand a slot from producer to consumer (FULL)
// and back (EMPTY).
//
// compat_flash_fwd_split, one block per (64-query tile, pair): the terms
// of qs stay resident, 32-key tiles of k and v (and the cache tile, the
// key data) stream through two slots. Per tile S = qs k^T (six products,
// m64n32k16, both operands in shared memory) is issued and the tile's
// compat formed while it runs; masks and the online softmax on S's
// fragment in registers as in the bf16 kernel, then p split
// into three A fragments and O += P V (six products, v read MN-major) into
// a zeroed tile sum that is added to the rescaled O. No atomics: two
// launches give the same bits. kBuild and kCached run this one template,
// so the f32 build+attend output equals the cached kernel's on the cache it
// wrote in every bit. The f32 output is not the plain version's in every
// bit (another summation order, the split): within 1e-5, as f32's own
// error.
//
// The forward's producer issues every load of a tile (k, v, the cache
// tile, the key data) into registers before it waits for the slot, then
// splits and stores: on an H100 at 16 x 1000 x 128 that took the f32
// cache's instance from 0.20 to 0.16 ms (0.050 ms bound); forming compat
// while S runs changed less than 2%.
//
// Shared memory at D = 128: 48 KB of resident q terms, two slots of 2 x 24
// KB of k and v terms plus the cache tile and key data (49-59 KB each):
// 147-169 KB, one block per SM. At the training shape (16 x 1000) the 64-
// query blocks give 256 blocks on 132 SMs; a second consumer warpgroup
// (128 queries a block) would leave 128 blocks and too few registers for
// two 64 x D accumulators, a tile sum and the fragments each (one
// consumer holds 218-240 registers, no spills).

constexpr int BT_ROWS = 64;    // resident rows per block: wgmma's M
constexpr int BT_STREAM = 32;  // rows of a streamed tile (one ring slot)
constexpr int BT_STAGES = 2;   // ring slots
constexpr int BT_THREADS = 256;  // warpgroup 0 consumes, 1 produces
constexpr int BT_WG = 128;
// named barriers (0 is __syncthreads): slot s is FULL at 1 + s, EMPTY at
// 1 + BT_STAGES + s
constexpr int BAR_FULL = 1, BAR_EMPTY = 1 + BT_STAGES;

// bf16 terms an operand of type T is split into
template <typename T>
__host__ __device__ constexpr int bt_terms() {
  return std::is_same<T, float>::value ? 3 : 1;
}

// the six products of a split operand pair in the order they are summed,
// smallest first: (a term, b term) = lo.hi, hi.lo, mid.mid, mid.hi,
// hi.mid, hi.hi (0 hi, 1 mid, 2 lo); one term: hi.hi alone
__host__ __device__ constexpr int term_a(int p) {
  return p == 0 ? 2 : p == 2 || p == 3 ? 1 : 0;
}
__host__ __device__ constexpr int term_b(int p) {
  return p == 1 ? 2 : p == 2 || p == 4 ? 1 : 0;
}
template <int TERMS>
__host__ __device__ constexpr int first_product() {
  return TERMS == 3 ? 0 : 5;
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(BT_THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(BT_THREADS)
               : "memory");
}

// d += A B: A 64 x 16 (shared, K-major), B 16 x 32 (shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// x -> TERMS bf16 values packed in pairs: hi, then the rounded remainders
template <int TERMS>
__device__ __forceinline__ void split2(float x0, float x1,
                                       uint32_t (&w)[TERMS]) {
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    w[t] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    x0 -= f.x;  // exact: x0 - bf16(x0) has at most 16 significant bits
    x1 -= f.y;
  }
}

__device__ __forceinline__ void widen8(const float4 (&raw)[2],
                                       float (&x)[8]) {
  x[0] = raw[0].x; x[1] = raw[0].y; x[2] = raw[0].z; x[3] = raw[0].w;
  x[4] = raw[1].x; x[5] = raw[1].y; x[6] = raw[1].z; x[7] = raw[1].w;
}

// 8 consecutive elements (one 16-byte chunk of the bf16 tile) of row i <
// N, zeros past N
template <typename T>
__device__ __forceinline__ void fetch8(const T* row, bool in,
                                       float4 (&raw)[2]) {
  if constexpr (std::is_same<T, float>::value) {
    raw[0] = in ? reinterpret_cast<const float4*>(row)[0]
                : make_float4(0.f, 0.f, 0.f, 0.f);
    raw[1] = in ? reinterpret_cast<const float4*>(row)[1]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    const uint4 u = in ? *reinterpret_cast<const uint4*>(row)
                       : make_uint4(0u, 0u, 0u, 0u);
    raw[0] = make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    raw[1] = make_float4(__uint_as_float(u.z << 16),
                         __uint_as_float(u.z & 0xffff0000u),
                         __uint_as_float(u.w << 16),
                         __uint_as_float(u.w & 0xffff0000u));
  }
}

// Rows [r0, r0 + ROWS) of a [N, D] tensor of T on their way into shared
// memory, NT threads (thread `tid`) sharing the work: fetch() loads this
// thread's 16-byte chunks of them into registers (rows past N as zeros),
// store() writes them swizzled:
//   split:  their bt_terms<T>() terms, tile t at split + t * ROWS * D * 2,
//           of x, or of x * mul rounded in f32 when kScaleSplit;
//   scaled: bf16(x * mul), one tile (the bf16 backward's qs).
// Either may be null. Tiles are TcTile<D>-swizzled, 1024-byte aligned.
template <typename T, int D, int ROWS, int NT>
struct RowChunks {
  static constexpr int CHUNKS = D / 8;  // 16-byte bf16 chunks of a row
  static constexpr int ITERS = ROWS * CHUNKS / NT;
  static_assert(ROWS * CHUNKS % NT == 0, "tile not a multiple of threads");
  float4 raw[ITERS][2];

  __device__ __forceinline__ void fetch(const T* src, int r0, int N,
                                        int tid) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int e = tid + it * NT, r = e / CHUNKS, ch = e % CHUNKS;
      const int i = r0 + r;
      fetch8(src + (size_t)(i < N ? i : 0) * D + ch * 8, i < N, raw[it]);
    }
  }

  template <bool kScaleSplit = false>
  __device__ __forceinline__ void store(uint8_t* split, uint8_t* scaled,
                                        int tid, float mul) const {
    using Tile = TcTile<D>;
    constexpr int TERMS = bt_terms<T>();
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int e = tid + it * NT;
      const uint32_t off = Tile::offset(e / CHUNKS, e % CHUNKS, ROWS);
      float x[8];
      widen8(raw[it], x);
      if (split != nullptr) {
        float y[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) y[c] = kScaleSplit ? x[c] * mul : x[c];
        uint32_t w[4][TERMS];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          split2<TERMS>(y[2 * c], y[2 * c + 1], w[c]);
#pragma unroll
        for (int t = 0; t < TERMS; ++t)
          *reinterpret_cast<uint4*>(split + t * ROWS * D * 2 + off) =
              make_uint4(w[0][t], w[1][t], w[2][t], w[3][t]);
      }
      if (scaled != nullptr)
        *reinterpret_cast<uint4*>(scaled + off) =
            make_uint4(pack_bf16(x[0] * mul, x[1] * mul),
                       pack_bf16(x[2] * mul, x[3] * mul),
                       pack_bf16(x[4] * mul, x[5] * mul),
                       pack_bf16(x[6] * mul, x[7] * mul));
    }
  }
};

// RowChunks' fetch, then its store
template <typename T, int D, int ROWS, int NT, bool kScaleSplit = false>
__device__ __forceinline__ void load_tile(uint8_t* split, uint8_t* scaled,
                                          const T* src, int r0, int N,
                                          int tid, float mul) {
  RowChunks<T, D, ROWS, NT> rows;
  rows.fetch(src, r0, N, tid);
  rows.template store<kScaleSplit>(split, scaled, tid, mul);
}

// A cache tile on its way into shared memory, a producer warpgroup's
// threads sharing the work: rows [r0, r0 + ROWS) (queries), columns [c0,
// c0 + COLS) (keys) of this pair's [N, ld] cache, entries past row N or
// column ld as zeros; fetch() loads this thread's 16-byte chunks (ld
// keeps every row 16-byte aligned, so a chunk never straddles a row),
// store() writes them into rows of `crow` bytes.
template <typename CT, int ROWS, int COLS>
struct CacheChunks {
  static constexpr int EPC = 16 / (int)sizeof(CT);  // entries per chunk
  static constexpr int CPR = COLS / EPC;            // chunks per tile row
  static constexpr int ITERS = ROWS * CPR / BT_WG;
  static_assert(ROWS * CPR % BT_WG == 0, "tile not a multiple of threads");
  uint4 raw[ITERS];

  __device__ __forceinline__ void fetch(const CT* cache, int r0, int c0,
                                        int N, int ld, int tid) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int e = tid + it * BT_WG, i = r0 + e / CPR;
      const int jc = c0 + (e % CPR) * EPC;
      raw[it] = i < N && jc < ld
                    ? *reinterpret_cast<const uint4*>(cache +
                                                      (size_t)i * ld + jc)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(uint8_t* dst, int crow,
                                        int tid) const {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int e = tid + it * BT_WG;
      *reinterpret_cast<uint4*>(dst + (e / CPR) * crow + (e % CPR) * 16) =
          raw[it];
    }
  }
};

// CacheChunks' fetch, then its store
template <typename CT, int ROWS, int COLS>
__device__ __forceinline__ void load_cache_tile(uint8_t* dst, const CT* cache,
                                                int r0, int c0, int N, int ld,
                                                int crow, int tid) {
  CacheChunks<CT, ROWS, COLS> chunks;
  chunks.fetch(cache, r0, c0, N, ld, tid);
  chunks.store(dst, crow, tid);
}

// acc (64 x BROWS) += A B^T over depth D, both operands split into TERMS
// tiles in shared memory, K-major: A of 64 rows at a, B of BROWS rows at b
template <int TERMS, int D, int BROWS, int R>
__device__ __forceinline__ void mma_ss(float (&acc)[R], uint32_t a,
                                       uint32_t b) {
  using Tile = TcTile<D>;
  constexpr int RB = Tile::RB;
#pragma unroll
  for (int p = first_product<TERMS>(); p < 6; ++p)
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t blk = ks * 32 / RB, col = ks * 32 % RB;
      wgmma_ss(acc,
               Tile::desc(a + term_a(p) * BT_ROWS * D * 2 +
                              blk * BT_ROWS * RB + col,
                          16, 8 * RB),
               Tile::desc(b + term_b(p) * BROWS * D * 2 + blk * BROWS * RB +
                              col,
                          16, 8 * RB));
    }
}

// d += A B: the products of mma_rs, issued and waited for
template <int TERMS, int D, int KROWS>
__device__ __forceinline__ void issue_rs(
    float (&d)[D / 2], const uint32_t (&a)[TERMS][KROWS / 16][4],
    uint32_t b) {
  using Tile = TcTile<D>;
  constexpr int RB = Tile::RB;
  wgmma_fence();
#pragma unroll
  for (int p = first_product<TERMS>(); p < 6; ++p)
#pragma unroll
    for (int kk = 0; kk < KROWS / 16; ++kk)
      wgmma_rs(d, a[term_a(p)][kk],
               Tile::desc(b + term_b(p) * KROWS * D * 2 + kk * 16 * RB,
                          KROWS * RB, 8 * RB));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

// acc (64 x D) += A B over depth KROWS: A in registers (TERMS split
// fragments of KROWS / 16 k-steps), B the KROWS x D tile split into TERMS
// tiles at b, read MN-major. One term: straight into acc. Three terms:
// into a zeroed tile sum, added to acc with rounded f32 adds. The tensor
// cores' f32 accumulation truncates; into acc itself, every slot's steps
// would each cost up to an ulp of the whole sum (on an H100, 7.4e-6 of
// the largest entry at N = 1000 against the plain version, whose limit is
// 1e-5; 1.5-2.3e-6 with the tile sums), into the tile's own sum they cost
// an ulp of that.
template <int TERMS, int D, int KROWS>
__device__ __forceinline__ void mma_rs(
    float (&acc)[D / 2], const uint32_t (&a)[TERMS][KROWS / 16][4],
    uint32_t b) {
  if constexpr (TERMS == 1) {
    issue_rs<TERMS, D, KROWS>(acc, a, b);
  } else {
    float part[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) part[i] = 0.f;
    issue_rs<TERMS, D, KROWS>(part, a, b);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
  }
}

// an m64nK accumulator's columns as the A fragments of K / 16 k-steps
// (column groups 2 kk and 2 kk + 1), split into TERMS bf16 terms
template <int TERMS, int K>
__device__ __forceinline__ void to_frags(const float (&x)[K / 2],
                                         uint32_t (&a)[TERMS][K / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t w[TERMS];
      split2<TERMS>(x[8 * kk + 2 * c], x[8 * kk + 2 * c + 1], w);
#pragma unroll
      for (int t = 0; t < TERMS; ++t) a[t][kk][c] = w[t];
    }
}

// an accumulator (64 x D, this thread's rows r and r + 8) to rows < N of
// out, two neighbouring columns a store
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[D / 2],
                                           int row, int N, int quad) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row + 8 * rr >= N) continue;
#pragma unroll
    for (int jg = 0; jg < D / 8; ++jg)
      *reinterpret_cast<float2*>(out + (size_t)(row + 8 * rr) * D + jg * 8 +
                                 2 * quad) =
          make_float2(acc[jg * 4 + rr * 2], acc[jg * 4 + rr * 2 + 1]);
  }
}
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2], int row,
                                           int N, int quad) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row + 8 * rr >= N) continue;
#pragma unroll
    for (int jg = 0; jg < D / 8; ++jg)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8 * rr) * D +
                                         jg * 8 + 2 * quad) =
          __floats2bfloat162_rn(acc[jg * 4 + rr * 2],
                                acc[jg * 4 + rr * 2 + 1]);
  }
}

// key state of key j: 1 valid, 0 masked (logit -1e9), -1 past N (weight 0)
__device__ __forceinline__ float key_state(const float* mask, int j, int N) {
  return j >= N ? -1.f : (mask[j] > 0.f ? 1.f : 0.f);
}


// Shared-memory layout of the f32 forward: the three terms of the 64
// resident query rows, then BT_STAGES slots, each the three terms of the
// k and of the v rows of a streamed 32-key tile, the cache tile (kCached:
// 64 query rows of BT_STREAM entries, a row padded as the bf16 kernel
// pads it) and KEY_FIELDS floats a key (s.xyz, t.xyz, the key state);
// after the ring, kBuild's codes on their way to the cache (64 rows of
// BT_STREAM bytes, padded to 48).
template <int D, Compat MODE, typename CT>
struct SplitLayout {
  static constexpr int RES = 3 * BT_ROWS * D * 2;
  static constexpr int STR = 3 * BT_STREAM * D * 2;
  static constexpr int CROW =
      BT_STREAM * (int)sizeof(CT) + (sizeof(CT) == 4 ? 32 : 16);
  static constexpr int CODE_ROW = BT_STREAM + 16;
  static constexpr int CACHE_OFF = 2 * STR;
  static constexpr int SIDE_OFF =
      CACHE_OFF + (MODE == Compat::kCached ? BT_ROWS * CROW : 0);
  static constexpr int SLOT =
      (SIDE_OFF + BT_STREAM * KEY_FIELDS * 4 + 1023) / 1024 * 1024;
  static constexpr size_t BYTES =
      1024 /* alignment */ + RES + BT_STAGES * SLOT +
      (MODE == Compat::kBuild ? BT_ROWS * CODE_ROW : 0);
};

// The f32 attention: arguments as compat_flash_fwd_tc's, of f32.
template <int D, Compat MODE, typename CT>
__global__ void __launch_bounds__(BT_THREADS, 1)
compat_flash_fwd_split(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ src,
                       const float* __restrict__ tgt,
                       const float* __restrict__ mask,
                       float* __restrict__ out, float* __restrict__ lse,
                       CT* __restrict__ cache, int N, int ld,
                       float sigma_arg, float qscale) {
  using L = SplitLayout<D, MODE, CT>;
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr bool kCoords = MODE != Compat::kCached && MODE != Compat::kNone;
  constexpr bool kCache = MODE == Compat::kBuild || MODE == Compat::kCached;
  constexpr int NS = BT_STREAM / 8;  // 8-column groups of S
  constexpr int NO = D / 8;          // of O
  extern __shared__ __align__(16) uint8_t sp_smem[];
  uint8_t* sQ = sp_smem + ((1024u - (smem_u32(sp_smem) & 1023u)) & 1023u);
  uint8_t* ring = sQ + L::RES;
  uint8_t* sCodes = ring + BT_STAGES * L::SLOT;  // kBuild

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT_ROWS;
  const size_t base = (size_t)blockIdx.y * N;
  q += base * D;
  k += base * D;
  v += base * D;
  out += base * D;
  mask += base;
  if (lse != nullptr) lse += base;
  if constexpr (kCoords) {
    src += base * 3;
    tgt += base * 3;
  }
  if constexpr (kCache) cache += base * ld;

  // resident: the terms of qs = q * scale * log2(e), rounded in f32 before
  // the split, as the plain version rounds it
  load_tile<float, D, BT_ROWS, BT_THREADS, true>(sQ, nullptr, q, q0, N, tid,
                                                 qscale);
  fence_proxy_async();
  __syncthreads();
  const int tiles = (N + BT_STREAM - 1) / BT_STREAM;

  if (tid >= BT_WG) {  // producer: the key tiles
    const int ptid = tid - BT_WG;
    constexpr int COORD_ITERS = (BT_STREAM * 6 + BT_WG - 1) / BT_WG;
    for (int t = 0; t < tiles; ++t) {
      const int s = t % BT_STAGES, k0 = t * BT_STREAM;
      // every load of the tile in flight before the slot is free
      RowChunks<float, D, BT_STREAM, BT_WG> kc, vc;
      kc.fetch(k, k0, N, ptid);
      vc.fetch(v, k0, N, ptid);
      CacheChunks<CT, BT_ROWS, BT_STREAM> cc;
      if constexpr (MODE == Compat::kCached)
        cc.fetch(cache, q0, k0, N, ld, ptid);
      const float state = ptid < BT_STREAM ? key_state(mask, k0 + ptid, N)
                                           : 0.f;
      float coord[COORD_ITERS];
      if constexpr (kCoords) {
#pragma unroll
        for (int it = 0; it < COORD_ITERS; ++it) {
          const int e = ptid + it * BT_WG, r = e / 6, c = e % 6;
          const int j = k0 + r;
          coord[it] = e >= BT_STREAM * 6 || j >= N ? 0.f
                      : c < 3 ? src[(size_t)j * 3 + c]
                              : tgt[(size_t)j * 3 + c - 3];
        }
      }
      if (t >= BT_STAGES) bar_sync(BAR_EMPTY + s);
      uint8_t* slot = ring + s * L::SLOT;
      kc.store(slot, nullptr, ptid, 0.f);
      vc.store(slot + L::STR, nullptr, ptid, 0.f);
      if constexpr (MODE == Compat::kCached)
        cc.store(slot + L::CACHE_OFF, L::CROW, ptid);
      float* key = reinterpret_cast<float*>(slot + L::SIDE_OFF);
      if (ptid < BT_STREAM) key[ptid * KEY_FIELDS + 6] = state;
      if constexpr (kCoords) {
#pragma unroll
        for (int it = 0; it < COORD_ITERS; ++it) {
          const int e = ptid + it * BT_WG;
          if (e < BT_STREAM * 6)
            key[(e / 6) * KEY_FIELDS + e % 6] = coord[it];
        }
      }
      fence_proxy_async();
      bar_arrive(BAR_FULL + s);
    }
    return;
  }

  // consumer: this warpgroup's 64 queries are wgmma's rows; a thread
  // holds rows row0 and row0 + 8 and two neighbouring columns of every 8
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int row0 = warp * 16 + lane / 4;
  float qp[2][6];
  if constexpr (kCoords) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = q0 + row0 + 8 * rr;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        qp[rr][c] = i < N ? src[(size_t)i * 3 + c] : 0.f;
        qp[rr][3 + c] = i < N ? tgt[(size_t)i * 3 + c] : 0.f;
      }
    }
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max and sum of rows row0 and row0 + 8
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(sQ);

  for (int t = 0; t < tiles; ++t) {
    const int s = t % BT_STAGES, k0 = t * BT_STREAM;
    uint8_t* slot = ring + s * L::SLOT;
    const uint32_t k_addr = smem_u32(slot);
    bar_sync(BAR_FULL + s);

    // S = qs k^T: six term products, 64 queries x BT_STREAM keys, in
    // flight while the compat of the tile is formed
    float st[BT_STREAM / 2];
#pragma unroll
    for (int i = 0; i < BT_STREAM / 2; ++i) st[i] = 0.f;
    wgmma_fence();
    mma_ss<3, D, BT_STREAM>(st, q_addr, k_addr);
    wgmma_commit();

    // compat of rows row0 + 8 rr and keys c0 + e of every 8
    const float* key = reinterpret_cast<const float*>(slot + L::SIDE_OFF);
    float cc[NS][2][2];
#pragma unroll
    for (int jg = 0; jg < NS; ++jg) {
      const int c0 = jg * 8 + 2 * quad;
      if constexpr (MODE == Compat::kCached) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          load2(reinterpret_cast<const CT*>(slot + L::CACHE_OFF +
                                            (row0 + 8 * rr) * L::CROW) +
                    c0,
                cc[jg][rr]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* kp = key + (c0 + e) * KEY_FIELDS;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            if constexpr (MODE == Compat::kStream) {
              cc[jg][rr][e] = compat_stream(qp[rr], kp, sigma_arg);
            } else if constexpr (MODE == Compat::kBuild) {
              // pad columns (past N) hold code 0
              cc[jg][rr][e] =
                  kp[6] < 0.f ? 0.f : compat_i8_code(qp[rr], kp, sigma_arg);
            } else {
              cc[jg][rr][e] = compat_variant<MODE>(qp[rr], kp, sigma_arg);
            }
          }
        }
      }
      if constexpr (MODE == Compat::kBuild) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          *reinterpret_cast<char2*>(sCodes + (row0 + 8 * rr) * L::CODE_ROW +
                                    c0) =
              make_char2((signed char)(int)cc[jg][rr][0],
                         (signed char)(int)cc[jg][rr][1]);
          cc[jg][rr][0] = dequant_i8(cc[jg][rr][0]);
          cc[jg][rr][1] = dequant_i8(cc[jg][rr][1]);
        }
      }
    }
    if constexpr (MODE == Compat::kBuild) {
      // this warp's 16 rows of codes, 16 bytes a lane: every (i, j < ld)
      // of the pair is written once, by the block that owns row i
      __syncwarp();
      const int r = warp * 16 + lane / 2, j = k0 + (lane % 2) * 16;
      if (q0 + r < N && j < ld)
        *reinterpret_cast<uint4*>(cache + (size_t)(q0 + r) * ld + j) =
            *reinterpret_cast<const uint4*>(sCodes + r * L::CODE_ROW +
                                            (j - k0));
    }
    wgmma_wait_all();
    fence_regs(st);

    // the logits: masked keys -1e9 after the multiply, keys past N -inf
    // (weight 0)
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jg = 0; jg < NS; ++jg)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float state = key[(jg * 8 + 2 * quad + e) * KEY_FIELDS + 6];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float logit = cc[jg][rr][e] * st[jg * 4 + rr * 2 + e];
          if (state == 0.f) logit = MASKED;
          if (state < 0.f) logit = -INFINITY;
          st[jg * 4 + rr * 2 + e] = logit;
          mt[rr] = fmaxf(mt[rr], logit);
        }
      }

    // online base-2 softmax: the tile's sum of p of a row, over its 4
    // lanes, joins the running sum once per tile
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
      const float m_next = fmaxf(m_run[rr], mt[rr]);
      const float alpha =
          m_run[rr] == -INFINITY ? 0.f : exp2f(m_run[rr] - m_next);
      m_run[rr] = m_next;
      float psum = 0.f;
#pragma unroll
      for (int jg = 0; jg < NS; ++jg)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(st[jg * 4 + rr * 2 + e] - m_next);
          psum += p;
          st[jg * 4 + rr * 2 + e] = p;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run[rr] = alpha * l_run[rr] + psum;
#pragma unroll
      for (int jg = 0; jg < NO; ++jg) {
        o[jg * 4 + rr * 2] *= alpha;
        o[jg * 4 + rr * 2 + 1] *= alpha;
      }
    }

    // O += P V: p split into three terms in registers, the six products
    // into a zeroed tile sum, added to the rescaled O with rounded adds
    uint32_t pa[3][BT_STREAM / 16][4];
    to_frags<3, BT_STREAM>(st, pa);
    mma_rs<3, D, BT_STREAM>(o, pa, k_addr + L::STR);
    if (t + BT_STAGES < tiles) bar_arrive(BAR_EMPTY + s);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = fmaxf(l_run[rr], 1e-30f);
    const int i = q0 + row0 + 8 * rr;
    // base-2 log-sum-exp of the row, as the TPU kernel stores it
    if (lse != nullptr && quad == 0 && i < N) lse[i] = m_run[rr] + log2f(l);
#pragma unroll
    for (int jg = 0; jg < NO; ++jg) {
      o[jg * 4 + rr * 2] /= l;
      o[jg * 4 + rr * 2 + 1] /= l;
    }
  }
  store_rows<D>(out + (size_t)q0 * D, o, row0, N - q0, quad);
}

template <typename T, int D, Compat MODE, typename CT>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         const float* src, const float* tgt,
                         const float* mask, void* out, float* lse,
                         CT* cache, int B, int N, int ld, float sigma_arg,
                         float qscale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // cp.async moves 16-byte chunks of q, k, v and the cache
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)cache) & 15)
      return cudaErrorMisalignedAddress;
    const size_t bytes = tc_smem_bytes<D, MODE, CT>();
    cudaError_t err = cudaFuncSetAttribute(
        compat_flash_fwd_tc<D, MODE, CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + TC_BQ - 1) / TC_BQ, B);
    compat_flash_fwd_tc<D, MODE, CT><<<grid, TC_THREADS, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), src, tgt, mask,
        static_cast<__nv_bfloat16*>(out), lse, cache, N, ld, sigma_arg,
        qscale);
  } else {
    // 16-byte loads of q, k, v and the cache
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)cache) & 15)
      return cudaErrorMisalignedAddress;
    const size_t bytes = SplitLayout<D, MODE, CT>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        compat_flash_fwd_split<D, MODE, CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + BT_ROWS - 1) / BT_ROWS, B);
    compat_flash_fwd_split<D, MODE, CT><<<grid, BT_THREADS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), src, tgt, mask, static_cast<float*>(out),
        lse, cache, N, ld, sigma_arg, qscale);
  }
  return cudaGetLastError();
}

// q/k/v element type (f32 or bf16) and head width (32 or 128)
template <Compat MODE, typename CT>
cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                           const void* src, const void* tgt,
                           const void* mask, void* out, void* lse,
                           CT* cache, int B, int N, int D, int ld,
                           int is_bf16, float sigma_arg, float qscale,
                           void* stream) {
  const auto* s = static_cast<const float*>(src);
  const auto* t = static_cast<const float*>(tgt);
  const auto* m = static_cast<const float*>(mask);
  auto* l = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
#define GMF_FLASH_CASE(T, WIDTH)                                          \
  return launch_flash<T, WIDTH, MODE, CT>(q, k, v, s, t, m, out, l, cache, \
                                          B, N, ld, sigma_arg, qscale, st)
  if (D == 32) {
    if (is_bf16) GMF_FLASH_CASE(__nv_bfloat16, 32);
    GMF_FLASH_CASE(float, 32);
  }
  if (D == 128) {
    if (is_bf16) GMF_FLASH_CASE(__nv_bfloat16, 128);
    GMF_FLASH_CASE(float, 128);
  }
#undef GMF_FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
