// Standalone compat cache for Hopper, sm_90a.
//
// Replaces gmf_tpu/ops/fused_attention.py::_compat_pre_kernel (the
// pallas_call in _build_compat_cache_jit, fused_attention.py:625) and the
// cache precompute of scripts/bench_flash_variants.py:214: the [N, N]
// spatial-consistency matrix of a pair, computed once and shared by the
// attention layers,
//
//   f32, bf16:  c = max(1 - (sqrt(ds2) - sqrt(dt2))^2 / sigma^2, 0)
//   int8:       dd2  = max(ds2 + dt2 - 2 sqrt(ds2 dt2), 0)
//               code = round_half_even(254 max(1 - dd2 / sigma^2, 0) - 127)
//
// with ds2, dt2 the squared distances from per-coordinate differences. The
// two forms are kept apart as the TPU kernel keeps them: the one-sqrt
// identity is safe only beneath the int8 step. The arithmetic is the
// __device__ functions of compat_flash_core.cuh, explicitly rounded, so
// the int8 cache equals the build+attend kernel's and the plain version's
// in every byte.
//
// The cache is [B, N, ld] with 16-byte aligned rows; pad columns N..ld-1
// are written as 0.
//
// c(i, j) equals c(j, i) bit for bit: a - b is exactly -(b - a), and the
// squares and sums then run in the same order. So a block takes one
// unordered pair of TILE x TILE tiles (I, J), I <= J, of one pair of
// clouds (blockIdx.x is the triangular index J (J + 1) / 2 + I), computes
// that tile once and stores it at (I, J) and, when I < J, its transpose at
// (J, I): B N (N + TILE) / 2 entries instead of B N^2. The pad columns lie
// in the last column tile, which every row tile reaches through its tile
// (I, last); a transposed tile never holds any.
//
// A block of 128 threads owns one tile pair. Each thread computes two
// 4 x 4 micro-tiles: its 4 columns' keypoints stay in registers, each
// row's are read from shared memory (two 16-byte loads a row). It
// converts them to the cache type and stages them twice: their rows into
// the tile, their columns into the transposed tile (int8 and bf16 columns
// built from the row words by __byte_perm). Both tiles' rows are then
// written to the cache 16 bytes a thread, neighbouring threads on
// neighbouring chunks of a row, by streaming stores. Staged rows are
// unpadded; a 4-entry slot s of row r sits at s ^ swizzle(r), so that the
// staging stores and the 16-byte reads hit distinct banks (int8: two
// threads a bank on the staging stores, the least its 64-byte rows allow).
//
// Bound on this card: the cache written once (B N ld elements) and the
// keypoints read once; per unordered pair ~20 f32 ALU ops and 3 SFU ops
// (two-sqrt form) or ~26 and 2 (one-sqrt int8 code): f32 and bf16 by the
// bytes, int8 by the ALU. What the kernel issues is more: the IEEE sqrt
// and division each expand to a reciprocal (square root) estimate, a
// fix-up sequence and a branch to a slow path, ~53 instructions an entry
// in all (SASS), so at B=8, N=5000 the issue alone takes ~0.16 ms. Tile
// size (64 or 128), threads per block, micro-tiles per thread, a
// persistent grid and a rolled row loop were timed on the H100 against
// each other (PERF.md, section 6); this layout was the fastest.

#include "compat_flash_core.cuh"

namespace {

constexpr int TILE = 64;       // rows and columns of a tile
constexpr int THREADS = 128;   // 16 x 8 threads, 2 x (4 x 4) entries each

// The staged 4 entries of a micro-tile row or column: 16, 8 or 4 bytes.
template <typename CT>
using Slot = std::conditional_t<
    sizeof(CT) == 4, uint4, std::conditional_t<sizeof(CT) == 2, uint2,
                                               uint32_t>>;

// XOR swizzle of the slots of staged row r. A warp is 8 column groups x 4
// row groups (see the kernel); the row stores of a quarter-warp (f32),
// half-warp (bf16) or warp (int8) write 8 neighbouring slots in each of 1,
// 2 or 4 rows 4 apart, the column stores one slot in each of 8 rows 4
// apart. A multiple of the slots per 16-byte chunk, so chunks stay whole.
template <typename CT>
__device__ __forceinline__ int swizzle(int r) {
  const int q = (r >> 2) & 7;
  if constexpr (sizeof(CT) == 4) return q;
  else if constexpr (sizeof(CT) == 2) return ((q & 1) << 3) | (q & 6);
  else return (q & 3) << 2;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The two's-complement byte of an integral code in [-127, 127]: its low
// byte once 1.5 * 2^23 is added (exact; an add, not a conversion).
__device__ __forceinline__ uint32_t code_bits(float x) {
  return __float_as_uint(__fadd_rn(x, 12582912.f));
}

// one byte per code, code a lowest
__device__ __forceinline__ uint32_t i8x4(float a, float b, float c, float d) {
  return __byte_perm(__byte_perm(code_bits(a), code_bits(b), 0x0040),
                     __byte_perm(code_bits(c), code_bits(d), 0x0040), 0x5410);
}

// 4 neighbouring entries of a row as one slot of the cache type
template <typename CT>
__device__ __forceinline__ Slot<CT> pack_row(const float (&v)[4]) {
  if constexpr (sizeof(CT) == 4)
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  else if constexpr (sizeof(CT) == 2)
    return make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));
  else
    return i8x4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& s, int k) {
  return k == 0 ? s.x : k == 1 ? s.y : k == 2 ? s.z : s.w;
}

// The column slots (rows 0..3 of column k) of a micro-tile's 4 row slots.
__device__ __forceinline__ void transpose(const uint4 (&row)[4],
                                          uint4 (&col)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    col[k] = make_uint4(word(row[0], k), word(row[1], k), word(row[2], k),
                        word(row[3], k));
}

__device__ __forceinline__ void transpose(const uint2 (&row)[4],
                                          uint2 (&col)[4]) {
  // column 2h + e: rows 0, 1 from word h of rows 0, 1, rows 2, 3 likewise
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t r0 = h ? row[0].y : row[0].x, r1 = h ? row[1].y : row[1].x;
    const uint32_t r2 = h ? row[2].y : row[2].x, r3 = h ? row[3].y : row[3].x;
    col[2 * h] = make_uint2(__byte_perm(r0, r1, 0x5410),
                            __byte_perm(r2, r3, 0x5410));
    col[2 * h + 1] = make_uint2(__byte_perm(r0, r1, 0x7632),
                                __byte_perm(r2, r3, 0x7632));
  }
}

__device__ __forceinline__ void transpose(const uint32_t (&row)[4],
                                          uint32_t (&col)[4]) {
  // a 4 x 4 byte transpose
  const uint32_t t0 = __byte_perm(row[0], row[1], 0x5140);
  const uint32_t t1 = __byte_perm(row[0], row[1], 0x7362);
  const uint32_t t2 = __byte_perm(row[2], row[3], 0x5140);
  const uint32_t t3 = __byte_perm(row[2], row[3], 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

// Copy `rows` staged rows to the cache rows starting at `out`, `chunks`
// 16-byte chunks of each, by streaming stores (this kernel reads none of
// them back). A thread keeps one chunk column and steps down the rows.
template <typename CT>
__device__ __forceinline__ void store_tile(const uint8_t* staged, CT* out,
                                           int ld, int rows, int chunks) {
  constexpr int ROW_BYTES = TILE * (int)sizeof(CT);
  constexpr int CH = ROW_BYTES / 16;             // chunks per staged row
  constexpr int SPC = 4 / (int)sizeof(CT);       // slots per chunk
  constexpr int STEP = THREADS / CH;             // rows per pass
  const int k = threadIdx.x % CH, r0 = threadIdx.x / CH;
  if (k >= chunks) return;
  uint8_t* dst = reinterpret_cast<uint8_t*>(out + (size_t)r0 * ld) + 16 * k;
  const size_t dstep = (size_t)STEP * ld * sizeof(CT);
#pragma unroll
  for (int i = 0; i < TILE / STEP; ++i, dst += dstep) {
    const int r = r0 + i * STEP;
    if (r < rows)
      __stcs(reinterpret_cast<uint4*>(dst),
             *reinterpret_cast<const uint4*>(
                 staged + r * ROW_BYTES + 16 * (k ^ (swizzle<CT>(r) / SPC))));
  }
}

// The 4 row slots of a thread's micro-tile: rows 4 ty .. of the staged row
// keypoints against the 4 columns whose keypoints are in b. RAGGED: the
// tile reaches past N, whose rows and columns hold 0.
template <typename CT, bool RAGGED>
__device__ __forceinline__ void micro_tile(const float (*rows)[8],
                                           const float (&b)[4][6], int ty,
                                           int row_end, int col_end,
                                           float sigma_sq,
                                           Slot<CT> (&out)[4]) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const float4 p = *reinterpret_cast<const float4*>(rows[4 * ty + rr]);
    const float4 q = *reinterpret_cast<const float4*>(rows[4 * ty + rr] + 4);
    const float a[6] = {p.x, p.y, p.z, p.w, q.x, q.y};
    float v[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      v[cc] = sizeof(CT) == 1 ? compat_i8_code(a, b[cc], sigma_sq)
                              : compat_two_sqrt(a, b[cc], sigma_sq);
      if (RAGGED && (4 * ty + rr >= row_end || cc >= col_end)) v[cc] = 0.f;
    }
    out[rr] = pack_row<CT>(v);
  }
}

// Blocks an SM: 8 for bf16, 6 for f32 and int8 (the faster of 6 and 8 on
// the H100, within a few per cent).
template <typename CT>
__global__ void __launch_bounds__(THREADS, sizeof(CT) == 2 ? 8 : 6)
compat_cache_tile_pairs(const float* __restrict__ src,
                        const float* __restrict__ tgt,
                        CT* __restrict__ cache, int N, int ld,
                        float sigma_sq) {
  constexpr int ROW_BYTES = TILE * (int)sizeof(CT);
  constexpr int SLOT_BYTES = 4 * (int)sizeof(CT);
  // keypoints s.xyz, t.xyz: the row tile's by point, the column tile's by
  // coordinate; points past N are 0
  __shared__ __align__(16) float sRow[TILE][8];
  __shared__ __align__(16) float sCol[6][TILE];
  __shared__ __align__(16) uint8_t sTile[TILE * ROW_BYTES];
  __shared__ __align__(16) uint8_t sTrans[TILE * ROW_BYTES];

  // the tile pair: blockIdx.x = J (J + 1) / 2 + I, I <= J
  const int p = blockIdx.x;
  int J = (int)((sqrtf(8.f * (float)p + 1.f) - 1.f) * 0.5f);
  while (J * (J + 1) / 2 > p) --J;
  while ((J + 1) * (J + 2) / 2 <= p) ++J;
  const int I = p - J * (J + 1) / 2;
  const int i0 = I * TILE, j0 = J * TILE;

  const size_t base = (size_t)blockIdx.y * N;
  src += base * 3;
  tgt += base * 3;
  cache += base * ld;

  const int t = threadIdx.x;
  for (int e = t; e < TILE * 3; e += THREADS) {
    const int point = e / 3, c = e % 3;
    const bool row_in = i0 + point < N, col_in = j0 + point < N;
    const size_t ri = (size_t)i0 * 3 + e, ci = (size_t)j0 * 3 + e;
    sRow[point][c] = row_in ? src[ri] : 0.f;
    sRow[point][3 + c] = row_in ? tgt[ri] : 0.f;
    sCol[c][point] = col_in ? src[ci] : 0.f;
    sCol[3 + c][point] = col_in ? tgt[ci] : 0.f;
  }
  __syncthreads();

  // a warp is 8 column groups x 4 row groups; a thread takes row groups ty
  // and ty + 8
  const int lane = t & 31, warp = t >> 5;
  const int tx = (lane & 7) | ((warp & 1) << 3);   // columns 4 tx ..
  float b[4][6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float4 q = *reinterpret_cast<const float4*>(&sCol[c][4 * tx]);
    b[0][c] = q.x, b[1][c] = q.y, b[2][c] = q.z, b[3][c] = q.w;
  }
  const bool inside = i0 + TILE <= N && j0 + TILE <= N;
#pragma unroll 1
  for (int ty = (lane >> 3) | ((warp >> 1) << 2); ty < TILE / 4; ty += 8) {
    Slot<CT> row[4], col[4];
    if (inside)
      micro_tile<CT, false>(sRow, b, ty, 0, 0, sigma_sq, row);
    else
      micro_tile<CT, true>(sRow, b, ty, N - i0, N - j0 - 4 * tx, sigma_sq,
                           row);
    transpose(row, col);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 4 * ty + k, c = 4 * tx + k;
      *reinterpret_cast<Slot<CT>*>(sTile + r * ROW_BYTES +
                                   SLOT_BYTES * (tx ^ swizzle<CT>(r))) =
          row[k];
      *reinterpret_cast<Slot<CT>*>(sTrans + c * ROW_BYTES +
                                   SLOT_BYTES * (ty ^ swizzle<CT>(c))) =
          col[k];
    }
  }
  __syncthreads();

  // (I, J), its columns up to ld (the last column tile holds the pads)
  store_tile<CT>(sTile, cache + (size_t)i0 * ld + j0, ld, min(TILE, N - i0),
                 min(TILE, ld - j0) * (int)sizeof(CT) / 16);
  // (J, I): I < J, so its TILE columns all lie before N
  if (I < J)
    store_tile<CT>(sTrans, cache + (size_t)j0 * ld + i0, ld,
                   min(TILE, N - j0), ROW_BYTES / 16);
}

template <typename CT>
cudaError_t launch_build(const float* src, const float* tgt, void* cache,
                         int B, int N, int ld, float sigma_sq,
                         cudaStream_t stream) {
  const long long tiles = (N + TILE - 1) / TILE;
  const long long pairs = tiles * (tiles + 1) / 2;
  if (pairs > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)pairs, B);
  compat_cache_tile_pairs<CT><<<grid, THREADS, 0, stream>>>(
      src, tgt, static_cast<CT*>(cache), N, ld, sigma_sq);
  return cudaGetLastError();
}

}  // namespace

// src, tgt: [B, N, 3] f32; cache: [B, N, ld] of cache_type (0 f32, 1 bf16,
// 2 int8), rows 16-byte aligned.
extern "C" int gmf_build_compat_cache(const void* src, const void* tgt,
                                      void* cache, int B, int N, int ld,
                                      int cache_type, float sigma_sq,
                                      void* stream) {
  if (B <= 0 || N <= 0 || ld < N || B > 65535)
    return cudaErrorInvalidValue;
  const auto* s = static_cast<const float*>(src);
  const auto* t = static_cast<const float*>(tgt);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (cache_type == CACHE_F32 && ld % 4 == 0)
    err = launch_build<float>(s, t, cache, B, N, ld, sigma_sq, st);
  else if (cache_type == CACHE_BF16 && ld % 8 == 0)
    err = launch_build<__nv_bfloat16>(s, t, cache, B, N, ld, sigma_sq, st);
  else if (cache_type == CACHE_INT8 && ld % 16 == 0)
    err = launch_build<int8_t>(s, t, cache, B, N, ld, sigma_sq, st);
  return static_cast<int>(err);
}
