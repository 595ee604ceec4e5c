// Seed kNN in feature space: exact top-K by inner product, sm_90a.
//
// Replaces gmf_tpu/ops/fused_topk.py::_kernel (the pallas_call in
// _seed_knn_topk_jit, fused_topk.py:108): for every seed row of a pair,
// the K <= 128 keys with the largest inner product seed.feat (f32
// accumulation), in the order jax.lax.top_k gives them:
//
//   - descending score; equal scores (compared with ==, so +0 ties -0)
//     break toward the smaller key index;
//   - masked keys score -inf and stay selectable, so a row with fewer than
//     K valid keys fills in ascending index order (fused_topk.py:17-21);
//   - keys past N are absent; an index that finds no key is clamped to
//     N-1 (:88-90; the wrapper refuses K > N, so none does).
//
// Precision per instance, as the reference's (fused_topk.py:52-58):
//   bf16  the products on the tensor cores (wgmma m64n64k16, f32
//         accumulation): a bf16 x bf16 product is exact in f32;
//   f32   full f32 FMAs on the CUDA cores (never TF32), register micro-tiles
//         fed from shared memory.
//
// One block serves the 64 (bf16: one warpgroup, wgmma's M) or 32 (f32: two
// warps, so that B=8 already fills the card) seeds of one pair and streams
// the pair's keys in tiles of 64 rows through a two-slot ring in shared
// memory (cp.async, zero-filled past N, so the last tile never reads the
// next pair): each key row is read once per block of seeds. The score
// tile stays in registers in wgmma's accumulator layout (a thread holds
// rows r and r + 8 of its warp's 16 and two neighbouring columns of every
// 8, so the four lanes of a quad hold a row); the f32 instance computes
// the same fragment.
//
// Selection by filtering (the WarpSelect idea of Johnson, Douze and
// Jegou, "Billion-scale similarity search with GPUs", 2017): each seed
// keeps its running top-K in registers, spread over its quad (entry p in
// lane p % 4), padded with (-inf, BIG + p), together with its worst
// entry. A score enters the row's candidate buffer in shared memory only
// if it beats that worst entry, (value, index) compared
// lexicographically; after each tile the quads of all rows at once take
// their candidates in turn, each replacing the worst entry if it still
// beats it, the new worst found by the quad (its lanes' registers, then
// two shuffles). After the first tiles few scores pass, so the work is
// one compare per score plus a few replacements. At the end each entry's
// place is the number of the row's entries that beat it (all are
// distinct, so the places are).
//
// Bound on this card: bf16, the products (2 S N C flop per pair) on the
// tensor cores or the bytes, both ~0.04 ms at 64 x 500 x 5000 x 128; f32,
// the products as f32 FMAs (0.61 ms there). The selection's compares are
// one per score.

#include "compat_flash_core.cuh"

namespace {

constexpr int KNN_KEYS = 64;          // keys per tile
constexpr int KNN_C = 128;            // feature depth (the wrapper pads to it)
constexpr int KNN_BIG = 1 << 30;      // > any key index: the list's pads
constexpr int F32_LD = KNN_C + 4;     // f32 tile row in floats: conflict-free
constexpr int KNN_NS = KNN_KEYS / 8;  // 8-column groups of a score tile
constexpr int CAND_LD = KNN_KEYS + 1;  // candidate row: 8 quads, 8 banks
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <bool BF16>
struct KnnLayout {
  using T = std::conditional_t<BF16, __nv_bfloat16, float>;
  static constexpr int WARPS = BF16 ? 4 : 2;   // warp w owns rows 16w..+15
  static constexpr int ROWS = 16 * WARPS;      // seeds per block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int CHUNKS = KNN_C / EPC;       // 16-byte chunks a row
  // bf16 tiles in wgmma's 128-byte-swizzled layout (1024-byte aligned);
  // f32 tiles row-major with rows of F32_LD floats
  static constexpr int ALIGN = BF16 ? 1024 : 16;
  static constexpr int A_BYTES = BF16 ? ROWS * KNN_C * 2 : ROWS * F32_LD * 4;
  static constexpr int B_BYTES = BF16 ? KNN_KEYS * KNN_C * 2
                                      : KNN_KEYS * F32_LD * 4;
  static constexpr size_t SMEM = ALIGN + A_BYTES + 2 * B_BYTES +
                                 2 * KNN_KEYS * sizeof(float) +
                                 (size_t)ROWS * CAND_LD * sizeof(float2);
  static __device__ __forceinline__ uint32_t offset(int r, int ch, int rows) {
    if constexpr (BF16) return TcTile<KNN_C>::offset(r, ch, rows);
    else return (r * F32_LD + ch * 4) * 4;
  }
};

// A row's running top-K, spread over its quad: entry p = 4 s + lane % 4 in
// slot s of that lane (QL slots a lane). Unused slots (p >= K) hold
// (+inf, -1), which beats everything, so they are never the worst.
template <int QL>
struct RowList {
  float v[QL];
  int i[QL];
  float wv;  // the worst entry and its place p, the same in the quad
  int wi, wp;

  __device__ __forceinline__ void init(int K, int quad, bool active) {
#pragma unroll
    for (int s = 0; s < QL; ++s) {
      const int p = 4 * s + quad;
      v[s] = p < K ? -INFINITY : INFINITY;
      i[s] = p < K ? KNN_BIG + p : -1;
    }
    // a row past S admits nothing: its worst beats every score
    wv = active ? -INFINITY : INFINITY;
    wi = active ? KNN_BIG + K - 1 : -1;
    wp = K - 1;
  }

  // put (cv, ci) in the worst entry's place (ins: it beats the worst) and
  // find the new worst, by a tournament over the lane's slots, then over
  // the quad; every lane of the warp calls it
  __device__ __forceinline__ void replace_worst(bool ins, float cv, int ci,
                                                int quad) {
    if (ins && (wp & 3) == quad) {
#pragma unroll
      for (int s = 0; s < QL; ++s)
        if (s == (wp >> 2)) {
          v[s] = cv;
          i[s] = ci;
        }
    }
    float tv[QL];
    int ti[QL], ts[QL];
#pragma unroll
    for (int s = 0; s < QL; ++s) {
      tv[s] = v[s];
      ti[s] = i[s];
      ts[s] = s;
    }
#pragma unroll
    for (int w = 1; w < QL; w *= 2)
#pragma unroll
      for (int s = 0; s + w < QL; s += 2 * w)
        if (better(tv[s], ti[s], tv[s + w], ti[s + w])) {
          tv[s] = tv[s + w];
          ti[s] = ti[s + w];
          ts[s] = ts[s + w];
        }
    float bv = tv[0];
    int bi = ti[0], bp = 4 * ts[0] + quad;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      const int op = __shfl_xor_sync(FULL, bp, off);
      if (better(bv, bi, ov, oi)) {
        bv = ov;
        bi = oi;
        bp = op;
      }
    }
    if (ins) {
      wv = bv;
      wi = bi;
      wp = bp;
    }
  }

  // write the K entries best first: an entry's place is the number of the
  // row's entries that beat it; every lane of the warp calls it
  __device__ __forceinline__ void store(int K, int quad, bool active, int N,
                                        int* idx_out, float* val_out) {
    int rank[QL];
#pragma unroll
    for (int s = 0; s < QL; ++s) rank[s] = 0;
#pragma unroll
    for (int src = 0; src < 4; ++src)
#pragma unroll
      for (int t = 0; t < QL; ++t) {
        const float ov = __shfl_sync(FULL, v[t], src, 4);
        const int oi = __shfl_sync(FULL, i[t], src, 4);
        if (4 * t + src >= K) continue;  // an unused slot
#pragma unroll
        for (int s = 0; s < QL; ++s) rank[s] += better(ov, oi, v[s], i[s]);
      }
    if (!active) return;
#pragma unroll
    for (int s = 0; s < QL; ++s)
      if (4 * s + quad < K) {
        idx_out[rank[s]] = min(i[s], N - 1);
        val_out[rank[s]] = v[s];
      }
  }
};

// seeds [B, S, KNN_C], feats [B, N, KNN_C] of T; mask [B, N] f32;
// idx [B, S, K] int32, val [B, S, K] f32; K <= Q. Grid (ceil(S / ROWS), B).
template <bool BF16, int Q>
__global__ void __launch_bounds__(KnnLayout<BF16>::THREADS)
seed_knn_topk_kernel(const typename KnnLayout<BF16>::T* __restrict__ seeds,
                     const typename KnnLayout<BF16>::T* __restrict__ feats,
                     const float* __restrict__ mask,
                     int* __restrict__ idx_out, float* __restrict__ val_out,
                     int S, int N, int K) {
  using L = KnnLayout<BF16>;
  constexpr int ROWS = L::ROWS, THREADS = L::THREADS;
  extern __shared__ __align__(16) uint8_t knn_smem[];
  uint8_t* sA = knn_smem + ((L::ALIGN - (smem_u32(knn_smem) & (L::ALIGN - 1))) &
                            (L::ALIGN - 1));
  uint8_t* sB = sA + L::A_BYTES;  // [2][B_BYTES] key ring
  float* sMask = reinterpret_cast<float*>(sB + 2 * L::B_BYTES);  // [2][64]
  float2* sCand = reinterpret_cast<float2*>(sMask + 2 * KNN_KEYS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int b = blockIdx.y, s0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, S - s0);
  const int row0 = warp * 16 + lane / 4;  // this thread's rows: row0, +8
  seeds += ((size_t)b * S + s0) * KNN_C;
  feats += (size_t)b * N * KNN_C;
  mask += (size_t)b * N;

  for (int e = tid; e < ROWS * L::CHUNKS; e += THREADS) {
    const int r = e / L::CHUNKS, ch = e % L::CHUNKS;
    cp_async16(smem_u32(sA) + L::offset(r, ch, ROWS),
               seeds + (size_t)(r < rows ? r : 0) * KNN_C + ch * L::EPC,
               r < rows);
  }
  auto load_tile = [&](int t, int slot) {
    const int k0 = t * KNN_KEYS;
    const uint32_t dst = smem_u32(sB + slot * L::B_BYTES);
    for (int e = tid; e < KNN_KEYS * L::CHUNKS; e += THREADS) {
      const int r = e / L::CHUNKS, ch = e % L::CHUNKS, j = k0 + r;
      cp_async16(dst + L::offset(r, ch, KNN_KEYS),
                 feats + (size_t)(j < N ? j : 0) * KNN_C + ch * L::EPC,
                 j < N);
    }
    for (int r = tid; r < KNN_KEYS; r += THREADS)
      cp_async4(smem_u32(sMask + slot * KNN_KEYS + r),
                mask + (k0 + r < N ? k0 + r : 0), k0 + r < N);
  };
  load_tile(0, 0);
  cp_async_commit();

  RowList<Q / 4> list[2];  // rows row0 and row0 + 8
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    list[rr].init(K, quad, row0 + 8 * rr < rows);

  const int tiles = (N + KNN_KEYS - 1) / KNN_KEYS;
  for (int t = 0; t < tiles; ++t) {
    const int slot = t & 1, k0 = t * KNN_KEYS;
    cp_async_wait_all();
    if constexpr (BF16) fence_proxy_async();
    // publishes tile t; every warp is done with the slot tile t + 1 fills
    // and with the candidates of tile t - 1
    __syncthreads();
    if (t + 1 < tiles) {
      load_tile(t + 1, slot ^ 1);
      cp_async_commit();
    }

    // scores of rows row0, row0 + 8 and columns 8 jg + 2 quad + e
    float s[KNN_NS * 4];
#pragma unroll
    for (int i = 0; i < KNN_NS * 4; ++i) s[i] = 0.f;
    if constexpr (BF16) {
      using Tile = TcTile<KNN_C>;
      const uint32_t a_addr = smem_u32(sA);
      const uint32_t b_addr = smem_u32(sB + slot * L::B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KNN_C / 16; ++ks) {
        const uint32_t blk = ks * 32 / Tile::RB, col = ks * 32 % Tile::RB;
        wgmma_ss(s,
                 Tile::desc(a_addr + blk * ROWS * Tile::RB + col, 16,
                            8 * Tile::RB),
                 Tile::desc(b_addr + blk * KNN_KEYS * Tile::RB + col, 16,
                            8 * Tile::RB));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
    } else {
      const float* a0 = reinterpret_cast<const float*>(sA) + row0 * F32_LD;
      const float* a1 = a0 + 8 * F32_LD;
      const float* kb = reinterpret_cast<const float*>(sB + slot * L::B_BYTES) +
                        2 * quad * F32_LD;
#pragma unroll 1
      for (int c = 0; c < KNN_C; c += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(a0 + c);
        const float4 x1 = *reinterpret_cast<const float4*>(a1 + c);
#pragma unroll
        for (int jg = 0; jg < KNN_NS; ++jg)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 y = *reinterpret_cast<const float4*>(
                kb + (jg * 8 + e) * F32_LD + c);
            float& d0 = s[jg * 4 + e];
            float& d1 = s[jg * 4 + 2 + e];
            d0 = fmaf(x0.x, y.x, d0);
            d0 = fmaf(x0.y, y.y, d0);
            d0 = fmaf(x0.z, y.z, d0);
            d0 = fmaf(x0.w, y.w, d0);
            d1 = fmaf(x1.x, y.x, d1);
            d1 = fmaf(x1.y, y.y, d1);
            d1 = fmaf(x1.z, y.z, d1);
            d1 = fmaf(x1.w, y.w, d1);
          }
      }
    }

    // masked keys -inf; keys past N NaN, which beats nothing and so never
    // enters a list
#pragma unroll
    for (int jg = 0; jg < KNN_NS; ++jg)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = k0 + jg * 8 + 2 * quad + e;
        const float m = sMask[slot * KNN_KEYS + jg * 8 + 2 * quad + e];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float& v = s[jg * 4 + rr * 2 + e];
          v = n >= N ? NAN : (m > 0.f ? v : -INFINITY);
        }
      }

    // the scores that beat their row's worst entry, into the row's buffer:
    // a bit per score, a prefix over the row's four lanes, then the writes
    int tot[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      unsigned bits = 0;
#pragma unroll
      for (int jg = 0; jg < KNN_NS; ++jg)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bits |= (unsigned)better(s[jg * 4 + rr * 2 + e],
                                   k0 + jg * 8 + 2 * quad + e, list[rr].wv,
                                   list[rr].wi)
                  << (2 * jg + e);
      const int c = __popc(bits);
      int x = c;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const int y = __shfl_up_sync(FULL, x, off, 4);
        if (quad >= off) x += y;
      }
      tot[rr] = __shfl_sync(FULL, x, 3, 4);
      float2* buf = sCand + (row0 + 8 * rr) * CAND_LD + x - c;
#pragma unroll
      for (int jg = 0; jg < KNN_NS; ++jg)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (bits >> (2 * jg + e) & 1u)
            buf[__popc(bits & ((1u << (2 * jg + e)) - 1))] = make_float2(
                s[jg * 4 + rr * 2 + e],
                __int_as_float(k0 + jg * 8 + 2 * quad + e));
    }
    __syncwarp();

    // every quad takes its rows' candidates in turn (each read one turn
    // ahead); a candidate that no longer beats the worst entry (replaced
    // meanwhile) is dropped
    const int turns = __reduce_max_sync(FULL, max(tot[0], tot[1]));
    const float2* cand[2] = {sCand + row0 * CAND_LD,
                             sCand + (row0 + 8) * CAND_LD};
    float2 next[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) next[rr] = cand[rr][0];
    for (int j = 0; j < turns; ++j) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float2 c = next[rr];
        next[rr] = cand[rr][j + 1 < KNN_KEYS ? j + 1 : j];
        const float cv = c.x;
        const int ci = __float_as_int(c.y);
        const bool ins = j < tot[rr] &&
                         better(cv, ci, list[rr].wv, list[rr].wi);
        list[rr].replace_worst(ins, cv, ci, quad);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const size_t o = ((size_t)b * S + s0 + row0 + 8 * rr) * K;
    list[rr].store(K, quad, row0 + 8 * rr < rows, N, idx_out + o,
                   val_out + o);
  }
}

template <bool BF16, int Q>
int launch(const void* seeds, const void* feats, const void* mask, void* idx,
           void* val, int B, int S, int N, int K, cudaStream_t stream) {
  using L = KnnLayout<BF16>;
  static_assert(L::SMEM <= 227 * 1024, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      seed_knn_topk_kernel<BF16, Q>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + L::ROWS - 1) / L::ROWS, B);
  seed_knn_topk_kernel<BF16, Q><<<grid, L::THREADS, L::SMEM, stream>>>(
      static_cast<const typename L::T*>(seeds),
      static_cast<const typename L::T*>(feats),
      static_cast<const float*>(mask), static_cast<int*>(idx),
      static_cast<float*>(val), S, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// seeds: [B, S, C], feats: [B, N, C], bf16 (is_bf16) or f32, C = 128;
// mask: [B, N] f32; idx: [B, S, K] int32; val: [B, S, K] f32; 1 <= K <=
// min(N, 128). The list is 48 entries wide for K <= 48 (the model's k + 1
// = 41 fits), else 128: its slots live in registers.
extern "C" int gmf_seed_knn_topk(const void* seeds, const void* feats,
                                 const void* mask, void* idx, void* val,
                                 int B, int S, int N, int C, int K,
                                 int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || K <= 0 || K > N || K > 128 ||
      C != KNN_C)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return K <= 48 ? launch<true, 48>(seeds, feats, mask, idx, val, B, S, N,
                                      K, st)
                   : launch<true, 128>(seeds, feats, mask, idx, val, B, S, N,
                                       K, st);
  return K <= 48
             ? launch<false, 48>(seeds, feats, mask, idx, val, B, S, N, K, st)
             : launch<false, 128>(seeds, feats, mask, idx, val, B, S, N, K,
                                  st);
}
