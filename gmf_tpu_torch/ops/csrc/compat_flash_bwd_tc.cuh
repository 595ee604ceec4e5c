// The compat-modulated flash attention BACKWARD on Hopper's tensor cores,
// sm_90a: dK/dV and dQ of compat_flash_core.cuh's cached and streaming
// forwards, recomputed from the forward's base-2 log-sum-exp. Both q/k/v
// types (f32 and bf16), D = 32 and 128; MODE Compat::kCached reads compat
// from the forward's cache (f32, bf16 or int8 codes), Compat::kStream
// rebuilds it per (i, j) from the keypoints.
//
// For pair b, query i and key j (qs = q * scale * log2(e); lse and delta
// per query row; the cache is [B, N, ld], rows are queries):
//
//   s       = compat * (qs_i . k_j)        masked keys: -1e9 AFTER the
//   p       = exp2(s - lse_i)              multiply, as in the forward
//   dp      = do_i . v_j
//   dlogits = p * (dp - delta_i) * compat * scale
//   dV_j = sum_i p * do_i,  dK_j = sum_i dlogits * q_i,  dQ_i = sum_j
//   dlogits * k_j
//
// lse_i = 1e9 on masked query rows (from the caller) makes their p, and so
// their dq, exactly 0; keys and queries past N carry no weight.
//
// Every product runs on wgmma, with compat_flash_core.cuh's descriptors,
// swizzles and wrappers and its three-term split machinery, which the f32
// forward (compat_flash_fwd_split) shares. A block is two warpgroups:
// warpgroup 1 produces, warpgroup 0 consumes.
//
//   compat_flash_bwd_dkv_tc  one block per (64-key tile, pair): k and v
//       stay resident, the query tiles stream through a ring of two
//       32-query slots (q, do, their cache tile or keypoints, lse,
//       delta). Per slot S^T = k qs^T and dP^T = v do^T with the keys as
//       wgmma's 64 rows (both operands K-major); p and dlogits on the
//       accumulators in registers; then dV += P^T do and dK += dS^T q
//       with P^T, dS^T as the register A operand (the accumulator's
//       layout is the A fragment's) and do, q read MN-major through the
//       descriptor's transpose bit, from the tiles S^T just read K-major.
//       The cache tile is read transposed from shared memory.
//   compat_flash_bwd_dq_tc   one block per (64-query tile, pair): qs and
//       do stay resident, the key tiles stream through the same ring (k,
//       v, the cache tile or keypoints, the key states). S = qs k^T, dP =
//       do v^T, then dQ += dS k with k read MN-major.
//
// kStream keeps the keypoints of the 64 resident rows beside the resident
// tiles and those of a slot's 32 rows in the slot, field-major (a warp's
// reads fall in distinct banks), and forms each compat on the S fragment's
// (i, j) with compat_stream(), the streaming forward's own function on the
// same operands (query, key), while S and dP run on the tensor cores; so p
// = exp2(s - lse) recomputes the forward's probabilities. The resident
// rows' keypoints stay in shared memory, not in registers, which the f32
// dK/dV instance has none to spare for. The producer warpgroup filling an
// f32 compat tile per slot instead was 9-11% slower in three of the four
// D = 128 instances on an H100 (it loads, then computes, one slot ahead).
//
// The producer loads each tile with 16-byte loads into registers and
// stores it swizzled; rows past N are stored as zeros (keypoints too), so
// the last tile of a pair never reads the next pair. Named barriers hand a
// slot from producer to consumer (FULL) and back (EMPTY). No atomics: each
// block owns its outputs, so two launches give the same bits.
//
// f32 q/k/v keep f32 accuracy by the three-term bf16 split
// (compat_flash_core.cuh): dV, dK and dQ take each slot's six products
// into a zeroed tile sum and add it with rounded f32 adds (mma_rs). TF32
// keeps 10 bits, and TF32 wgmma takes K-major operands only, which would
// need a transposed copy of q and do that does not fit beside the tiles. The f32 instance
// folds qscale into S in registers (qscale * (q . k)): one f32 rounding
// more than the plain version's (q * qscale) . k, some 6e-8 of s, where a
// scaled copy of q would cost three more tiles.
//
// The bf16 instance is the same template with one term. It rounds where
// the plain version and the TPU kernel round: qs (a scaled copy of q,
// bf16(q * qscale) as in the forward, so p recomputes the forward's
// probabilities), p before dV, dlogits before dK and dQ.
//
// Shared memory, f32, D = 128: resident 2 x 3 terms x 64 x 128 bf16 (96
// KB) and two slots of 2 x 3 x 32 x 128 bf16 plus the cache tile (57-59
// KB each): 211-215 KB, one block per SM; kStream 2 KB of resident
// keypoints and slots of 49 KB: 197 KB. Two 32-row slots beat one of 64
// rows, which the same bytes allow (no overlap of loads with products).
//
// Bound: the products, 4 (dK/dV) or 3 (dQ) of depth D per (i, j), at 989
// TFLOP/s in bf16 and at 989 / 6 in f32. What holds the kernels above it
// (on an H100): one consumer warpgroup an SM, which waits for its own
// products (S and dP, then dV and dK, then each tile sum) and leaves the
// tensor cores idle while it forms p, dlogits and the fragments; the
// S and dP products are m64n32k16, which read more shared memory per flop
// than wider ones; and the f32 dK/dV instance runs at 255 registers with
// some 390 bytes of spills.

#pragma once

#include "compat_flash_core.cuh"

namespace {

constexpr float LSE_PAD = 1e9f;  // lse of rows past N: p = 0

// one cache entry as compat (int8: dequantized with the forward's FMA)
__device__ __forceinline__ float compat_at(const float* p) { return *p; }
__device__ __forceinline__ float compat_at(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(p)
                         << 16);
}
__device__ __forceinline__ float compat_at(const int8_t* p) {
  return dequant_i8((float)*p);
}

// Shared-memory layout of both kernels: the resident operands (two of
// TERMS tiles of 64 rows) and, kStream, the resident rows' keypoints;
// then BT_STAGES slots, each two streamed operands (TERMS tiles of
// BT_STREAM rows), the bf16 dK/dV instance's qs tile, kCached's cache tile
// of CROWS rows of `crow` bytes and SIDE floats a row of the stream (lse
// and delta, or the key state; then kStream's keypoints).
template <typename T, int D, typename CT, bool kDkv, Compat MODE>
struct BtLayout {
  static constexpr int TERMS = bt_terms<T>();
  static constexpr int RES = TERMS * BT_ROWS * D * 2;
  static constexpr int STR = TERMS * BT_STREAM * D * 2;
  static constexpr int QS = kDkv && TERMS == 1 ? BT_STREAM * D * 2 : 0;
  // dK/dV: rows = the slot's queries, 64 keys a row, read transposed; a
  // 16-byte pad puts the lanes of a warp in distinct banks. dQ: rows =
  // the block's queries, BT_STREAM keys a row, read as the forward reads.
  static constexpr int CROWS = kDkv ? BT_STREAM : BT_ROWS;
  static constexpr int CROW =
      kDkv ? BT_ROWS * (int)sizeof(CT) + 16
           : BT_STREAM * (int)sizeof(CT) + (sizeof(CT) == 4 ? 32 : 16);
  // keypoints: s.xyz, t.xyz of row r at [c * rows + r]
  static constexpr int COORDS = MODE == Compat::kStream ? 6 : 0;
  static constexpr int RCOORD = (COORDS * BT_ROWS * 4 + 1023) / 1024 * 1024;
  static constexpr int SIDE = (kDkv ? 2 : 1) + COORDS;
  static constexpr int CACHE_OFF = 2 * STR + QS;
  static constexpr int SIDE_OFF =
      CACHE_OFF + (MODE == Compat::kCached ? CROWS * CROW : 0);
  static constexpr int SLOT =
      (SIDE_OFF + SIDE * BT_STREAM * 4 + 1023) / 1024 * 1024;
  static constexpr size_t BYTES = 1024 /* alignment */ + 2 * RES + RCOORD +
                                  BT_STAGES * SLOT;
};

// the keypoints of rows [r0, r0 + ROWS) of a pair into dst, field-major
// (s.xyz, t.xyz of row r at dst[c * ROWS + r]), rows past N as zeros; NT
// threads share the work
template <int ROWS, int NT>
__device__ __forceinline__ void load_coords(float* dst, const float* src,
                                            const float* tgt, int r0, int N,
                                            int tid) {
  for (int e = tid; e < 6 * ROWS; e += NT) {
    const int half = e / (3 * ROWS), f = e % (3 * ROWS), r = f / 3;
    const float* p = half == 0 ? src : tgt;
    dst[(3 * half + f % 3) * ROWS + r] =
        r0 + r < N ? p[(size_t)r0 * 3 + f] : 0.f;
  }
}

// the keypoints of row r of a field-major block of ROWS rows
template <int ROWS>
__device__ __forceinline__ void coords_of(const float* block, int r,
                                          float (&c)[6]) {
#pragma unroll
  for (int f = 0; f < 6; ++f) c[f] = block[f * ROWS + r];
}

// q, k, v, dout: [B, N, D] of T; lse, delta, mask: [B, N] f32; kCached:
// cache [B, N, ld]; kStream: src, tgt [B, N, 3] f32 and 1 / sigma^2 -> dk,
// dv [B, N, D] of T
template <typename T, int D, typename CT, Compat MODE>
__global__ void __launch_bounds__(BT_THREADS, 1)
compat_flash_bwd_dkv_tc(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ mask,
                        const CT* __restrict__ cache, T* __restrict__ dk,
                        T* __restrict__ dv, int N, int ld, float qscale,
                        float scale, const float* __restrict__ src,
                        const float* __restrict__ tgt, float inv_sigma_sq) {
  using L = BtLayout<T, D, CT, true, MODE>;
  constexpr int TERMS = L::TERMS;
  constexpr bool kStream = MODE == Compat::kStream;
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  extern __shared__ __align__(16) uint8_t bt_smem[];
  uint8_t* sK = bt_smem + ((1024u - (smem_u32(bt_smem) & 1023u)) & 1023u);
  uint8_t* sV = sK + L::RES;
  float* sKc = reinterpret_cast<float*>(sV + L::RES);  // kStream
  uint8_t* ring = sV + L::RES + L::RCOORD;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT_ROWS;
  const size_t base = (size_t)blockIdx.y * N;
  q += base * D;
  k += base * D;
  v += base * D;
  dout += base * D;
  dk += base * D;
  dv += base * D;
  lse += base;
  delta += base;
  mask += base;
  if constexpr (kStream) {
    src += base * 3;
    tgt += base * 3;
  } else {
    cache += base * ld;
  }

  load_tile<T, D, BT_ROWS, BT_THREADS>(sK, nullptr, k, k0, N, tid, 0.f);
  load_tile<T, D, BT_ROWS, BT_THREADS>(sV, nullptr, v, k0, N, tid, 0.f);
  if constexpr (kStream)
    load_coords<BT_ROWS, BT_THREADS>(sKc, src, tgt, k0, N, tid);
  fence_proxy_async();
  __syncthreads();
  const int tiles = (N + BT_STREAM - 1) / BT_STREAM;

  if (tid >= BT_WG) {  // producer: the query tiles
    const int ptid = tid - BT_WG;
    for (int t = 0; t < tiles; ++t) {
      const int s = t % BT_STAGES, q0 = t * BT_STREAM;
      if (t >= BT_STAGES) bar_sync(BAR_EMPTY + s);
      uint8_t* slot = ring + s * L::SLOT;
      load_tile<T, D, BT_STREAM, BT_WG>(
          slot, TERMS == 1 ? slot + 2 * L::STR : nullptr, q, q0, N, ptid,
          qscale);
      load_tile<T, D, BT_STREAM, BT_WG>(slot + L::STR, nullptr, dout, q0, N,
                                        ptid, 0.f);
      if constexpr (kStream)
        load_coords<BT_STREAM, BT_WG>(
            reinterpret_cast<float*>(slot + L::SIDE_OFF) + 2 * BT_STREAM,
            src, tgt, q0, N, ptid);
      else
        load_cache_tile<CT, BT_STREAM, BT_ROWS>(slot + L::CACHE_OFF, cache,
                                                q0, k0, N, ld, L::CROW, ptid);
      if (ptid < BT_STREAM) {
        float* side = reinterpret_cast<float*>(slot + L::SIDE_OFF);
        const int i = q0 + ptid;
        side[ptid] = i < N ? lse[i] : LSE_PAD;
        side[BT_STREAM + ptid] = i < N ? delta[i] : 0.f;
      }
      fence_proxy_async();
      bar_arrive(BAR_FULL + s);
    }
  } else {  // consumer: this warpgroup's 64 keys are wgmma's rows
    const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
    const int row0 = warp * 16 + lane / 4;  // keys k0 + row0, + 8
    const float state[2] = {key_state(mask, k0 + row0, N),
                            key_state(mask, k0 + row0 + 8, N)};
    const float sfold = TERMS == 1 ? 1.f : qscale;
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);

    for (int t = 0; t < tiles; ++t) {
      const int s = t % BT_STAGES, q0 = t * BT_STREAM;
      uint8_t* slot = ring + s * L::SLOT;
      const uint32_t q_addr = smem_u32(slot);
      const uint32_t do_addr = q_addr + L::STR;
      bar_sync(BAR_FULL + s);

      // S^T = k qs^T, dP^T = v do^T: 64 keys x BT_STREAM queries
      float st[BT_STREAM / 2], dpt[BT_STREAM / 2];
#pragma unroll
      for (int i = 0; i < BT_STREAM / 2; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
      mma_ss<TERMS, D, BT_STREAM>(st, k_addr,
                                  TERMS == 1 ? q_addr + 2 * L::STR : q_addr);
      mma_ss<TERMS, D, BT_STREAM>(dpt, v_addr, do_addr);
      wgmma_commit();

      // kStream: compat of keys row0 + 8 rr and queries c of every 8,
      // formed while the products run
      float sc[BT_STREAM / 8][2][2];
      if constexpr (kStream) {
        const float* qcs =
            reinterpret_cast<const float*>(slot + L::SIDE_OFF) +
            2 * BT_STREAM;
        float kc[2][6];
        coords_of<BT_ROWS>(sKc, row0, kc[0]);
        coords_of<BT_ROWS>(sKc, row0 + 8, kc[1]);
#pragma unroll
        for (int jg = 0; jg < BT_STREAM / 8; ++jg)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float qc[6];
            coords_of<BT_STREAM>(qcs, jg * 8 + 2 * quad + e, qc);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              sc[jg][rr][e] = compat_stream(qc, kc[rr], inv_sigma_sq);
          }
      }
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // p and dlogits in place; a thread holds keys row0, row0 + 8 and
      // queries 2 quad, 2 quad + 1 of every 8
      const uint8_t* ctile = slot + L::CACHE_OFF;
      const float* side = reinterpret_cast<const float*>(slot + L::SIDE_OFF);
#pragma unroll
      for (int jg = 0; jg < BT_STREAM / 8; ++jg)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = jg * 8 + 2 * quad + e;
          const float l = side[c], dl = side[BT_STREAM + c];
          const bool q_in = q0 + c < N;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int idx = jg * 4 + rr * 2 + e;
            float p = 0.f, ds = 0.f;
            if (q_in && state[rr] >= 0.f) {
              float compat;
              if constexpr (kStream)
                compat = sc[jg][rr][e];
              else
                compat = compat_at(reinterpret_cast<const CT*>(
                    ctile + c * L::CROW) + row0 + 8 * rr);
              float logit = compat * (sfold * st[idx]);
              if (state[rr] == 0.f) logit = MASKED;
              p = exp2f(logit - l);
              ds = p * (dpt[idx] - dl) * compat * scale;
            }
            st[idx] = p;
            dpt[idx] = ds;
          }
        }

      // dV += P^T do, dK += dS^T q (p and dlogits rounded to bf16 under
      // bf16, split into three terms under f32)
      uint32_t pa[TERMS][BT_STREAM / 16][4], da[TERMS][BT_STREAM / 16][4];
      to_frags<TERMS, BT_STREAM>(st, pa);
      mma_rs<TERMS, D, BT_STREAM>(acc_v, pa, do_addr);
      to_frags<TERMS, BT_STREAM>(dpt, da);
      mma_rs<TERMS, D, BT_STREAM>(acc_k, da, q_addr);
      if (t + BT_STAGES < tiles) bar_arrive(BAR_EMPTY + s);
    }
    store_rows<D>(dk + (size_t)k0 * D, acc_k, row0, N - k0, quad);
    store_rows<D>(dv + (size_t)k0 * D, acc_v, row0, N - k0, quad);
  }
}

// the same inputs -> dq [B, N, D] of T
template <typename T, int D, typename CT, Compat MODE>
__global__ void __launch_bounds__(BT_THREADS, 1)
compat_flash_bwd_dq_tc(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ mask,
                       const CT* __restrict__ cache, T* __restrict__ dq,
                       int N, int ld, float qscale, float scale,
                       const float* __restrict__ src,
                       const float* __restrict__ tgt, float inv_sigma_sq) {
  using L = BtLayout<T, D, CT, false, MODE>;
  constexpr int TERMS = L::TERMS;
  constexpr bool kStream = MODE == Compat::kStream;
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  extern __shared__ __align__(16) uint8_t bt_smem[];
  uint8_t* sQ = bt_smem + ((1024u - (smem_u32(bt_smem) & 1023u)) & 1023u);
  uint8_t* sDO = sQ + L::RES;
  float* sQc = reinterpret_cast<float*>(sDO + L::RES);  // kStream
  uint8_t* ring = sDO + L::RES + L::RCOORD;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT_ROWS;
  const size_t base = (size_t)blockIdx.y * N;
  q += base * D;
  k += base * D;
  v += base * D;
  dout += base * D;
  dq += base * D;
  lse += base;
  delta += base;
  mask += base;
  if constexpr (kStream) {
    src += base * 3;
    tgt += base * 3;
  } else {
    cache += base * ld;
  }

  // resident: the q terms (f32; qscale is folded into S) or bf16(q *
  // qscale), and do
  load_tile<T, D, BT_ROWS, BT_THREADS>(TERMS == 1 ? nullptr : sQ,
                                       TERMS == 1 ? sQ : nullptr, q, q0, N,
                                       tid, qscale);
  load_tile<T, D, BT_ROWS, BT_THREADS>(sDO, nullptr, dout, q0, N, tid, 0.f);
  if constexpr (kStream)
    load_coords<BT_ROWS, BT_THREADS>(sQc, src, tgt, q0, N, tid);
  fence_proxy_async();
  __syncthreads();
  const int tiles = (N + BT_STREAM - 1) / BT_STREAM;

  if (tid >= BT_WG) {  // producer: the key tiles
    const int ptid = tid - BT_WG;
    for (int t = 0; t < tiles; ++t) {
      const int s = t % BT_STAGES, k0 = t * BT_STREAM;
      if (t >= BT_STAGES) bar_sync(BAR_EMPTY + s);
      uint8_t* slot = ring + s * L::SLOT;
      load_tile<T, D, BT_STREAM, BT_WG>(slot, nullptr, k, k0, N, ptid, 0.f);
      load_tile<T, D, BT_STREAM, BT_WG>(slot + L::STR, nullptr, v, k0, N,
                                        ptid, 0.f);
      if constexpr (kStream)
        load_coords<BT_STREAM, BT_WG>(
            reinterpret_cast<float*>(slot + L::SIDE_OFF) + BT_STREAM, src,
            tgt, k0, N, ptid);
      else
        load_cache_tile<CT, BT_ROWS, BT_STREAM>(slot + L::CACHE_OFF, cache,
                                                q0, k0, N, ld, L::CROW, ptid);
      if (ptid < BT_STREAM)
        reinterpret_cast<float*>(slot + L::SIDE_OFF)[ptid] =
            key_state(mask, k0 + ptid, N);
      fence_proxy_async();
      bar_arrive(BAR_FULL + s);
    }
  } else {  // consumer: this warpgroup's 64 queries are wgmma's rows
    const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
    const int row0 = warp * 16 + lane / 4;  // queries q0 + row0, + 8
    float lse_r[2], delta_r[2];
    bool q_in[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = q0 + row0 + 8 * rr;
      q_in[rr] = i < N;
      lse_r[rr] = q_in[rr] ? lse[i] : LSE_PAD;
      delta_r[rr] = q_in[rr] ? delta[i] : 0.f;
    }
    const float sfold = TERMS == 1 ? 1.f : qscale;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(sQ), do_addr = smem_u32(sDO);

    for (int t = 0; t < tiles; ++t) {
      const int s = t % BT_STAGES;
      uint8_t* slot = ring + s * L::SLOT;
      const uint32_t k_addr = smem_u32(slot);
      bar_sync(BAR_FULL + s);

      // S = qs k^T, dP = do v^T: 64 queries x BT_STREAM keys
      float st[BT_STREAM / 2], dp[BT_STREAM / 2];
#pragma unroll
      for (int i = 0; i < BT_STREAM / 2; ++i) st[i] = dp[i] = 0.f;
      wgmma_fence();
      mma_ss<TERMS, D, BT_STREAM>(st, q_addr, k_addr);
      mma_ss<TERMS, D, BT_STREAM>(dp, do_addr, k_addr + L::STR);
      wgmma_commit();

      // kStream: compat of queries row0 + 8 rr and keys c of every 8,
      // formed while the products run
      float sc[BT_STREAM / 8][2][2];
      if constexpr (kStream) {
        const float* kcs =
            reinterpret_cast<const float*>(slot + L::SIDE_OFF) + BT_STREAM;
        float qc[2][6];
        coords_of<BT_ROWS>(sQc, row0, qc[0]);
        coords_of<BT_ROWS>(sQc, row0 + 8, qc[1]);
#pragma unroll
        for (int jg = 0; jg < BT_STREAM / 8; ++jg)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float kc[6];
            coords_of<BT_STREAM>(kcs, jg * 8 + 2 * quad + e, kc);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              sc[jg][rr][e] = compat_stream(qc[rr], kc, inv_sigma_sq);
          }
      }
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dp);

      // dlogits in place of dp; a thread holds queries row0, row0 + 8 and
      // keys 2 quad, 2 quad + 1 of every 8
      const uint8_t* ctile = slot + L::CACHE_OFF;
      const float* kstate =
          reinterpret_cast<const float*>(slot + L::SIDE_OFF);
#pragma unroll
      for (int jg = 0; jg < BT_STREAM / 8; ++jg) {
        const int c0 = jg * 8 + 2 * quad;
        float cc[2][2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if constexpr (kStream) {
            cc[rr][0] = sc[jg][rr][0];
            cc[rr][1] = sc[jg][rr][1];
          } else {
            load2(reinterpret_cast<const CT*>(ctile +
                                              (row0 + 8 * rr) * L::CROW) +
                      c0,
                  cc[rr]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float state = kstate[c0 + e];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int idx = jg * 4 + rr * 2 + e;
            float ds = 0.f;
            if (q_in[rr] && state >= 0.f) {
              const float compat = cc[rr][e];
              float logit = compat * (sfold * st[idx]);
              if (state == 0.f) logit = MASKED;
              const float p = exp2f(logit - lse_r[rr]);
              ds = p * (dp[idx] - delta_r[rr]) * compat * scale;
            }
            dp[idx] = ds;
          }
        }
      }

      // dQ += dS k
      uint32_t da[TERMS][BT_STREAM / 16][4];
      to_frags<TERMS, BT_STREAM>(dp, da);
      mma_rs<TERMS, D, BT_STREAM>(acc, da, k_addr);
      if (t + BT_STAGES < tiles) bar_arrive(BAR_EMPTY + s);
    }
    store_rows<D>(dq + (size_t)q0 * D, acc, row0, N - q0, quad);
  }
}

// Launch one backward kernel. dq_kernel selects compat_flash_bwd_dq_tc
// (out0 = dq) over compat_flash_bwd_dkv_tc (out0 = dk, out1 = dv). kCached
// reads cache and ld; kStream src, tgt and inv_sigma_sq.
template <typename T, int D, typename CT, Compat MODE>
cudaError_t launch_bwd_tc(bool dq_kernel, const void* q, const void* k,
                          const void* v, const void* dout, const float* lse,
                          const float* delta, const float* mask,
                          const CT* cache, void* out0, void* out1, int B,
                          int N, int ld, float qscale, float scale,
                          const float* src, const float* tgt,
                          float inv_sigma_sq, cudaStream_t stream) {
  // 16-byte loads of q, k, v, do and the cache
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)cache) & 15)
    return cudaErrorMisalignedAddress;
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* tdo = static_cast<const T*>(dout);
  const dim3 grid((N + BT_ROWS - 1) / BT_ROWS, B);
  if (dq_kernel) {
    const size_t bytes = BtLayout<T, D, CT, false, MODE>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        compat_flash_bwd_dq_tc<T, D, CT, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    compat_flash_bwd_dq_tc<T, D, CT, MODE>
        <<<grid, BT_THREADS, bytes, stream>>>(
            tq, tk, tv, tdo, lse, delta, mask, cache, static_cast<T*>(out0),
            N, ld, qscale, scale, src, tgt, inv_sigma_sq);
  } else {
    const size_t bytes = BtLayout<T, D, CT, true, MODE>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        compat_flash_bwd_dkv_tc<T, D, CT, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    compat_flash_bwd_dkv_tc<T, D, CT, MODE>
        <<<grid, BT_THREADS, bytes, stream>>>(
            tq, tk, tv, tdo, lse, delta, mask, cache, static_cast<T*>(out0),
            static_cast<T*>(out1), N, ld, qscale, scale, src, tgt,
            inv_sigma_sq);
  }
  return cudaGetLastError();
}

// q/k/v element type (f32 or bf16) and head width (32 or 128)
template <typename CT, Compat MODE>
cudaError_t dispatch_bwd_tc(bool dq_kernel, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, const void* mask,
                            const CT* cache, void* out0, void* out1, int B,
                            int N, int D, int ld, int is_bf16, float qscale,
                            float scale, const void* src, const void* tgt,
                            float inv_sigma_sq, void* stream) {
  const auto* l = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* m = static_cast<const float*>(mask);
  const auto* s = static_cast<const float*>(src);
  const auto* t = static_cast<const float*>(tgt);
  auto st = static_cast<cudaStream_t>(stream);
#define GMF_BWD_TC_CASE(T, WIDTH)                                          \
  return launch_bwd_tc<T, WIDTH, CT, MODE>(                                \
      dq_kernel, q, k, v, dout, l, dl, m, cache, out0, out1, B, N, ld,     \
      qscale, scale, s, t, inv_sigma_sq, st)
  if (D == 32) {
    if (is_bf16) GMF_BWD_TC_CASE(__nv_bfloat16, 32);
    GMF_BWD_TC_CASE(float, 32);
  }
  if (D == 128) {
    if (is_bf16) GMF_BWD_TC_CASE(__nv_bfloat16, 128);
    GMF_BWD_TC_CASE(float, 128);
  }
#undef GMF_BWD_TC_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
