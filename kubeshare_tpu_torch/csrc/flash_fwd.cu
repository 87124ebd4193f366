// Flash-attention forward for Hopper (sm_90a).
//
// Replaces kubeshare_tpu/ops/attention.py:_attention_kernel (the Pallas
// forward launched by _flash_forward).  It computes what
// kubeshare_tpu_torch/ops/attention.py:flash_forward_reference computes:
//   scores = (q . k^T in f32) * d^-1/2, masked to -inf outside the causal /
//   sliding-window band and past the sequence end;
//   online softmax with f32 running max m, row sum l and accumulator acc;
//   p is cast to v's dtype before the p . v product (f32 accumulation);
//   out = acc / max(l, 1e-30) in q's dtype, lse = m + log(max(l, 1e-30))
//   (-inf for a row with no visible key), f32 [b, h, s, 1].
//
// What bounds it.  At the flagship prefill shape (b=4, h=8, s=1024, d=64,
// bf16, causal) the causal band holds s(s+1)/2 query-key pairs per head:
// 4 * d * b * h * s(s+1)/2 = 4.30 GFLOP, 4.35 us at 989 TFLOP/s; q, k, v
// and out are 16.8 MB (+ 0.13 MB of lse), 5.05 us at 3.35 TB/s.  So the
// floor is the memory traffic, about 5 us per launch, four launches (one
// per layer) per prefill.
//
// What the design does about it.  One thread block per (batch, head,
// 64-row Q tile) keeps its Q tile, its accumulator and its softmax state
// on chip for the whole K sweep, so neither the s x s scores nor a partial
// output reach device memory, and K/V tiles above the causal diagonal or
// outside the window are never loaded.  The K sweep is a loop inside the
// block (the Pallas grid's sequential innermost axis), because Hopper runs
// blocks in parallel and in no order; the longest causal rows start first.
//
// bf16 (the model's path): four warps, each owning 16 query rows, run the
// two products on the tensor cores with mma.sync m16n8k16 (f32
// accumulate).  Scores, probabilities and the accumulator stay in
// registers: the score accumulator's layout is the A operand's layout of
// the p . v product, so p goes from one to the other without touching
// shared memory.  K/V tiles are double-buffered with cp.async, so the next
// tile streams in while this one is multiplied.  wgmma and TMA are left
// for later work.
//
// f32: the products run on the CUDA cores (the tensor cores would round
// f32 to TF32) over shared-memory tiles; this path exists for f32 configs
// and is not tuned.
//
// GQA: query head hi reads KV head hi / (h / h_kv); KV is never repeated.
// Ragged lengths: rows past the sequence end are loaded as zeros, masked,
// and never written, so every length runs on the kernel.
//
// Block-sparse mode (kMasked = true; replaces the same Pallas kernel with
// has_mask=True, launched by block_sparse_attention): a pair is visible
// when the caller's [s / block_q, s / block_k] mask keeps its block and,
// if causal, the key is not after the query.  The mask's blocks are the
// caller's (any divisors of s), not the 64-row tiles, so each block first
// lists, in shared memory, the K tiles that hold a visible pair for its Q
// tile (BlockMask::tile_state, build_live_tiles), then sweeps that list,
// prefetching the next listed tile; a tile the mask cuts through takes
// the pair-by-pair test in visible().  A Q tile with an empty list loads
// nothing and writes out = 0 and lse = -inf, as does every row with no
// visible key.  The dense instantiations read no mask and compile as
// before.
//
// Layout: q, out [b, h, s, d]; k, v [b, h_kv, s, d]; all contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;  // warp w owns Q rows [16w, 16w + 16)
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;

// Where a (batch, head, Q tile) block starts and which K tiles it visits.
struct Tile {
  int q0, q_rows, k_tile_begin, k_tile_end;
  size_t q_offset, kv_offset;  // element offsets of the Q rows, the KV head

  __device__ Tile(int h, int h_kv, int s, int d, bool banded, int window) {
    const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest rows first
    const int head = blockIdx.y;
    const int batch = blockIdx.z;
    const int kv_head = head / (h / h_kv);
    q0 = q_tile * kBlockQ;
    q_rows = min(kBlockQ, s - q0);
    q_offset = ((size_t)(batch * h + head) * s + q0) * d;
    kv_offset = (size_t)(batch * h_kv + kv_head) * s * d;
    // K tiles that can hold a visible key for some row of this Q tile
    k_tile_end = (banded ? q0 + q_rows - 1 : s - 1) / kBlockK;
    k_tile_begin = window > 0 ? max(q0 - window + 1, 0) / kBlockK : 0;
  }
};

// `cut`: the tile straddles mask blocks, so the mask is tested too
__device__ __forceinline__ bool visible(int q_pos, int k_pos, int s,
                                        bool banded, int window, bool cut,
                                        const BlockMask& mask) {
  bool ok = k_pos < s;
  if (banded) ok = ok && q_pos >= k_pos;
  if (window > 0) ok = ok && (q_pos - k_pos) < window;
  if (cut) ok = ok && mask.keeps(q_pos, k_pos, s);
  return ok;
}

// A masked block's live list of K tiles, built in the shared memory at
// `list` (after the block's tiles)
__device__ __forceinline__ LiveTiles live_k_tiles(unsigned char* list,
                                                  const Tile& tile, int s,
                                                  bool causal,
                                                  const BlockMask& mask) {
  return build_live_tiles<kThreads>(
      reinterpret_cast<int*>(list), (s + kBlockK - 1) / kBlockK, [&](int kt) {
        return mask.tile_state(tile.q0, tile.q0 + kBlockQ, kt * kBlockK,
                               (kt + 1) * kBlockK, s, causal);
      });
}

// ------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, register-resident softmax
// ------------------------------------------------------------------------

template <int D>
struct Bf16Smem {
  // rows padded by 16 bytes: the fragment loads of 8 rows x 16 bytes
  // then fall on 32 distinct banks
  static constexpr int kLd = D + 8;
  static constexpr int kTile = kBlockK * kLd;  // elements per K or V tile
  // Q, then K[2], V[2]
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * 5 * kTile;
};

// one [64, D] tile; rows at or past `valid` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int valid) {
  load_rows_async<D, kBlockK, Bf16Smem<D>::kLd, kThreads>(dst, src, valid);
}

template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int h, int h_kv, int s,
                      int causal, int window, float scale,
                      const BlockMask mask) {
  using G = Bf16Smem<D>;
  constexpr int kLd = G::kLd;
  constexpr int kNTiles = kBlockK / 8;  // score n-tiles per K tile
  constexpr int kDTiles = D / 8;        // accumulator n-tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + G::kTile;      // two buffers
  __nv_bfloat16* sV = sK + 2 * G::kTile;  // two buffers

  const bool banded = causal || window > 0;
  const Tile tile(h, h_kv, s, D, banded, window);
  // the K tiles to visit, kt in [kt_begin, kt_end]: tile kt of the band
  // (dense), or entry kt of this Q tile's live list (masked)
  const LiveTiles live = kMasked ? live_k_tiles(smem_raw + G::kBytes, tile,
                                                s, banded, mask)
                                 : LiveTiles();
  const int kt_begin = kMasked ? 0 : tile.k_tile_begin;
  const int kt_end = kMasked ? live.count - 1 : tile.k_tile_end;
  auto k_start = [&](int kt) { return (kMasked ? live.tile(kt) : kt) * kBlockK; };
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // fragment column pair
  const int row0 = warp * kRowsPerWarp + g;  // this lane's rows: row0, row0 + 8
  const int q_pos0 = tile.q0 + row0;
  const int q_pos1 = q_pos0 + 8;

  const __nv_bfloat16* k_head = k + tile.kv_offset;
  const __nv_bfloat16* v_head = v + tile.kv_offset;

  if (!kMasked || live.count > 0) {  // an empty live list loads nothing
    load_tile_async<D>(sQ, q + tile.q_offset, tile.q_rows);
    {
      const int k0 = k_start(kt_begin);
      load_tile_async<D>(sK, k_head + (size_t)k0 * D, min(kBlockK, s - k0));
      load_tile_async<D>(sV, v_head + (size_t)k0 * D, min(kBlockK, s - k0));
    }
    cp_async_commit();
  }

  uint32_t q_frag[D / 16][4];
  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows row0, row0+8
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the row sums

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    const int k0 = k_start(kt);
    if (kt < kt_end) {  // prefetch the next tile into the other buffer
      const int k1 = kMasked ? k_start(kt + 1) : k0 + kBlockK;
      load_tile_async<D>(sK + (buf ^ 1) * G::kTile, k_head + (size_t)k1 * D,
                         min(kBlockK, s - k1));
      load_tile_async<D>(sV + (buf ^ 1) * G::kTile, v_head + (size_t)k1 * D,
                         min(kBlockK, s - k1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (kt == kt_begin) {
      const __nv_bfloat16* qr = sQ + (warp * kRowsPerWarp + g) * kLd + t * 2;
#pragma unroll
      for (int e = 0; e < D / 16; ++e) {
        q_frag[e][0] = *reinterpret_cast<const uint32_t*>(qr + e * 16);
        q_frag[e][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * kLd + e * 16);
        q_frag[e][2] = *reinterpret_cast<const uint32_t*>(qr + e * 16 + 8);
        q_frag[e][3] =
            *reinterpret_cast<const uint32_t*>(qr + 8 * kLd + e * 16 + 8);
      }
    }

    // ---- S = Q . K^T: 16 rows x 64 keys per warp, f32 ----
    const __nv_bfloat16* sKb = sK + buf * G::kTile;
    float sc[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const __nv_bfloat16* kr = sKb + (j * 8 + g) * kLd + t * 2;
#pragma unroll
      for (int e = 0; e < D / 16; ++e) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + e * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + e * 16 + 8);
        mma_bf16(sc[j], q_frag[e], b0, b1);
      }
    }

    // ---- scale, mask, online softmax (rows row0 and row0 + 8) ----
    // a tile needs the element mask only where the band, the end or the
    // block mask cuts it
    const bool cut = kMasked && live.cut(kt);
    const bool edge = k0 + kBlockK > s ||
                      (banded && k0 + kBlockK - 1 > tile.q0) ||
                      (window > 0 && k0 <= tile.q0 + kBlockQ - 1 - window) ||
                      cut;
    float bm0 = -INFINITY, bm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k_pos = k0 + j * 8 + t * 2 + c;
        float x0 = sc[j][c] * scale;
        float x1 = sc[j][2 + c] * scale;
        if (edge) {
          if (!visible(q_pos0, k_pos, s, banded, window, cut, mask))
            x0 = -INFINITY;
          if (!visible(q_pos1, k_pos, s, banded, window, cut, mask))
            x1 = -INFINITY;
        }
        sc[j][c] = x0;
        sc[j][2 + c] = x1;
        bm0 = fmaxf(bm0, x0);
        bm1 = fmaxf(bm1, x1);
      }
    }
    // the four lanes of a quad hold one row between them
    bm0 = fmaxf(bm0, __shfl_xor_sync(0xffffffffu, bm0, 1));
    bm0 = fmaxf(bm0, __shfl_xor_sync(0xffffffffu, bm0, 2));
    bm1 = fmaxf(bm1, __shfl_xor_sync(0xffffffffu, bm1, 1));
    bm1 = fmaxf(bm1, __shfl_xor_sync(0xffffffffu, bm1, 2));
    const float mn0 = fmaxf(m0, bm0), mn1 = fmaxf(m1, bm1);
    // a row with no visible key so far keeps m = -inf
    const float safe0 = isfinite(mn0) ? mn0 : 0.f;
    const float safe1 = isfinite(mn1) ? mn1 : 0.f;
    const float corr0 = isfinite(m0) ? expf(m0 - safe0) : 0.f;
    const float corr1 = isfinite(m1) ? expf(m1 - safe1) : 0.f;
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p0 = isfinite(sc[j][c]) ? expf(sc[j][c] - safe0) : 0.f;
        const float p1 = isfinite(sc[j][2 + c]) ? expf(sc[j][2 + c] - safe1) : 0.f;
        sc[j][c] = p0;
        sc[j][2 + c] = p1;
        rs0 += p0;
        rs1 += p1;
      }
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }

    // ---- acc += P . V: p in bf16 as the A operand, straight from sc ----
    const __nv_bfloat16* sVb = sV + buf * G::kTile;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      // lane i addresses row i % 8 of matrix i / 8: keys kk*16 + (m % 2)*8,
      // columns (m / 2)*8 of each 16-column pair
      const int key = kk * 16 + ((lane / 8) % 2) * 8 + lane % 8;
      const int col = (lane / 16) * 8;
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sVb + key * kLd + np * 16 + col);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  // ---- out = acc / max(l, 1e-30), lse ----
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* out_rows = out + tile.q_offset;
  const bool w0 = row0 < tile.q_rows, w1 = row0 + 8 < tile.q_rows;
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    const int col = n * 8 + t * 2;
    if (w0) {
      *reinterpret_cast<uint32_t*>(out_rows + (size_t)row0 * D + col) =
          pack_bf16(o[n][0] / d0, o[n][1] / d0);
    }
    if (w1) {
      *reinterpret_cast<uint32_t*>(out_rows + (size_t)(row0 + 8) * D + col) =
          pack_bf16(o[n][2] / d1, o[n][3] / d1);
    }
  }
  if (t == 0) {
    float* lse_rows = lse + tile.q_offset / D;
    if (w0) lse_rows[row0] = l0 > 0.f ? m0 + logf(d0) : -INFINITY;
    if (w1) lse_rows[row0 + 8] = l1 > 0.f ? m1 + logf(d1) : -INFINITY;
  }
}

// ------------------------------------------------------------------------
// f32: CUDA-core products over shared-memory tiles
// ------------------------------------------------------------------------

template <int D>
struct F32Smem {
  // rows padded by 16 bytes (keeps float4 alignment, staggers banks)
  static constexpr int kLd = D + 4;        // q, k, v tiles and accumulator
  static constexpr int kLdS = kBlockK + 4;  // scores / probabilities
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + kBlockQ * kLd;
  static constexpr size_t kV = kK + kBlockK * kLd;
  static constexpr size_t kS = kV + kBlockK * kLd;
  static constexpr size_t kO = kS + kBlockQ * kLdS;
  static constexpr size_t kM = kO + kBlockQ * kLd;
  static constexpr size_t kL = kM + kBlockQ;
  static constexpr size_t kBytes = sizeof(float) * (kL + kBlockQ);
};

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              int valid) {
  load_rows_f32<D, kBlockK, F32Smem<D>::kLd, kThreads>(dst, src, valid);
}

template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int h, int h_kv, int s,
                     int causal, int window, float scale,
                     const BlockMask mask) {
  using G = F32Smem<D>;
  constexpr int kLd = G::kLd;
  constexpr int kLdS = G::kLdS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* sQ = smem + G::kQ;
  float* sK = smem + G::kK;
  float* sV = smem + G::kV;
  float* sS = smem + G::kS;
  float* sO = smem + G::kO;
  float* sM = smem + G::kM;
  float* sL = smem + G::kL;

  const bool banded = causal || window > 0;
  const Tile tile(h, h_kv, s, D, banded, window);
  const LiveTiles live = kMasked ? live_k_tiles(smem_raw + G::kBytes, tile,
                                                s, banded, mask)
                                 : LiveTiles();
  const int kt_begin = kMasked ? 0 : tile.k_tile_begin;
  const int kt_end = kMasked ? live.count - 1 : tile.k_tile_end;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile_f32<D>(sQ, q + tile.q_offset, tile.q_rows);
  for (int i = threadIdx.x; i < kBlockQ * kLd; i += kThreads) sO[i] = 0.f;
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  // softmax work split: two lanes per row, 32 columns each
  const int my_row = warp * kRowsPerWarp + lane / 2;
  const int my_half = lane % 2;
  const int q_pos = tile.q0 + my_row;
  float* s_rows = sS + warp * kRowsPerWarp * kLdS;
  float* o_rows = sO + warp * kRowsPerWarp * kLd;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = (kMasked ? live.tile(kt) : kt) * kBlockK;
    const bool cut = kMasked && live.cut(kt);
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile_f32<D>(sK, k + tile.kv_offset + (size_t)k0 * D,
                     min(kBlockK, s - k0));
    load_tile_f32<D>(sV, v + tile.kv_offset + (size_t)k0 * D,
                     min(kBlockK, s - k0));
    __syncthreads();

    // scores for this warp's 16 rows
    for (int idx = lane; idx < kRowsPerWarp * kBlockK; idx += 32) {
      const int r = idx / kBlockK;
      const int c = idx % kBlockK;
      const float* qr = sQ + (warp * kRowsPerWarp + r) * kLd;
      const float* kr = sK + c * kLd;
      float acc = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) acc = fmaf(qr[e], kr[e], acc);
      s_rows[r * kLdS + c] = acc;
    }
    __syncwarp();

    // online softmax on this lane's half row
    float* srow = sS + my_row * kLdS;
    float block_max = -INFINITY;
    for (int c = my_half * 32; c < my_half * 32 + 32; ++c) {
      const float score = visible(q_pos, k0 + c, s, banded, window, cut, mask)
                              ? srow[c] * scale : -INFINITY;
      srow[c] = score;
      block_max = fmaxf(block_max, score);
    }
    block_max = fmaxf(block_max, __shfl_xor_sync(0xffffffffu, block_max, 1));
    const float m_prev = sM[my_row];
    const float m_next = fmaxf(m_prev, block_max);
    const float safe_m = isfinite(m_next) ? m_next : 0.f;
    float row_sum = 0.f;
    for (int c = my_half * 32; c < my_half * 32 + 32; ++c) {
      const float p = isfinite(srow[c]) ? expf(srow[c] - safe_m) : 0.f;
      srow[c] = p;
      row_sum += p;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    const float correction = isfinite(m_prev) ? expf(m_prev - safe_m) : 0.f;
    float* orow = sO + my_row * kLd;
    for (int e = my_half * (D / 2); e < my_half * (D / 2) + D / 2; ++e) {
      orow[e] *= correction;
    }
    __syncwarp();  // both lanes of the row have read m_prev
    if (my_half == 0) {
      sL[my_row] = sL[my_row] * correction + row_sum;
      sM[my_row] = m_next;
    }
    __syncwarp();

    // acc += P . V for this warp's 16 rows
    for (int idx = lane; idx < kRowsPerWarp * D; idx += 32) {
      const int r = idx / D;
      const int e = idx % D;
      float acc = o_rows[r * kLd + e];
#pragma unroll 8
      for (int c = 0; c < kBlockK; ++c) {
        acc = fmaf(s_rows[r * kLdS + c], sV[c * kLd + e], acc);
      }
      o_rows[r * kLd + e] = acc;
    }
    __syncwarp();
  }
  // an empty live list ran no iteration: the zeroed sO, sL, sM come from
  // every thread
  if (kMasked) __syncthreads();

  float* out_rows = out + tile.q_offset;
  for (int idx = lane; idx < kRowsPerWarp * D; idx += 32) {
    const int r = warp * kRowsPerWarp + idx / D;
    const int e = idx % D;
    if (r < tile.q_rows) {
      out_rows[(size_t)r * D + e] = sO[r * kLd + e] / fmaxf(sL[r], 1e-30f);
    }
  }
  if (lane < kRowsPerWarp) {
    const int r = warp * kRowsPerWarp + lane;
    if (r < tile.q_rows) {
      const float l = sL[r];
      lse[tile.q_offset / D + r] =
          l > 0.f ? sM[r] + logf(fmaxf(l, 1e-30f)) : -INFINITY;
    }
  }
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const void* q, const void* k,
                   const void* v, void* out, void* lse, int b, int h,
                   int h_kv, int s, int causal, int window, float scale,
                   const BlockMask& mask, cudaStream_t stream) {
  // above 48 KB a block's shared memory needs the opt-in (per device)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), h, h_kv, s, causal, window, scale, mask);
  return cudaGetLastError();
}

template <bool kMasked>
int dispatch(const void* q, const void* k, const void* v, void* out,
             void* lse, int dtype, int b, int h, int h_kv, int s, int d,
             int causal, int window, float scale, const BlockMask& mask,
             cudaStream_t st) {
  // a masked block's live list follows its tiles in shared memory
  const size_t list = kMasked ? live_list_bytes((s + kBlockK - 1) / kBlockK) : 0;
  if (dtype == 1 && d == 64)
    return (int)launch<__nv_bfloat16>(
        flash_fwd_bf16_kernel<64, kMasked>, Bf16Smem<64>::kBytes + list, q, k,
        v, out, lse, b, h, h_kv, s, causal, window, scale, mask, st);
  if (dtype == 1 && d == 128)
    return (int)launch<__nv_bfloat16>(
        flash_fwd_bf16_kernel<128, kMasked>, Bf16Smem<128>::kBytes + list, q,
        k, v, out, lse, b, h, h_kv, s, causal, window, scale, mask, st);
  if (dtype == 0 && d == 64)
    return (int)launch<float>(
        flash_fwd_f32_kernel<64, kMasked>, F32Smem<64>::kBytes + list, q, k,
        v, out, lse, b, h, h_kv, s, causal, window, scale, mask, st);
  if (dtype == 0 && d == 128)
    return (int)launch<float>(
        flash_fwd_f32_kernel<128, kMasked>, F32Smem<128>::kBytes + list, q, k,
        v, out, lse, b, h, h_kv, s, causal, window, scale, mask, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.  scale
// is d^-1/2 as the caller rounds it to f32 (the plain version's scalar).
// Returns cudaErrorInvalidValue for a dtype, head_dim or head count the
// kernel does not take, else the launch's cudaGetLastError().
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int dtype, int b, int h,
                                int h_kv, int s, int d, int causal, int window,
                                float scale, void* stream) {
  if (b < 1 || s < 1 || h_kv < 1 || h % h_kv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch<false>(q, k, v, out, lse, dtype, b, h, h_kv, s, d, causal,
                         window, scale, BlockMask{},
                         static_cast<cudaStream_t>(stream));
}

// The block-sparse forward: the arguments of flash_fwd_launch (window must
// be 0) and the mask's: bits [s / block_q, n_kblocks] uint8 (nonzero keeps
// the block), block_q, block_k.
extern "C" int flash_fwd_block_sparse_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* bits, int n_kblocks, int block_q, int block_k, int dtype,
    int b, int h, int h_kv, int s, int d, int causal, int window, float scale,
    void* stream) {
  BlockMask mask;
  if (b < 1 || s < 1 || h_kv < 1 || h % h_kv != 0 ||
      !make_block_mask(bits, n_kblocks, block_q, block_k, s, window,
                       &mask)) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch<true>(q, k, v, out, lse, dtype, b, h, h_kv, s, d, causal,
                        window, scale, mask,
                        static_cast<cudaStream_t>(stream));
}
