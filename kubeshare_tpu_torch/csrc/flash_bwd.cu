// Flash-attention backward for Hopper (sm_90a): the dK/dV kernel and the
// dQ kernel.
//
// Replaces kubeshare_tpu/ops/attention.py:_flash_bwd_dkv_kernel and
// _flash_bwd_dq_kernel (the Pallas backward launched by _flash_backward).
// Both compute what kubeshare_tpu_torch/ops/attention.py:
// flash_backward_reference computes, from q, k, v, dO, the forward's lse
// and delta = rowsum(dO o out) (f32, computed by the caller):
//   p  = exp(q . k^T * d^-1/2 - lse) in f32, 0 outside the causal /
//        sliding-window band and past the sequence end;
//   dv = p^T . dO, p rounded to dO's dtype first (f32 accumulation);
//   dp = dO . v^T in f32;  ds = p o (dp - delta);
//   dk = d^-1/2 * ds^T . q,  dq = d^-1/2 * ds . k, ds rounded to q's / k's
//        dtype first; results in k's / v's / q's dtype.
//
// What bounds them.  At the training shape (b=2, h=8, s=2048, d=128, bf16,
// causal) the band holds 2.10 M query-key pairs per head; dK/dV does four
// products on each (8 d FLOPs), 34.4 GFLOP, 34.8 us at 989 TFLOP/s, against
// 50.6 MB of traffic (q, k, v, dO, lse, delta read, dk, dv written), 15.1 us
// at 3.35 TB/s; dQ does three (6 d FLOPs), 25.8 GFLOP, 26.1 us, against
// 42.2 MB, 12.6 us.  Both are bound by operations.
//
// What the design does about it.  The s x s scores and probabilities never
// reach device memory: each block recomputes its tiles of p from lse.
//   dK/dV: one block per (batch, KV head, 64-row K tile) keeps its K and V
//   tiles and the dk, dv accumulators on chip while it sweeps, in order,
//   every query head of its GQA group and every Q tile the band lets it
//   see (from the diagonal for causal, up to k_end + window - 1 for a
//   window).  The group's sum happens in the accumulator, so dk/dv are
//   written once at KV-head resolution: no atomics, no group-sum pass, and
//   the result does not depend on scheduling.
//   dQ: one block per (batch, head, 64-row Q tile) sweeps the K tiles of
//   its band (the Pallas grid's sequential innermost axis becomes a loop
//   inside the block, since Hopper runs blocks in parallel and in no
//   order).
// bf16 (the model's path): four warps, each owning 16 rows of the block's
// tile, run every product on the tensor cores with mma.sync m16n8k16 (f32
// accumulate).  dK/dV computes S^T = K . Q^T and dP^T = V . dO^T, so p^T
// and ds^T come out in the accumulator layout, which is the A-operand
// layout of p^T . dO and ds^T . Q: they go from one product to the next in
// registers.  dQ computes S and dP the forward's way and feeds ds straight
// into ds . K.  The B operands that are read along the key axis (dO, Q in
// dK/dV; K in dQ) come through ldmatrix.trans.  The swept tiles are
// double-buffered with cp.async.
// Registers: each lane holds D/8 x 4 f32 of dk and as many of dv.  At
// head_dim 128 that is 128 registers, so dK/dV sweeps 32-query tiles there
// (64 at head_dim 64): the score and dP tiles then take 32 more, and the
// K/V A fragments are re-read from shared memory for each product rather
// than held, which keeps the kernel under the 255-register cap without
// spilling.  wgmma, TMA and warp specialisation are left for later work.
//
// f32: the products run on the CUDA cores (the tensor cores would round
// f32 to TF32) over shared-memory tiles and accumulators; this path exists
// for f32 configs and is not tuned.
//
// Ragged lengths: rows past the sequence end are loaded as zeros, their
// pairs are masked (p = 0), and they are never written.
//
// Block-sparse mode (kMasked = true; the same Pallas kernels with
// has_mask=True, launched for block_sparse_attention's gradient): a pair
// is visible when the caller's [s / block_q, s / block_k] mask keeps its
// block and, if causal, the key is not after the query.  JAX refines the
// mask to its backward blocks by repetition; here the mask's blocks and
// the kernels' tiles are independent, so each block first lists, in
// shared memory, the tiles that hold a visible pair (BlockMask::
// tile_state, build_live_tiles) and sweeps that list: dK/dV the (query
// head, live Q step) items of its K tile, dQ the live K tiles of its Q
// tile, each prefetching the next listed one.  A tile the
// mask cuts through takes the pair-by-pair test in visible(), so p = 0 on
// every masked pair and a row with no visible key (lse = -inf) never
// reaches exp().  The dense instantiations read no mask and compile as
// before.
//
// Layout: q, dO, dq [b, h, s, d]; k, v, dk, dv [b, h_kv, s, d]; lse, delta
// [b, h, s, 1] f32; all contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kBlockK = 64;  // K rows of a dK/dV block; K tile of the dQ sweep
constexpr int kBlockQ = 64;  // Q rows of a dQ block
constexpr int kWarps = 4;    // warp w owns rows [16w, 16w + 16) of the block
constexpr int kThreads = kWarps * 32;

// `cut`: the tile straddles mask blocks, so the mask is tested too
__device__ __forceinline__ bool visible(int q_pos, int k_pos, int s,
                                        bool banded, int window, bool cut,
                                        const BlockMask& mask) {
  bool ok = q_pos < s && k_pos < s;
  if (banded) ok = ok && q_pos >= k_pos;
  if (window > 0) ok = ok && (q_pos - k_pos) < window;
  if (cut) ok = ok && mask.keeps(q_pos, k_pos, s);
  return ok;
}

// The Q tiles (of `bq` rows) a K tile [k0, k_last] meets in the band.
struct QSweep {
  int begin, count;
  __device__ QSweep(int k0, int k_last, int s, int bq, bool banded,
                    int window) {
    begin = banded ? k0 / bq : 0;
    const int last_q = window > 0 ? min(s - 1, k_last + window - 1) : s - 1;
    count = last_q / bq - begin + 1;
  }
};

// The K tiles a Q tile [q0, q_last] meets in the band.
struct KSweep {
  int begin, end;  // inclusive
  __device__ KSweep(int q0, int q_last, int s, bool banded, int window) {
    end = (banded ? q_last : s - 1) / kBlockK;
    begin = window > 0 ? max(q0 - window + 1, 0) / kBlockK : 0;
  }
};

// A masked dK/dV block's live list of Q steps (`rows` queries each) for
// its K tile at k0, built in the shared memory at `list`
__device__ __forceinline__ LiveTiles live_q_steps(unsigned char* list,
                                                  int rows, int k0, int s,
                                                  bool causal,
                                                  const BlockMask& mask) {
  return build_live_tiles<kThreads>(
      reinterpret_cast<int*>(list), (s + rows - 1) / rows, [&](int step) {
        return mask.tile_state(step * rows, (step + 1) * rows, k0,
                               k0 + kBlockK, s, causal);
      });
}

// A masked dQ block's live list of K tiles for its Q tile at q0
__device__ __forceinline__ LiveTiles live_k_tiles(unsigned char* list,
                                                  int q0, int s, bool causal,
                                                  const BlockMask& mask) {
  return build_live_tiles<kThreads>(
      reinterpret_cast<int*>(list), (s + kBlockK - 1) / kBlockK, [&](int kt) {
        return mask.tile_state(q0, q0 + kBlockQ, kt * kBlockK,
                               (kt + 1) * kBlockK, s, causal);
      });
}

// [ROWS] f32 row values (lse or delta) into shared memory; rows at or past
// `valid` are zeros (their pairs are masked).
template <int ROWS>
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               int valid) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool in = i < valid;
    cp_async_4(dst + i, src + (in ? i : 0), in ? 4 : 0);
  }
}

// ------------------------------------------------------------------------
// bf16 dK/dV
// ------------------------------------------------------------------------

template <int D>
struct DkvBf16 {
  static constexpr int kBQ = D == 64 ? 64 : 32;  // query columns per step
  // rows padded by 16 bytes: fragment loads of 8 rows x 16 bytes then fall
  // on 32 distinct banks
  static constexpr int kLd = D + 8;
  static constexpr int kKTile = kBlockK * kLd;
  static constexpr int kQTile = kBQ * kLd;
  // K, V, then Q[2], dO[2] (bf16), then lse[2], delta[2] (f32)
  static constexpr size_t kHalfBytes =
      sizeof(__nv_bfloat16) * (2 * kKTile + 4 * kQTile);
  static constexpr size_t kBytes = kHalfBytes + sizeof(float) * 4 * kBQ;
};

template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int h, int h_kv,
                          int s, int causal, int window, float scale,
                          const BlockMask mask) {
  using G = DkvBf16<D>;
  constexpr int kBQ = G::kBQ;
  constexpr int kLd = G::kLd;
  constexpr int kNTiles = kBQ / 8;  // score n-tiles (query columns)
  constexpr int kDTiles = D / 8;    // accumulator n-tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + G::kKTile;
  __nv_bfloat16* sQ = sV + G::kKTile;       // two buffers
  __nv_bfloat16* sdO = sQ + 2 * G::kQTile;  // two buffers
  float* sLse = reinterpret_cast<float*>(smem_raw + G::kHalfBytes);  // two
  float* sDelta = sLse + 2 * kBQ;                                    // two

  const int kv_head = blockIdx.y;
  const int batch = blockIdx.z;
  const int group = h / h_kv;
  const bool banded = causal || window > 0;
  const int k0 = blockIdx.x * kBlockK;  // tile 0, with the longest sweep, first
  const int k_rows = min(kBlockK, s - k0);
  // the Q steps of each query head: the band's (dense), or the live list
  // of this K tile (masked)
  const QSweep sweep(k0, k0 + k_rows - 1, s, kBQ, banded, window);
  const LiveTiles live =
      kMasked ? live_q_steps(smem_raw + G::kBytes, kBQ, k0, s, banded, mask)
              : LiveTiles();
  const int steps = kMasked ? live.count : sweep.count;
  const int n_items = group * steps;  // (query head, Q tile) pairs
  const size_t kv_offset = ((size_t)(batch * h_kv + kv_head) * s + k0) * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // fragment column pair
  const int krow0 = warp * 16 + g;  // this lane's K rows: krow0, krow0 + 8
  const int k_pos0 = k0 + krow0;
  const int k_pos1 = k_pos0 + 8;

  auto item_q0 = [&](int it) {
    return (kMasked ? live.tile(it % steps) : sweep.begin + it % steps) * kBQ;
  };
  auto load_item = [&](int it, int buf) {
    const int head = kv_head * group + it / steps;
    const int q0 = item_q0(it);
    const size_t row = (size_t)(batch * h + head) * s + q0;
    const int valid = min(kBQ, s - q0);
    load_rows_async<D, kBQ, kLd, kThreads>(sQ + buf * G::kQTile, q + row * D,
                                           valid);
    load_rows_async<D, kBQ, kLd, kThreads>(sdO + buf * G::kQTile,
                                           dout + row * D, valid);
    load_vec_async<kBQ>(sLse + buf * kBQ, lse + row, valid);
    load_vec_async<kBQ>(sDelta + buf * kBQ, delta + row, valid);
  };

  load_rows_async<D, kBlockK, kLd, kThreads>(sK, k + kv_offset, k_rows);
  load_rows_async<D, kBlockK, kLd, kThreads>(sV, v + kv_offset, k_rows);
  if (n_items > 0) load_item(0, 0);
  cp_async_commit();

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;
  }

  for (int it = 0; it < n_items; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_items) {  // prefetch the next item into the other buffer
      load_item(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int q0 = item_q0(it);
    const bool cut = kMasked && live.cut(it % steps);
    const __nv_bfloat16* sQb = sQ + buf * G::kQTile;
    const __nv_bfloat16* sdOb = sdO + buf * G::kQTile;
    const float* lse_b = sLse + buf * kBQ;
    const float* delta_b = sDelta + buf * kBQ;

    // ---- S^T = K . Q^T and dP^T = V . dO^T: 16 K rows x kBQ queries ----
    float st[kNTiles][4], dpt[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) st[j][c] = dpt[j][c] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < D / 16; ++e) {
      uint32_t ka[4], va[4];
      load_a_frag(ka, sK + krow0 * kLd + t * 2 + e * 16, kLd);
      load_a_frag(va, sV + krow0 * kLd + t * 2 + e * 16, kLd);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const __nv_bfloat16* qr = sQb + (j * 8 + g) * kLd + t * 2 + e * 16;
        mma_bf16(st[j], ka, ld_u32(qr), ld_u32(qr + 8));
        const __nv_bfloat16* dr = sdOb + (j * 8 + g) * kLd + t * 2 + e * 16;
        mma_bf16(dpt[j], va, ld_u32(dr), ld_u32(dr + 8));
      }
    }

    // ---- p^T = exp(S^T scale - lse), ds^T = p^T o (dP^T - delta) ----
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j * 8 + t * 2 + c;
        const int q_pos = q0 + col;
        const float l = lse_b[col];
        const float dl = delta_b[col];
        const float p0 = visible(q_pos, k_pos0, s, banded, window, cut, mask)
                             ? expf(st[j][c] * scale - l) : 0.f;
        const float p1 = visible(q_pos, k_pos1, s, banded, window, cut, mask)
                             ? expf(st[j][2 + c] * scale - l) : 0.f;
        st[j][c] = p0;
        st[j][2 + c] = p1;
        dpt[j][c] = p0 * (dpt[j][c] - dl);
        dpt[j][2 + c] = p1 * (dpt[j][2 + c] - dl);
      }
    }

    // ---- dV += p^T . dO, dK += ds^T . Q: A operands straight from above ----
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      da[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      da[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      da[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      da[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
      // lane i addresses row i % 8 of matrix i / 8: query rows
      // kk*16 + (m % 2)*8, columns (m / 2)*8 of each 16-column pair
      const int row = kk * 16 + ((lane / 8) % 2) * 8 + lane % 8;
      const int col = (lane / 16) * 8;
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sdOb + row * kLd + np * 16 + col);
        mma_bf16(dv_acc[2 * np], pa, b[0], b[1]);
        mma_bf16(dv_acc[2 * np + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, sQb + row * kLd + np * 16 + col);
        mma_bf16(dk_acc[2 * np], da, b[0], b[1]);
        mma_bf16(dk_acc[2 * np + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }
  if (kMasked) cp_async_wait<0>();  // a K tile with no live item: K, V

  // ---- dk = scale * acc, dv = acc, rows of the tile inside the sequence ----
  __nv_bfloat16* dk_rows = dk + kv_offset;
  __nv_bfloat16* dv_rows = dv + kv_offset;
  const bool w0 = krow0 < k_rows, w1 = krow0 + 8 < k_rows;
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    const int col = n * 8 + t * 2;
    if (w0) {
      *reinterpret_cast<uint32_t*>(dk_rows + (size_t)krow0 * D + col) =
          pack_bf16(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv_rows + (size_t)krow0 * D + col) =
          pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    }
    if (w1) {
      *reinterpret_cast<uint32_t*>(dk_rows + (size_t)(krow0 + 8) * D + col) =
          pack_bf16(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv_rows + (size_t)(krow0 + 8) * D + col) =
          pack_bf16(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// ------------------------------------------------------------------------
// bf16 dQ
// ------------------------------------------------------------------------

template <int D>
struct DqBf16 {
  static constexpr int kLd = D + 8;
  static constexpr int kTile = kBlockK * kLd;  // kBlockQ == kBlockK rows
  // Q, dO, then K[2], V[2]
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * 6 * kTile;
};

template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int h, int h_kv,
                         int s, int causal, int window, float scale,
                         const BlockMask mask) {
  using G = DqBf16<D>;
  constexpr int kLd = G::kLd;
  constexpr int kNTiles = kBlockK / 8;  // score n-tiles (keys)
  constexpr int kDTiles = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + G::kTile;
  __nv_bfloat16* sK = sdO + G::kTile;     // two buffers
  __nv_bfloat16* sV = sK + 2 * G::kTile;  // two buffers

  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (h / h_kv);
  const bool banded = causal || window > 0;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int q0 = q_tile * kBlockQ;
  const int q_rows = min(kBlockQ, s - q0);
  // the K tiles to visit, kt in [kt_begin, kt_end]: tile kt of the band
  // (dense), or entry kt of this Q tile's live list (masked)
  const KSweep sweep(q0, q0 + q_rows - 1, s, banded, window);
  const LiveTiles live =
      kMasked ? live_k_tiles(smem_raw + G::kBytes, q0, s, banded, mask)
              : LiveTiles();
  const int kt_begin = kMasked ? 0 : sweep.begin;
  const int kt_end = kMasked ? live.count - 1 : sweep.end;
  auto k_start = [&](int kt) { return (kMasked ? live.tile(kt) : kt) * kBlockK; };
  const size_t q_row = (size_t)(batch * h + head) * s + q0;
  const __nv_bfloat16* k_head = k + (size_t)(batch * h_kv + kv_head) * s * D;
  const __nv_bfloat16* v_head = v + (size_t)(batch * h_kv + kv_head) * s * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int q_pos0 = q0 + row0;
  const int q_pos1 = q_pos0 + 8;
  // rows past the end are masked; read nothing for them
  const float l0 = q_pos0 < s ? lse[q_row + row0] : 0.f;
  const float l1 = q_pos1 < s ? lse[q_row + row0 + 8] : 0.f;
  const float dl0 = q_pos0 < s ? delta[q_row + row0] : 0.f;
  const float dl1 = q_pos1 < s ? delta[q_row + row0 + 8] : 0.f;

  if (!kMasked || live.count > 0) {  // an empty live list loads nothing
    load_rows_async<D, kBlockQ, kLd, kThreads>(sQ, q + q_row * D, q_rows);
    load_rows_async<D, kBlockQ, kLd, kThreads>(sdO, dout + q_row * D, q_rows);
    {
      const int k0 = k_start(kt_begin);
      load_rows_async<D, kBlockK, kLd, kThreads>(sK, k_head + (size_t)k0 * D,
                                                 min(kBlockK, s - k0));
      load_rows_async<D, kBlockK, kLd, kThreads>(sV, v_head + (size_t)k0 * D,
                                                 min(kBlockK, s - k0));
    }
    cp_async_commit();
  }

  float dq_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dq_acc[n][c] = 0.f;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    const int k0 = k_start(kt);
    const bool cut = kMasked && live.cut(kt);
    if (kt < kt_end) {  // prefetch the next K/V tiles into the other buffer
      const int k1 = kMasked ? k_start(kt + 1) : k0 + kBlockK;
      load_rows_async<D, kBlockK, kLd, kThreads>(
          sK + (buf ^ 1) * G::kTile, k_head + (size_t)k1 * D,
          min(kBlockK, s - k1));
      load_rows_async<D, kBlockK, kLd, kThreads>(
          sV + (buf ^ 1) * G::kTile, v_head + (size_t)k1 * D,
          min(kBlockK, s - k1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* sKb = sK + buf * G::kTile;
    const __nv_bfloat16* sVb = sV + buf * G::kTile;

    // ---- S = Q . K^T and dP = dO . V^T: 16 query rows x 64 keys ----
    float sc[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] = dp[j][c] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < D / 16; ++e) {
      uint32_t qa[4], da[4];
      load_a_frag(qa, sQ + row0 * kLd + t * 2 + e * 16, kLd);
      load_a_frag(da, sdO + row0 * kLd + t * 2 + e * 16, kLd);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const __nv_bfloat16* kr = sKb + (j * 8 + g) * kLd + t * 2 + e * 16;
        mma_bf16(sc[j], qa, ld_u32(kr), ld_u32(kr + 8));
        const __nv_bfloat16* vr = sVb + (j * 8 + g) * kLd + t * 2 + e * 16;
        mma_bf16(dp[j], da, ld_u32(vr), ld_u32(vr + 8));
      }
    }

    // ---- p = exp(S scale - lse), ds = p o (dP - delta), into sc ----
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k_pos = k0 + j * 8 + t * 2 + c;
        const float p0 = visible(q_pos0, k_pos, s, banded, window, cut, mask)
                             ? expf(sc[j][c] * scale - l0) : 0.f;
        const float p1 = visible(q_pos1, k_pos, s, banded, window, cut, mask)
                             ? expf(sc[j][2 + c] * scale - l1) : 0.f;
        sc[j][c] = p0 * (dp[j][c] - dl0);
        sc[j][2 + c] = p1 * (dp[j][2 + c] - dl1);
      }
    }

    // ---- dQ += ds . K: ds in bf16 as the A operand, straight from sc ----
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const int key = kk * 16 + ((lane / 8) % 2) * 8 + lane % 8;
      const int col = (lane / 16) * 8;
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sKb + key * kLd + np * 16 + col);
        mma_bf16(dq_acc[2 * np], a, b[0], b[1]);
        mma_bf16(dq_acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  __nv_bfloat16* dq_rows = dq + q_row * D;
  const bool w0 = row0 < q_rows, w1 = row0 + 8 < q_rows;
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    const int col = n * 8 + t * 2;
    if (w0) {
      *reinterpret_cast<uint32_t*>(dq_rows + (size_t)row0 * D + col) =
          pack_bf16(dq_acc[n][0] * scale, dq_acc[n][1] * scale);
    }
    if (w1) {
      *reinterpret_cast<uint32_t*>(dq_rows + (size_t)(row0 + 8) * D + col) =
          pack_bf16(dq_acc[n][2] * scale, dq_acc[n][3] * scale);
    }
  }
}

// ------------------------------------------------------------------------
// f32 dK/dV: CUDA-core products over shared-memory tiles
// ------------------------------------------------------------------------

template <int D>
struct DkvF32 {
  static constexpr int kBQ = 32;     // query rows per step
  static constexpr int kLd = D + 4;  // rows padded by 16 bytes
  static constexpr int kLdP = kBQ + 4;
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + kBlockK * kLd;
  static constexpr size_t kDK = kV + kBlockK * kLd;
  static constexpr size_t kDV = kDK + kBlockK * kLd;
  static constexpr size_t kQ = kDV + kBlockK * kLd;
  static constexpr size_t kDO = kQ + kBQ * kLd;
  static constexpr size_t kP = kDO + kBQ * kLd;       // p^T [64, kBQ]
  static constexpr size_t kDS = kP + kBlockK * kLdP;  // ds^T [64, kBQ]
  static constexpr size_t kLse = kDS + kBlockK * kLdP;
  static constexpr size_t kDelta = kLse + kBQ;
  static constexpr size_t kBytes = sizeof(float) * (kDelta + kBQ);
};

template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int h, int h_kv, int s, int causal, int window,
                         float scale, const BlockMask mask) {
  using G = DkvF32<D>;
  constexpr int kBQ = G::kBQ;
  constexpr int kLd = G::kLd;
  constexpr int kLdP = G::kLdP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* sK = smem + G::kK;
  float* sV = smem + G::kV;
  float* sDK = smem + G::kDK;
  float* sDV = smem + G::kDV;
  float* sQ = smem + G::kQ;
  float* sdO = smem + G::kDO;
  float* sP = smem + G::kP;
  float* sDS = smem + G::kDS;
  float* sLse = smem + G::kLse;
  float* sDelta = smem + G::kDelta;

  const int kv_head = blockIdx.y;
  const int batch = blockIdx.z;
  const int group = h / h_kv;
  const bool banded = causal || window > 0;
  const int k0 = blockIdx.x * kBlockK;
  const int k_rows = min(kBlockK, s - k0);
  const QSweep sweep(k0, k0 + k_rows - 1, s, kBQ, banded, window);
  const LiveTiles live =
      kMasked ? live_q_steps(smem_raw + G::kBytes, kBQ, k0, s, banded, mask)
              : LiveTiles();
  const int steps = kMasked ? live.count : sweep.count;
  const size_t kv_offset = ((size_t)(batch * h_kv + kv_head) * s + k0) * D;

  load_rows_f32<D, kBlockK, kLd, kThreads>(sK, k + kv_offset, k_rows);
  load_rows_f32<D, kBlockK, kLd, kThreads>(sV, v + kv_offset, k_rows);
  for (int i = threadIdx.x; i < kBlockK * kLd; i += kThreads) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }

  for (int it = 0; it < group * steps; ++it) {
    const int head = kv_head * group + it / steps;
    const int q0 =
        (kMasked ? live.tile(it % steps) : sweep.begin + it % steps) * kBQ;
    const bool cut = kMasked && live.cut(it % steps);
    const size_t row = (size_t)(batch * h + head) * s + q0;
    const int valid = min(kBQ, s - q0);
    __syncthreads();  // every thread is done with the previous Q tile
    load_rows_f32<D, kBQ, kLd, kThreads>(sQ, q + row * D, valid);
    load_rows_f32<D, kBQ, kLd, kThreads>(sdO, dout + row * D, valid);
    for (int i = threadIdx.x; i < kBQ; i += kThreads) {
      sLse[i] = i < valid ? lse[row + i] : 0.f;
      sDelta[i] = i < valid ? delta[row + i] : 0.f;
    }
    __syncthreads();

    // p^T and ds^T for the 64 x kBQ pairs
    for (int idx = threadIdx.x; idx < kBlockK * kBQ; idx += kThreads) {
      const int r = idx / kBQ;  // key row
      const int c = idx % kBQ;  // query column
      const float* kr = sK + r * kLd;
      const float* vr = sV + r * kLd;
      const float* qr = sQ + c * kLd;
      const float* dr = sdO + c * kLd;
      float sc = 0.f, dp = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) {
        sc = fmaf(kr[e], qr[e], sc);
        dp = fmaf(vr[e], dr[e], dp);
      }
      const float p = visible(q0 + c, k0 + r, s, banded, window, cut, mask)
                          ? expf(sc * scale - sLse[c]) : 0.f;
      sP[r * kLdP + c] = p;
      sDS[r * kLdP + c] = p * (dp - sDelta[c]);
    }
    __syncthreads();

    // dV += p^T . dO, dK += ds^T . Q
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D;
      const int e = idx % D;
      float acc_v = sDV[r * kLd + e];
      float acc_k = sDK[r * kLd + e];
#pragma unroll 8
      for (int c = 0; c < kBQ; ++c) {
        acc_v = fmaf(sP[r * kLdP + c], sdO[c * kLd + e], acc_v);
        acc_k = fmaf(sDS[r * kLdP + c], sQ[c * kLd + e], acc_k);
      }
      sDV[r * kLd + e] = acc_v;
      sDK[r * kLd + e] = acc_k;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
    const int r = idx / D;
    const int e = idx % D;
    if (r < k_rows) {
      dk[kv_offset + (size_t)r * D + e] = sDK[r * kLd + e] * scale;
      dv[kv_offset + (size_t)r * D + e] = sDV[r * kLd + e];
    }
  }
}

// ------------------------------------------------------------------------
// f32 dQ
// ------------------------------------------------------------------------

template <int D>
struct DqF32 {
  static constexpr int kLd = D + 4;
  static constexpr int kLdS = kBlockK + 4;
  static constexpr size_t kQ = 0;
  static constexpr size_t kDO = kQ + kBlockQ * kLd;
  static constexpr size_t kDQ = kDO + kBlockQ * kLd;
  static constexpr size_t kK = kDQ + kBlockQ * kLd;
  static constexpr size_t kV = kK + kBlockK * kLd;
  static constexpr size_t kDS = kV + kBlockK * kLd;  // ds [64, 64]
  static constexpr size_t kLse = kDS + kBlockQ * kLdS;
  static constexpr size_t kDelta = kLse + kBlockQ;
  static constexpr size_t kBytes = sizeof(float) * (kDelta + kBlockQ);
};

template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int h, int h_kv, int s,
                        int causal, int window, float scale,
                        const BlockMask mask) {
  using G = DqF32<D>;
  constexpr int kLd = G::kLd;
  constexpr int kLdS = G::kLdS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* sQ = smem + G::kQ;
  float* sdO = smem + G::kDO;
  float* sDQ = smem + G::kDQ;
  float* sK = smem + G::kK;
  float* sV = smem + G::kV;
  float* sDS = smem + G::kDS;
  float* sLse = smem + G::kLse;
  float* sDelta = smem + G::kDelta;

  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (h / h_kv);
  const bool banded = causal || window > 0;
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int q0 = q_tile * kBlockQ;
  const int q_rows = min(kBlockQ, s - q0);
  const KSweep sweep(q0, q0 + q_rows - 1, s, banded, window);
  const LiveTiles live =
      kMasked ? live_k_tiles(smem_raw + G::kBytes, q0, s, banded, mask)
              : LiveTiles();
  const int kt_begin = kMasked ? 0 : sweep.begin;
  const int kt_end = kMasked ? live.count - 1 : sweep.end;
  const size_t q_row = (size_t)(batch * h + head) * s + q0;
  const float* k_head = k + (size_t)(batch * h_kv + kv_head) * s * D;
  const float* v_head = v + (size_t)(batch * h_kv + kv_head) * s * D;

  load_rows_f32<D, kBlockQ, kLd, kThreads>(sQ, q + q_row * D, q_rows);
  load_rows_f32<D, kBlockQ, kLd, kThreads>(sdO, dout + q_row * D, q_rows);
  for (int i = threadIdx.x; i < kBlockQ * kLd; i += kThreads) sDQ[i] = 0.f;
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    sLse[i] = i < q_rows ? lse[q_row + i] : 0.f;
    sDelta[i] = i < q_rows ? delta[q_row + i] : 0.f;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = (kMasked ? live.tile(kt) : kt) * kBlockK;
    const bool cut = kMasked && live.cut(kt);
    __syncthreads();  // every thread is done with the previous K/V tiles
    load_rows_f32<D, kBlockK, kLd, kThreads>(sK, k_head + (size_t)k0 * D,
                                             min(kBlockK, s - k0));
    load_rows_f32<D, kBlockK, kLd, kThreads>(sV, v_head + (size_t)k0 * D,
                                             min(kBlockK, s - k0));
    __syncthreads();

    for (int idx = threadIdx.x; idx < kBlockQ * kBlockK; idx += kThreads) {
      const int r = idx / kBlockK;  // query row
      const int c = idx % kBlockK;  // key column
      const float* qr = sQ + r * kLd;
      const float* dr = sdO + r * kLd;
      const float* kr = sK + c * kLd;
      const float* vr = sV + c * kLd;
      float sc = 0.f, dp = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) {
        sc = fmaf(qr[e], kr[e], sc);
        dp = fmaf(dr[e], vr[e], dp);
      }
      const float p = visible(q0 + r, k0 + c, s, banded, window, cut, mask)
                          ? expf(sc * scale - sLse[r]) : 0.f;
      sDS[r * kLdS + c] = p * (dp - sDelta[r]);
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < kBlockQ * D; idx += kThreads) {
      const int r = idx / D;
      const int e = idx % D;
      float acc = sDQ[r * kLd + e];
#pragma unroll 8
      for (int c = 0; c < kBlockK; ++c) {
        acc = fmaf(sDS[r * kLdS + c], sK[c * kLd + e], acc);
      }
      sDQ[r * kLd + e] = acc;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D;
    const int e = idx % D;
    if (r < q_rows) dq[(q_row + r) * D + e] = sDQ[r * kLd + e] * scale;
  }
}

// above 48 KB a block's shared memory needs the opt-in (per device)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename Kernel>
cudaError_t launch_dkv(Kernel kernel, size_t smem, const void* q,
                       const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int b, int h, int h_kv, int s, int causal, int window,
                       float scale, const BlockMask& mask,
                       cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlockK - 1) / kBlockK, h_kv, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), h, h_kv, s, causal, window,
      scale, mask);
  return cudaGetLastError();
}

template <typename T, typename Kernel>
cudaError_t launch_dq(Kernel kernel, size_t smem, const void* q,
                      const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int b,
                      int h, int h_kv, int s, int causal, int window,
                      float scale, const BlockMask& mask,
                      cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), h, h_kv, s, causal, window, scale, mask);
  return cudaGetLastError();
}

bool bad_shape(int b, int h, int h_kv, int s) {
  return b < 1 || s < 1 || h_kv < 1 || h % h_kv != 0;
}

template <bool kMasked>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int dtype, int b, int h, int h_kv, int s,
                 int d, int causal, int window, float scale,
                 const BlockMask& mask, cudaStream_t st) {
  // a masked block's live list of Q steps follows its tiles in shared
  // memory
  auto list = [&](int rows) {
    return kMasked ? live_list_bytes((s + rows - 1) / rows) : 0;
  };
  if (dtype == 1 && d == 64)
    return (int)launch_dkv<__nv_bfloat16>(
        flash_bwd_dkv_bf16_kernel<64, kMasked>,
        DkvBf16<64>::kBytes + list(DkvBf16<64>::kBQ), q, k, v, dout, lse,
        delta, dk, dv, b, h, h_kv, s, causal, window, scale, mask, st);
  if (dtype == 1 && d == 128)
    return (int)launch_dkv<__nv_bfloat16>(
        flash_bwd_dkv_bf16_kernel<128, kMasked>,
        DkvBf16<128>::kBytes + list(DkvBf16<128>::kBQ), q, k, v, dout, lse,
        delta, dk, dv, b, h, h_kv, s, causal, window, scale, mask, st);
  if (dtype == 0 && d == 64)
    return (int)launch_dkv<float>(
        flash_bwd_dkv_f32_kernel<64, kMasked>,
        DkvF32<64>::kBytes + list(DkvF32<64>::kBQ), q, k, v, dout, lse,
        delta, dk, dv, b, h, h_kv, s, causal, window, scale, mask, st);
  if (dtype == 0 && d == 128)
    return (int)launch_dkv<float>(
        flash_bwd_dkv_f32_kernel<128, kMasked>,
        DkvF32<128>::kBytes + list(DkvF32<128>::kBQ), q, k, v, dout, lse,
        delta, dk, dv, b, h, h_kv, s, causal, window, scale, mask, st);
  return (int)cudaErrorInvalidValue;
}

template <bool kMasked>
int dispatch_dq(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int dtype, int b, int h, int h_kv, int s, int d,
                int causal, int window, float scale, const BlockMask& mask,
                cudaStream_t st) {
  // a masked block's live list of K tiles follows its tiles in shared
  // memory
  const size_t list = kMasked ? live_list_bytes((s + kBlockK - 1) / kBlockK) : 0;
  if (dtype == 1 && d == 64)
    return (int)launch_dq<__nv_bfloat16>(
        flash_bwd_dq_bf16_kernel<64, kMasked>, DqBf16<64>::kBytes + list, q,
        k, v, dout, lse, delta, dq, b, h, h_kv, s, causal, window, scale, mask,
        st);
  if (dtype == 1 && d == 128)
    return (int)launch_dq<__nv_bfloat16>(
        flash_bwd_dq_bf16_kernel<128, kMasked>, DqBf16<128>::kBytes + list, q,
        k, v, dout, lse, delta, dq, b, h, h_kv, s, causal, window, scale, mask,
        st);
  if (dtype == 0 && d == 64)
    return (int)launch_dq<float>(
        flash_bwd_dq_f32_kernel<64, kMasked>, DqF32<64>::kBytes + list, q, k,
        v, dout, lse, delta, dq, b, h, h_kv, s, causal, window, scale, mask,
        st);
  if (dtype == 0 && d == 128)
    return (int)launch_dq<float>(
        flash_bwd_dq_f32_kernel<128, kMasked>, DqF32<128>::kBytes + list, q,
        k, v, dout, lse, delta, dq, b, h, h_kv, s, causal, window, scale, mask,
        st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.  scale
// is d^-1/2 as the caller rounds it to f32.  Each returns
// cudaErrorInvalidValue for a dtype, head_dim or head count the kernel
// does not take, else the launch's cudaGetLastError().

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int dtype, int b,
                                    int h, int h_kv, int s, int d, int causal,
                                    int window, float scale, void* stream) {
  if (bad_shape(b, h, h_kv, s)) return (int)cudaErrorInvalidValue;
  return dispatch_dkv<false>(q, k, v, dout, lse, delta, dk, dv, dtype, b, h,
                             h_kv, s, d, causal, window, scale, BlockMask{},
                             static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int dtype, int b, int h,
                                   int h_kv, int s, int d, int causal,
                                   int window, float scale, void* stream) {
  if (bad_shape(b, h, h_kv, s)) return (int)cudaErrorInvalidValue;
  return dispatch_dq<false>(q, k, v, dout, lse, delta, dq, dtype, b, h, h_kv,
                            s, d, causal, window, scale, BlockMask{},
                            static_cast<cudaStream_t>(stream));
}

// The block-sparse backward: the dense launchers' arguments (window must
// be 0) and the mask's: bits [s / block_q, n_kblocks] uint8 (nonzero
// keeps the block), block_q, block_k.

extern "C" int flash_bwd_dkv_block_sparse_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* bits,
    int n_kblocks, int block_q, int block_k, int dtype, int b, int h,
    int h_kv, int s, int d, int causal, int window, float scale,
    void* stream) {
  BlockMask mask;
  if (bad_shape(b, h, h_kv, s) ||
      !make_block_mask(bits, n_kblocks, block_q, block_k, s, window,
                       &mask)) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, dtype, b, h,
                            h_kv, s, d, causal, window, scale, mask,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq_block_sparse_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* bits,
    int n_kblocks, int block_q, int block_k, int dtype, int b, int h,
    int h_kv, int s, int d, int causal, int window, float scale,
    void* stream) {
  BlockMask mask;
  if (bad_shape(b, h, h_kv, s) ||
      !make_block_mask(bits, n_kblocks, block_q, block_k, s, window,
                       &mask)) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_dq<true>(q, k, v, dout, lse, delta, dq, dtype, b, h, h_kv,
                           s, d, causal, window, scale, mask,
                           static_cast<cudaStream_t>(stream));
}
