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
// reach device memory: each block recomputes its tiles of p from lse, and
// every product runs on the tensor cores by wgmma.  The Pallas grid's
// sequential innermost axis becomes a loop inside the block, since Hopper
// runs blocks in parallel and in no order.
//
// bf16 (the model's path) is warp-specialised like the forward
// (flash_fwd.cu), 384 threads: warpgroup 0 is the producer (setmaxnreg 24;
// one thread issues every TMA copy into 128B-swizzled tiles guarded by
// full / empty mbarriers), warpgroups 1 and 2 are consumers (setmaxnreg
// 240) that own 64 rows each of the block's 128-row tile.  Rows past s
// arrive as zeros from TMA's bounds check, their pairs are masked, and the
// TMA store of the results drops them.
//   dK/dV: one block per (batch, KV head, 128-key K tile) keeps its K and
//   V tiles in shared memory and its dk, dv accumulators in registers
//   while it sweeps every (query head of its GQA group, 64-query Q step)
//   item: Q and dO of a step come through a two-stage ring by TMA, lse
//   and delta by the producer warp's loads.  Per step a consumer issues
//   S^T = K . Q^T and dP^T = V . dO^T (both operands from shared memory,
//   K-major), so p^T and ds^T come out in the accumulator layout, which
//   is the register-A layout of the next two products, dV += p^T . dO and
//   dK += ds^T . Q, which read the same Q and dO tiles MN-major (the
//   descriptor's transpose bit).  Each consumer waits for its own
//   products; the other consumer's products run under its elementwise
//   work.  The group is summed in the accumulators, so dk and dv are
//   written once at KV-head resolution: no atomics, no group-sum pass,
//   and the result does not depend on scheduling.  dk is scaled by d^-1/2
//   once, at the end, and both go out through shared memory (the
//   consumer's rows of the K and V tiles) and a TMA store.
//   dQ: one block per (batch, head, 128-row Q tile) loads Q and dO once
//   and streams 64-key K/V tiles through a two-stage ring (the forward's
//   skeleton): S = Q . K^T and dP = dO . V^T from shared memory, ds in
//   registers feeds dQ += ds . K with K read MN-major; the two consumers
//   take turns to issue (ping-pong, named barriers); dq is scaled at the
//   end and stored by TMA.
// Registers: the score accumulators are declared inside the sweep's body,
// so between their products they hold none.  At head_dim 128 a dK/dV
// consumer keeps 128 accumulator floats of dk and dv, plus 64 of S^T and
// dP^T or 32 registers of bf16 p^T and ds^T; a dQ consumer 64 of dq,
// plus 64 of S and dP or 16 registers of bf16 ds.  No instantiation
// spills.  p comes from exp2 with d^-1/2 log2(e) folded into the scores
// and log2(e) into lse.
// Order: blocks start the longest sweeps first across all heads (dK/dV:
// every head's K tile 0 first, dense and masked; dQ: the forward's order,
// every head's last Q tile first when dense, head by head when masked).
// The tensor maps are encoded by the launchers (hopper_common.cuh); a map
// that cuTensorMapEncodeTiled refuses returns cudaErrorInvalidValue.
//
// f32 dK/dV (f32 models): one block of 8 warps (256 threads) per
// (batch, KV head, 128-key tile), KvTile's longest-sweep-first order;
// warp w owns keys 16w..16w + 15.  What bounds it: at (4, 8, 1024, 64)
// causal the four products' 8.60 GFLOP take 52 us at 165 TFLOP/s (three
// TF32 passes at 495: the card's fastest f32-accurate rate), against
// ~50 MB of traffic, 15 us: operations.  The previous design (CUDA-core
// FMAs out of shared memory) ran at 6 TFLOP/s.  This one:
//   - all four products, S^T = K . Q^T, dP^T = V . dO^T, dV += p^T . dO
//     and dK += ds^T . Q, by mma.sync m16n8k8 in 3xTF32, as the forward
//     (flash_fwd.cu's note says why not wgmma);
//   - K and V load once (cp.async); the block streams (query head of its
//     GQA group, Q step of 64 queries, 16 at d = 128) items, each
//     bringing Q, dO, lse and delta through a two-stage cp.async ring, so
//     item i + 1 loads under item i's products; rows padded to D + 4;
//   - p^T and ds^T go from the S^T and dP^T accumulators to the A operand
//     of the next two products with the forward's permutation of the k
//     slots, applied to Q's and dO's rows in their B fragments;
//   - the tensor cores truncate each accumulation (round toward zero), a
//     bias that grows with a running sum's length: dk and dv sum the
//     group's whole sweep (up to thousands of queries), which left them
//     3.0e-5 of max off at (2, 8, 2048, 128) (the limit is 1e-5).  So
//     each step's products go into a zeroed partial that the CUDA cores
//     add into dk, dv with round-to-nearest (accumulate_step): 5.0e-6
//     there, at 10% of the kernel's time (flash_ablations.py);
//   - the group is summed in the accumulators and dk, dv written once
//     (float2 stores): no atomics, the result independent of the
//     schedule; dk is scaled by d^-1/2 once, at the end;
//   - a warp skips a step none of its keys is seen in (band, window).
//   Registers: dk and dv take 4 D / 8 floats a thread (128 at d = 128);
//   no instantiation spills (chip_smoke.py checks it).
// f32 dQ: one block of 4 warps per (batch, head, 64-query tile) at
// d = 64, of 8 warps per 128-query tile at d = 128 (DqF32), in TileOf's
// order (longest causal sweep first across all heads when dense); warp w
// owns queries 16w..16w + 15.  What bounds it: at (4, 8, 1024, 64)
// causal its three products' 6.45 GFLOP take 39 us at 165 TFLOP/s,
// against 42.2 MB of traffic (q, k, v, dO, lse, delta read, dq written),
// 13 us: operations.  The previous design (one thread per dot product
// out of shared memory, CUDA-core FMAs) ran at 5 TFLOP/s.  This one is
// the f32 forward's skeleton with a second score product:
//   - Q and dO load once (cp.async, rows padded to D + 4), K and V tiles
//     of 32 keys stream through a two-stage cp.async ring, so tile i + 1
//     loads under tile i's products; each lane holds lse and delta of its
//     rows in registers for the whole sweep;
//   - S = Q . K^T and dP = dO . V^T by 3xTF32 mma.sync (Q's fragments
//     split in registers for the sweep at d = 64, dO's split at each
//     use), then p and ds = p o (dP - delta) on the accumulators, and
//     dQ += ds . K with ds going to the A operand through the forward's
//     permutation of the k slots and K read as the forward reads V;
//   - each tile's ds . K goes into a zeroed partial that the CUDA cores
//     add into dq with round-to-nearest (the truncation that dK/dV's
//     partials answer: dq sums a row's whole key sweep).  Without them
//     dq was 2.0e-5 of max off at (2, 8, 2048, 128) non-causal (5.1e-6
//     with them; the limit is 1e-5); causal, where the rows with the
//     longest sums have the smallest dq, 3.6e-6 (flash_ablations.py);
//   - a warp skips a tile none of its rows sees (band, window); dq is
//     scaled by d^-1/2 once, at the end, and written once (float2
//     stores): no atomics, the result independent of the schedule.
//
// Block-sparse mode (kMasked = true; the same Pallas kernels with
// has_mask=True, launched for block_sparse_attention's gradient): a pair
// is visible when the caller's [s / block_q, s / block_k] mask keeps its
// block and, if causal, the key is not after the query.  JAX refines the
// mask to its backward blocks by repetition; here the mask's blocks and
// the kernels' tiles are independent, so each block first lists, in
// shared memory, the tiles that hold a visible pair (BlockMask::
// tile_state, build_live_tiles, all threads before the roles split) and
// sweeps that list: dK/dV the (query head, live Q step) items of its K
// tile, dQ the live K tiles of its Q tile.  A tile the mask cuts through
// takes the pair-by-pair test in visible(), so p = 0 on every masked pair
// and a row with no visible key (lse = -inf) never reaches exp().  A block
// with an empty list loads nothing and writes zeros.  The dense
// instantiations read no mask.
//
// Layout: q, dO, dq [b, h, s, d]; k, v, dk, dv [b, h_kv, s, d]; lse, delta
// [b, h, s, 1] f32; all contiguous.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

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

// A masked dK/dV block's live list of Q steps (`rows` queries each) for
// its BK-key tile at k0, built by all THREADS threads in the shared
// memory at `list`
template <int THREADS, int BK>
__device__ __forceinline__ LiveTiles live_q_steps(unsigned char* list,
                                                  int rows, int k0, int s,
                                                  bool causal,
                                                  const BlockMask& mask) {
  return build_live_tiles<THREADS>(
      reinterpret_cast<int*>(list), (s + rows - 1) / rows, [&](int step) {
        return mask.tile_state(step * rows, (step + 1) * rows, k0, k0 + BK,
                               s, causal);
      });
}

// A masked dQ block's live list of BK-key tiles for its BQ-row Q tile at
// q0
template <int THREADS, int BQ, int BK>
__device__ __forceinline__ LiveTiles live_k_tiles(unsigned char* list,
                                                  int q0, int s, bool causal,
                                                  const BlockMask& mask) {
  return build_live_tiles<THREADS>(
      reinterpret_cast<int*>(list), (s + BK - 1) / BK, [&](int kt) {
        return mask.tile_state(q0, q0 + BQ, kt * BK, (kt + 1) * BK, s,
                               causal);
      });
}

// ------------------------------------------------------------------------
// bf16: TMA producer, two wgmma consumer warpgroups
// ------------------------------------------------------------------------

constexpr int kConsumers = 2;  // consumer warpgroups, 64 rows of the tile each
constexpr int kHThreads = 128 * (1 + kConsumers);
// registers a thread after the hand-over: 128 x 24 + 256 x 240 = 168 x 384
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 2;    // ring depth of the swept tiles
constexpr int kHRows = 128;   // K rows of a dK/dV block, Q rows of a dQ block
constexpr int kDkvStep = 64;  // queries of a dK/dV step: S^T is m64n64
constexpr int kDqStep = 64;   // keys of a dQ step: S is m64n64
constexpr float kLog2e = 1.4426950408889634f;
// named barriers: 1 + cw closes consumer cw's sweep before its epilogue;
// kTurnBarrier + cw is its turn to issue dQ products (ping-pong)
constexpr int kTurnBarrier = 3;

// Where a dK/dV block's 128-key tile lies, and its GQA group's heads.
// Blocks go longest causal sweep first across all heads: every head's K
// tile 0 first, then every head's tile 1, and so on.  Masked blocks too:
// at the document mask this order measured faster than head by head
// (flash_ablations.py), though the masked forward's did not.  This
// is TileOf's order (flash_common.cuh) and relies, as it does, on the
// H100 starting blocks in the order of their linear index, measured but
// not documented.
struct KvTile {
  int k0, k_rows;
  int kv_row;   // row of the [b * h_kv] heads
  int q_head0;  // row of the [b * h] heads: the group's first query head

  __device__ KvTile(int h, int h_kv, int s) {
    const int heads = gridDim.y * gridDim.z;  // b * h_kv
    const int lin =
        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    kv_row = lin % heads;
    q_head0 = (kv_row / h_kv) * h + (kv_row % h_kv) * (h / h_kv);
    k0 = lin / heads * kHRows;
    k_rows = min(kHRows, s - k0);
  }
};

// A consumer's 64 x D accumulator (rows r0 and r0 + 8 of this lane) times
// `scale`, in bf16, into the 128B-swizzled rows at `rows` (64-column boxes
// `box` bytes apart), for a TMA store
template <int D>
__device__ __forceinline__ void stage_rows(uint32_t rows, uint32_t box,
                                           const float* acc, int r0, int t,
                                           float scale) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    // columns 8j + 2t, + 1: box j / 8, 16-byte chunk j % 8, swizzled
    const uint32_t at =
        rows + (j / 8) * box + r0 * 128 + (((j % 8) ^ (r0 % 8)) * 16) + t * 4;
    const uint32_t lo = pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    const uint32_t hi =
        pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(lo) : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + 8 * 128), "r"(hi)
                 : "memory");
  }
}

// f32 accumulator fragments (8-column chunks 2kk, 2kk + 1 of rows r0 and
// r0 + 8) in bf16 as the A operand of k16 step kk
template <int STEPS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[STEPS][4],
                                       const float* acc) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

template <int D>
struct DkvSmem {
  // byte offsets from the 1024-aligned base: K, V, Q[kStages],
  // dO[kStages], lse[kStages], delta[kStages], then the mbarriers and
  // (masked) the live list
  static constexpr uint32_t kKBox = kHRows * 128;  // one 64-column box
  static constexpr uint32_t kQBox = kDkvStep * 128;
  static constexpr uint32_t kKBytes = kKBox * (D / kBoxCols);
  static constexpr uint32_t kQBytes = kQBox * (D / kBoxCols);
  static constexpr uint32_t kVecBytes = kDkvStep * 4;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kKBytes;
  static constexpr uint32_t kQ = kV + kKBytes;
  static constexpr uint32_t kDO = kQ + kStages * kQBytes;
  static constexpr uint32_t kLse = kDO + kStages * kQBytes;
  static constexpr uint32_t kDelta = kLse + kStages * kVecBytes;
  // kv_full, q_full[], q_empty[]
  static constexpr uint32_t kBars = kDelta + kStages * kVecBytes;
  static constexpr uint32_t kList = kBars + 8 * (1 + 2 * kStages);
  // + 1024: the dynamic shared memory is aligned up to 1024 in the kernel
  static constexpr size_t kBytes = kList + 1024;
};

template <int D, bool kMasked>
__global__ void __launch_bounds__(kHThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_dout,
                          const __grid_constant__ CUtensorMap tm_dk,
                          const __grid_constant__ CUtensorMap tm_dv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int h, int h_kv,
                          int s, int causal, int window, float scale,
                          const BlockMask mask) {
  using G = DkvSmem<D>;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ unsigned char smem_raw[];
  // 128B-swizzled tiles start 1024-aligned
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t sK = base + G::kK;
  const uint32_t sV = base + G::kV;
  auto sQ = [&](int st) { return base + G::kQ + st * G::kQBytes; };
  auto sdO = [&](int st) { return base + G::kDO + st * G::kQBytes; };
  auto sLse = [&](int st) {
    return reinterpret_cast<float*>(smem + G::kLse + st * G::kVecBytes);
  };
  auto sDelta = [&](int st) {
    return reinterpret_cast<float*>(smem + G::kDelta + st * G::kVecBytes);
  };
  const uint32_t kv_full = base + G::kBars;
  auto q_full = [&](int st) { return kv_full + 8 * (1 + st); };
  auto q_empty = [&](int st) { return kv_full + 8 * (1 + kStages + st); };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      // the TMA bytes and one arrive from each lane of the producer warp,
      // plus its lane 0's arrive with the byte count
      mbar_init(q_full(st), 33);
      mbar_init(q_empty(st), kConsumers * 4);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const bool banded = causal || window > 0;
  const int group = h / h_kv;
  const KvTile tile(h, h_kv, s);
  // the Q steps of each query head: the band's (dense), or the live list
  // of this K tile (masked)
  const QSweep sweep(tile.k0, tile.k0 + tile.k_rows - 1, s, kDkvStep, banded,
                     window);
  const LiveTiles live =
      kMasked ? live_q_steps<kHThreads, kHRows>(smem + G::kList, kDkvStep,
                                                tile.k0, s, banded, mask)
              : LiveTiles();
  const int steps = kMasked ? live.count : sweep.count;
  const int n_items = group * steps;  // (query head, Q step) pairs
  // Q step i of the sweep: step sweep.begin + i of the band (dense), or
  // entry i of the live list (masked)
  auto step_q0 = [&](int i) {
    return (kMasked ? live.tile(i) : sweep.begin + i) * kDkvStep;
  };

  if (threadIdx.x < 128) {
    // ---- producer: warp 0; its lane 0 issues every TMA copy ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32 && n_items > 0) {  // an empty list loads nothing
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * G::kKBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_3d(sK + c * G::kKBox, &tm_k, c * kBoxCols, tile.k0,
                      tile.kv_row, kv_full);
          tma_load_3d(sV + c * G::kKBox, &tm_v, c * kBoxCols, tile.k0,
                      tile.kv_row, kv_full);
        }
      }
      // item it = (query head g, Q step i), it = g * steps + i
      for (int g = 0, it = 0; g < group; ++g) {
        const int q_head = tile.q_head0 + g;
        const float* lse_head = lse + (size_t)q_head * s;
        const float* delta_head = delta + (size_t)q_head * s;
        for (int i = 0; i < steps; ++i, ++it) {
          const int st = it % kStages;
          const int q0 = step_q0(i);
          mbar_wait(q_empty(st), ((it / kStages) & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(q_full(st), 2 * G::kQBytes);
            for (int c = 0; c < kBoxes; ++c) {
              tma_load_3d(sQ(st) + c * G::kQBox, &tm_q, c * kBoxCols, q0,
                          q_head, q_full(st));
              tma_load_3d(sdO(st) + c * G::kQBox, &tm_dout, c * kBoxCols,
                          q0, q_head, q_full(st));
            }
          }
          // lse and delta of the step's queries by plain loads: a step's
          // rows start at any element of the [b * h * s] vectors, not on
          // the 16-byte boundaries of TMA.  Rows past s read nothing
          // (their pairs are masked).  Each lane's arrive releases its
          // stores to the consumers.
          for (int r = lane; r < kDkvStep; r += 32) {
            const bool in = q0 + r < s;
            sLse(st)[r] = in ? lse_head[q0 + r] : 0.f;
            sDelta(st)[r] = in ? delta_head[q0 + r] : 0.f;
          }
          mbar_arrive(q_full(st));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns keys [64 cw, 64 cw + 64) ----
    setmaxnreg_inc<kConsumerRegs>();
    constexpr int kSAcc = kDkvStep / 2;    // S^T or dP^T floats a thread
    constexpr int kAcc = D / 2;            // dk or dv floats a thread
    constexpr int kPSteps = kDkvStep / 16;  // k16 steps of dV, dK
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t = lane % 4;  // accumulator column pair
    const int r0 = 16 * warp + lane / 4;  // this lane's keys: r0, r0 + 8
    const int wk0 = tile.k0 + 64 * cw;    // the warpgroup's first key
    const int k_pos0 = wk0 + r0;
    const int k_pos1 = k_pos0 + 8;
    const float scale_log2 = scale * kLog2e;  // d^-1/2 log2(e)
    const uint32_t k_rows = sK + cw * 64 * 128;
    const uint32_t v_rows = sV + cw * 64 * 128;

    float dk[kAcc], dv[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) dk[i] = dv[i] = 0.f;
    if (n_items > 0) mbar_wait(kv_full, 0);
    // item it = (query head it / steps, Q step i = it % steps)
    for (int it = 0, i = 0; it < n_items; ++it, i = i + 1 < steps ? i + 1 : 0) {
      const int st = it % kStages;
      // fresh each step: between the products they hold no register
      float sc[kSAcc], dp[kSAcc];  // S^T, dP^T; then p^T, ds^T in f32
      uint32_t pa[kPSteps][4], da[kPSteps][4];  // p^T, ds^T in bf16
      const int q0 = step_q0(i);
      mbar_wait(q_full(st), (it / kStages) & 1);

      // ---- S^T = K . Q^T, dP^T = V . dO^T (64 keys x 64 queries) ----
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = kk / 4, col = (kk % 4) * 32;  // 16 bf16 = 32 B
        wgmma_ss<kDkvStep>(
            sc, wgmma_desc(k_rows + box * G::kKBox + col, 16, 1024),
            wgmma_desc(sQ(st) + box * G::kQBox + col, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = kk / 4, col = (kk % 4) * 32;
        wgmma_ss<kDkvStep>(
            dp, wgmma_desc(v_rows + box * G::kKBox + col, 16, 1024),
            wgmma_desc(sdO(st) + box * G::kQBox + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // ---- p^T = exp(S^T d^-1/2 - lse), ds^T = p^T o (dP^T - delta) ----
      const bool cut = kMasked && live.cut(i);
      // a tile needs the element mask only where the band, the end or the
      // block mask cuts it
      const bool edge = q0 + kDkvStep > s || wk0 + 64 > s ||
                        (banded && q0 < wk0 + 63) ||
                        (window > 0 && q0 + kDkvStep - 1 - wk0 >= window) ||
                        cut;
      const float* lse_s = sLse(st);
      const float* delta_s = sDelta(st);
#pragma unroll
      for (int j = 0; j < kDkvStep / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
        const float2 dl =
            *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float lse_log2 = (c ? l.y : l.x) * kLog2e;
          const float dlc = c ? dl.y : dl.x;
          float p0 = exp2_approx(fmaf(sc[4 * j + c], scale_log2, -lse_log2));
          float p1 =
              exp2_approx(fmaf(sc[4 * j + 2 + c], scale_log2, -lse_log2));
          if (edge) {
            const int q_pos = q0 + 8 * j + 2 * t + c;
            if (!visible(q_pos, k_pos0, s, banded, window, cut, mask)) p0 = 0.f;
            if (!visible(q_pos, k_pos1, s, banded, window, cut, mask)) p1 = 0.f;
          }
          sc[4 * j + c] = p0;
          sc[4 * j + 2 + c] = p1;
          dp[4 * j + c] = p0 * (dp[4 * j + c] - dlc);
          dp[4 * j + 2 + c] = p1 * (dp[4 * j + 2 + c] - dlc);
        }
      }
      pack_a(pa, sc);
      pack_a(da, dp);

      // ---- dV += p^T . dO, dK += ds^T . Q: Q, dO read MN-major ----
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
        // queries [16 kk, 16 kk + 16): two 8-row groups of 128-byte rows
        wgmma_rs<D>(dv, pa[kk],
                    wgmma_desc(sdO(st) + kk * 16 * 128, G::kQBox, 1024));
        wgmma_rs<D>(dk, da[kk],
                    wgmma_desc(sQ(st) + kk * 16 * 128, G::kQBox, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      if (lane == 0) mbar_arrive(q_empty(st));
    }

    // ---- dk = d^-1/2 acc, dv = acc through this warpgroup's K, V rows ----
    // the rows are free once all its warps are past their last product
    named_barrier_sync(1 + cw, 128);
    stage_rows<D>(k_rows, G::kKBox, dk, r0, t, scale);
    stage_rows<D>(v_rows, G::kKBox, dv, r0, t, 1.f);
    fence_proxy_async();
    named_barrier_sync(1 + cw, 128);
    if (tid == 0 && wk0 < s) {
      for (int c = 0; c < kBoxes; ++c) {
        tma_store_3d(&tm_dk, k_rows + c * G::kKBox, c * kBoxCols, wk0,
                     tile.kv_row);
        tma_store_3d(&tm_dv, v_rows + c * G::kKBox, c * kBoxCols, wk0,
                     tile.kv_row);
      }
      tma_store_commit_and_wait();
    }
  }
}

template <int D>
struct DqSmem {
  // byte offsets from the 1024-aligned base: Q, dO, K[kStages],
  // V[kStages], then the mbarriers and (masked) the live list
  static constexpr uint32_t kQBox = kHRows * 128;  // one 64-column box
  static constexpr uint32_t kKBox = kDqStep * 128;
  static constexpr uint32_t kQBytes = kQBox * (D / kBoxCols);
  static constexpr uint32_t kKBytes = kKBox * (D / kBoxCols);
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQ + kQBytes;
  static constexpr uint32_t kK = kDO + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKBytes;
  // q_full, k_full[], k_empty[], v_full[], v_empty[]
  static constexpr uint32_t kBars = kV + kStages * kKBytes;
  static constexpr uint32_t kList = kBars + 8 * (1 + 4 * kStages);
  static constexpr size_t kBytes = kList + 1024;
};

template <int D, bool kMasked>
__global__ void __launch_bounds__(kHThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_dout,
                         const __grid_constant__ CUtensorMap tm_dq,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, int h, int h_kv,
                         int s, int causal, int window, float scale,
                         const BlockMask mask) {
  using G = DqSmem<D>;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t sQ = base + G::kQ;
  const uint32_t sdO = base + G::kDO;
  auto sK = [&](int st) { return base + G::kK + st * G::kKBytes; };
  auto sV = [&](int st) { return base + G::kV + st * G::kKBytes; };
  const uint32_t q_full = base + G::kBars;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * kStages + st); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kConsumers * 4);
      mbar_init(v_empty(st), kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const bool banded = causal || window > 0;
  // the forward's blocks and order: longest causal rows first, across all
  // heads when dense, head by head when masked
  const TileOf<kHRows, kDqStep> tile(h, h_kv, s, D, banded, window,
                                     !kMasked);
  // the K tiles to visit, kt in [kt_begin, kt_end]: tile kt of the band
  // (dense), or entry kt of this Q tile's live list (masked)
  const LiveTiles live =
      kMasked ? live_k_tiles<kHThreads, kHRows, kDqStep>(
                    smem + G::kList, tile.q0, s, banded, mask)
              : LiveTiles();
  const int kt_begin = kMasked ? 0 : tile.k_tile_begin;
  const int kt_end = kMasked ? live.count - 1 : tile.k_tile_end;
  const int n = kt_end - kt_begin + 1;
  auto k_start = [&](int kt) {
    return (kMasked ? live.tile(kt) : kt) * kDqStep;
  };

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n > 0) {  // an empty list loads nothing
      mbar_arrive_expect_tx(q_full, 2 * G::kQBytes);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_3d(sQ + c * G::kQBox, &tm_q, c * kBoxCols, tile.q0,
                    tile.q_head, q_full);
        tma_load_3d(sdO + c * G::kQBox, &tm_dout, c * kBoxCols, tile.q0,
                    tile.q_head, q_full);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        const uint32_t free_parity = ((i / kStages) & 1) ^ 1;
        const int k0 = k_start(kt_begin + i);
        mbar_wait(k_empty(st), free_parity);
        mbar_arrive_expect_tx(k_full(st), G::kKBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_3d(sK(st) + c * G::kKBox, &tm_k, c * kBoxCols, k0,
                      tile.kv_head, k_full(st));
        }
        mbar_wait(v_empty(st), free_parity);
        mbar_arrive_expect_tx(v_full(st), G::kKBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_3d(sV(st) + c * G::kKBox, &tm_v, c * kBoxCols, k0,
                      tile.kv_head, v_full(st));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns Q rows [64 cw, 64 cw + 64) ----
    setmaxnreg_inc<kConsumerRegs>();
    constexpr int kSAcc = kDqStep / 2;     // S or dP floats a thread
    constexpr int kAcc = D / 2;            // dq floats a thread
    constexpr int kDsSteps = kDqStep / 16;  // k16 steps of dQ += ds . K
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t = lane % 4;
    const int r0 = 16 * warp + lane / 4;  // this lane's rows: r0, r0 + 8
    const int wq0 = tile.q0 + 64 * cw;    // the warpgroup's first query
    const int q_pos0 = wq0 + r0;
    const int q_pos1 = q_pos0 + 8;
    const float scale_log2 = scale * kLog2e;
    // rows past the end are masked; read nothing for them
    const size_t row = (size_t)tile.q_head * s;
    const float l0 = q_pos0 < s ? lse[row + q_pos0] * kLog2e : 0.f;
    const float l1 = q_pos1 < s ? lse[row + q_pos1] * kLog2e : 0.f;
    const float dl0 = q_pos0 < s ? delta[row + q_pos0] : 0.f;
    const float dl1 = q_pos1 < s ? delta[row + q_pos1] : 0.f;
    const uint32_t q_rows = sQ + cw * 64 * 128;
    const uint32_t do_rows = sdO + cw * 64 * 128;

    float dq[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) dq[i] = 0.f;
    // Ping-pong: the two warpgroups take turns to issue their products
    // (two turns a step), so one's elementwise work runs under the
    // other's products.  Warpgroup cw waits at barrier kTurnBarrier + cw
    // until the other has issued; each barrier counts the owner's 128
    // syncs and the other's 128 arrives, so warpgroup 1 opens warpgroup
    // 0's first turn and leaves out its own last arrive.
    auto my_turn = [&]() { named_barrier_sync(kTurnBarrier + cw, 256); };
    auto their_turn = [&](bool last) {
      if (cw == 0 || !last) {
        named_barrier_arrive(kTurnBarrier + (cw ^ 1), 256);
      }
    };

    if (n > 0) {
      mbar_wait(q_full, 0);
      if (cw == 1) their_turn(false);
    }
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      // fresh each step: between the products they hold no register
      float sc[kSAcc], dp[kSAcc];  // S, dP; then ds in f32
      uint32_t ds[kDsSteps][4];    // ds in bf16
      const int kt = kt_begin + i;
      const int k0 = k_start(kt);
      mbar_wait(k_full(st), parity);
      mbar_wait(v_full(st), parity);
      my_turn();

      // ---- S = Q . K^T, dP = dO . V^T (64 queries x 64 keys) ----
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = kk / 4, col = (kk % 4) * 32;
        wgmma_ss<kDqStep>(
            sc, wgmma_desc(q_rows + box * G::kQBox + col, 16, 1024),
            wgmma_desc(sK(st) + box * G::kKBox + col, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = kk / 4, col = (kk % 4) * 32;
        wgmma_ss<kDqStep>(
            dp, wgmma_desc(do_rows + box * G::kQBox + col, 16, 1024),
            wgmma_desc(sV(st) + box * G::kKBox + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      their_turn(false);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (lane == 0) mbar_arrive(v_empty(st));

      // ---- p = exp(S d^-1/2 - lse), ds = p o (dP - delta), into sc ----
      const bool cut = kMasked && live.cut(kt);
      const bool edge = wq0 + 64 > s || k0 + kDqStep > s ||
                        (banded && k0 + kDqStep - 1 > wq0) ||
                        (window > 0 && wq0 + 63 - k0 >= window) || cut;
#pragma unroll
      for (int j = 0; j < kDqStep / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p0 = exp2_approx(fmaf(sc[4 * j + c], scale_log2, -l0));
          float p1 = exp2_approx(fmaf(sc[4 * j + 2 + c], scale_log2, -l1));
          if (edge) {
            const int k_pos = k0 + 8 * j + 2 * t + c;
            if (!visible(q_pos0, k_pos, s, banded, window, cut, mask)) p0 = 0.f;
            if (!visible(q_pos1, k_pos, s, banded, window, cut, mask)) p1 = 0.f;
          }
          sc[4 * j + c] = p0 * (dp[4 * j + c] - dl0);
          sc[4 * j + 2 + c] = p1 * (dp[4 * j + 2 + c] - dl1);
        }
      }
      pack_a(ds, sc);

      // ---- dQ += ds . K: K read MN-major ----
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < kDsSteps; ++kk) fence_regs(ds[kk]);
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDsSteps; ++kk) {
        wgmma_rs<D>(dq, ds[kk],
                    wgmma_desc(sK(st) + kk * 16 * 128, G::kKBox, 1024));
      }
      wgmma_commit();
      their_turn(i + 1 == n);
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < kDsSteps; ++kk) fence_regs(ds[kk]);
      if (lane == 0) mbar_arrive(k_empty(st));
    }

    // ---- dq = d^-1/2 acc through this warpgroup's Q rows ----
    named_barrier_sync(1 + cw, 128);
    stage_rows<D>(q_rows, G::kQBox, dq, r0, t, scale);
    fence_proxy_async();
    named_barrier_sync(1 + cw, 128);
    if (tid == 0 && wq0 < s) {
      for (int c = 0; c < kBoxes; ++c) {
        tma_store_3d(&tm_dq, q_rows + c * G::kQBox, c * kBoxCols, wq0,
                     tile.q_head);
      }
      tma_store_commit_and_wait();
    }
  }
}

// ------------------------------------------------------------------------
// f32 dK/dV: 3xTF32 mma.sync over a cp.async ring (the design is in the
// note at the top)
// ------------------------------------------------------------------------

// 8 warps, warp w owns keys [16w, 16w + 16) of KvTile's 128
constexpr int kDkvF32Warps = kHRows / 16;
constexpr int kDkvF32Threads = 32 * kDkvF32Warps;

template <int D>
struct DkvF32 {
  // queries a step: 64; 16 at d = 128, where dk and dv take 128
  // registers a thread and 32-query steps spill in the masked build
  // (dense, they ran 13% faster: flash_ablations.py)
  static constexpr int kStep = D == 64 ? 64 : 16;
  // floats a row: 16-byte rows, and every fragment load of a warp on 32
  // distinct banks (D + 4 = 4 mod 32)
  static constexpr int kLd = D + 4;
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + kHRows * kLd;
  // stage st of the ring at kRing + st kStage: Q, dO, lse, delta
  static constexpr size_t kRing = kV + kHRows * kLd;
  static constexpr int kDO = kStep * kLd;
  static constexpr int kLse = 2 * kStep * kLd;
  static constexpr int kDelta = kLse + kStep;
  static constexpr int kStage = kDelta + kStep;
  static constexpr size_t kBytes = sizeof(float) * (kRing + 2 * kStage);
};

// c = A . B^T for one step, 3xTF32: A the lane's rows r0, r0 + 8 of the
// block's K or V tile, B the step's rows of Q or dO (both row-major in
// shared memory, D columns); c's rows are keys, its columns 8j + 2t, +1
// the step's queries
template <int D, int kStep, int kLd>
__device__ __forceinline__ void step_product(float (&c)[kStep / 8][4],
                                             const float* a_tile,
                                             const float* b_rows, int r0,
                                             int g, int t) {
#pragma unroll
  for (int j = 0; j < kStep / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const Tf32Split<4> a = a_frag<kLd>(a_tile, r0, kk, t);
#pragma unroll
    for (int j = 0; j < kStep / 8; ++j) {
      // B = rows^T: (k 8kk + t, n 8j + g) and (8kk + t + 4, 8j + g)
      const float* at = b_rows + (8 * j + g) * kLd + 8 * kk + t;
      Tf32Split<2> b;
      b.set(0, at[0]);
      b.set(1, at[4]);
      mma_3xtf32(c[j], a, b);
    }
  }
}

// acc += a . B for one step: a holds the step's p^T or ds^T accumulator
// tiles (keys by queries 8j + 2t, +1), B the step's rows of Q or dO in
// shared memory (`rows`).  The tensor cores truncate each accumulation
// (round toward zero), a bias that grows with the length of a running
// sum, and dk and dv sum the group's whole sweep: so each step's product
// goes into a zeroed partial, kChunk column tiles at a time, which the
// CUDA cores add to acc with round-to-nearest.  A's split is redone for
// each chunk (two at d = 128) rather than held, to spare registers.
template <int D, int kStep, int kLd>
__device__ __forceinline__ void accumulate_step(float (&acc)[D / 8][4],
                                                const float (&a)[kStep / 8][4],
                                                const float* rows, int g,
                                                int t) {
  constexpr int kChunk = 8;
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += kChunk) {
    float part[kChunk][4];
#pragma unroll
    for (int n = 0; n < kChunk; ++n)
      part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kStep / 8; ++j) {
      const Tf32Split<4> aj = acc_as_a(a[j]);
      const float* b = rows + (8 * j + 2 * t) * kLd + g;
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        mma_3xtf32(part[n], aj, b_rows_permuted<kLd>(b, n0 + n));
      }
    }
#pragma unroll
    for (int n = 0; n < kChunk; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n0 + n][c] += part[n][c];
    }
  }
}

template <int D, bool kMasked>
__global__ void __launch_bounds__(kDkvF32Threads, 1)
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
  constexpr int kStep = G::kStep;
  constexpr int kLd = G::kLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const float* sK = smem + G::kK;
  const float* sV = smem + G::kV;

  const KvTile tile(h, h_kv, s);  // longest sweeps first across all heads
  const int group = h / h_kv;
  const bool banded = causal || window > 0;
  const QSweep sweep(tile.k0, tile.k0 + tile.k_rows - 1, s, kStep, banded,
                     window);
  const LiveTiles live =
      kMasked ? live_q_steps<kDkvF32Threads, kHRows>(
                    smem_raw + G::kBytes, kStep, tile.k0, s, banded, mask)
              : LiveTiles();
  const int steps = kMasked ? live.count : sweep.count;
  const int items = group * steps;  // (query head of the group, Q step)
  const size_t kv_offset = ((size_t)tile.kv_row * s + tile.k0) * D;
  auto q_start = [&](int it) {
    return (kMasked ? live.tile(it % steps) : sweep.begin + it % steps) *
           kStep;
  };
  // item it's Q, dO, lse and delta into ring stage it % 2
  auto load_item = [&](int it) {
    const int q0 = q_start(it);
    const size_t row = (size_t)(tile.q_head0 + it / steps) * s + q0;
    const int valid = min(kStep, s - q0);
    float* stage = smem + G::kRing + (it % 2) * G::kStage;
    cp_async_rows_f32<D, kStep, kLd, kDkvF32Threads>(stage, q + row * D,
                                                     valid);
    cp_async_rows_f32<D, kStep, kLd, kDkvF32Threads>(stage + G::kDO,
                                                     dout + row * D, valid);
    if (threadIdx.x < 2 * kStep) {  // lse, then delta
      const int i = threadIdx.x % kStep;
      const float* src = (threadIdx.x < kStep ? lse : delta) + row;
      cp_async_4(smem_u32(stage + G::kLse + threadIdx.x),
                 src + (i < valid ? i : 0), i < valid ? 4 : 0);
    }
  };
  cp_async_rows_f32<D, kHRows, kLd, kDkvF32Threads>(smem + G::kK,
                                                    k + kv_offset,
                                                    tile.k_rows);
  cp_async_rows_f32<D, kHRows, kLd, kDkvF32Threads>(smem + G::kV,
                                                    v + kv_offset,
                                                    tile.k_rows);
  if (items > 0) load_item(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;        // fragment row group
  const int t = lane % 4;        // fragment column pair
  const int r0 = 16 * warp + g;  // this lane's keys of the tile: r0, r0 + 8
  const int kw0 = tile.k0 + 16 * warp;  // the warp's first key
  const float scale_log2 = scale * kLog2e;

  // rows r0, r0 + 8 of the tile; columns 8n + 2t, 8n + 2t + 1
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) load_item(it + 1);
    cp_async_commit();  // an empty group past the last item
    cp_async_wait<1>();  // K, V and item it have landed (this thread's)
    __syncthreads();     // ... and every thread's
    const int q0 = q_start(it);
    const bool cut = kMasked && live.cut(it % steps);
    const float* stage = smem + G::kRing + (it % 2) * G::kStage;
    const float* sQ = stage;
    const float* sdO = stage + G::kDO;
    const float* sLse = stage + G::kLse;
    const float* sDelta = stage + G::kDelta;
    // the warp's 16 keys are past s, or no query of the step sees them
    const bool dead = kw0 >= s || (banded && kw0 > q0 + kStep - 1) ||
                      (window > 0 && q0 - (kw0 + 15) >= window);
    if (!dead) {
      // Two halves, so that only one of S^T / dP^T and its partial are
      // live beside dk, dv (at d = 128 they take 128 registers).
      // S^T = K . Q^T, then p^T = exp(S^T d^-1/2 - lse) on visible
      // pairs, else 0; every pair of a full tile is visible
      const bool full = !cut && kw0 + 16 <= s && q0 + kStep <= s &&
                        (!banded || q0 >= kw0 + 15) &&
                        (window <= 0 || q0 + kStep - 1 - kw0 < window);
      float pt[kStep / 8][4];
      step_product<D, kStep, kLd>(pt, sK, sQ, r0, g, t);
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = 8 * j + 2 * t + (c % 2);
          float p = 0.f;
          if (full || visible(q0 + qi, tile.k0 + r0 + 8 * (c / 2), s, banded,
                              window, cut, mask)) {
            p = exp2_approx(fmaf(pt[j][c], scale_log2, -sLse[qi] * kLog2e));
          }
          pt[j][c] = p;
        }
      }
      // dV += p^T . dO over the step's queries
      accumulate_step<D, kStep, kLd>(dv_acc, pt, sdO, g, t);

      // dP^T = V . dO^T, then ds^T = p^T o (dP^T - delta); dK += ds^T . Q
      float dst[kStep / 8][4];
      step_product<D, kStep, kLd>(dst, sV, sdO, r0, g, t);
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = 8 * j + 2 * t + (c % 2);
          dst[j][c] = pt[j][c] * (dst[j][c] - sDelta[qi]);
        }
      }
      accumulate_step<D, kStep, kLd>(dk_acc, dst, sQ, g, t);
    }
    __syncthreads();  // stage it % 2 is free for item it + 2
  }
  cp_async_wait<0>();  // an empty sweep left K's and V's copies in flight

  // dk = d^-1/2 ds^T . q and dv, each written once (the whole group
  // summed in the accumulators): rows r0, r0 + 8, columns 8n + 2t, +1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= tile.k_rows) continue;
    float* dk_row = dk + kv_offset + (size_t)row * D + 2 * t;
    float* dv_row = dv + kv_offset + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dk_row + 8 * n) = make_float2(
          dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv_row + 8 * n) =
          make_float2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------------
// f32 dQ: 3xTF32 mma.sync over a cp.async ring (the design is in the note
// at the top)
// ------------------------------------------------------------------------

template <int D>
struct DqF32 {
  // query rows a block, 16 a warp: 64 at d = 64 (70 KB of shared memory,
  // two blocks an SM); 128 at d = 128 (203 KB, 8 warps an SM), where
  // 64-row blocks (135 KB, one of 4 warps an SM) ran 48% slower and
  // 64-row blocks with 16-key tiles (101 KB, two an SM) 29% slower at
  // (2, 8, 2048, 128) (flash_ablations.py dq_rows64, dq_keys16)
  static constexpr int kRows = D == 64 ? 64 : 128;
  static constexpr int kThreads = 2 * kRows;  // 32 threads a warp
  // keys a K / V tile
  static constexpr int kBK = 32;
  // floats a row: 16-byte rows, and every fragment load of a warp on 32
  // distinct banks (D + 4 = 4 mod 32)
  static constexpr int kLd = D + 4;
  static constexpr int kTile = kBK * kLd;
  static constexpr size_t kQ = 0;
  static constexpr size_t kDO = kQ + kRows * kLd;
  // stage st of the ring: K at kRing + 2 st kTile, V right after it
  static constexpr size_t kRing = kDO + kRows * kLd;
  static constexpr size_t kBytes = sizeof(float) * (kRing + 2 * 2 * kTile);
};

// One block's bound: at d = 64 a cap of three blocks' worth (170
// registers, against 203-217) spills and ran 28% slower
// (flash_ablations.py dq_cap3)
template <int D, bool kMasked>
__global__ void __launch_bounds__(DqF32<D>::kThreads, 1)
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
  constexpr int kRows = G::kRows;
  constexpr int kBK = G::kBK;
  constexpr int kLd = G::kLd;
  // d = 64: the warp's Q fragments stay split in registers (64 of them)
  // for the whole sweep, as in the forward (from shared memory it ran 16%
  // slower: flash_ablations.py dq_q_shared); d = 128 would need 128, so
  // they are read from shared memory and split at each use, as dO's are
  constexpr bool kQInRegs = D == 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const float* sQ = smem + G::kQ;
  const float* sdO = smem + G::kDO;

  const bool banded = causal || window > 0;
  // dense: longest causal rows first across all heads, as the forward
  const TileOf<kRows, kBK> tile(h, h_kv, s, D, banded, window, !kMasked);
  const LiveTiles live =
      kMasked ? live_k_tiles<G::kThreads, kRows, kBK>(
                    smem_raw + G::kBytes, tile.q0, s, banded, mask)
              : LiveTiles();
  const int n_tiles =
      kMasked ? live.count : tile.k_tile_end - tile.k_tile_begin + 1;
  auto k_start = [&](int i) {
    return (kMasked ? live.tile(i) : tile.k_tile_begin + i) * kBK;
  };
  // tile i's K and V into ring stage i % 2
  auto load_kv = [&](int i) {
    const int k0 = k_start(i);
    const size_t at = tile.kv_offset + (size_t)k0 * D;
    float* sK = smem + G::kRing + (i % 2) * 2 * G::kTile;
    cp_async_rows_f32<D, kBK, kLd, G::kThreads>(sK, k + at, min(kBK, s - k0));
    cp_async_rows_f32<D, kBK, kLd, G::kThreads>(sK + G::kTile, v + at,
                                                min(kBK, s - k0));
  };
  if (n_tiles > 0) {  // an empty live list loads nothing
    cp_async_rows_f32<D, kRows, kLd, G::kThreads>(
        smem + G::kQ, q + tile.q_offset, tile.q_rows);
    cp_async_rows_f32<D, kRows, kLd, G::kThreads>(
        smem + G::kDO, dout + tile.q_offset, tile.q_rows);
    load_kv(0);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;        // fragment row group
  const int t = lane % 4;        // fragment column pair
  const int r0 = 16 * warp + g;  // this lane's rows of the tile: r0, r0 + 8
  const int qw0 = tile.q0 + 16 * warp;  // the warp's first query
  const float scale_log2 = scale * kLog2e;  // d^-1/2 log2(e)
  // lse (log2 units) and delta of rows r0, r0 + 8, held for the sweep;
  // rows past s read nothing (their pairs are masked)
  float lse_log2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const size_t at = tile.q_offset / D + row;
    lse_log2[r] = row < tile.q_rows ? lse[at] * kLog2e : 0.f;
    dl[r] = row < tile.q_rows ? delta[at] : 0.f;
  }

  Tf32Split<4> qf[kQInRegs ? D / 8 : 1];
  // rows r0 (0, 1) and r0 + 8 (2, 3), columns 8n + 2t, +1
  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_kv(i + 1);
    cp_async_commit();  // an empty group past the last tile
    cp_async_wait<1>();  // Q, dO and tile i have landed (this thread's)
    __syncthreads();     // ... and every thread's
    if (kQInRegs && i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) qf[kk] = a_frag<kLd>(sQ, r0, kk, t);
    }
    const int k0 = k_start(i);
    const bool cut = kMasked && live.cut(i);
    const float* sK = smem + G::kRing + (i % 2) * 2 * G::kTile;
    const float* sV = sK + G::kTile;
    // the warp's 16 rows are past s, or see no key of this tile (band,
    // window): skip
    const bool dead = qw0 >= s || (banded && k0 > qw0 + 15) ||
                      (window > 0 && qw0 - (k0 + kBK - 1) >= window);
    if (!dead) {
      // S = Q . K^T and dP = dO . V^T for rows r0, r0 + 8, keys 8j + 2t, +1
      float sc[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        Tf32Split<4> a;
        if constexpr (kQInRegs) {
          a = qf[kk];
        } else {
          a = a_frag<kLd>(sQ, r0, kk, t);
        }
        const Tf32Split<4> ao = a_frag<kLd>(sdO, r0, kk, t);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          // B = K^T, V^T: (k 8kk + t, n 8j + g) and (8kk + t + 4, 8j + g)
          const int at = (8 * j + g) * kLd + 8 * kk + t;
          Tf32Split<2> bk, bv;
          bk.set(0, sK[at]);
          bk.set(1, sK[at + 4]);
          bv.set(0, sV[at]);
          bv.set(1, sV[at + 4]);
          mma_3xtf32(sc[j], a, bk);
          mma_3xtf32(dp[j], ao, bv);
        }
      }

      // p = exp(S d^-1/2 - lse) on visible pairs, else 0 (every pair of
      // a full tile is visible, so a row with lse = -inf never reaches
      // exp2); ds = p o (dP - delta), split as the A operand of ds . K
      const bool full = !cut && k0 + kBK <= s && qw0 + 16 <= s &&
                        (!banded || k0 + kBK - 1 <= qw0) &&
                        (window <= 0 || qw0 + 15 - k0 < window);
      Tf32Split<4> da[kBK / 8];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c / 2;
          float p = 0.f;
          if (full || visible(qw0 + g + 8 * r, k0 + 8 * j + 2 * t + (c % 2),
                              s, banded, window, cut, mask)) {
            p = exp2_approx(fmaf(sc[j][c], scale_log2, -lse_log2[r]));
          }
          sc[j][c] = p * (dp[j][c] - dl[r]);
        }
        da[j] = acc_as_a(sc[j]);
      }

      // dQ += ds . K over the tile's keys: ds's accumulator is the A
      // fragment with its keys permuted (acc_as_a), and K's B fragment
      // reads the same keys (the forward's P . V with K for V).  The
      // tensor cores truncate each accumulation, a bias that grows with a
      // running sum's length, and dq sums the whole sweep: so each tile's
      // product goes into a zeroed partial, kChunk column tiles at a
      // time, which the CUDA cores add to dq with round-to-nearest
      constexpr int kChunk = 8;
      const float* kb = sK + (2 * t) * kLd + g;
#pragma unroll
      for (int n0 = 0; n0 < D / 8; n0 += kChunk) {
        float part[kChunk][4];
#pragma unroll
        for (int n = 0; n < kChunk; ++n)
          part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          const float* kj = kb + 8 * j * kLd;  // keys 8j + 2t, + 1
#pragma unroll
          for (int n = 0; n < kChunk; ++n) {
            mma_3xtf32(part[n], da[j], b_rows_permuted<kLd>(kj, n0 + n));
          }
        }
#pragma unroll
        for (int n = 0; n < kChunk; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) dq_acc[n0 + n][c] += part[n][c];
        }
      }
    }
    __syncthreads();  // stage i % 2 is free for tile i + 2
  }
  cp_async_wait<0>();  // nothing in flight past the sweep

  // dq = d^-1/2 ds . k, written once (no atomics): rows r0, r0 + 8,
  // columns 8n + 2t, +1; an empty sweep writes zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= tile.q_rows) continue;
    float* dq_row = dq + tile.q_offset + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dq_row + 8 * n) = make_float2(
          dq_acc[n][2 * r] * scale, dq_acc[n][2 * r + 1] * scale);
    }
  }
}

// above 48 KB a block's shared memory needs the opt-in (per device)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, bool kMasked>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int b,
                           int h, int h_kv, int s, int causal, int window,
                           float scale, const BlockMask& mask,
                           cudaStream_t stream) {
  // a masked block's live list of Q steps follows its tiles
  constexpr int kStep = DkvF32<D>::kStep;
  const size_t smem =
      DkvF32<D>::kBytes +
      (kMasked ? live_list_bytes((s + kStep - 1) / kStep) : 0);
  auto kernel = flash_bwd_dkv_f32_kernel<D, kMasked>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // KvTile's order: the grid of the bf16 dK/dV kernel
  const dim3 grid((s + kHRows - 1) / kHRows, h_kv, b);
  kernel<<<grid, kDkvF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), h, h_kv, s, causal,
      window, scale, mask);
  return cudaGetLastError();
}

template <int D, bool kMasked>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int b, int h,
                          int h_kv, int s, int causal, int window,
                          float scale, const BlockMask& mask,
                          cudaStream_t stream) {
  using G = DqF32<D>;
  // a masked block's live list of K tiles follows its tiles
  const size_t smem =
      G::kBytes + (kMasked ? live_list_bytes((s + G::kBK - 1) / G::kBK) : 0);
  auto kernel = flash_bwd_dq_f32_kernel<D, kMasked>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // TileOf's grid: the forward's order
  const dim3 grid((s + G::kRows - 1) / G::kRows, h, b);
  kernel<<<grid, G::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), h, h_kv, s, causal, window, scale, mask);
  return cudaGetLastError();
}

template <int D, bool kMasked>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int b,
                            int h, int h_kv, int s, int causal, int window,
                            float scale, const BlockMask& mask,
                            cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_dout, tm_dk, tm_dv;
  if (!encode_map(&tm_q, q, b * h, s, D, kDkvStep) ||
      !encode_map(&tm_k, k, b * h_kv, s, D, kHRows) ||
      !encode_map(&tm_v, v, b * h_kv, s, D, kHRows) ||
      !encode_map(&tm_dout, dout, b * h, s, D, kDkvStep) ||
      !encode_map(&tm_dk, dk, b * h_kv, s, D, kHRows / kConsumers) ||
      !encode_map(&tm_dv, dv, b * h_kv, s, D, kHRows / kConsumers)) {
    return cudaErrorInvalidValue;
  }
  // a masked block's live list of Q steps follows its barriers
  const size_t smem =
      DkvSmem<D>::kBytes +
      (kMasked ? live_list_bytes((s + kDkvStep - 1) / kDkvStep) : 0);
  auto kernel = flash_bwd_dkv_bf16_kernel<D, kMasked>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kHRows - 1) / kHRows, h_kv, b);
  kernel<<<grid, kHThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_dout, tm_dk, tm_dv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), h, h_kv, s, causal, window, scale,
      mask);
  return cudaGetLastError();
}

template <int D, bool kMasked>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int b, int h,
                           int h_kv, int s, int causal, int window,
                           float scale, const BlockMask& mask,
                           cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_dout, tm_dq;
  if (!encode_map(&tm_q, q, b * h, s, D, kHRows) ||
      !encode_map(&tm_k, k, b * h_kv, s, D, kDqStep) ||
      !encode_map(&tm_v, v, b * h_kv, s, D, kDqStep) ||
      !encode_map(&tm_dout, dout, b * h, s, D, kHRows) ||
      !encode_map(&tm_dq, dq, b * h, s, D, kHRows / kConsumers)) {
    return cudaErrorInvalidValue;
  }
  // a masked block's live list of K tiles follows its barriers
  const size_t smem =
      DqSmem<D>::kBytes +
      (kMasked ? live_list_bytes((s + kDqStep - 1) / kDqStep) : 0);
  auto kernel = flash_bwd_dq_bf16_kernel<D, kMasked>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kHRows - 1) / kHRows, h, b);
  kernel<<<grid, kHThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_dout, tm_dq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), h, h_kv, s, causal, window, scale,
      mask);
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
  if (dtype == 1 && d == 64)
    return (int)launch_dkv_bf16<64, kMasked>(q, k, v, dout, lse, delta, dk,
                                             dv, b, h, h_kv, s, causal,
                                             window, scale, mask, st);
  if (dtype == 1 && d == 128)
    return (int)launch_dkv_bf16<128, kMasked>(q, k, v, dout, lse, delta, dk,
                                              dv, b, h, h_kv, s, causal,
                                              window, scale, mask, st);
  if (dtype == 0 && d == 64)
    return (int)launch_dkv_f32<64, kMasked>(q, k, v, dout, lse, delta, dk,
                                            dv, b, h, h_kv, s, causal,
                                            window, scale, mask, st);
  if (dtype == 0 && d == 128)
    return (int)launch_dkv_f32<128, kMasked>(q, k, v, dout, lse, delta, dk,
                                             dv, b, h, h_kv, s, causal,
                                             window, scale, mask, st);
  return (int)cudaErrorInvalidValue;
}

template <bool kMasked>
int dispatch_dq(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int dtype, int b, int h, int h_kv, int s, int d,
                int causal, int window, float scale, const BlockMask& mask,
                cudaStream_t st) {
  if (dtype == 1 && d == 64)
    return (int)launch_dq_bf16<64, kMasked>(q, k, v, dout, lse, delta, dq, b,
                                            h, h_kv, s, causal, window, scale,
                                            mask, st);
  if (dtype == 1 && d == 128)
    return (int)launch_dq_bf16<128, kMasked>(q, k, v, dout, lse, delta, dq,
                                             b, h, h_kv, s, causal, window,
                                             scale, mask, st);
  if (dtype == 0 && d == 64)
    return (int)launch_dq_f32<64, kMasked>(q, k, v, dout, lse, delta, dq, b,
                                           h, h_kv, s, causal, window, scale,
                                           mask, st);
  if (dtype == 0 && d == 128)
    return (int)launch_dq_f32<128, kMasked>(q, k, v, dout, lse, delta, dq, b,
                                            h, h_kv, s, causal, window, scale,
                                            mask, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.  scale
// is d^-1/2 as the caller rounds it to f32.  Each returns
// cudaErrorInvalidValue for a dtype, head_dim or head count the kernel
// does not take or a tensor map cuTensorMapEncodeTiled refuses, else the
// launch's cudaGetLastError().

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
