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
// and out are 16.8 MB (+ 0.13 MB of lse), 5.05 us at 3.35 TB/s: the memory
// traffic.  At the training shape (2, 8, 2048, 128) the band's 17.2 GFLOP
// take 17.4 us, three times its 5.1 us of traffic: the tensor cores.
//
// What the design does about it.  One thread block per (batch, head,
// 128-row Q tile) keeps its Q tile, its accumulator and its softmax state
// on chip for the whole K sweep, so neither the s x s scores nor a partial
// output reach device memory, and K/V tiles above the causal diagonal or
// outside the window are never loaded.  The K sweep is a loop inside the
// block (the Pallas grid's sequential innermost axis), because Hopper runs
// blocks in parallel and in no order; the longest causal rows start
// first, and in the bf16 dense sweep across all heads (every head's last
// Q tile before any head's last but one), which keeps the last wave from
// holding one head's long tiles alone.
//
// bf16 (the model's path) is warp-specialised, 384 threads:
//   - warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//     one thread issues TMA copies: Q once, then K and V tiles of 128 keys
//     into a two-stage ring in shared memory, 128B-swizzled (a d = 128 row
//     is two 64-column boxes), each stage guarded by full / empty
//     mbarriers.  Rows past s arrive as zeros from TMA's bounds check, so
//     no copy crosses into the next head.
//   - warpgroups 1 and 2 are consumers, 64 query rows each (the wgmma
//     m64 tile), with 240 registers a thread: S = Q . K^T by wgmma with
//     both operands in shared memory (K-major), the softmax on the f32
//     accumulator in registers (exp2 of scores pre-multiplied by
//     d^-1/2 log2(e)), then O += P . V by wgmma with P repacked to bf16
//     A-operand registers straight from the score accumulator and V read
//     MN-major (transposed by the descriptor).  A consumer releases a K
//     (V) stage as soon as its product has read it.
//   - the products hide the softmax: a consumer issues S_i and
//     P_{i-1} . V_{i-1} together and runs the softmax of S_i while the
//     second product runs (overlap), and the two consumers take turns to
//     issue (ping-pong, named barriers), so one's softmax also runs under
//     the other's products.
//   - out goes through shared memory (each consumer's rows of the Q
//     buffer) and a TMA store, which drops rows past s; lse is stored
//     directly.
// The tensor maps are encoded on the host by the launchers
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
// nothing links libcuda) and passed as __grid_constant__ parameters.
//
// f32: the products run on the CUDA cores (the tensor cores would round
// f32 to TF32) over 64 x 64 shared-memory tiles with 128 threads; this
// path exists for f32 configs and is not tuned.
//
// GQA: query head hi reads KV head hi / (h / h_kv); KV is never repeated.
// Ragged lengths: rows past the sequence end are loaded as zeros, masked,
// and never written, so every length runs on the kernel.
//
// Block-sparse mode (kMasked = true; replaces the same Pallas kernel with
// has_mask=True, launched by block_sparse_attention): a pair is visible
// when the caller's [s / block_q, s / block_k] mask keeps its block and,
// if causal, the key is not after the query.  The mask's blocks are the
// caller's (any divisors of s), not the kernel's tiles, so each block
// first lists, in shared memory, the K tiles that hold a visible pair for
// its Q tile (BlockMask::tile_state, build_live_tiles, all threads before
// the roles split); the producer loads and the consumers sweep that list.
// A tile the mask cuts through takes the pair-by-pair test in visible().
// A Q tile with an empty list loads nothing and writes out = 0 and
// lse = -inf, as does every row with no visible key.  The dense
// instantiations read no mask.
//
// Layout: q, out [b, h, s, d]; k, v [b, h_kv, s, d]; all contiguous.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;  // warp w owns Q rows [16w, 16w + 16)
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;

using Tile = TileOf<kBlockQ, kBlockK>;  // the f32 kernel's 64 x 64 tiles

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

// A masked block's live list of K tiles, built by all THREADS threads in
// the shared memory at `list` (after the block's tiles)
template <int THREADS = kThreads, int BQ, int BK>
__device__ __forceinline__ LiveTiles live_k_tiles(unsigned char* list,
                                                  const TileOf<BQ, BK>& tile,
                                                  int s, bool causal,
                                                  const BlockMask& mask) {
  return build_live_tiles<THREADS>(
      reinterpret_cast<int*>(list), (s + BK - 1) / BK, [&](int kt) {
        return mask.tile_state(tile.q0, tile.q0 + BQ, kt * BK, (kt + 1) * BK,
                               s, causal);
      });
}

// ------------------------------------------------------------------------
// bf16: TMA producer, two wgmma consumer warpgroups
// ------------------------------------------------------------------------

constexpr int kHBlockQ = 128;  // Q rows per block: 64 per consumer
constexpr int kHBlockK = 128;  // keys per K / V tile: S is one m64n128 wgmma
constexpr int kStages = 2;     // K / V ring depth
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kHThreads = 128 * (1 + kConsumers);
// registers a thread after the hand-over: 128 x 24 + 256 x 240 = 168 x 384
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// named barriers: 1 + cw closes warpgroup cw's sweep before its
// epilogue; kTurnBarrier + cw is its turn to issue products (ping-pong)
constexpr int kTurnBarrier = 3;

template <int D>
struct HopperSmem {
  // byte offsets from the 1024-aligned base: Q, K[kStages], V[kStages],
  // then the mbarriers and (masked) the live list
  static constexpr uint32_t kQBox = kHBlockQ * 128;  // one 64-column box
  static constexpr uint32_t kKVBox = kHBlockK * 128;
  static constexpr uint32_t kQBytes = kQBox * (D / kBoxCols);
  static constexpr uint32_t kKVBytes = kKVBox * (D / kBoxCols);
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  // q_full, k_full[], k_empty[], v_full[], v_empty[]
  static constexpr uint32_t kBars = kV + kStages * kKVBytes;
  static constexpr uint32_t kList = kBars + 8 * (1 + 4 * kStages);
  // + 1024: the dynamic shared memory is aligned up to 1024 in the kernel
  static constexpr size_t kBytes = kList + 1024;
};

template <int D, bool kMasked>
__global__ void __launch_bounds__(kHThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_out,
                      float* __restrict__ lse, int h, int h_kv, int s,
                      int causal, int window, float scale,
                      const BlockMask mask) {
  using G = HopperSmem<D>;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ unsigned char smem_raw[];
  // 128B-swizzled tiles start 1024-aligned
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t sQ = base + G::kQ;
  auto sK = [&](int st) { return base + G::kK + st * G::kKVBytes; };
  auto sV = [&](int st) { return base + G::kV + st * G::kKVBytes; };
  const uint32_t q_full = base + G::kBars;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * kStages + st); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);  // the producer's arrive + TMA bytes
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kConsumers * 4);  // one arrive per consumer warp
      mbar_init(v_empty(st), kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const bool banded = causal || window > 0;
  // A masked block's sweep is its live list, whose length the Q tile
  // does not set: masked blocks keep the order of each head in turn (at
  // the document mask it measured faster than the order across heads).
  const TileOf<kHBlockQ, kHBlockK> tile(h, h_kv, s, D, banded, window,
                                        !kMasked);
  // the K tiles to visit, kt in [kt_begin, kt_end]: tile kt of the band
  // (dense), or entry kt of this Q tile's live list (masked)
  const LiveTiles live = kMasked ? live_k_tiles<kHThreads>(smem + G::kList,
                                                           tile, s, banded,
                                                           mask)
                                 : LiveTiles();
  const int kt_begin = kMasked ? 0 : tile.k_tile_begin;
  const int kt_end = kMasked ? live.count - 1 : tile.k_tile_end;

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && kt_begin <= kt_end) {  // an empty list loads nothing
      mbar_arrive_expect_tx(q_full, G::kQBytes);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load_3d(sQ + c * G::kQBox, &tm_q, c * kBoxCols, tile.q0,
                    tile.q_head, q_full);
      }
      for (int kt = kt_begin; kt <= kt_end; ++kt) {
        const int i = kt - kt_begin;
        const int st = i % kStages;
        const uint32_t free_parity = ((i / kStages) & 1) ^ 1;
        const int k0 = (kMasked ? live.tile(kt) : kt) * kHBlockK;
        mbar_wait(k_empty(st), free_parity);
        mbar_arrive_expect_tx(k_full(st), G::kKVBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_3d(sK(st) + c * G::kKVBox, &tm_k, c * kBoxCols, k0,
                      tile.kv_head, k_full(st));
        }
        mbar_wait(v_empty(st), free_parity);
        mbar_arrive_expect_tx(v_full(st), G::kKVBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load_3d(sV(st) + c * G::kKVBox, &tm_v, c * kBoxCols, k0,
                      tile.kv_head, v_full(st));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns Q rows [64 cw, 64 cw + 64) ----
    setmaxnreg_inc<kConsumerRegs>();
    constexpr int kSAcc = kHBlockK / 2;  // score accumulator floats a thread
    constexpr int kOAcc = D / 2;         // output accumulator floats a thread
    constexpr int kPSteps = kHBlockK / 16;  // k16 steps of O += P . V
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // accumulator row group
    const int t = lane % 4;  // accumulator column pair
    const int r0 = 16 * warp + g;  // this lane's rows in the warpgroup: r0, r0 + 8
    const int wq0 = tile.q0 + 64 * cw;  // the warpgroup's first query
    const int q_pos0 = wq0 + r0;
    const int q_pos1 = q_pos0 + 8;
    const float scale_log2 = scale * 1.4426950408889634f;  // d^-1/2 log2(e)
    const uint32_t q_rows_addr = sQ + cw * 64 * 128;

    float o[kOAcc];
#pragma unroll
    for (int i = 0; i < kOAcc; ++i) o[i] = 0.f;
    float sc[kSAcc];             // scores, then p in f32
    uint32_t p[kPSteps][4];      // p in bf16: the A operand of O += P . V
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of raw scores
    float l0 = 0.f, l1 = 0.f;              // this lane's share of the row sums

    // S = Q . K^T (64 rows x 128 keys, f32) from stage st, issued
    auto issue_s = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = kk / 4, col = (kk % 4) * 32;  // 16 bf16 = 32 B
        wgmma_ss_m64n128k16(
            sc, wgmma_desc(q_rows_addr + box * G::kQBox + col, 16, 1024),
            wgmma_desc(sK(st) + box * G::kKVBox + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      fence_regs(sc);
    };
    // O += P . V from stage st, issued
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
        // keys [16 kk, 16 kk + 16): two 8-row groups of 128-byte rows
        wgmma_rs<D>(o, p[kk],
                    wgmma_desc(sV(st) + kk * 16 * 128, G::kKVBox, 1024));
      }
      wgmma_commit();
      fence_regs(o);
    };
    // mask, online softmax of the scores of tile entry kt (rows r0 and
    // r0 + 8): sc becomes p in f32, m and l move on; returns the factors
    // (corr0, corr1) that rescale the rows' accumulator
    auto softmax = [&](int kt) {
      const int k0 = (kMasked ? live.tile(kt) : kt) * kHBlockK;
      // a tile needs the element mask only where the band, the end or the
      // block mask cuts it
      const bool cut = kMasked && live.cut(kt);
      const bool edge = k0 + kHBlockK > s ||
                        (banded && k0 + kHBlockK - 1 > wq0) ||
                        (window > 0 && k0 <= wq0 + 63 - window) || cut;
      if (edge) {
#pragma unroll
        for (int j = 0; j < kHBlockK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int k_pos = k0 + j * 8 + t * 2 + c;
            if (!visible(q_pos0, k_pos, s, banded, window, cut, mask))
              sc[4 * j + c] = -INFINITY;
            if (!visible(q_pos1, k_pos, s, banded, window, cut, mask))
              sc[4 * j + 2 + c] = -INFINITY;
          }
        }
      }
      // four partial maxima and sums a row keep the chains short
      float bm0[4], bm1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        bm0[u] = fmaxf(sc[4 * u], sc[4 * u + 1]);
        bm1[u] = fmaxf(sc[4 * u + 2], sc[4 * u + 3]);
      }
#pragma unroll
      for (int j = 4; j < kHBlockK / 8; ++j) {
        bm0[j % 4] = fmaxf(bm0[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
        bm1[j % 4] = fmaxf(bm1[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float mx0 = fmaxf(fmaxf(bm0[0], bm0[1]), fmaxf(bm0[2], bm0[3]));
      float mx1 = fmaxf(fmaxf(bm1[0], bm1[1]), fmaxf(bm1[2], bm1[3]));
      // the four lanes of a quad hold one row between them
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // the exponent's offset in log2 units; a row with no visible key so
      // far keeps m = -inf and takes 0, so exp2 sees -inf (p = 0), never
      // +inf or nan
      const float off0 = mn0 == -INFINITY ? 0.f : mn0 * scale_log2;
      const float off1 = mn1 == -INFINITY ? 0.f : mn1 * scale_log2;
      const float corr0 = exp2_approx(fmaf(m0, scale_log2, -off0));
      const float corr1 = exp2_approx(fmaf(m1, scale_log2, -off1));
      m0 = mn0;
      m1 = mn1;
      float rs0[4] = {0.f, 0.f, 0.f, 0.f}, rs1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kHBlockK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[4 * j + c] = exp2_approx(fmaf(sc[4 * j + c], scale_log2, -off0));
          sc[4 * j + 2 + c] =
              exp2_approx(fmaf(sc[4 * j + 2 + c], scale_log2, -off1));
          rs0[j % 4] += sc[4 * j + c];
          rs1[j % 4] += sc[4 * j + 2 + c];
        }
      }
      l0 = l0 * corr0 + ((rs0[0] + rs0[1]) + (rs0[2] + rs0[3]));
      l1 = l1 * corr1 + ((rs1[0] + rs1[1]) + (rs1[2] + rs1[3]));
      return make_float2(corr0, corr1);
    };
    // p in bf16, straight from the score accumulator's layout
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
        p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    // pin the products' register operands: no instruction that writes
    // them may sink past this point into a product's pipeline stage
    // (ptxas would then serialise every wgmma)
    auto fence_operands = [&]() {
      fence_regs(o);
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) fence_regs(p[kk]);
    };
    // Ping-pong: the two warpgroups take turns to issue their products,
    // so one's softmax runs under the other's products.  Warpgroup cw
    // waits at barrier kTurnBarrier + cw until the other has issued; each
    // barrier counts the owner's 128 syncs and the other's 128 arrives.
    auto my_turn = [&]() { named_barrier_sync(kTurnBarrier + cw, 256); };
    auto their_turn = [&]() {
      named_barrier_arrive(kTurnBarrier + (cw ^ 1), 256);
    };

    // The sweep, n tiles: step 0 issues S_0; step i (1 <= i < n) issues
    // S_i and O += P_{i-1} V_{i-1} together and runs the softmax of S_i
    // while the second product does; step n issues the
    // last P . V.  Step 0 is peeled off, so every wgmma.wait_group of the
    // loop retires the same products on every path (ptxas serialises the
    // products when it cannot tell).
    const int n = kt_end - kt_begin + 1;
    if (n > 0) {
      if (cw == 1) their_turn();  // warpgroup 0 issues first
      mbar_wait(q_full, 0);
      my_turn();
      mbar_wait(k_full(0), 0);
      fence_operands();
      wgmma_fence();
      issue_s(0);
      their_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty(0));
      softmax(kt_begin);  // o is 0: nothing to rescale
      pack_p();
      for (int i = 1; i < n; ++i) {
        const int st = i % kStages, prev = (i - 1) % kStages;
        my_turn();
        mbar_wait(k_full(st), (i / kStages) & 1);
        mbar_wait(v_full(prev), ((i - 1) / kStages) & 1);
        // o and p were written since the last products: finish those
        // writes here, before the products start
        fence_operands();
        wgmma_fence();
        issue_s(st);
        issue_pv(prev);
        their_turn();
        wgmma_wait<1>();  // S_i is done, P_{i-1} V_{i-1} may run on
        fence_regs(sc);
        if (lane == 0) mbar_arrive(k_empty(st));
        const float2 corr = softmax(kt_begin + i);
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < kPSteps; ++kk) fence_regs(p[kk]);
        if (lane == 0) mbar_arrive(v_empty(prev));
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= corr.x;
          o[4 * j + 1] *= corr.x;
          o[4 * j + 2] *= corr.y;
          o[4 * j + 3] *= corr.y;
        }
        pack_p();
      }
      const int last = (n - 1) % kStages;
      my_turn();
      mbar_wait(v_full(last), ((n - 1) / kStages) & 1);
      fence_operands();
      wgmma_fence();
      issue_pv(last);
      // warpgroup 1's turns end here: no sync of warpgroup 0 is left to
      // meet another arrive
      if (cw == 0) their_turn();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) fence_regs(p[kk]);
      if (lane == 0) mbar_arrive(v_empty(last));
    }

    // ---- out = acc / max(l, 1e-30) through shared memory, lse ----
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    // this warpgroup's rows of the Q buffer are free once all its warps
    // are past their last product
    named_barrier_sync(1 + cw, 128);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      // columns 8j + 2t, + 1: box j / 8, 16-byte chunk j % 8, swizzled
      const uint32_t at = q_rows_addr + (j / 8) * G::kQBox + r0 * 128 +
                          (((j % 8) ^ (r0 % 8)) * 16) + t * 4;
      const uint32_t lo = pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
      const uint32_t hi = pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(lo) : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + 8 * 128), "r"(hi)
                   : "memory");
    }
    fence_proxy_async();
    named_barrier_sync(1 + cw, 128);
    if (tid == 0 && wq0 < s) {
      for (int c = 0; c < kBoxes; ++c) {
        tma_store_3d(&tm_out, q_rows_addr + c * G::kQBox, c * kBoxCols, wq0,
                     tile.q_head);
      }
      tma_store_commit_and_wait();
    }
    if (t == 0) {
      float* lse_rows = lse + (size_t)tile.q_head * s;
      if (q_pos0 < s) lse_rows[q_pos0] = l0 > 0.f ? m0 * scale + logf(d0) : -INFINITY;
      if (q_pos1 < s) lse_rows[q_pos1] = l1 > 0.f ? m1 * scale + logf(d1) : -INFINITY;
    }
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

template <int D, bool kMasked>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, void* lse, int b, int h, int h_kv, int s,
                        int causal, int window, float scale,
                        const BlockMask& mask, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_out;
  if (!encode_map(&tm_q, q, b * h, s, D, kHBlockQ) ||
      !encode_map(&tm_k, k, b * h_kv, s, D, kHBlockK) ||
      !encode_map(&tm_v, v, b * h_kv, s, D, kHBlockK) ||
      !encode_map(&tm_out, out, b * h, s, D, kHBlockQ / kConsumers)) {
    return cudaErrorInvalidValue;
  }
  // a masked block's live list follows its barriers in shared memory
  const size_t smem =
      HopperSmem<D>::kBytes +
      (kMasked ? live_list_bytes((s + kHBlockK - 1) / kHBlockK) : 0);
  auto kernel = flash_fwd_bf16_kernel<D, kMasked>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kHBlockQ - 1) / kHBlockQ, h, b);
  kernel<<<grid, kHThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_out,
                                            static_cast<float*>(lse), h,
                                            h_kv, s, causal, window, scale,
                                            mask);
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
    return (int)launch_bf16<64, kMasked>(q, k, v, out, lse, b, h, h_kv, s,
                                         causal, window, scale, mask, st);
  if (dtype == 1 && d == 128)
    return (int)launch_bf16<128, kMasked>(q, k, v, out, lse, b, h, h_kv, s,
                                          causal, window, scale, mask, st);
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
// kernel does not take or a tensor map the driver refuses, else the
// launch's cudaGetLastError().
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
