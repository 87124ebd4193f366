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
// f32 (f32 models, e.g. entry.flagship_config(torch.float32)): the same
// function at f32 accuracy, 128 threads, 64 query rows a block (warp w
// owns rows 16w..16w + 15).  What bounds it: at (4, 8, 1024, 64) causal
// the band's 4.30 GFLOP take 26 us at 165 TFLOP/s, the card's fastest
// f32-accurate rate (three TF32 passes at 495), against 33.6 MB of
// traffic, 10 us: operations.  The previous design (one thread per dot
// product out of shared memory, two shared loads an FMA, no tensor core)
// sat at 3.5 TFLOP/s, shared-memory bound.  This one:
//   - products on the tensor cores by mma.sync m16n8k8 TF32 in 3xTF32:
//     each operand fragment is split in registers into TF32 big and small
//     parts, and a . b = a_small b_big + a_big b_small + a_big b_big (only
//     small x small, 2^-22 of |a b|, is dropped), so the result keeps f32
//     accuracy (a single TF32 pass would be off by ~5e-4).  mma.sync and
//     not wgmma: wgmma reads its B operand (here A too) from shared
//     memory, so the split would need big and small copies of every tile
//     there, and TF32 wgmma takes only K-major operands where V is
//     MN-major in P . V;
//   - K / V tiles of 32 keys come through a two-stage ring by cp.async,
//     so tile i + 1 loads under tile i's products; rows are padded to
//     D + 4 floats, which puts every fragment load of a warp on 32 banks;
//   - Q: at d = 64 each warp keeps its fragments split in registers for
//     the whole sweep; at d = 128 that would take 128 registers, so they
//     are read from shared memory and split at each use;
//   - the softmax runs on the S accumulator in registers (exp2 with
//     d^-1/2 log2(e) folded in, as bf16); P goes from the accumulator to
//     P . V's A operand with no shuffle: the accumulator holds keys
//     2t, 2t + 1 of an 8-key slice where the A layout wants t, t + 4, and
//     since the product sums over keys, k slot t takes key 2t and slot
//     t + 4 key 2t + 1 on both sides (V's B fragment reads those rows);
//   - a warp skips a tile none of its rows sees (band, window); dense
//     blocks go longest causal rows first across all heads.
// The O accumulator keeps the running sum on the tensor cores: their
// truncating accumulation leaves out 5.5e-6 off at (2, 8, 2048, 128),
// inside the 1e-4 limit.  No instantiation spills (chip_smoke.py checks
// it).
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

// the f32 kernel: 64 query rows a block, warp w owns rows [16w, 16w + 16)
constexpr int kBlockQ = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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
// f32: 3xTF32 mma.sync over a cp.async ring (the design is in the note
// at the top)
// ------------------------------------------------------------------------

template <int D>
struct F32Smem {
  // keys a K / V tile: 32 ran 3% faster than 64 at d = 64 on the card
  // (flash_ablations.py); 52 KB of shared memory a block at d = 64, 101 KB
  // at d = 128
  static constexpr int kBK = 32;
  // floats a row: 16-byte rows, and every fragment load of a warp on 32
  // distinct banks (D + 4 = 4 mod 32)
  static constexpr int kLd = D + 4;
  static constexpr int kTile = kBK * kLd;
  static constexpr size_t kQ = 0;
  // stage st of the ring: K at kRing + 2 st kTile, V right after it
  static constexpr size_t kRing = kQ + kBlockQ * kLd;
  static constexpr size_t kBytes = sizeof(float) * (kRing + 2 * 2 * kTile);
};

// The bounds are measured, not derived (flash_ablations.py, fwd_no_cap):
// at d = 128 a register cap of three blocks' worth (170; shared memory
// holds two) and at d = 64 an explicit minimum of one block (185
// registers, against 168 without it) each ran 7-9% faster on the card
template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads, D == 128 ? 3 : 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int h, int h_kv, int s,
                     int causal, int window, float scale,
                     const BlockMask mask) {
  using G = F32Smem<D>;
  constexpr int kBK = G::kBK;
  constexpr int kLd = G::kLd;
  // d = 64: the warp's Q fragments stay split in registers (64 of them)
  // for the whole sweep; d = 128 would need 128, so they are read from
  // shared memory and split at each use
  constexpr bool kQInRegs = D == 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const float* sQ = smem + G::kQ;

  const bool banded = causal || window > 0;
  // dense: longest causal rows first across all heads, as the bf16 sweep
  const TileOf<kBlockQ, kBK> tile(h, h_kv, s, D, banded, window, !kMasked);
  const LiveTiles live = kMasked ? live_k_tiles(smem_raw + G::kBytes, tile,
                                                s, banded, mask)
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
    cp_async_rows_f32<D, kBK, kLd, kThreads>(sK, k + at, min(kBK, s - k0));
    cp_async_rows_f32<D, kBK, kLd, kThreads>(sK + G::kTile, v + at,
                                             min(kBK, s - k0));
  };
  cp_async_rows_f32<D, kBlockQ, kLd, kThreads>(smem + G::kQ,
                                               q + tile.q_offset, tile.q_rows);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;        // fragment row group
  const int t = lane % 4;        // fragment column pair
  const int r0 = 16 * warp + g;  // this lane's rows of the tile: r0, r0 + 8
  const int qw0 = tile.q0 + 16 * warp;  // the warp's first query
  const float scale_log2 = scale * 1.4426950408889634f;  // d^-1/2 log2(e)

  Tf32Split<4> qf[kQInRegs ? D / 8 : 1];
  float o[D / 8][4];  // acc of rows r0 (0, 1), r0 + 8 (2, 3), cols 8n + 2t, +1
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_kv(i + 1);
    cp_async_commit();  // an empty group past the last tile
    cp_async_wait<1>();  // Q and tile i have landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    if (kQInRegs && i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) qf[kk] = a_frag<kLd>(sQ, r0, kk, t);
    }
    const int k0 = k_start(i);
    const bool cut = kMasked && live.cut(i);
    const float* sK = smem + G::kRing + (i % 2) * 2 * G::kTile;
    const float* sV = sK + G::kTile;
    // the warp's 16 rows see no key of this tile (band or window): skip
    const bool dead = (banded && k0 > qw0 + 15) ||
                      (window > 0 && qw0 - (k0 + kBK - 1) >= window);
    if (!dead) {
      // S = Q . K^T for rows r0, r0 + 8, keys 8j + 2t, +1
      float sc[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        Tf32Split<4> a;
        if constexpr (kQInRegs) {
          a = qf[kk];
        } else {
          a = a_frag<kLd>(sQ, r0, kk, t);
        }
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          // B = K^T: (k 8kk + t, n 8j + g) and (8kk + t + 4, 8j + g)
          const float* kb = sK + (8 * j + g) * kLd + 8 * kk + t;
          Tf32Split<2> b;
          b.set(0, kb[0]);
          b.set(1, kb[4]);
          mma_3xtf32(sc[j], a, b);
        }
      }

      // mask, then the online softmax of rows r0 (c = 0, 1) and r0 + 8
      // (c = 2, 3); every key of a full tile is visible to every row
      const bool full = !cut && k0 + kBK <= s &&
                        (!banded || k0 + kBK - 1 <= qw0) &&
                        (window <= 0 || qw0 + 15 - k0 < window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!full && !visible(tile.q0 + r0 + 8 * (c / 2),
                                k0 + 8 * j + 2 * t + (c % 2), s, banded,
                                window, cut, mask)) {
            sc[j][c] = -INFINITY;
          }
          mx[c / 2] = fmaxf(mx[c / 2], sc[j][c]);
        }
      }
      float off[2];  // the exponent's offset in log2 units
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no visible key so far keeps m = -inf and takes
        // offset 0, so exp2 sees -inf (p = 0), never inf - inf
        off[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
        const float corr = exp2_approx(fmaf(m[r], scale_log2, -off[r]));
        m[r] = mx[r];
        l[r] *= corr;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][2 * r] *= corr;
          o[n][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sc[j][c] = exp2_approx(fmaf(sc[j][c], scale_log2, -off[c / 2]));
          l[c / 2] += sc[j][c];
        }
      }

      // O += P . V: P's accumulator is the A fragment with its keys
      // permuted (acc_as_a), and V's B fragment reads the same keys
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const Tf32Split<4> a = acc_as_a(sc[j]);
        const float* vb = sV + (8 * j + 2 * t) * kLd + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          mma_3xtf32(o[n], a, b_rows_permuted<kLd>(vb, n));
        }
      }
    }
    __syncthreads();  // stage i % 2 is free for tile i + 2
  }
  cp_async_wait<0>();  // an empty live list left Q's copies in flight

  // rows r0 and r0 + 8: the quad's shares of l, then out = acc / l and
  // lse (-inf, with out = 0, on a row with no visible key)
  float* lse_rows = lse + tile.q_offset / D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= tile.q_rows) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* out_row = out + tile.q_offset + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(out_row + 8 * n) =
          make_float2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
    }
    if (t == 0) {
      lse_rows[row] = l[r] > 0.f ? m[r] * scale + logf(denom) : -INFINITY;
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
  // a masked f32 block's live list follows its tiles in shared memory
  auto list = [&](int bk) {
    return kMasked ? live_list_bytes((s + bk - 1) / bk) : 0;
  };
  if (dtype == 1 && d == 64)
    return (int)launch_bf16<64, kMasked>(q, k, v, out, lse, b, h, h_kv, s,
                                         causal, window, scale, mask, st);
  if (dtype == 1 && d == 128)
    return (int)launch_bf16<128, kMasked>(q, k, v, out, lse, b, h, h_kv, s,
                                          causal, window, scale, mask, st);
  if (dtype == 0 && d == 64)
    return (int)launch<float>(
        flash_fwd_f32_kernel<64, kMasked>,
        F32Smem<64>::kBytes + list(F32Smem<64>::kBK), q, k,
        v, out, lse, b, h, h_kv, s, causal, window, scale, mask, st);
  if (dtype == 0 && d == 128)
    return (int)launch<float>(
        flash_fwd_f32_kernel<128, kMasked>,
        F32Smem<128>::kBytes + list(F32Smem<128>::kBK), q, k,
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
