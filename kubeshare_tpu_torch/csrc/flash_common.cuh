// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): shared-memory addresses, bf16 packing, the f32 kernels'
// tile loads by cp.async and their 3xTF32 tensor-core products, the Q
// tile a block owns (TileOf), and the block mask and tile sweep of the
// block-sparse mode.  Each including source gets its own copy (anonymous
// namespace).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- f32: cp.async and 3xTF32 mma.sync ----------------------------------

// 16 bytes from global memory at `src` into shared memory at `dst`,
// asynchronously (cp.async, bypassing L1); with `bytes` = 0 nothing is
// read and 16 zero bytes are written
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// the same for one float
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// [ROWS, D] f32 tile into rows of LD floats by cp.async, 16 bytes a copy;
// rows at or past `valid` are zero-filled and read nothing
template <int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void cp_async_rows_f32(float* dst,
                                                  const float* src,
                                                  int valid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool in = r < valid;
    cp_async_16(smem_u32(dst + r * LD + 4 * c),
                src + (size_t)(in ? r : 0) * D + 4 * c, in ? 16 : 0);
  }
}

// x rounded to nearest to TF32 (10 mantissa bits), as an f32 bit pattern
// whose low 13 bits are zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// An mma.sync operand fragment of N f32 values, each split into a TF32
// big part and the TF32 rounding of its remainder (x - big is exact in
// f32), so that big + small carries 21 of x's 24 significant bits
template <int N>
struct Tf32Split {
  uint32_t big[N], small[N];

  __device__ __forceinline__ void set(int i, float x) {
    big[i] = to_tf32(x);
    small[i] = to_tf32(x - __uint_as_float(big[i]));
  }
};

// d += a . b for one m16n8k8 tile, TF32 operands, f32 accumulation.
// Fragments (g = lane / 4, t = lane % 4): a[0..3] hold A's (row, k) at
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b[0..1] hold B's (k, n)
// at (t, g), (t + 4, g); d[0..3] hold (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b to f32 accuracy on the tensor cores (3xTF32): the two cross
// terms first, then big . big; only small . small (2^-22 of |a| |b|) is
// dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const Tf32Split<4>& a,
                                           const Tf32Split<2>& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// A fragment of rows r0, r0 + 8 of a row-major f32 tile at columns
// 8 kk + t, 8 kk + t + 4 (the m16n8k8 A layout), split for 3xTF32
template <int LD>
__device__ __forceinline__ Tf32Split<4> a_frag(const float* tile, int r0,
                                               int kk, int t) {
  const float* at = tile + r0 * LD + 8 * kk + t;
  Tf32Split<4> a;
  a.set(0, at[0]);
  a.set(1, at[8 * LD]);
  a.set(2, at[4]);
  a.set(3, at[8 * LD + 4]);
  return a;
}

// The accumulator of an m16n8 tile (rows g, g + 8 at columns 2t, 2t + 1)
// as the A fragment of a product that sums over those columns: k slot t
// takes column 2t and slot t + 4 column 2t + 1, so the B fragment must
// read rows 2t and 2t + 1 of its 8 (b_rows_permuted)
__device__ __forceinline__ Tf32Split<4> acc_as_a(const float (&c)[4]) {
  Tf32Split<4> a;
  a.set(0, c[0]);
  a.set(1, c[2]);
  a.set(2, c[1]);
  a.set(3, c[3]);
  return a;
}

// B fragment of rows 2t, 2t + 1 of a row-major tile (`rows` points at
// row 2t, column g), column 8n + g: the permuted k slots of acc_as_a
template <int LD>
__device__ __forceinline__ Tf32Split<2> b_rows_permuted(const float* rows,
                                                        int n) {
  Tf32Split<2> b;
  b.set(0, rows[8 * n]);
  b.set(1, rows[LD + 8 * n]);
  return b;
}

// Where a (batch, head, Q tile) block of BQ query rows starts and which
// BK-key tiles it visits.
template <int BQ, int BK>
struct TileOf {
  int q0, q_rows, k_tile_begin, k_tile_end;
  int q_head, kv_head;         // rows of the [b * h] and [b * h_kv] heads
  size_t q_offset, kv_offset;  // element offsets of the Q rows, the KV head

  // across_heads: order the blocks longest causal rows first over all
  // heads (the bf16 dense sweep); else over each head in turn.
  __device__ TileOf(int h, int h_kv, int s, int d, bool banded, int window,
                    bool across_heads = false) {
    int q_tile, head;
    if (across_heads) {
      // Walk every head's last Q tile first, then every head's last but
      // one, so the short tiles fill the last wave's gaps.  This relies on
      // blocks starting in the order of their linear index (x fastest,
      // then y, z), which the H100 was measured to do but which no
      // documentation guarantees; another GPU or driver may lose the gain
      // (never correctness).  A persistent kernel with an atomic tile
      // counter would make the order explicit.
      const int heads = gridDim.y * gridDim.z;  // b * h
      const int lin =
          blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
      q_tile = gridDim.x - 1 - lin / heads;
      q_head = lin % heads;  // batch * h + head
      head = q_head % h;
    } else {
      q_tile = gridDim.x - 1 - blockIdx.x;  // longest rows first
      head = blockIdx.y;
      q_head = blockIdx.z * h + head;
    }
    const int batch = q_head / h;
    kv_head = batch * h_kv + head / (h / h_kv);
    q0 = q_tile * BQ;
    q_rows = min(BQ, s - q0);
    q_offset = ((size_t)q_head * s + q0) * d;
    kv_offset = (size_t)kv_head * s * d;
    // K tiles that can hold a visible key for some row of this Q tile
    k_tile_end = (banded ? q0 + q_rows - 1 : s - 1) / BK;
    k_tile_begin = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  }
};

// ------------------------------------------------------------------------
// Block-sparse mode (kernels instantiated with kMasked = true)
// ------------------------------------------------------------------------

// The caller's block mask: a pair (q_pos, k_pos) is visible when the byte
// of its (q_pos / block_q, k_pos / block_k) block is nonzero (and, if
// causal, k_pos <= q_pos).  The blocks are the caller's, any divisors of
// s, so a kernel tile may straddle several.  Dense instantiations get a
// zeroed struct and never read it.
struct BlockMask {
  const uint8_t* bits;  // [s / block_q, n_kblocks]
  int n_kblocks, block_q, block_k;

  // the mask keeps pair (q_pos, k_pos); positions past the sequence end
  // read no byte (they are masked anyway)
  __device__ __forceinline__ bool keeps(int q_pos, int k_pos, int s) const {
    return q_pos < s && k_pos < s &&
           bits[(q_pos / block_q) * n_kblocks + k_pos / block_k] != 0;
  }

  // The tile of queries [q0, q1) and keys [k0, k1): bit 0 set when it
  // holds a visible pair (live), bit 1 when it is live and the mask also
  // zeroes a pair that the causal band leaves visible (cut: its pairs
  // need keeps()).  Walks the mask blocks the tile overlaps, clipped to
  // s; the band reaches a block's part of the tile when that part's last
  // query is not before its first key.
  __device__ int tile_state(int q0, int q1, int k0, int k1, int s,
                            bool causal) const {
    q1 = min(q1, s);
    k1 = min(k1, s);
    if (q0 >= q1 || k0 >= k1 || (causal && q1 - 1 < k0)) return 0;
    bool kept = false, zeroed = false;
    for (int qb = q0 / block_q; qb * block_q < q1; ++qb) {
      const int q_last = min(q1, (qb + 1) * block_q) - 1;
      for (int kb = k0 / block_k; kb * block_k < k1; ++kb) {
        if (causal && q_last < max(k0, kb * block_k)) break;
        if (bits[qb * n_kblocks + kb] != 0) {
          kept = true;
        } else {
          zeroed = true;
        }
      }
    }
    return kept ? (zeroed ? 3 : 1) : 0;
  }
};

// A block's live list: the tiles of its sweep that hold a visible pair,
// in increasing order, as entries (tile << 1) | cut in shared memory.  A
// masked block sweeps it in place of the band's contiguous range of
// tiles, so the tiles the mask skips are neither loaded nor computed and
// the prefetch of entry i + 1 goes to the next live tile.  Dense
// instantiations hold an empty one and read nothing.
struct LiveTiles {
  const int* entries;
  int count;

  __device__ __forceinline__ LiveTiles() : entries(nullptr), count(0) {}
  __device__ __forceinline__ LiveTiles(const int* e, int n)
      : entries(e), count(n) {}

  __device__ __forceinline__ int tile(int i) const { return entries[i] >> 1; }
  // the tile of entry i needs the pair-by-pair mask test
  __device__ __forceinline__ bool cut(int i) const { return entries[i] & 1; }
};

// Fill `list` (shared memory, n_tiles ints) with the live entries among
// tiles [0, n_tiles), state(t) giving BlockMask::tile_state of tile t.
// Every thread of the block calls it: THREADS tiles a round, compacted in
// order by warp ballots; it ends with a barrier, after which every thread
// may read the list.
template <int THREADS, typename State>
__device__ LiveTiles build_live_tiles(int* list, int n_tiles, State state) {
  constexpr int kWarpsPerBlock = THREADS / 32;
  __shared__ int warp_live[kWarpsPerBlock];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int count = 0;
  for (int base = 0; base < n_tiles; base += THREADS) {
    const int tile = base + threadIdx.x;
    const int st = tile < n_tiles ? state(tile) : 0;
    const unsigned live = __ballot_sync(0xffffffffu, st & 1);
    if (lane == 0) warp_live[warp] = __popc(live);
    __syncthreads();
    int slot = count + __popc(live & ((1u << lane) - 1));
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      if (w < warp) slot += warp_live[w];
      count += warp_live[w];
    }
    if (st & 1) list[slot] = (tile << 1) | (st >> 1);
    __syncthreads();  // warp_live is rewritten next round; the list is read
  }
  return LiveTiles(list, count);
}

// The masked launchers' BlockMask from their C arguments; false (the
// launcher returns cudaErrorInvalidValue) unless the blocks tile s, the
// mask has s / block_k columns and no window is asked for.
inline bool make_block_mask(const void* bits, int n_kblocks, int block_q,
                            int block_k, int s, int window, BlockMask* mask) {
  if (window > 0 || block_q < 1 || block_k < 1 || s % block_q != 0 ||
      s % block_k != 0 || n_kblocks != s / block_k) {
    return false;
  }
  *mask = BlockMask{static_cast<const uint8_t*>(bits), n_kblocks, block_q,
                    block_k};
  return true;
}

// bytes of a masked block's live list of n_tiles entries
inline size_t live_list_bytes(int n_tiles) {
  return sizeof(int) * (size_t)n_tiles;
}

}  // namespace
