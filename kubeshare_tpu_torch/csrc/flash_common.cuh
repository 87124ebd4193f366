// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async copies into shared memory, the bf16 tensor-core
// product mma.sync m16n8k16 with f32 accumulation, ldmatrix, bf16
// packing, and the block mask and tile sweep of the block-sparse mode.
// Each including source gets its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
// 4-byte global->shared copy; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a . b for one 16x8x16 tile (A row-major, B column-major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row_addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row_addr)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of a 16x16 bf16 tile whose row `g` (this lane's row
// group) starts at `row`, `ld` elements between rows, columns from `col`
// (t * 2 for this lane): rows g and g + 8, column pairs col and col + 8.
__device__ __forceinline__ void load_a_frag(uint32_t* a,
                                            const __nv_bfloat16* row, int ld) {
  a[0] = ld_u32(row);
  a[1] = ld_u32(row + 8 * ld);
  a[2] = ld_u32(row + 8);
  a[3] = ld_u32(row + 8 * ld + 8);
}

// Start the 16-byte copies of one [ROWS, D] bf16 tile into rows of LD
// elements; rows at or past `valid` are zero-filled (their source address
// is clamped to row 0).
template <int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool in = r < valid;
    cp_async_16(dst + r * LD + c * 8, src + (size_t)(in ? r : 0) * D + c * 8,
                in ? 16 : 0);
  }
}

// [ROWS, D] f32 tile into rows of LD floats, synchronously; rows at or
// past `valid` are zeros.
template <int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_rows_f32(float* dst,
                                              const float* __restrict__ src,
                                              int valid) {
  constexpr int kChunks = D / 4;  // float4 per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = reinterpret_cast<const float4*>(src + (size_t)r * D)[c];
    reinterpret_cast<float4*>(dst + r * LD)[c] = val;
  }
}

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
