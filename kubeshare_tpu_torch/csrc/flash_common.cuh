// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async copies into shared memory, the bf16 tensor-core
// product mma.sync m16n8k16 with f32 accumulation, ldmatrix, and bf16
// packing.  Each including source gets its own copy (anonymous namespace).

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

}  // namespace
