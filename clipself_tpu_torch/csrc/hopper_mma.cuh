// Hopper building blocks shared by the flash-attention kernels: warpgroup
// matrix products (wgmma) on bf16 tiles in 128-byte-swizzled shared memory,
// the asynchronous tile loader that writes that layout, and the map from a
// thread's accumulator registers to (row, column).
//
// Tile layout. Every shared-memory operand is a [rows][64] bf16 tile: one row
// is 128 bytes, eight 16-byte chunks. Chunk c of row r lies at byte
// r * 128 + ((c ^ (r & 7)) << 4) from the tile's base, which must be aligned
// to 1024 bytes (the 8-row swizzle atom). This is the layout the tensor
// cores' "128-byte swizzle" descriptor mode reads, and it keeps both the
// row-wise 16-byte stores of the loader and the column-wise reads of the
// tensor cores free of bank conflicts.
//
// One descriptor form serves both operand orientations of such a tile:
//   K-major  (the product contracts over the tile's 64 columns): eight-row
//            groups are 1024 bytes apart (SBO); a k-slice of 16 columns is
//            32 bytes further along the row: descriptor + K_SLICE_K_MAJOR.
//   MN-major (the product contracts over the tile's rows; needs the
//            wgmma's transpose flag, 16-bit types only): the 64
//            columns are one swizzled row, eight k-rows are one atom, the
//            next eight are 1024 bytes on (SBO); a k-slice of 16 rows is
//            2048 bytes on: descriptor + K_SLICE_MN_MAJOR.
// LBO is not used by either at a width of 64 elements.
//
// Accumulator layout of an m64nNk16 product (f32, N / 2 registers a
// thread): warp w of the warpgroup owns rows 16 w .. 16 w + 15; register i
// of lane l holds row (l / 4) + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (l % 4) + (i % 2). Packed to bf16 pairs, registers
// 8 kk .. 8 kk + 7 are exactly the A fragment (four 32-bit registers) of the
// next product's k-slice kk, which is how the attention kernels hand P and dS
// to their second products without touching shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int ROW_BYTES = 128;          // one tile row: 64 bf16
constexpr int ATOM_BYTES = 1024;        // eight rows: the swizzle atom
constexpr int TILE64_BYTES = 64 * ROW_BYTES;
constexpr uint64_t K_SLICE_K_MAJOR = 32 >> 4;      // descriptor units of 16 bytes
constexpr uint64_t K_SLICE_MN_MAJOR = 2048 >> 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t align_1024(uint32_t addr) {
  return (addr + 1023u) & ~1023u;
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile.
__device__ __forceinline__ uint32_t swizzle_offset(int row, int chunk) {
  return static_cast<uint32_t>(row * ROW_BYTES + ((chunk ^ (row & 7)) << 4));
}

// Shared-memory matrix descriptor of a swizzled [rows][64] bf16 tile (or of
// the 8-row-aligned sub-tile that starts at `addr`).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFFu) >> 4);  // start address
  d |= static_cast<uint64_t>(16 >> 4) << 16;                   // LBO (unused)
  d |= static_cast<uint64_t>(ATOM_BYTES >> 4) << 32;           // SBO
  d |= static_cast<uint64_t>(1) << 62;                         // 128-byte swizzle
  return d;
}

// ---- asynchronous copies (cp.async) ---------------------------------------

// 16 bytes global -> shared; `valid` false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most PENDING of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Make shared-memory writes of this thread (cp.async results it has waited
// for, ordinary stores) visible to the tensor cores' asynchronous reads.
// Call it before the barrier that precedes the product.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- bulk reduction shared -> global ---------------------------------------

// Add `bytes` of f32 at shared address `src` to the same count at `dst` in
// global memory, element by element (both 16-byte aligned, bytes a multiple
// of 16). One thread starts it; the copy engine does the additions in the
// L2, and the shared memory must stay as it is until bulk_wait_read.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, uint32_t src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk operations have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// 2^x by the special-function unit alone (ex2.approx: two ULP, -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Start the copy of rows [row0, row0 + ROWS) of a [*, 64] bf16 matrix with
// row stride `stride` (elements) into the swizzled tile at `dst`; rows at or
// past `n` are zero-filled. Eight neighbouring threads copy one row.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int row0,
                                                int n, int tid) {
  static_assert((ROWS * 8) % THREADS == 0, "whole chunks for every thread");
#pragma unroll
  for (int it = 0; it < ROWS * 8 / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i >> 3;
    const int c = i & 7;
    const int g = row0 + r;
    const bool ok = g < n;
    const __nv_bfloat16* p = ok ? src + (long long)g * stride + c * 8 : src;
    cp_async_16(dst + swizzle_offset(r, c), p, ok);
  }
}

// ---- warpgroup products ---------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Pin registers that an asynchronous product reads or writes: the compiler
// may not move code that touches them across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_ACC8(d, o)                                              \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define HOPPER_ACC32(d) \
  HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24)
#define HOPPER_ACC32_LIST                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// d[64, 64] (+)= A[64, 16] . B[16, 64], bf16 in, f32 out, both operands in
// shared memory. TRANS_A / TRANS_B: 0 for a K-major tile, 1 for MN-major.
// `accumulate` 0 overwrites d.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_ACC32_LIST
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// The same product with A from registers: a[0..3] is this thread's A
// fragment of the k-slice (see the accumulator layout above).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate),
        "n"(TRANS_B));
}

// ---- accumulator fragment -------------------------------------------------

// Row (0..63) and column (0..63) of accumulator register i for thread `t`
// (0..127) of the warpgroup.
__device__ __forceinline__ int frag_row(int t, int i) {
  return (t >> 5) * 16 + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// Two floats to one register of bf16: `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_f32x4(uint32_t addr, float a, float b,
                                                float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a),
               "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ float4 ld_shared_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint4 ld_shared_u128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Store this warp's 16 rows of a 64-wide f32 accumulator as bf16 rows of
// 128 bytes: the fragment goes to the warp's own 16 rows of the swizzled
// tile at `stage` (which no pending product may still read) and comes back
// as whole 16-byte chunks, so that a warp writes four full rows at a time.
// `dst` points at row 0 of the 64-row tile in global memory, `row_stride`
// is in elements, rows at or past `rows_valid` are skipped.
__device__ __forceinline__ void store_acc_rows(const float (&acc)[32],
                                               uint32_t stage,
                                               __nv_bfloat16* dst,
                                               long long row_stride,
                                               int rows_valid) {
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int wrow = (t >> 5) * 16;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wrow + (lane >> 2) + 8 * hr;
      st_shared_u32(stage + swizzle_offset(r, j) + 4 * (lane & 3),
                    pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]));
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = wrow + 4 * i + (lane >> 3);
    const int c = lane & 7;
    const uint4 v = ld_shared_u128(stage + swizzle_offset(r, c));
    if (r < rows_valid) {
      *reinterpret_cast<uint4*>(dst + (long long)r * row_stride + c * 8) = v;
    }
  }
  __syncwarp();
}

}  // namespace hopper
