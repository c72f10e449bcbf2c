// Hopper building blocks shared by the flash-attention kernels: warpgroup
// matrix products (wgmma) on bf16 tiles in 128-byte-swizzled shared memory,
// the asynchronous tile loader that writes that layout, and the map from a
// thread's accumulator registers to (row, column); and, at the end, the
// float32 pieces: the TF32 three-product split, its mma.sync products with
// their fragment loads and row-major tile loader, and its wgmma products on
// split tiles (hi and lo planes in the swizzled layout).
//
// Tile layout. Every shared-memory operand is built from [rows][64] bf16
// panels: one panel row is 128 bytes, eight 16-byte chunks. Chunk c of row r
// lies at byte r * 128 + ((c ^ (r & 7)) << 4) from the panel's base, which
// must be aligned to 1024 bytes (the 8-row swizzle atom). This is the layout
// the tensor cores' "128-byte swizzle" descriptor mode reads, and it keeps
// both the row-wise 16-byte stores of the loader and the column-wise reads of
// the tensor cores free of bank conflicts. A tile wider than 64 columns
// (head_dim 72-128: DP = head_dim rounded up to 16) is two panels, one after
// the other: columns 0-63, then columns 64 to DP - 1 in the first chunks of
// the second panel's rows (the rest of those rows is never read).
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
// LBO is not used by either: a product never spans two panels. A K-major
// operand of DP columns is DP / 16 k-slices, four in panel 0 and the rest
// in panel 1; an MN-major operand of N = DP columns is two products, N = 64
// on panel 0 and N = DP - 64 on panel 1, each with its own descriptor.
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

// 64-column panels of a DP-wide tile, and the bytes of a ROWS-row tile
__host__ __device__ constexpr int panels(int dp) { return (dp + 63) / 64; }
__host__ __device__ constexpr int tile_bytes(int rows, int dp) {
  return panels(dp) * rows * ROW_BYTES;
}
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

// The same value, opaque to the compiler: descriptors formed from it are
// recomputed where they are used instead of being held in registers across
// a loop (sixteen 64-bit descriptors of a two-panel K and V tile would take
// 32 registers).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Descriptor of k-slice kk (columns 16 kk .. 16 kk + 15) of a K-major tile
// whose panels are `panel_bytes` apart, from the address of the rows it
// starts at in panel 0.
__device__ __forceinline__ uint64_t k_slice_desc(uint32_t addr, int kk,
                                                 uint32_t panel_bytes) {
  return tile_desc(addr + (kk >> 2) * panel_bytes) + (kk & 3) * K_SLICE_K_MAJOR;
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

// 2^x by the special-function unit alone (ex2.approx: two ULP, -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Start the copy of rows [row0, row0 + ROWS) of a [*, d] bf16 matrix with
// row stride `stride` (elements) into the DP-wide tile of panels at `dst`
// (DP / 8 chunks a row, chunk c in panel c / 8); rows at or past `n` and
// chunks at or past the true width `d` (a multiple of 8, so a chunk is wholly
// in or out) are zero-filled. Neighbouring threads copy neighbouring chunks
// of a row. At DP 64 every chunk is below d.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int row0,
                                                int n, int d, int tid) {
  constexpr int CH = DP / 8;
  constexpr int TOTAL = ROWS * CH;
#pragma unroll
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if (TOTAL % THREADS == 0 || i < TOTAL) {
      const int r = i / CH;
      const int c = i % CH;
      const int g = row0 + r;
      const bool ok = g < n && (DP == 64 || c * 8 < d);
      const __nv_bfloat16* p = ok ? src + (long long)g * stride + c * 8 : src;
      cp_async_16(dst + (c >> 3) * (ROWS * ROW_BYTES) + swizzle_offset(r, c & 7), p, ok);
    }
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
#define HOPPER_ACC16(d) HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8)
#define HOPPER_ACC24(d) HOPPER_ACC16(d), HOPPER_ACC8(d, 16)
#define HOPPER_ACC32(d) HOPPER_ACC24(d), HOPPER_ACC8(d, 24)
#define HOPPER_LIST8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HOPPER_LIST16                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}"
#define HOPPER_LIST24                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23}"
#define HOPPER_LIST32                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// One m64nNk16 product with both operands in shared memory; LIST and ACCS
// name the N / 2 accumulator registers, the numbers the operands after them.
#define HOPPER_WGMMA_SS(SHAPE, LIST, ACCS, DA, DB, ACC, TA, TB)              \
  asm volatile("{\n"                                                         \
               ".reg .pred p;\n"                                             \
               "setp.ne.b32 p, %" #ACC ", 0;\n"                              \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32.bf16.bf16 " LIST  \
               ", %" #DA ", %" #DB ", p, 1, 1, %" #TA ", %" #TB ";\n"         \
               "}\n"                                                         \
               : ACCS                                                        \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A),    \
                 "n"(TRANS_B))

// The same with A from registers.
#define HOPPER_WGMMA_RS(SHAPE, LIST, ACCS, A0, A1, A2, A3, DB, ACC, TB)      \
  asm volatile("{\n"                                                         \
               ".reg .pred p;\n"                                             \
               "setp.ne.b32 p, %" #ACC ", 0;\n"                              \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32.bf16.bf16 " LIST  \
               ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB            \
               ", p, 1, 1, %" #TB ";\n"                                      \
               "}\n"                                                         \
               : ACCS                                                        \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b),            \
                 "r"(accumulate), "n"(TRANS_B))

// d[64, N] (+)= A[64, 16] . B[16, N], bf16 in, f32 out, both operands in
// shared memory; N = 16, 32, 48 or 64 (one panel). TRANS_A / TRANS_B: 0 for
// a K-major tile, 1 for MN-major. `accumulate` 0 overwrites d.
template <int N, int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64, "one panel: N <= 64");
  if constexpr (N == 16) {
    HOPPER_WGMMA_SS("m64n16k16", HOPPER_LIST8, HOPPER_ACC8(d, 0), 8, 9, 10, 11, 12);
  } else if constexpr (N == 32) {
    HOPPER_WGMMA_SS("m64n32k16", HOPPER_LIST16, HOPPER_ACC16(d), 16, 17, 18, 19, 20);
  } else if constexpr (N == 48) {
    HOPPER_WGMMA_SS("m64n48k16", HOPPER_LIST24, HOPPER_ACC24(d), 24, 25, 26, 27, 28);
  } else {
    HOPPER_WGMMA_SS("m64n64k16", HOPPER_LIST32, HOPPER_ACC32(d), 32, 33, 34, 35, 36);
  }
}

// The same product with A from registers: a0..a3 is this thread's A
// fragment of the k-slice (see the accumulator layout above).
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t desc_b, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64, "one panel: N <= 64");
  if constexpr (N == 16) {
    HOPPER_WGMMA_RS("m64n16k16", HOPPER_LIST8, HOPPER_ACC8(d, 0), 8, 9, 10, 11, 12, 13, 14);
  } else if constexpr (N == 32) {
    HOPPER_WGMMA_RS("m64n32k16", HOPPER_LIST16, HOPPER_ACC16(d), 16, 17, 18, 19, 20, 21, 22);
  } else if constexpr (N == 48) {
    HOPPER_WGMMA_RS("m64n48k16", HOPPER_LIST24, HOPPER_ACC24(d), 24, 25, 26, 27, 28, 29, 30);
  } else {
    HOPPER_WGMMA_RS("m64n64k16", HOPPER_LIST32, HOPPER_ACC32(d), 32, 33, 34, 35, 36, 37, 38);
  }
}

// The accumulator of a [64, DP] result: panel 0's 64 columns, and panel 1's
// DP - 64 when DP > 64 (a one-register stand-in, never used, at DP 64).
template <int DP>
struct WideAcc {
  static constexpr int N1 = DP > 64 ? DP - 64 : 0;
  float p0[32];
  float p1[N1 > 0 ? N1 / 2 : 1];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 32; ++i) p0[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (N1 > 0 ? N1 / 2 : 1); ++i) p1[i] = 0.0f;
  }
  __device__ __forceinline__ void fence() {
    fence_regs(p0);
    if constexpr (N1 > 0) fence_regs(p1);
  }
  __device__ __forceinline__ void scale_rows(float s0, float s1) {
    // registers 4 j, 4 j + 1 are the thread's first row, 4 j + 2, 4 j + 3
    // its second (the accumulator layout above)
#pragma unroll
    for (int i = 0; i < 32; ++i) p0[i] *= ((i >> 1) & 1) ? s1 : s0;
    if constexpr (N1 > 0) {
#pragma unroll
      for (int i = 0; i < N1 / 2; ++i) p1[i] *= ((i >> 1) & 1) ? s1 : s0;
    }
  }
  // += A[64, 16] . B[16, DP], A from registers, B an MN-major tile of
  // panels `panel_bytes` apart (desc: panel 0's descriptor of the k-slice)
  __device__ __forceinline__ void add_rs(uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc,
                                         uint32_t panel_bytes) {
    wgmma_rs<64, 1>(p0, a0, a1, a2, a3, desc, 1);
    if constexpr (N1 > 0) wgmma_rs<N1, 1>(p1, a0, a1, a2, a3, desc + (panel_bytes >> 4), 1);
  }
};

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

__device__ __forceinline__ uint4 ld_shared_u128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Store this warp's 16 rows of an N-wide f32 accumulator (one panel's
// product, N / 2 registers) as bf16 rows: the fragment goes to the warp's own
// 16 rows of the swizzled panel at `stage` (which no pending product may
// still read) and comes back as whole 16-byte chunks, so that a warp writes
// whole rows at a time. `dst` points at row 0, column 0 of the panel's
// columns in global memory, `row_stride` is in elements; rows at or past
// `rows_valid` and chunks at or past `cols_valid` are skipped.
template <int N>
__device__ __forceinline__ void store_acc_rows(const float (&acc)[N / 2],
                                               uint32_t stage,
                                               __nv_bfloat16* dst,
                                               long long row_stride,
                                               int rows_valid, int cols_valid) {
  constexpr int CH = N / 8;  // chunks a row
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int wrow = (t >> 5) * 16;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wrow + (lane >> 2) + 8 * hr;
      st_shared_u32(stage + swizzle_offset(r, j) + 4 * (lane & 3),
                    pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]));
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < CH / 2; ++it) {
    const int i = it * 32 + lane;
    const int r = wrow + i / CH;
    const int c = i % CH;
    const uint4 v = ld_shared_u128(stage + swizzle_offset(r, c));
    if (r < rows_valid && c * 8 < cols_valid) {
      *reinterpret_cast<uint4*>(dst + (long long)r * row_stride + c * 8) = v;
    }
  }
  __syncwarp();
}

// Both panels of a [64, DP] accumulator, staged in the two panels of a tile
// (`panel_bytes` apart) whose rows 0-63 start at `stage`; `d` is the true
// row length (the columns past it are not stored).
template <int DP>
__device__ __forceinline__ void store_wide_rows(const WideAcc<DP>& acc,
                                                uint32_t stage,
                                                uint32_t panel_bytes,
                                                __nv_bfloat16* dst,
                                                long long row_stride,
                                                int rows_valid, int d) {
  store_acc_rows<64>(acc.p0, stage, dst, row_stride, rows_valid, 64);
  if constexpr (DP > 64) {
    store_acc_rows<DP - 64>(acc.p1, stage + panel_bytes, dst + 64, row_stride,
                            rows_valid, d - 64);
  }
}

// ---- float32 on the tensor cores: the TF32 three-product split -------------
//
// A TF32 product keeps 10 explicit mantissa bits of each operand (about three
// decimal digits). Splitting each float32 operand as x = hi + lo, hi = x
// rounded to TF32 (to nearest, ties away, as cvt.rna.tf32.f32 rounds) and
// lo = x - hi (exact in float32), and summing lo_a hi_b + hi_a lo_b +
// hi_a hi_b drops only lo_a lo_b (at most 2^-22 of |a b|) and the low bits of
// lo that the tensor core does not read (at most 2^-21 of |a b|): float32
// accuracy at three tensor-core products. hi is formed with two integer
// instructions (half a TF32 unit added to the magnitude, the 13 low bits
// cleared: cvt.rna's result for every finite value; cvt.rna itself compiles
// to a longer sequence on sm_90a) and lo with one subtraction, handed to the
// tensor core as it is.
//
// The tensor cores add each product's terms to the accumulator with less
// care than a float32 FMA (the low bits of the aligned sum are cut, always
// toward zero), so an error of about one float32 unit of the running sum
// comes with every product and does not average out. A sum over thousands
// of keys (O, dQ, dK, dV over N = 4097) is therefore never accumulated on
// the tensor cores across tiles: each tile's products go to a fresh
// accumulator (at most 24 products deep at head_dim 64, 48 at 128) that is
// then added to the running float32 sum with an ordinary add or FMA.
//
// Two product forms carry the split. The products contracted over the
// head_dim (the scores: S = Q K^T, dP = dO V^T and their transposes) are
// wgmma m64nNk8 on a warpgroup, A from registers (each warp's 16 rows,
// ldmatrix from a row-major tile and split there), B a split tile (below);
// their accumulator is laid out as the bf16 products' above, so registers
// 4 j .. 4 j + 3 are the mma.sync C fragment of columns 8 j .. 8 j + 7. The
// products contracted over a tile's rows (O = P V, dV, dK, dQ), whose B
// operand wgmma would need transposed, which TF32 does not take, are
// mma.sync.m16n8k8 with every operand in registers. Its fragments
// (g = lane / 4, c = lane % 4; wgmma's A fragment is the same):
//   A [16, 8]: a0 (row g, col c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)
//   B [8, 8]:  b0 (k c, col g), b1 (k c + 4, col g)
//   C [16, 8]: c0 (row g, col 2 c), c1 (g, 2 c + 1), c2 (g + 8, 2 c), c3 (g + 8, 2 c + 1)
// A product's C fragment is not the next product's A fragment (a thread
// holds columns 2c, 2c + 1 of each 8, A wants c and c + 4). The kernels
// renumber the contraction instead: slot c of k-slice kk carries key (or
// query) 8 kk + 2 c and slot c + 4 carries 8 kk + 2 c + 1, so c0, c2, c1, c3
// are a0..a3 as they stand, and the B fragment reads the matching rows
// 8 kk + 2 c and 8 kk + 2 c + 1 (two 32-bit shared loads, `b_rows`, or
// four from a split tile's planes, `b_rows_split`).
//
// Row-major float32 tiles in shared memory have rows of DP + 4 floats
// (DP a multiple of 16): that row stride is 4 or 20 modulo the 32 banks, so
// the eight rows an ldmatrix phase reads, and the eight rows x four columns
// of a `b_rows` load, fall on distinct banks. ldmatrix on 16-bit elements
// moves float32 data unchanged: an 8 x 8 b16 matrix is 8 rows x 4 floats,
// and lane l receives row l / 4, float l % 4, which is the A fragment order
// above.

constexpr int F32_PAD = 4;  // floats past DP in a shared row

// x = hi + lo: hi rounded to TF32 (to nearest, ties away from zero; its 13
// low bits zero), lo = x - hi exactly, as the tensor core's second operand
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A fragment (four floats) split into its hi and lo parts
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    split_tf32(x0, hi[0], lo[0]);
    split_tf32(x1, hi[1], lo[1]);
    split_tf32(x2, hi[2], lo[2]);
    split_tf32(x3, hi[3], lo[3]);
  }
};

// B fragment (two floats) split into its hi and lo parts
struct SplitB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float x0, float x1) {
    split_tf32(x0, hi[0], lo[0]);
    split_tf32(x1, hi[1], lo[1]);
  }
};

// d[16, 8] += a[16, 8] . b[8, 8], TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[64, N] (+)= A[64, 8] . B[8, N] on the warpgroup, TF32 in, float32 out:
// a[0..3] this thread's A fragment of the k-slice (rows g and g + 8 of its
// warp's 16, columns c and c + 4: the mma.sync A fragment), B a K-major
// tile in shared memory (TF32 has no transposed form): the N rows of a
// split tile's plane (below); N = 16, 32 or 64. `accumulate` 0 overwrites
// d. The accumulator layout is the bf16 products' (above): registers
// 4 j .. 4 j + 3 are an mma.sync C fragment of columns 8 j .. 8 j + 7.
#define HOPPER_WGMMA_TF32_RS(SHAPE, LIST, ACCS, A0, A1, A2, A3, DB, ACC)     \
  asm volatile("{\n"                                                         \
               ".reg .pred p;\n"                                             \
               "setp.ne.b32 p, %" #ACC ", 0;\n"                              \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32.tf32.tf32 " LIST  \
               ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB            \
               ", p, 1, 1;\n"                                                \
               "}\n"                                                         \
               : ACCS                                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),    \
                 "r"(accumulate))

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "N = 16, 32 or 64");
  if constexpr (N == 16) {
    HOPPER_WGMMA_TF32_RS("m64n16k8", HOPPER_LIST8, HOPPER_ACC8(d, 0), 8, 9, 10, 11, 12, 13);
  } else if constexpr (N == 32) {
    HOPPER_WGMMA_TF32_RS("m64n32k8", HOPPER_LIST16, HOPPER_ACC16(d), 16, 17, 18, 19, 20, 21);
  } else {
    HOPPER_WGMMA_TF32_RS("m64n64k8", HOPPER_LIST32, HOPPER_ACC32(d), 32, 33, 34, 35, 36, 37);
  }
}

// Split tiles: a float32 [ROWS, DP] operand of the TF32 wgmma products,
// stored as two planes, hi then lo, each a 128-byte-swizzled K-major tile
// as the bf16 ones with 32 floats to a panel row: chunk c (floats
// 4 c .. 4 c + 3) of row r lies in panel c / 8 at `swizzle_offset(r, c % 8)`,
// panels ROWS * 128 bytes apart. A k-slice of 8 floats is 32 bytes, as a
// bf16 k-slice of 16 is, so `k_slice_desc` addresses it. The loader copies
// the raw floats into the hi plane; once its copies have landed, each thread
// splits the chunks it copied (`split_tile`), before the barrier that
// publishes the tile: one pass over the tile a block, where splitting at
// the fragment loads would split it once a warp.
__host__ __device__ constexpr int f32_plane_bytes(int rows, int dp) {
  return (dp + 31) / 32 * rows * ROW_BYTES;
}

template <int ROWS>
__device__ __forceinline__ uint32_t f32_chunk_offset(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * (ROWS * ROW_BYTES)) + swizzle_offset(r, c & 7);
}

__device__ __forceinline__ void st_shared_u128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Start the copy of rows [row0, row0 + ROWS) of a [*, d] float32 matrix with
// row stride `stride` (elements) into the hi plane of the split tile at
// `dst` (1024-byte aligned); rows at or past `n` and columns at or past the
// true width `d` (a multiple of 8) load as zeros.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_split_async(uint32_t dst, const float* src, long long stride,
                                                 int row0, int n, int d, int tid) {
  constexpr int CH = DP / 4;  // 16-byte chunks a row
  constexpr int TOTAL = ROWS * CH;
#pragma unroll
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if (TOTAL % THREADS == 0 || i < TOTAL) {
      const int r = i / CH;
      const int c = i % CH;
      const int g = row0 + r;
      const bool ok = g < n && c * 4 < d;
      cp_async_16(dst + f32_chunk_offset<ROWS>(r, c), ok ? src + (long long)g * stride + c * 4 : src,
                  ok);
    }
  }
}

// Split in place the chunks this thread copied with `load_split_async` (the
// same map of thread to chunk), after its copies have landed: hi stays in
// the hi plane, lo goes to the lo plane. The caller then fences
// (`fence_async_proxy`) and syncs the block before a product reads it.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void split_tile(uint32_t dst, int tid) {
  constexpr int CH = DP / 4;
  constexpr int TOTAL = ROWS * CH;
  constexpr uint32_t LO = f32_plane_bytes(ROWS, DP);
#pragma unroll
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if (TOTAL % THREADS == 0 || i < TOTAL) {
      const uint32_t at = dst + f32_chunk_offset<ROWS>(i / CH, i % CH);
      const uint4 x = ld_shared_u128(at);
      uint4 hi, lo;
      split_tf32(__uint_as_float(x.x), hi.x, lo.x);
      split_tf32(__uint_as_float(x.y), hi.y, lo.y);
      split_tf32(__uint_as_float(x.z), hi.z, lo.z);
      split_tf32(__uint_as_float(x.w), hi.w, lo.w);
      st_shared_u128(at, hi);
      st_shared_u128(at + LO, lo);
    }
  }
}

// The three products of one k-slice of A[64, DP] . B[N, DP]^T on the
// warpgroup, in the split's order: a this thread's split A fragment, `hi`
// the descriptor of the k-slice in B's hi plane, `lo_units` the distance to
// its lo plane in descriptor units (16 bytes). The caller fences
// (`wgmma_fence`) after writing a, and commits and waits.
template <int N>
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[N / 2], const SplitA& a, uint64_t hi,
                                             uint32_t lo_units, int accumulate) {
  wgmma_tf32_rs<N>(d, a.lo, hi, accumulate);
  wgmma_tf32_rs<N>(d, a.hi, hi + lo_units, 1);
  wgmma_tf32_rs<N>(d, a.hi, hi, 1);
}

// The B fragment of k-slice kk, n-tile j of a product whose B is a split
// tile [k, n] of ROWS rows (`tile` its hi plane) under the renumbered
// contraction: rows 8 kk + 2 c and 8 kk + 2 c + 1, column 8 j + g, hi and lo
// read as stored. The eight rows x four columns of one read fall on
// distinct banks (the swizzle moves row pairs' chunks apart).
template <int ROWS, int DP>
__device__ __forceinline__ void b_rows_split(SplitB& b, const float* tile, int kk, int j, int lane) {
  constexpr int LO = f32_plane_bytes(ROWS, DP) / 4;
  const int col = 8 * j + (lane >> 2);
  const int r = 8 * kk + 2 * (lane & 3);
  const float* p0 = tile + f32_chunk_offset<ROWS>(r, col >> 2) / 4 + (col & 3);
  const float* p1 = tile + f32_chunk_offset<ROWS>(r + 1, col >> 2) / 4 + (col & 3);
  b.hi[0] = __float_as_uint(p0[0]);
  b.lo[0] = __float_as_uint(p0[LO]);
  b.hi[1] = __float_as_uint(p1[0]);
  b.lo[1] = __float_as_uint(p1[LO]);
}

// The three products of the split, always in this order (the sums, and so
// the bits, repeat from call to call): lo . hi, hi . lo, hi . hi.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const SplitA& a, const SplitB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Four 8 x 8 b16 matrices (8 rows x 4 floats each) from shared memory: lanes
// 8 i .. 8 i + 7 give the row addresses of matrix i, register i receives it.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two of them: lanes 0-7 and 8-15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// Byte offset, from a tile's row 0, of the float this lane gives ldmatrix for
// an A fragment of k-slice kk of rows 0-15: matrices (rows 0-7, cols 8 kk),
// (rows 8-15, 8 kk), (rows 0-7, 8 kk + 4), (rows 8-15, 8 kk + 4) = a0..a3.
template <int LD>
__device__ __forceinline__ uint32_t a_lane_offset(int lane) {
  return static_cast<uint32_t>(((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 4 * (lane >> 4)) * 4;
}

// ... for the B fragment (ldsm_x2) of k-slice kk of rows 0-7 (the n index):
// matrices (cols 8 kk), (cols 8 kk + 4) = b0, b1.
template <int LD>
__device__ __forceinline__ uint32_t b_lane_offset(int lane) {
  return static_cast<uint32_t>((lane & 7) * LD + 4 * ((lane >> 3) & 1)) * 4;
}

// One split A fragment of k-slice kk (rows 0-15 at `rows`, lane offset
// included) and one split B fragment of the same slice (rows 0-7 at
// `rows_b`, lane offset included), both through ldmatrix.
__device__ __forceinline__ void a_frag(SplitA& a, uint32_t rows, int kk) {
  uint32_t r[4];
  ldsm_x4(r, rows + kk * 32);
  a.set(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]), __uint_as_float(r[3]));
}
__device__ __forceinline__ void b_frag(SplitB& b, uint32_t rows_b, int kk) {
  uint32_t r[2];
  ldsm_x2(r, rows_b + kk * 32);
  b.set(__uint_as_float(r[0]), __uint_as_float(r[1]));
}

// The B fragment of k-slice kk, n-tile j of a product whose B is a row-major
// [k, n] tile in shared memory (row stride LD floats) under the renumbered
// contraction: b0 = row 8 kk + 2 c, b1 = row 8 kk + 2 c + 1, both at column
// 8 j + g. `lane_rows` is the tile plus this lane's (2 c) * LD + g.
template <int LD>
__device__ __forceinline__ void b_rows(SplitB& b, const float* lane_rows, int kk, int j) {
  const float* at = lane_rows + 8 * kk * LD + 8 * j;
  b.set(at[0], at[LD]);
}

template <int LD>
__device__ __forceinline__ int b_rows_lane(int lane) {
  return 2 * (lane & 3) * LD + (lane >> 2);
}

// Start the copy of rows [row0, row0 + ROWS) of a [*, d] float32 matrix with
// row stride `stride` (elements) into a row-major tile of DP + F32_PAD floats
// a row at `dst`; rows at or past `n` and columns at or past the true width
// `d` (a multiple of 8, so a 16-byte chunk is wholly in or out) load as zeros.
// UNROLL: the loop's unroll factor (the copies are asynchronous; an unrolled
// loop holds each chunk's address in a register of the calling kernel, which
// the forward at DP 64 gives back for two blocks an SM).
template <int ROWS, int DP, int THREADS, int UNROLL = ROWS * DP / 4 / THREADS + 1>
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const float* src, long long stride,
                                              int row0, int n, int d, int tid) {
  constexpr int CH = DP / 4;  // 16-byte chunks a row
  constexpr int TOTAL = ROWS * CH;
#pragma unroll UNROLL
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if (TOTAL % THREADS == 0 || i < TOTAL) {
      const int r = i / CH;
      const int c = i % CH;
      const int g = row0 + r;
      const bool ok = g < n && c * 4 < d;
      cp_async_16(dst + static_cast<uint32_t>(r * (DP + F32_PAD) + c * 4) * 4,
                  ok ? src + (long long)g * stride + c * 4 : src, ok);
    }
  }
}

}  // namespace hopper
