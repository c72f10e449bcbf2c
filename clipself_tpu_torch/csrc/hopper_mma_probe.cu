// One bf16 product through each operand form of hopper_mma.cuh, at the
// widths the attention kernels run it, so that a fault in a descriptor, a
// transpose flag, the swizzled panels of the loader or the fragment map
// shows here and not inside the attention kernels that are built from the
// same pieces:
//
//   mode 0: C[64, N] = A . B^T   A [64, K] and B [N, K] K-major tiles in
//                                shared memory, K / 16 k-slices over one or
//                                two panels (the scores, S = Q K^T at head
//                                dims 64-128; N = 32 is a round of the
//                                dK / dV pass)
//   mode 1: C[64, N] = A . B     A [64, 64] from registers, B [64, N] an
//                                MN-major tile: one product a k-slice up to
//                                N = 64, two past it (the value product,
//                                O = P V, and dV, dK, dQ)
//   mode 2: C[64, N] = A^T . B   A [64, 64] and B [64, N] MN-major tiles in
//                                shared memory, the products split as in
//                                mode 1
//
// a, b, c: contiguous, bf16 in, f32 out. One block of one warpgroup.
//
// And the float32 products of the TF32 three-product split (the float32
// flash kernels), float32 in and out, through the same fragment loads,
// split tiles, split and products as those kernels (split = 0 runs the
// hi . hi product alone: one TF32 product, for comparison):
//
//   mode 3: C[64, N] = A . B^T   wgmma on one warpgroup: A [64, K] a
//                                row-major tile read with ldmatrix and split
//                                in registers, B [N, K] a split tile (S = Q K^T,
//                                dP = dO V^T and their transposes); K a
//                                multiple of 8 up to 128, on a tile of K
//                                rounded up to 16 columns with the k-slice
//                                past K skipped; N = 16 or 32
//   mode 4: C[16, N] = A . B     mma.sync on one warp: A [16, 64] from
//                                registers in the accumulator layout under
//                                the renumbered contraction, B [64, N]
//                                row-major read with 32-bit loads (O = P V);
//                                N a multiple of 8 up to 128
//   mode 5: C[16, N] = A . B     the same with B [K, N] a split tile of
//                                K = 16 or 32 rows, hi and lo read as stored
//                                (dV, dK, dQ)
//   mode 6: C[16, 64] = A . B^T  mma.sync on one warp: A [16, K] and B [64, K]
//                                row-major tiles both read with ldmatrix and
//                                split in registers (the backward's scores
//                                past tile width 96); K as in mode 3

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

template <int MODE, int K, int N>
__global__ void __launch_bounds__(128)
    probe_kernel(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, float* __restrict__ c) {
  constexpr int A_COLS = MODE == 0 ? K : 64;
  constexpr int B_ROWS = MODE == 0 ? N : 64;
  constexpr int B_COLS = MODE == 0 ? K : N;
  constexpr uint32_t A_PANEL = 64 * ROW_BYTES;
  constexpr uint32_t B_PANEL = B_ROWS * ROW_BYTES;
  constexpr int N0 = N < 64 ? N : 64;        // the product on B's first panel
  constexpr int N1 = N > 64 ? N - 64 : 16;   // on its second (unused up to 64)
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t a_s = align_1024(smem_u32(smem));
  const uint32_t b_s = a_s + tile_bytes(64, A_COLS);

  load_tile_async<64, A_COLS, 128>(a_s, a, A_COLS, 0, 64, A_COLS, tid);
  load_tile_async<B_ROWS, B_COLS, 128>(b_s, b, B_COLS, 0, B_ROWS, B_COLS, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_proxy();
  __syncthreads();

  float acc0[N0 / 2], acc1[N1 / 2];
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) acc0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < N1 / 2; ++i) acc1[i] = 0.0f;
  uint32_t frag[16];
  if constexpr (MODE == 1) {  // A fragment of every k-slice, straight from global memory
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const __nv_bfloat16* p = a + frag_row(tid, i) * 64 + frag_col(tid, i);
      frag[i / 2] = *reinterpret_cast<const uint32_t*>(p);
    }
  }

  fence_regs(acc0);
  fence_regs(acc1);
  wgmma_fence();
  if constexpr (MODE == 0) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      wgmma_ss<N, 0, 0>(acc0, k_slice_desc(a_s, kk, A_PANEL), k_slice_desc(b_s, kk, B_PANEL), 1);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b_desc = tile_desc(b_s) + kk * K_SLICE_MN_MAJOR;
      if constexpr (MODE == 1) {
        wgmma_rs<N0, 1>(acc0, frag[4 * kk], frag[4 * kk + 1], frag[4 * kk + 2],
                        frag[4 * kk + 3], b_desc, 1);
        if constexpr (N > 64) {
          wgmma_rs<N1, 1>(acc1, frag[4 * kk], frag[4 * kk + 1], frag[4 * kk + 2],
                          frag[4 * kk + 3], b_desc + (B_PANEL >> 4), 1);
        }
      } else {
        const uint64_t a_desc = tile_desc(a_s) + kk * K_SLICE_MN_MAJOR;
        wgmma_ss<N0, 1, 1>(acc0, a_desc, b_desc, 1);
        if constexpr (N > 64) wgmma_ss<N1, 1, 1>(acc1, a_desc, b_desc + (B_PANEL >> 4), 1);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  if constexpr (MODE == 1) fence_regs(frag);

#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) c[frag_row(tid, i) * N + frag_col(tid, i)] = acc0[i];
  if constexpr (N > 64) {
#pragma unroll
    for (int i = 0; i < N1 / 2; ++i) c[frag_row(tid, i) * N + 64 + frag_col(tid, i)] = acc1[i];
  }
}

template <int MODE, int K, int N>
cudaError_t launch(const void* a, const void* b, void* c, cudaStream_t stream) {
  constexpr int smem_bytes = ATOM_BYTES + tile_bytes(64, MODE == 0 ? K : 64) +
                             tile_bytes(MODE == 0 ? N : 64, MODE == 0 ? K : N);
  auto kern = probe_kernel<MODE, K, N>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<1, 128, smem_bytes, stream>>>(static_cast<const __nv_bfloat16*>(a),
                                       static_cast<const __nv_bfloat16*>(b),
                                       static_cast<float*>(c));
  return cudaGetLastError();
}

// mode 4 at tile width DP (N rounded up to 16), true width w
template <int DP>
__global__ void __launch_bounds__(32)
    tf32_rows_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           float* __restrict__ c, int w, int split) {
  constexpr int LD = DP + F32_PAD;
  constexpr int NT = DP / 8;  // n-tiles of C
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int cq = lane & 3;
  load_rows_f32<64, DP, 32>(smem_u32(smem), b, w, 0, 64, w, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  }
  const float* b_lane = reinterpret_cast<const float*>(smem) + b_rows_lane<LD>(lane);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    // the accumulator fragment of a [16, 64] product: a thread holds
    // columns 8 kk + 2 c and 8 kk + 2 c + 1 of rows g and g + 8
    const float* r0 = a + g * 64 + 8 * kk + 2 * cq;
    SplitA x;
    x.set(r0[0], r0[8 * 64], r0[1], r0[8 * 64 + 1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j + 1 < NT || 8 * j < w) {
        SplitB y;
        b_rows<LD>(y, b_lane, kk, j);
        if (split) {
          mma_tf32x3(acc[j], x, y);
        } else {
          mma_tf32(acc[j], x.hi, y.hi);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (8 * j < w) {
      c[g * w + 8 * j + 2 * cq] = acc[j][0];
      c[g * w + 8 * j + 2 * cq + 1] = acc[j][1];
      c[(g + 8) * w + 8 * j + 2 * cq] = acc[j][2];
      c[(g + 8) * w + 8 * j + 2 * cq + 1] = acc[j][3];
    }
  }
}

// mode 6 at tile width DP (K rounded up to 16), true width w
template <int DP>
__global__ void __launch_bounds__(32)
    tf32_ldmatrix_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               float* __restrict__ c, int w, int split) {
  constexpr int LD = DP + F32_PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int cq = lane & 3;
  const uint32_t a_s = smem_u32(smem);
  const uint32_t b_s = a_s + 16 * LD * 4;
  load_rows_f32<16, DP, 32>(a_s, a, w, 0, 16, w, lane);
  load_rows_f32<64, DP, 32>(b_s, b, w, 0, 64, w, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  }
  const uint32_t aa = a_s + a_lane_offset<LD>(lane);
  const uint32_t bb = b_s + b_lane_offset<LD>(lane);
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    if (kk + 1 < DP / 8 || 8 * kk < w) {
      SplitA x;
      a_frag(x, aa, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        SplitB y;
        b_frag(y, bb + 8 * j * LD * 4, kk);
        if (split) {
          mma_tf32x3(acc[j], x, y);
        } else {
          mma_tf32(acc[j], x.hi, y.hi);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[g * 64 + 8 * j + 2 * cq] = acc[j][0];
    c[g * 64 + 8 * j + 2 * cq + 1] = acc[j][1];
    c[(g + 8) * 64 + 8 * j + 2 * cq] = acc[j][2];
    c[(g + 8) * 64 + 8 * j + 2 * cq + 1] = acc[j][3];
  }
}

// mode 5: B a split tile of K rows at tile width DP (N rounded up to 16)
template <int K, int DP>
__global__ void __launch_bounds__(32)
    tf32_split_rows_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 float* __restrict__ c, int w, int split) {
  constexpr int NT = DP / 8;
  extern __shared__ unsigned char smem[];
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int cq = lane & 3;
  const uint32_t b_s = align_1024(smem_u32(smem));
  load_split_async<K, DP, 32>(b_s, b, w, 0, K, w, lane);
  cp_async_commit();
  cp_async_wait<0>();
  split_tile<K, DP, 32>(b_s, lane);
  __syncwarp();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  }
  const float* b_f = reinterpret_cast<const float*>(smem + (b_s - smem_u32(smem)));
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const float* r0 = a + g * K + 8 * kk + 2 * cq;
    SplitA x;
    x.set(r0[0], r0[8 * K], r0[1], r0[8 * K + 1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j + 1 < NT || 8 * j < w) {
        SplitB y;
        b_rows_split<K, DP>(y, b_f, kk, j, lane);
        if (split) {
          mma_tf32x3(acc[j], x, y);
        } else {
          mma_tf32(acc[j], x.hi, y.hi);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (8 * j < w) {
      c[g * w + 8 * j + 2 * cq] = acc[j][0];
      c[g * w + 8 * j + 2 * cq + 1] = acc[j][1];
      c[(g + 8) * w + 8 * j + 2 * cq] = acc[j][2];
      c[(g + 8) * w + 8 * j + 2 * cq + 1] = acc[j][3];
    }
  }
}

// mode 3 at tile width DP (K rounded up to 16), true width w
template <int DP, int N>
__global__ void __launch_bounds__(128)
    tf32_scores_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                             float* __restrict__ c, int w, int split) {
  constexpr int LD = DP + F32_PAD;
  constexpr uint32_t LO_UNITS = f32_plane_bytes(N, DP) >> 4;
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t b_s = align_1024(smem_u32(smem));
  const uint32_t a_s = b_s + 2 * f32_plane_bytes(N, DP);
  load_rows_f32<64, DP, 128>(a_s, a, w, 0, 64, w, tid);
  load_split_async<N, DP, 128>(b_s, b, w, 0, N, w, tid);
  cp_async_commit();
  cp_async_wait<0>();
  split_tile<N, DP, 128>(b_s, tid);
  fence_async_proxy();
  __syncthreads();

  const uint32_t aa = a_s + (tid >> 5) * 16 * LD * 4 + a_lane_offset<LD>(tid & 31);
  float acc[N / 2];
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    if (kk + 1 < DP / 8 || 8 * kk < w) {
      SplitA x;
      a_frag(x, aa, kk);
      wgmma_fence();
      const uint64_t hi = k_slice_desc(b_s, kk, N * ROW_BYTES);
      if (split) {
        wgmma_tf32x3<N>(acc, x, hi, LO_UNITS, kk > 0);
      } else {
        wgmma_tf32_rs<N>(acc, x.hi, hi, kk > 0);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c[frag_row(tid, i) * N + frag_col(tid, i)] = acc[i];
}

// The width DP a true width w runs at: w rounded up to 16
#define CLIPSELF_TF32_DP(...)                \
  switch ((w + 15) / 16 * 16) {               \
    case 16: { constexpr int DP = 16; __VA_ARGS__; } \
    case 32: { constexpr int DP = 32; __VA_ARGS__; } \
    case 48: { constexpr int DP = 48; __VA_ARGS__; } \
    case 64: { constexpr int DP = 64; __VA_ARGS__; } \
    case 80: { constexpr int DP = 80; __VA_ARGS__; } \
    case 96: { constexpr int DP = 96; __VA_ARGS__; } \
    case 112: { constexpr int DP = 112; __VA_ARGS__; } \
    default: { constexpr int DP = 128; __VA_ARGS__; } \
  }

template <typename Kernel>
cudaError_t launch_probe(Kernel kern, int threads, int bytes, const void* a, const void* b,
                         void* c, int w, int split, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kern<<<1, threads, bytes, stream>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                      static_cast<float*>(c), w, split);
  return cudaGetLastError();
}

}  // namespace

// The float32 forms (ops/hopper_mma_probe.py::TF32_PRODUCTS): mode 3 with
// k_cols (K) a multiple of 8 up to 128 and n_cols (N) 16 or 32, mode 6 with
// the same K and n_cols 64; mode 4 with
// k_cols 64 and mode 5 with k_cols 16 or 32, each with n_cols (N) a
// multiple of 8 up to 128; split 1 for the three-product split, 0 for one
// TF32 product. Returns cudaErrorInvalidValue for any other.
extern "C" int clipself_tf32_probe(int mode, int k_cols, int n_cols, int split, const void* a,
                                   const void* b, void* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = mode == 3 || mode == 6 ? k_cols : n_cols;
  const bool other_ok = mode == 3 ? (n_cols == 16 || n_cols == 32)
                        : mode == 4 ? k_cols == 64
                        : mode == 5 ? (k_cols == 16 || k_cols == 32)
                        : mode == 6 ? n_cols == 64
                                    : false;
  if (!other_ok || w < 8 || w > 128 || w % 8 != 0) return (int)cudaErrorInvalidValue;
  if (mode == 3) {
    if (n_cols == 16) {
      CLIPSELF_TF32_DP(return (int)launch_probe(
          tf32_scores_probe_kernel<DP, 16>, 128,
          ATOM_BYTES + 2 * f32_plane_bytes(16, DP) + 64 * (DP + F32_PAD) * 4, a, b, c, w, split, s))
    }
    CLIPSELF_TF32_DP(return (int)launch_probe(
        tf32_scores_probe_kernel<DP, 32>, 128,
        ATOM_BYTES + 2 * f32_plane_bytes(32, DP) + 64 * (DP + F32_PAD) * 4, a, b, c, w, split, s))
  }
  if (mode == 4) {
    CLIPSELF_TF32_DP(return (int)launch_probe(tf32_rows_probe_kernel<DP>, 32,
                                              64 * (DP + F32_PAD) * 4, a, b, c, w, split, s))
  }
  if (mode == 6) {
    CLIPSELF_TF32_DP(return (int)launch_probe(tf32_ldmatrix_probe_kernel<DP>, 32,
                                              80 * (DP + F32_PAD) * 4, a, b, c, w, split, s))
  }
  if (k_cols == 16) {
    CLIPSELF_TF32_DP(return (int)launch_probe(tf32_split_rows_probe_kernel<16, DP>, 32,
                                              ATOM_BYTES + 2 * f32_plane_bytes(16, DP), a, b, c,
                                              w, split, s))
  }
  CLIPSELF_TF32_DP(return (int)launch_probe(tf32_split_rows_probe_kernel<32, DP>, 32,
                                            ATOM_BYTES + 2 * f32_plane_bytes(32, DP), a, b, c, w,
                                            split, s))
}
#undef CLIPSELF_TF32_DP

// The (mode, K, N) forms built: ops/hopper_mma_probe.py::PRODUCTS lists the
// same. Returns cudaErrorInvalidValue for any other.
extern "C" int clipself_wgmma_probe(int mode, int k_cols, int n_cols, const void* a,
                                    const void* b, void* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CLIPSELF_PROBE(M, K, N) \
  if (mode == M && k_cols == K && n_cols == N) return (int)launch<M, K, N>(a, b, c, s);
  CLIPSELF_PROBE(0, 64, 64)
  CLIPSELF_PROBE(0, 80, 64)
  CLIPSELF_PROBE(0, 96, 64)
  CLIPSELF_PROBE(0, 112, 64)
  CLIPSELF_PROBE(0, 128, 64)
  CLIPSELF_PROBE(0, 80, 32)
  CLIPSELF_PROBE(0, 128, 32)
  CLIPSELF_PROBE(0, 64, 16)
  CLIPSELF_PROBE(0, 64, 48)
#define CLIPSELF_PROBE_N(M)                                                   \
  CLIPSELF_PROBE(M, 64, 16) CLIPSELF_PROBE(M, 64, 32) CLIPSELF_PROBE(M, 64, 48) \
  CLIPSELF_PROBE(M, 64, 64) CLIPSELF_PROBE(M, 64, 80) CLIPSELF_PROBE(M, 64, 96) \
  CLIPSELF_PROBE(M, 64, 112) CLIPSELF_PROBE(M, 64, 128)
  CLIPSELF_PROBE_N(1)
  CLIPSELF_PROBE_N(2)
#undef CLIPSELF_PROBE_N
#undef CLIPSELF_PROBE
  return (int)cudaErrorInvalidValue;
}
