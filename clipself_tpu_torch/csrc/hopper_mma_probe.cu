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

}  // namespace

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
