// One 64 x 64 x 64 bf16 product through each operand form of
// hopper_mma.cuh, so that a fault in a descriptor, a transpose flag, the
// swizzled loader or the fragment map shows here and not inside the
// attention kernels that are built from the same pieces:
//
//   mode 0: C = A . B^T   A and B K-major tiles in shared memory
//                         (the attention scores, S = Q K^T)
//   mode 1: C = A . B     A from registers, B an MN-major tile
//                         (the value product, O = P V)
//   mode 2: C = A^T . B   A and B MN-major tiles in shared memory
//                         (dQ = dS K from a stored dS^T)
//
// a, b: contiguous [64, 64] bf16; c: contiguous [64, 64] f32. One block of
// one warpgroup.

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

template <int MODE>
__global__ void __launch_bounds__(128)
    probe_kernel(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, float* __restrict__ c) {
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t a_s = align_1024(smem_u32(smem));
  const uint32_t b_s = a_s + TILE64_BYTES;

  load_tile_async<64, 128>(a_s, a, 64, 0, 64, tid);
  load_tile_async<64, 128>(b_s, b, 64, 0, 64, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_proxy();
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  uint32_t frag[16];
  if (MODE == 1) {  // A fragment of every k-slice, straight from global memory
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const __nv_bfloat16* p = a + frag_row(tid, i) * 64 + frag_col(tid, i);
      frag[i / 2] = *reinterpret_cast<const uint32_t*>(p);
    }
  }

  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (MODE == 0) {
      wgmma_m64n64k16_ss<0, 0>(acc, tile_desc(a_s) + kk * K_SLICE_K_MAJOR,
                               tile_desc(b_s) + kk * K_SLICE_K_MAJOR, 1);
    } else if (MODE == 1) {
      wgmma_m64n64k16_rs<1>(acc, frag[4 * kk], frag[4 * kk + 1],
                            frag[4 * kk + 2], frag[4 * kk + 3],
                            tile_desc(b_s) + kk * K_SLICE_MN_MAJOR, 1);
    } else {
      wgmma_m64n64k16_ss<1, 1>(acc, tile_desc(a_s) + kk * K_SLICE_MN_MAJOR,
                               tile_desc(b_s) + kk * K_SLICE_MN_MAJOR, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if (MODE == 1) fence_regs(frag);

#pragma unroll
  for (int i = 0; i < 32; ++i) c[frag_row(tid, i) * 64 + frag_col(tid, i)] = acc[i];
}

template <int MODE>
cudaError_t launch(const void* a, const void* b, void* c, cudaStream_t stream) {
  const int smem_bytes = 2 * TILE64_BYTES + ATOM_BYTES;
  auto kern = probe_kernel<MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<1, 128, smem_bytes, stream>>>(static_cast<const __nv_bfloat16*>(a),
                                       static_cast<const __nv_bfloat16*>(b),
                                       static_cast<float*>(c));
  return cudaGetLastError();
}

}  // namespace

extern "C" int clipself_wgmma_probe(int mode, const void* a, const void* b,
                                    void* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)launch<0>(a, b, c, s);
    case 1: return (int)launch<1>(a, b, c, s);
    case 2: return (int)launch<2>(a, b, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
