// Rolled 2-D RoPE on the flat [B, N, W] q/k projection layout.
//
// Replaces the TPU kernel clipself_tpu/ops/rope_roll.py:_rope_kernel (launched
// by _rope_call), which computes
//
//     y = x * cos + roll(x, -1) * sin_a + roll(x, +1) * sin_b
//
// along the lane axis, with the rotation signs and lane parity folded into
// sin_a (nonzero on even lanes only) and sin_b (nonzero on odd lanes only),
// as clipself_tpu/models/rope.py:_split_sin_np builds them. Both rolls stay
// inside one (even, odd) lane pair, so the Pallas block plan and its in-VMEM
// lane rotates have no counterpart here: one thread owns one pair,
//
//     y[2i]   = x[2i]   * cos[2i]   + x[2i+1] * sin_a[2i]
//     y[2i+1] = x[2i+1] * cos[2i+1] + x[2i]   * sin_b[2i+1]
//
// computed in f32 and rounded once to the output type.
//
// Bound on the H100: device-memory bytes. Two multiply-adds per element
// against 2 x sizeof(T) bytes moved. The design reads x once with one
// vector load per pair and writes y once; the tables are [N, head_dim] f32
// (RoPE is head-independent), so they are W / head_dim times smaller than x
// and are served from L2 after the first head touches them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

template <typename T>
__global__ void rope_roll_kernel(const T* __restrict__ x,
                                 const float* __restrict__ cos_t,
                                 const float* __restrict__ sin_a,
                                 const float* __restrict__ sin_b,
                                 T* __restrict__ y, long long pairs, int n,
                                 int width, int head_dim) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < pairs; p += stride) {
    const long long e = 2 * p;
    const int lane = (int)(e % width);
    const int tok = (int)((e / width) % n);
    const long long t = (long long)tok * head_dim + lane % head_dim;
    const float2 xv = load_pair(x + e);
    const float2 c = *reinterpret_cast<const float2*>(cos_t + t);
    float2 out;
    out.x = fmaf(xv.y, sin_a[t], xv.x * c.x);
    out.y = fmaf(xv.x, sin_b[t + 1], xv.y * c.y);
    store_pair(y + e, out);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* cos_t, const void* sin_a,
                   const void* sin_b, void* y, int batch, int n, int width,
                   int head_dim, cudaStream_t stream) {
  const long long pairs = (long long)batch * n * width / 2;
  if (pairs == 0) return cudaSuccess;
  const int threads = 256;
  const long long want = (pairs + threads - 1) / threads;
  const int blocks = (int)(want < (1LL << 30) ? want : (1LL << 30));
  rope_roll_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_a), static_cast<const float*>(sin_b),
      static_cast<T*>(y), pairs, n, width, head_dim);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y: contiguous [batch, n, width];
// cos_t, sin_a, sin_b: contiguous float32 [n, head_dim]; width % head_dim == 0
// and head_dim even. Returns the launch's cudaError_t.
extern "C" int clipself_rope_roll(int dtype, const void* x, const void* cos_t,
                                  const void* sin_a, const void* sin_b,
                                  void* y, int batch, int n, int width,
                                  int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 0 || head_dim % 2 || width % head_dim) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return (int)launch<float>(x, cos_t, sin_a, sin_b, y, batch, n, width,
                              head_dim, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(x, cos_t, sin_a, sin_b, y, batch, n,
                                      width, head_dim, s);
  }
  return (int)cudaErrorInvalidValue;
}
