// Fused row LayerNorm, forward and one-pass backward.
//
// Replaces the TPU kernels clipself_tpu/ops/layer_norm.py:_fwd_kernel (launched
// by _fwd_call) and _bwd_kernel (launched by _bwd_call). Per row of width W, in
// f32 whatever the type T of x:
//
//     mu = mean(x), var = max(mean(x^2) - mu^2, 0), rstd = rsqrt(var + eps)
//     y  = (x - mu) * (rstd * gamma) + beta              written in T
//     (with stats: mu and rstd per row, f32)
//
//     g  = dy * gamma, xhat = (x - mu) * rstd
//     dx = rstd * (g - mean(g) - xhat * mean(g * xhat))  written in T
//     dgamma = sum_rows dy * xhat, dbeta = sum_rows dy   f32
//
// Bound on the H100: device-memory bytes (a handful of operations per element
// against 2 or 3 elements moved). So each kernel reads x (and dy) once: a warp
// owns a row, keeps it in shared memory between the reduction pass and the
// output pass, and reduces its two sums with warp shuffles.
//
// The Pallas block plan (VMEM tiles of [block_n, W] rows, 128-aligned row
// blocks, widths that are multiples of 128, a sequential grid that revisits
// one (W,) block for dgamma and dbeta) has no counterpart here:
//   - rows are independent, so any row count runs unpadded, and rows are
//     addressed through two strides, so the views t[:, 1:] and t[:, 0] of a
//     [B, N, W] tensor need no copy;
//   - any width runs: loads are VEC elements wide, VEC the largest of
//     16 / sizeof(T), ..., 2, 1 that divides the width and every row's
//     address (W = 2730 in bf16 has 4-byte aligned rows: VEC = 2);
//   - blocks run in no order, so dgamma and dbeta go through per-block
//     partial sums [blocks, W] in f32: a persistent block of R warps takes R
//     rows at a time, each column is owned by one thread that adds the R
//     rows' terms in a fixed order into a shared-memory accumulator, and a
//     second small kernel adds the blocks' partials in a fixed order. No
//     atomics: the result is repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90

// VEC consecutive elements moved by one aligned load or store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// VEC floats of a [W] f32 vector, at most 16 bytes a load
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&out)[VEC]) {
  constexpr int FV = VEC < 4 ? VEC : 4;
  using PF = Pack<float, FV>;
#pragma unroll
  for (int h = 0; h < VEC / FV; ++h) {
    const PF t = reinterpret_cast<const PF*>(p)[h];
#pragma unroll
    for (int j = 0; j < FV; ++j) out[h * FV + j] = t.v[j];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long row_offset(long long row, int n_inner,
                                                long long stride_outer,
                                                long long stride_inner) {
  return (row / n_inner) * stride_outer + (row % n_inner) * stride_inner;
}

// One warp a row. Shared memory: blockDim.x / 32 rows of row_bytes each.
template <typename T, int VEC>
__global__ void layer_norm_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ y,
    float* __restrict__ mu_out, float* __restrict__ rstd_out, long long rows,
    int n_inner, long long stride_outer, long long stride_inner, int width,
    float eps, int row_bytes) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // whole warps leave; the kernel has no barrier
  P* stage = reinterpret_cast<P*>(smem + (size_t)warp * row_bytes);
  const P* xv = reinterpret_cast<const P*>(
      x + row_offset(row, n_inner, stride_outer, stride_inner));
  const int nvec = width / VEC;

  float s = 0.f, ss = 0.f;
#pragma unroll 4
  for (int i = lane; i < nvec; i += 32) {
    const P p = xv[i];
    stage[i] = p;  // read back by this lane only
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f32(p.v[j]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)width;
  const float var = fmaxf(ss / (float)width - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);

  P* yv = reinterpret_cast<P*>(y + row * width);
#pragma unroll 2
  for (int i = lane; i < nvec; i += 32) {
    const P p = stage[i];
    float g[VEC], b[VEC];
    load_f32<VEC>(gamma + (size_t)i * VEC, g);
    load_f32<VEC>(beta + (size_t)i * VEC, b);
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      from_f32((to_f32(p.v[j]) - mu) * (rstd * g[j]) + b[j], &o.v[j]);
    }
    yv[i] = o;
  }
  if (mu_out != nullptr && lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// A persistent block of R = blockDim.x / 32 warps takes R rows at a time.
// Shared memory: acc_g[W], acc_b[W], mu[R], rstd[R] in f32, then (from a
// 16-byte boundary) R rows of x and R rows of dy, row_bytes each.
// dx and partial may each be null: that output is then not computed.
// partial is [2, partial_stride / W, W]: block b writes its dgamma sums to
// row b of the first half and its dbeta sums to row b of the second.
template <typename T, int VEC>
__global__ void layer_norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ mu_in, const float* __restrict__ rstd_in,
    const float* __restrict__ gamma, T* __restrict__ dx,
    float* __restrict__ partial, long long partial_stride, long long rows,
    int n_inner, long long stride_outer, long long stride_inner, int width,
    int row_bytes, int stage_offset) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc_g = reinterpret_cast<float*>(smem);
  float* acc_b = acc_g + width;
  float* stat = acc_b + width;  // mu[R], rstd[R] of the rows in flight
  unsigned char* stage_x = smem + stage_offset;
  unsigned char* stage_dy = stage_x + (size_t)n_warps * row_bytes;
  const int nvec = width / VEC;
  const float inv_w = 1.f / (float)width;

  if (partial != nullptr) {
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      acc_g[c] = 0.f;
      acc_b[c] = 0.f;
    }
    // the first barrier of the loop below orders this against the adds
  }

  for (long long base = (long long)blockIdx.x * n_warps; base < rows;
       base += (long long)gridDim.x * n_warps) {
    const long long row = base + warp;
    if (row < rows) {
      P* sx = reinterpret_cast<P*>(stage_x + (size_t)warp * row_bytes);
      P* sdy = reinterpret_cast<P*>(stage_dy + (size_t)warp * row_bytes);
      const P* xv = reinterpret_cast<const P*>(
          x + row_offset(row, n_inner, stride_outer, stride_inner));
      const P* dyv = reinterpret_cast<const P*>(dy + row * width);
      const float mu = mu_in[row], rstd = rstd_in[row];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll 2
      for (int i = lane; i < nvec; i += 32) {
        const P px = xv[i];
        const P pd = dyv[i];
        sx[i] = px;
        sdy[i] = pd;
        float gm[VEC];
        load_f32<VEC>(gamma + (size_t)i * VEC, gm);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float g = to_f32(pd.v[j]) * gm[j];
          const float xhat = (to_f32(px.v[j]) - mu) * rstd;
          s1 += g;
          s2 = fmaf(g, xhat, s2);
        }
      }
      const float m1 = warp_sum(s1) * inv_w;
      const float m2 = warp_sum(s2) * inv_w;
      if (dx != nullptr) {
        P* dxv = reinterpret_cast<P*>(dx + row * width);
#pragma unroll 2
        for (int i = lane; i < nvec; i += 32) {
          const P px = sx[i];  // written by this lane
          const P pd = sdy[i];
          float gm[VEC];
          load_f32<VEC>(gamma + (size_t)i * VEC, gm);
          P o;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float g = to_f32(pd.v[j]) * gm[j];
            const float xhat = (to_f32(px.v[j]) - mu) * rstd;
            from_f32(rstd * (g - m1 - xhat * m2), &o.v[j]);
          }
          dxv[i] = o;
        }
      }
      if (lane == 0) {
        stat[warp] = mu;
        stat[n_warps + warp] = rstd;
      }
    }
    if (partial != nullptr) {
      __syncthreads();  // the R staged rows and their stats are complete
      const long long left = rows - base;
      const int n_rows = left < n_warps ? (int)left : n_warps;
      for (int c = threadIdx.x; c < width; c += blockDim.x) {
        float ag = 0.f, ab = 0.f;
        for (int r = 0; r < n_rows; ++r) {
          const T* xs = reinterpret_cast<const T*>(stage_x + (size_t)r * row_bytes);
          const T* ds = reinterpret_cast<const T*>(stage_dy + (size_t)r * row_bytes);
          const float d = to_f32(ds[c]);
          const float xhat = (to_f32(xs[c]) - stat[r]) * stat[n_warps + r];
          ag = fmaf(d, xhat, ag);
          ab += d;
        }
        acc_g[c] += ag;  // column c belongs to this thread alone
        acc_b[c] += ab;
      }
      __syncthreads();  // before the next rows overwrite the stage
    }
  }

  if (partial != nullptr) {
    // a block that took no rows still writes its zeros
    __syncthreads();
    float* out_g = partial + (long long)blockIdx.x * width;
    float* out_b = partial + partial_stride + (long long)blockIdx.x * width;
    for (int c = threadIdx.x; c < width; c += blockDim.x) {
      out_g[c] = acc_g[c];
      out_b[c] = acc_b[c];
    }
  }
}

// dgamma[c] (blockIdx.y == 0) or dbeta[c] (blockIdx.y == 1) = the sum of the
// blocks' partials, in a fixed order: thread (c, j) adds blocks j, j + 8, ...,
// then thread (c, 0) adds the eight sums.
__global__ void layer_norm_bwd_reduce_kernel(const float* __restrict__ partial,
                                             long long partial_stride,
                                             int n_blocks, int width,
                                             float* __restrict__ dgamma,
                                             float* __restrict__ dbeta) {
  __shared__ float sums[8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const float* src = partial + (long long)blockIdx.y * partial_stride;
  float s = 0.f;
  if (c < width) {
    for (int b = threadIdx.y; b < n_blocks; b += 8) {
      s += src[(long long)b * width + c];
    }
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < width) {
    float total = sums[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < 8; ++j) total += sums[j][threadIdx.x];
    (blockIdx.y == 0 ? dgamma : dbeta)[c] = total;
  }
}

inline int round_up16(long long v) { return (int)((v + 15) / 16 * 16); }

// The widest load, in elements, that every row of these tensors allows.
template <typename T>
int pick_vec(int width, long long stride_outer, long long stride_inner,
             const void* const* ptrs, int n_ptrs, const void* const* f32_ptrs,
             int n_f32_ptrs) {
  for (int vec = 16 / (int)sizeof(T); vec > 1; vec /= 2) {
    const size_t bytes = sizeof(T) * vec;
    const size_t f32_bytes = vec < 4 ? 4 * vec : 16;
    bool ok = width % vec == 0 && stride_outer % vec == 0 &&
              stride_inner % vec == 0;
    for (int i = 0; ok && i < n_ptrs; ++i) {
      ok = reinterpret_cast<size_t>(ptrs[i]) % bytes == 0;
    }
    for (int i = 0; ok && i < n_f32_ptrs; ++i) {
      ok = reinterpret_cast<size_t>(f32_ptrs[i]) % f32_bytes == 0;
    }
    if (ok) return vec;
  }
  return 1;
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int VEC>
cudaError_t launch_fwd_vec(const void* x, const void* gamma, const void* beta,
                           void* y, void* mu, void* rstd, long long rows,
                           int n_inner, long long stride_outer,
                           long long stride_inner, int width, float eps,
                           cudaStream_t stream) {
  const int row_bytes = round_up16((long long)width * sizeof(T));
  int warps = 4;
  while (warps > 1 && (long long)warps * row_bytes > kMaxSharedBytes) warps /= 2;
  const long long shared = (long long)warps * row_bytes;
  if (shared > kMaxSharedBytes) return cudaErrorInvalidValue;
  auto kernel = layer_norm_fwd_kernel<T, VEC>;
  cudaError_t err = allow_shared(kernel, (int)shared);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, warps * 32, (size_t)shared, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y),
      static_cast<float*>(mu), static_cast<float*>(rstd), rows, n_inner,
      stride_outer, stride_inner, width, eps, row_bytes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta,
                       void* y, void* mu, void* rstd, long long rows,
                       int n_inner, long long stride_outer,
                       long long stride_inner, int width, float eps,
                       cudaStream_t stream) {
  const void* ptrs[] = {x, y};
  const void* f32_ptrs[] = {gamma, beta};
  const int vec = pick_vec<T>(width, stride_outer, stride_inner, ptrs, 2,
                              f32_ptrs, 2);
#define CLIPSELF_LN_FWD(V)                                                    \
  return launch_fwd_vec<T, V>(x, gamma, beta, y, mu, rstd, rows, n_inner,     \
                              stride_outer, stride_inner, width, eps, stream)
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) CLIPSELF_LN_FWD(8);
  }
  if (vec == 4) CLIPSELF_LN_FWD(4);
  if (vec == 2) CLIPSELF_LN_FWD(2);
  CLIPSELF_LN_FWD(1);
#undef CLIPSELF_LN_FWD
}

// Shared-memory bytes of the backward kernel with `warps` rows in flight.
template <typename T>
long long bwd_shared(int warps, int width, int* stage_offset, int* row_bytes) {
  *row_bytes = round_up16((long long)width * sizeof(T));
  *stage_offset = round_up16((2LL * width + 2LL * warps) * sizeof(float));
  return *stage_offset + 2LL * warps * *row_bytes;
}

template <typename T, int VEC>
cudaError_t launch_bwd_vec(const void* x, const void* dy, const void* mu,
                           const void* rstd, const void* gamma, void* dx,
                           void* partial, void* dgamma, void* dbeta,
                           long long rows, int n_inner, long long stride_outer,
                           long long stride_inner, int width, int max_blocks,
                           cudaStream_t stream) {
  // the most rows in flight that leave room for two blocks on an SM; fewer
  // if even one block would not fit
  int warps = 8, stage_offset = 0, row_bytes = 0;
  while (warps > 1 &&
         bwd_shared<T>(warps, width, &stage_offset, &row_bytes) > kMaxSharedBytes / 2) {
    warps /= 2;
  }
  const long long shared = bwd_shared<T>(warps, width, &stage_offset, &row_bytes);
  if (shared > kMaxSharedBytes) return cudaErrorInvalidValue;
  auto kernel = layer_norm_bwd_kernel<T, VEC>;
  cudaError_t err = allow_shared(kernel, (int)shared);
  if (err != cudaSuccess) return err;
  long long blocks = (rows + warps - 1) / warps;
  if (blocks > max_blocks) blocks = max_blocks;
  const long long partial_stride = (long long)max_blocks * width;
  kernel<<<(unsigned)blocks, warps * 32, (size_t)shared, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const float*>(gamma), static_cast<T*>(dx),
      static_cast<float*>(partial), partial_stride, rows, n_inner,
      stride_outer, stride_inner, width, row_bytes, stage_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const dim3 grid((width + 31) / 32, 2), block(32, 8);
  layer_norm_bwd_reduce_kernel<<<grid, block, 0, stream>>>(
      static_cast<const float*>(partial), partial_stride, (int)blocks, width,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* mu,
                       const void* rstd, const void* gamma, void* dx,
                       void* partial, void* dgamma, void* dbeta, long long rows,
                       int n_inner, long long stride_outer,
                       long long stride_inner, int width, int max_blocks,
                       cudaStream_t stream) {
  const void* ptrs[] = {x, dy, dx};  // a null dx is aligned to anything
  const void* f32_ptrs[] = {gamma};
  const int vec = pick_vec<T>(width, stride_outer, stride_inner, ptrs, 3,
                              f32_ptrs, 1);
#define CLIPSELF_LN_BWD(V)                                                    \
  return launch_bwd_vec<T, V>(x, dy, mu, rstd, gamma, dx, partial, dgamma,    \
                              dbeta, rows, n_inner, stride_outer,             \
                              stride_inner, width, max_blocks, stream)
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) CLIPSELF_LN_BWD(8);
  }
  if (vec == 4) CLIPSELF_LN_BWD(4);
  if (vec == 2) CLIPSELF_LN_BWD(2);
  CLIPSELF_LN_BWD(1);
#undef CLIPSELF_LN_BWD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: rows of `width` elements with unit
// stride, row r at x + (r / n_inner) * stride_outer + (r % n_inner) *
// stride_inner (strides in elements); gamma, beta: contiguous float32 [width];
// y: contiguous [rows, width] of x's type; mu, rstd: float32 [rows], or both
// null for a forward that writes no statistics. Returns the launch's
// cudaError_t.
extern "C" int clipself_layer_norm_fwd(int dtype, const void* x,
                                       const void* gamma, const void* beta,
                                       void* y, void* mu, void* rstd,
                                       long long rows, int n_inner,
                                       long long stride_outer,
                                       long long stride_inner, int width,
                                       float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 0 || n_inner <= 0 || rows < 0 || (mu == nullptr) != (rstd == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  if (dtype == 0) {
    return (int)launch_fwd<float>(x, gamma, beta, y, mu, rstd, rows, n_inner,
                                  stride_outer, stride_inner, width, eps, s);
  }
  if (dtype == 1) {
    return (int)launch_fwd<__nv_bfloat16>(x, gamma, beta, y, mu, rstd, rows,
                                          n_inner, stride_outer, stride_inner,
                                          width, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// x as in the forward; dy: contiguous [rows, width] of x's type; mu, rstd:
// the forward's float32 [rows]; dx: contiguous [rows, width] of x's type, or
// null. partial: float32 scratch [2, max_blocks, width] with dgamma, dbeta
// float32 [width], or all three null when neither is wanted. At most
// max_blocks blocks run.
extern "C" int clipself_layer_norm_bwd(int dtype, const void* x, const void* dy,
                                       const void* mu, const void* rstd,
                                       const void* gamma, void* dx,
                                       void* partial, void* dgamma,
                                       void* dbeta, long long rows, int n_inner,
                                       long long stride_outer,
                                       long long stride_inner, int width,
                                       int max_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sums = partial != nullptr;
  if (width <= 0 || n_inner <= 0 || rows <= 0 || max_blocks <= 0 ||
      sums != (dgamma != nullptr) || sums != (dbeta != nullptr) ||
      (!sums && dx == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return (int)launch_bwd<float>(x, dy, mu, rstd, gamma, dx, partial, dgamma,
                                  dbeta, rows, n_inner, stride_outer,
                                  stride_inner, width, max_blocks, s);
  }
  if (dtype == 1) {
    return (int)launch_bwd<__nv_bfloat16>(x, dy, mu, rstd, gamma, dx, partial,
                                          dgamma, dbeta, rows, n_inner,
                                          stride_outer, stride_inner, width,
                                          max_blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
