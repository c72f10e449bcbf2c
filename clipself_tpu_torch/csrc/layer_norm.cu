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
// against 2 or 3 elements moved), so each kernel reads x (and dy) once.
//
// The Pallas block plan (VMEM tiles of [block_n, W] rows, 128-aligned row
// blocks, widths that are multiples of 128, a sequential grid that revisits
// one (W,) block for dgamma and dbeta) has no counterpart here:
//   - rows are independent, so any row count runs unpadded, and rows are
//     addressed through two strides, so the views t[:, 1:] and t[:, 0] of a
//     [B, N, W] tensor need no copy;
//   - any width runs: loads are VEC elements wide, VEC the largest of
//     16 / sizeof(T), ..., 2, 1 that divides the width and every row's
//     address (W = 2730 in bf16 has 4-byte aligned rows: VEC = 2; 32 lanes
//     on neighbouring 4-byte words still coalesce fully);
//   - blocks run in no order, so dgamma and dbeta go through per-block
//     partial rows [blocks, W] in f32 that a second small kernel adds in a
//     fixed order. No atomics: the result is repeatable.
//
// The forward: one warp a row, staged in shared memory between the
// reduction pass and the output pass.
//
// The backward: a row group of G warps takes one row at a time, and each of
// its lanes owns the same VEC-wide column chunks in every row (at most
// kBwdLaneElems elements of x and as many of dy, so G grows with the width:
// 16 elements keep the bf16 kernels within 128 registers, where 32 spilled).
// A lane copies its chunks of the group's next row into a ring in shared
// memory (cp.async) while it works on the current one, which it reads back
// into registers for both passes (the two row sums, by warp shuffles and,
// when G > 1, one exchange under a named barrier of the group; then dx); it
// adds the row's dgamma and dbeta terms into registers of its own. A lane
// reads only what it copied, so the ring needs no barrier. The ring is what
// keeps enough bytes in flight: with one 512-thread block an SM (the
// registers allow no more) a group that held one row in registers waited out
// a load's latency every row. A persistent grid walks the rows, the groups
// strided by their global index; at the end the block adds its groups' sums
// in group order into one partial row. The plan (G, groups a block, shared
// bytes) comes from ops/layer_norm.py:bwd_plan, which this file checks.
// That is the "registers" design. The "staged" design (the first port's)
// takes the rows the registers design cannot (bf16 rows read one element at
// a time, rows wider than it holds) and fewer rows than SMs, where the H100
// measured it faster (ops/layer_norm.py:bwd_design): a persistent block of R
// warps stages R rows of x and dy in shared memory, a warp a row, and a
// thread a column adds the R rows' dgamma and dbeta terms into a
// shared-memory accumulator. The shared-memory attribute, the occupancy and
// the SM count are looked up once a process for each kernel and block shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <map>
#include <mutex>
#include <tuple>

namespace {

// ops/layer_norm.py reads the four constants below from this file, so they
// are set here alone.
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
// elements of x (and of dy) of one row that a backward lane holds in
// registers, beside their dgamma and dbeta sums
constexpr int kBwdLaneElems = 16;
// threads of a backward block: 16 warps at <= 128 registers fill an SM
constexpr int kBwdMaxThreads = 512;
// rows a backward row group has in its ring: one it works on, the next in
// flight (three or four read no faster on the H100)
constexpr int kBwdStages = 2;
// blocks of the partial-sum reduce: (32 columns, 8 strided sums)
constexpr int kReduceLanes = 8;

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

// the `threads` threads of one row group meet at barrier `id` (1..15; 0 is
// __syncthreads)
__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
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

// Asynchronous copies of BYTES (4, 8 or 16) from global to shared memory. A
// thread commits its copies in groups and waits for its own groups; what it
// copied itself it then reads without a barrier.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The chunks of one row of x and dy that a lane of a row group owns (gt,
// gt + gthreads, ...), copied into a slot of the group's ring (x, then dy at
// row_bytes), as one commit group; past the last row the group is empty.
template <typename T, int VEC, int MAXC>
__device__ __forceinline__ void copy_row(const T* __restrict__ x, const T* __restrict__ dy,
                                         long long row, long long rows, int n_inner,
                                         long long stride_outer, long long stride_inner,
                                         int width, int gt, int gthreads,
                                         unsigned char* slot, int row_bytes) {
  using P = Pack<T, VEC>;
  if (row < rows) {
    // rows < 2^31 (checked at the launch): 32-bit division
    const unsigned r = (unsigned)row, inner = (unsigned)n_inner;
    const P* xv = reinterpret_cast<const P*>(
        x + (long long)(r / inner) * stride_outer + (long long)(r % inner) * stride_inner);
    const P* dyv = reinterpret_cast<const P*>(dy + row * width);
    P* sx = reinterpret_cast<P*>(slot);
    P* sd = reinterpret_cast<P*>(slot + row_bytes);
    const int nvec = width / VEC;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int i = gt + c * gthreads;
      if (i < nvec) {
        cp_async<sizeof(P)>(sx + i, xv + i);
        cp_async<sizeof(P)>(sd + i, dyv + i);
      }
    }
  }
  cp_async_commit();
}

// The backward's "registers" design. blockDim.x = groups * G * 32; MAXC =
// the most VEC-wide chunks a lane holds of a row (kBwdLaneElems of x); a
// group takes rows q, q + S, ... of its stride S, with the next
// kBwdStages - 1 of them in flight in its ring while it works on one.
// Shared memory: gamma
// [round_up4(W)] f32, the groups' row-sum exchange [2][groups][G][2] f32
// (double-buffered by row, so one barrier a row suffices), then the groups'
// rings [groups][kBwdStages][x, dy] of row_bytes each, which the groups' dgamma
// and dbeta sums [groups][2][W] f32 overlay once the rows are done. dx and
// partial may each be null: that output is then not computed. partial is
// [2, partial_stride / W, W]: block b writes its dgamma sums to row b of the
// first half and its dbeta sums to row b of the second.
template <typename T, int VEC, int MAXC>
__global__ void __launch_bounds__(kBwdMaxThreads) layer_norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ mu_in, const float* __restrict__ rstd_in,
    const float* __restrict__ gamma, T* __restrict__ dx,
    float* __restrict__ partial, long long partial_stride, long long rows,
    int n_inner, long long stride_outer, long long stride_inner, int width,
    int group_warps) {
  using P = Pack<T, VEC>;
  static_assert(sizeof(P) >= 4, "cp.async moves 4 bytes or more");
  extern __shared__ __align__(16) unsigned char smem[];
  const int gthreads = group_warps * 32;
  const int groups = blockDim.x / gthreads;
  const int group = threadIdx.x / gthreads, gt = threadIdx.x % gthreads;
  const int lane = threadIdx.x & 31, gwarp = gt >> 5;
  const int nvec = width / VEC;
  const bool sums = partial != nullptr;
  const float inv_w = 1.f / (float)width;
  const int row_bytes = (width * (int)sizeof(T) + 15) & ~15;
  float* gamma_s = reinterpret_cast<float*>(smem);
  float* xchg = gamma_s + ((width + 3) & ~3);
  unsigned char* ring = reinterpret_cast<unsigned char*>(xchg + 4 * groups * group_warps);
  unsigned char* own = ring + (size_t)group * kBwdStages * 2 * row_bytes;
  float* red = reinterpret_cast<float*>(ring);

  const long long stride_rows = (long long)gridDim.x * groups;
  const long long first = (long long)blockIdx.x * groups + group;
  for (int s = 0; s + 1 < kBwdStages; ++s) {
    copy_row<T, VEC, MAXC>(x, dy, first + s * stride_rows, rows, n_inner, stride_outer,
                           stride_inner, width, gt, gthreads, own + (size_t)s * 2 * row_bytes,
                           row_bytes);
  }
  for (int c = threadIdx.x; c < width; c += blockDim.x) gamma_s[c] = gamma[c];
  __syncthreads();

  float ag[MAXC][VEC], ab[MAXC][VEC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) ag[c][j] = ab[c][j] = 0.f;
  }

  float mu_next = 0.f, rstd_next = 0.f;
  if (first < rows) {
    mu_next = mu_in[first];
    rstd_next = rstd_in[first];
  }
  int parity = 0, slot = 0;
  for (long long row = first; row < rows; row += stride_rows) {
    // the row kBwdStages - 1 ahead goes into the slot this lane read last
    const int ahead = slot > 0 ? slot - 1 : kBwdStages - 1;
    copy_row<T, VEC, MAXC>(x, dy, row + (kBwdStages - 1) * stride_rows, rows, n_inner,
                           stride_outer, stride_inner, width, gt, gthreads,
                           own + (size_t)ahead * 2 * row_bytes, row_bytes);
    const float mu = mu_next, rstd = rstd_next;
    if (row + stride_rows < rows) {
      mu_next = mu_in[row + stride_rows];
      rstd_next = rstd_in[row + stride_rows];
    }
    cp_async_wait<kBwdStages - 1>();  // this row's copies, all made by this lane
    const P* sx = reinterpret_cast<const P*>(own + (size_t)slot * 2 * row_bytes);
    const P* sd = reinterpret_cast<const P*>(own + (size_t)slot * 2 * row_bytes + row_bytes);
    P px[MAXC], pd[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int i = gt + c * gthreads;
      if (i < nvec) {
        px[c] = sx[i];
        pd[c] = sd[i];
      }
    }

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int i = gt + c * gthreads;
      if (i < nvec) {
        float gm[VEC];
        load_f32<VEC>(gamma_s + i * VEC, gm);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = to_f32(pd[c].v[j]);
          const float xhat = (to_f32(px[c].v[j]) - mu) * rstd;
          const float g = d * gm[j];
          s1 += g;
          s2 = fmaf(g, xhat, s2);
          if (sums) {
            ag[c][j] = fmaf(d, xhat, ag[c][j]);
            ab[c][j] += d;
          }
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (group_warps > 1) {  // the group's warps add their sums in warp order
      float* xs = xchg + 2 * group_warps * (parity * groups + group);
      if (lane == 0) {
        xs[2 * gwarp] = s1;
        xs[2 * gwarp + 1] = s2;
      }
      group_barrier(1 + group, gthreads);
      s1 = xs[0];
      s2 = xs[1];
      for (int w = 1; w < group_warps; ++w) {
        s1 += xs[2 * w];
        s2 += xs[2 * w + 1];
      }
      parity ^= 1;
    }
    const float m1 = s1 * inv_w, m2 = s2 * inv_w;

    if (dx != nullptr) {
      P* dxv = reinterpret_cast<P*>(dx + row * width);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int i = gt + c * gthreads;
        if (i < nvec) {
          float gm[VEC];
          load_f32<VEC>(gamma_s + i * VEC, gm);
          P o;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float g = to_f32(pd[c].v[j]) * gm[j];
            const float xhat = (to_f32(px[c].v[j]) - mu) * rstd;
            from_f32(rstd * (g - m1 - xhat * m2), &o.v[j]);
          }
          dxv[i] = o;
        }
      }
    }
    slot = slot + 1 < kBwdStages ? slot + 1 : 0;
  }

  if (sums) {
    cp_async_wait<0>();  // the empty groups past the last row
    __syncthreads();   // every group is done with its ring, which red overlays
    // a group covers every column, so each group writes all W of its sums
    float* red_g = red + (size_t)group * 2 * width;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int i = gt + c * gthreads;
      if (i < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          red_g[i * VEC + j] = ag[c][j];
          red_g[width + i * VEC + j] = ab[c][j];
        }
      }
    }
    __syncthreads();
    // a block that took no rows still writes its zeros
    float* out_g = partial + (long long)blockIdx.x * width;
    float* out_b = out_g + partial_stride;
    for (int col = threadIdx.x; col < width; col += blockDim.x) {
      float tg = red[col], tb = red[width + col];
      for (int g = 1; g < groups; ++g) {
        tg += red[(size_t)g * 2 * width + col];
        tb += red[(size_t)g * 2 * width + width + col];
      }
      out_g[col] = tg;
      out_b[col] = tb;
    }
  }
}

// The backward's "staged" design: a persistent block of R = blockDim.x / 32
// warps takes R rows at a time.
// Shared memory: acc_g[W], acc_b[W], mu[R], rstd[R] in f32, then (from a
// 16-byte boundary) R rows of x and R rows of dy, row_bytes each.
// dx and partial may each be null: that output is then not computed.
// partial is [2, partial_stride / W, W]: block b writes its dgamma sums to
// row b of the first half and its dbeta sums to row b of the second.
template <typename T, int VEC>
__global__ void layer_norm_bwd_staged_kernel(
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
  __shared__ float sums[kReduceLanes][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const float* src = partial + (long long)blockIdx.y * partial_stride;
  float s = 0.f;
  if (c < width) {
#pragma unroll 4
    for (int b = threadIdx.y; b < n_blocks; b += kReduceLanes) {
      s += src[(long long)b * width + c];
    }
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < width) {
    float total = sums[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kReduceLanes; ++j) total += sums[j][threadIdx.x];
    (blockIdx.y == 0 ? dgamma : dbeta)[c] = total;
  }
}

inline int round_up16(long long v) { return (int)((v + 15) / 16 * 16); }

// What a kernel needs before its first launch at one block shape on one
// device, looked up once a process: the shared-memory attribute (above 48
// KB), the blocks of `threads` with `shared` bytes an SM holds, and the
// device's SM count.
struct Setup {
  cudaError_t err;
  int blocks_per_sm;
  int sms;
};

std::mutex g_setup_mutex;
std::map<std::tuple<const void*, int, int, int>, Setup> g_setups;
// the shared-memory attribute each kernel has on each device: it only grows,
// so a set-up at a smaller size never lowers what an earlier one allowed
std::map<std::tuple<const void*, int>, int> g_shared_allowed;
std::atomic<int> g_setup_calls{0};

Setup setup_once(const void* kernel, int threads, int shared) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return {err, 0, 0};
  const auto key = std::make_tuple(kernel, threads, shared, device);
  std::lock_guard<std::mutex> lock(g_setup_mutex);
  const auto found = g_setups.find(key);
  if (found != g_setups.end()) return found->second;
  g_setup_calls.fetch_add(1);
  Setup s{cudaSuccess, 0, 0};
  int& allowed = g_shared_allowed[std::make_tuple(kernel, device)];
  if (shared > 48 * 1024 && shared > allowed) {
    s.err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (s.err == cudaSuccess) allowed = shared;
  }
  if (s.err == cudaSuccess) {
    s.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.blocks_per_sm,
                                                          kernel, threads, shared);
  }
  if (s.err == cudaSuccess) {
    s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (s.err == cudaSuccess && s.blocks_per_sm < 1) s.err = cudaErrorInvalidConfiguration;
  if (s.err == cudaSuccess) g_setups.emplace(key, s);
  return s;
}

// Whether every row of these tensors allows loads of `vec` elements.
bool vec_fits(int vec, size_t elem, int width, long long stride_outer,
              long long stride_inner, const void* const* ptrs, int n_ptrs) {
  if (width % vec != 0 || stride_outer % vec != 0 || stride_inner % vec != 0) {
    return false;
  }
  for (int i = 0; i < n_ptrs; ++i) {
    if (reinterpret_cast<size_t>(ptrs[i]) % (elem * vec) != 0) return false;
  }
  return true;
}

// The widest load, in elements, that every row of these tensors allows.
template <typename T>
int pick_vec(int width, long long stride_outer, long long stride_inner,
             const void* const* ptrs, int n_ptrs, const void* const* f32_ptrs,
             int n_f32_ptrs) {
  for (int vec = 16 / (int)sizeof(T); vec > 1; vec /= 2) {
    const size_t f32_bytes = vec < 4 ? 4 * vec : 16;
    bool ok = vec_fits(vec, sizeof(T), width, stride_outer, stride_inner, ptrs, n_ptrs);
    for (int i = 0; ok && i < n_f32_ptrs; ++i) {
      ok = reinterpret_cast<size_t>(f32_ptrs[i]) % f32_bytes == 0;
    }
    if (ok) return vec;
  }
  return 1;
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
  const Setup setup = setup_once((const void*)kernel, warps * 32, (int)shared);
  if (setup.err != cudaSuccess) return setup.err;
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

// The second launch of either design: dgamma and dbeta from the blocks'
// partial rows, if they are wanted (the first launch's error, if any, first).
cudaError_t launch_bwd_reduce(void* partial, void* dgamma, void* dbeta,
                              long long partial_stride, int blocks, int width,
                              cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const dim3 grid((width + 31) / 32, 2), block(32, kReduceLanes);
  layer_norm_bwd_reduce_kernel<<<grid, block, 0, stream>>>(
      static_cast<const float*>(partial), partial_stride, blocks, width,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return cudaGetLastError();
}

// Shared-memory bytes of the staged design with `warps` rows in flight.
template <typename T>
long long staged_shared(int warps, int width, int* stage_offset, int* row_bytes) {
  *row_bytes = round_up16((long long)width * sizeof(T));
  *stage_offset = round_up16((2LL * width + 2LL * warps) * sizeof(float));
  return *stage_offset + 2LL * warps * *row_bytes;
}

template <typename T, int VEC>
cudaError_t launch_bwd_staged_vec(const void* x, const void* dy, const void* mu,
                                  const void* rstd, const void* gamma, void* dx,
                                  void* partial, void* dgamma, void* dbeta,
                                  long long rows, int n_inner,
                                  long long stride_outer, long long stride_inner,
                                  int width, int max_blocks, cudaStream_t stream) {
  // the most rows in flight that leave room for two blocks on an SM; fewer
  // if even one block would not fit
  int warps = 8, stage_offset = 0, row_bytes = 0;
  while (warps > 1 &&
         staged_shared<T>(warps, width, &stage_offset, &row_bytes) > kMaxSharedBytes / 2) {
    warps /= 2;
  }
  const long long shared = staged_shared<T>(warps, width, &stage_offset, &row_bytes);
  if (shared > kMaxSharedBytes) return cudaErrorInvalidValue;
  auto kernel = layer_norm_bwd_staged_kernel<T, VEC>;
  const Setup setup = setup_once((const void*)kernel, warps * 32, (int)shared);
  if (setup.err != cudaSuccess) return setup.err;
  long long blocks = (rows + warps - 1) / warps;
  if (blocks > max_blocks) blocks = max_blocks;
  const long long partial_stride = (long long)max_blocks * width;
  kernel<<<(unsigned)blocks, warps * 32, (size_t)shared, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const float*>(gamma), static_cast<T*>(dx),
      static_cast<float*>(partial), partial_stride, rows, n_inner,
      stride_outer, stride_inner, width, row_bytes, stage_offset);
  return launch_bwd_reduce(partial, dgamma, dbeta, partial_stride, (int)blocks,
                           width, stream);
}

template <typename T>
cudaError_t launch_bwd_staged(const void* x, const void* dy, const void* mu,
                              const void* rstd, const void* gamma, void* dx,
                              void* partial, void* dgamma, void* dbeta,
                              long long rows, int n_inner, long long stride_outer,
                              long long stride_inner, int width, int max_blocks,
                              cudaStream_t stream) {
  const void* ptrs[] = {x, dy, dx};  // a null dx is aligned to anything
  const void* f32_ptrs[] = {gamma};
  const int vec = pick_vec<T>(width, stride_outer, stride_inner, ptrs, 3,
                              f32_ptrs, 1);
#define CLIPSELF_LN_BWD_STAGED(V)                                             \
  return launch_bwd_staged_vec<T, V>(x, dy, mu, rstd, gamma, dx, partial,     \
                                     dgamma, dbeta, rows, n_inner,            \
                                     stride_outer, stride_inner, width,       \
                                     max_blocks, stream)
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) CLIPSELF_LN_BWD_STAGED(8);
  }
  if (vec == 4) CLIPSELF_LN_BWD_STAGED(4);
  if (vec == 2) CLIPSELF_LN_BWD_STAGED(2);
  CLIPSELF_LN_BWD_STAGED(1);
#undef CLIPSELF_LN_BWD_STAGED
}

// Shared-memory bytes of the registers design's block (ops/layer_norm.py:
// bwd_plan computes the same): gamma, the row-sum exchange, then the rings
// or, overlaying them, the groups' sums, whichever is larger.
long long bwd_shared_bytes(int width, int elem, int group_warps, int groups) {
  const long long rings = 2LL * groups * kBwdStages * ((width * elem + 15) & ~15);
  const long long sums = 8LL * groups * width;
  return 4LL * ((width + 3) & ~3) + 16LL * groups * group_warps + (rings > sums ? rings : sums);
}

template <typename T, int VEC>
cudaError_t launch_bwd_vec(const void* x, const void* dy, const void* mu,
                           const void* rstd, const void* gamma, void* dx,
                           void* partial, void* dgamma, void* dbeta,
                           long long rows, int n_inner, long long stride_outer,
                           long long stride_inner, int width, int group_warps,
                           int groups, int shared, int max_blocks,
                           cudaStream_t stream) {
  constexpr int kMaxChunks = kBwdLaneElems / VEC;
  static_assert(kMaxChunks >= 1, "a lane holds at least one load of a row");
  const int nvec = width / VEC;
  const int threads = groups * group_warps * 32;
  if (group_warps < 1 || groups < 1 || threads > kBwdMaxThreads ||
      (group_warps > 1 && groups > 15) ||
      (nvec + group_warps * 32 - 1) / (group_warps * 32) > kMaxChunks ||
      shared != bwd_shared_bytes(width, sizeof(T), group_warps, groups) ||
      shared > kMaxSharedBytes) {
    return cudaErrorInvalidValue;
  }
  auto kernel = layer_norm_bwd_kernel<T, VEC, kMaxChunks>;
  const Setup setup = setup_once((const void*)kernel, threads, shared);
  if (setup.err != cudaSuccess) return setup.err;
  long long blocks = (rows + groups - 1) / groups;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > (long long)setup.blocks_per_sm * setup.sms) {
    blocks = (long long)setup.blocks_per_sm * setup.sms;
  }
  const long long partial_stride = (long long)max_blocks * width;
  kernel<<<(unsigned)blocks, threads, (size_t)shared, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const float*>(gamma), static_cast<T*>(dx),
      static_cast<float*>(partial), partial_stride, rows, n_inner,
      stride_outer, stride_inner, width, group_warps);
  return launch_bwd_reduce(partial, dgamma, dbeta, partial_stride, (int)blocks,
                           width, stream);
}

// The registers design copies whole loads of 4 bytes or more; a bfloat16 row
// read one element at a time takes the staged design (ops/layer_norm.py:
// bwd_design).
template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* mu,
                       const void* rstd, const void* gamma, void* dx,
                       void* partial, void* dgamma, void* dbeta, long long rows,
                       int n_inner, long long stride_outer,
                       long long stride_inner, int width, int vec,
                       int group_warps, int groups, int shared, int max_blocks,
                       cudaStream_t stream) {
  const void* ptrs[] = {x, dy, dx};  // a null dx is aligned to anything
  if (vec < 1 || vec > 16 / (int)sizeof(T) ||
      !vec_fits(vec, sizeof(T), width, stride_outer, stride_inner, ptrs, 3)) {
    return cudaErrorInvalidValue;
  }
#define CLIPSELF_LN_BWD(V)                                                    \
  return launch_bwd_vec<T, V>(x, dy, mu, rstd, gamma, dx, partial, dgamma,    \
                              dbeta, rows, n_inner, stride_outer,             \
                              stride_inner, width, group_warps, groups,       \
                              shared, max_blocks, stream)
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) CLIPSELF_LN_BWD(8);
    if (vec == 4) CLIPSELF_LN_BWD(4);
    if (vec == 2) CLIPSELF_LN_BWD(2);
  } else {
    if (vec == 4) CLIPSELF_LN_BWD(4);
    if (vec == 2) CLIPSELF_LN_BWD(2);
    if (vec == 1) CLIPSELF_LN_BWD(1);
  }
#undef CLIPSELF_LN_BWD
  return cudaErrorInvalidValue;
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
// float32 [width], or all three null when neither is wanted. design: 0 =
// "registers" with the plan of ops/layer_norm.py:bwd_plan (loads of `vec`
// elements, which x, dy and dx must allow; `group_warps` warps a row,
// `groups` row groups a block, `shared` bytes of shared memory), 1 =
// "staged" (picks its own loads and block; the plan is not read). At most
// max_blocks blocks run.
extern "C" int clipself_layer_norm_bwd(int dtype, const void* x, const void* dy,
                                       const void* mu, const void* rstd,
                                       const void* gamma, void* dx,
                                       void* partial, void* dgamma,
                                       void* dbeta, long long rows, int n_inner,
                                       long long stride_outer,
                                       long long stride_inner, int width,
                                       int design, int vec, int group_warps,
                                       int groups, int shared, int max_blocks,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sums = partial != nullptr;
  if (width <= 0 || n_inner <= 0 || rows <= 0 || rows > 0x7fffffffLL || max_blocks <= 0 ||
      sums != (dgamma != nullptr) || sums != (dbeta != nullptr) ||
      (!sums && dx == nullptr) || (design != 0 && design != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (design == 1 && dtype == 0) {
    return (int)launch_bwd_staged<float>(x, dy, mu, rstd, gamma, dx, partial,
                                         dgamma, dbeta, rows, n_inner,
                                         stride_outer, stride_inner, width,
                                         max_blocks, s);
  }
  if (design == 1 && dtype == 1) {
    return (int)launch_bwd_staged<__nv_bfloat16>(
        x, dy, mu, rstd, gamma, dx, partial, dgamma, dbeta, rows, n_inner,
        stride_outer, stride_inner, width, max_blocks, s);
  }
  if (dtype == 0) {
    return (int)launch_bwd<float>(x, dy, mu, rstd, gamma, dx, partial, dgamma,
                                  dbeta, rows, n_inner, stride_outer,
                                  stride_inner, width, vec, group_warps, groups,
                                  shared, max_blocks, s);
  }
  if (dtype == 1) {
    return (int)launch_bwd<__nv_bfloat16>(x, dy, mu, rstd, gamma, dx, partial,
                                          dgamma, dbeta, rows, n_inner,
                                          stride_outer, stride_inner, width,
                                          vec, group_warps, groups, shared,
                                          max_blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel set-ups (shared-memory attribute, occupancy) this process has made:
// one for each LayerNorm kernel instantiation, shared size and device.
extern "C" int clipself_layer_norm_setup_calls() { return g_setup_calls.load(); }
