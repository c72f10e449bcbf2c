// Flash-attention backward: dQ, dK, dV of softmax(Q K^T * scale) V per
// (batch, head), from the forward's output O and row log-sum-exp lse.
//
// Replaces the TPU kernel clipself_tpu/ops/flash_bwd.py:_bwd_kernel
// (launched by flash_attention_bwd), which computes, per query row block
// against a key block,
//
//     P  = exp(S - lse),  S = Q K^T * scale   (keys past N masked to -inf
//                                              before the exp)
//     dV += P^T dO        dP = dO V^T         di = rowsum(dO * O)
//     dS = P * (dP - di) * scale
//     dK += dS^T Q        dQ += dS K
//
// with P and dS rounded to the input dtype before their products and every
// product accumulated in f32. The TPU kernel walks the key blocks in order
// and carries dQ in a VMEM scratch between grid steps; Hopper runs blocks in
// no order, so the accumulation across key blocks takes one of two forms: a
// dK/dV pass followed by a dQ pass that recomputes S and dP, or atomics.
// This kernel takes the atomics: one pass, five products per tile pair
// instead of eight. dQ accumulates in a zeroed f32 buffer through
// atomicAdd, and a last pass rounds it to bf16 (a float32 dq is its own
// accumulator). The order of the f32 additions into dQ changes from run to
// run, so dQ is not bitwise repeatable; the checks use tolerances.
//
// Blocking: one block of 4 warps owns 64 keys of one (batch, head) and keeps
// their dK and dV in f32 (WMMA accumulator fragments for bf16, registers for
// float32); each warp owns 16 of the keys. The block loops over 64-row query
// tiles: it stages Q and dO (rows past N zero-filled, so 0 * garbage cannot
// make a NaN) with lse and di, each warp forms S^T and dP^T for its 16 keys,
// the probabilities and dS^T, and adds P^T dO and dS^T Q into its
// accumulators; then each warp takes 16 query rows of dS K and adds them
// into dQ with atomics. di = rowsum(dO * O) is one small pass before the
// main kernel instead of being recomputed for every key block. K, V, Q and
// dO are read through the [B, N, H, D] strides the forward takes; dK and dV
// are written as contiguous [B, N, H, D].
//
// Bound on the H100: at N = 4097, D = 64 the block does 10 * 64 * D flops
// per (key, query tile row) pair against the Q/dO tile loads, which are
// reused by 64 keys, so it is bound by math throughput and shared-memory
// traffic, plus the f32 atomics of dQ (N / 64 partial sums per dQ element,
// served by the L2). bf16 runs all five products on the tensor cores through WMMA
// 16x16x16 tiles with f32 accumulation; float32 runs them as f32 FMAs so
// that it keeps full f32 precision (WMMA on f32 inputs would round them to
// TF32). wgmma, TMA and a pipelined Q/dO ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;  // query rows per inner tile
constexpr int BK = 64;  // keys per block
constexpr int WARPS = 4;
constexpr int WROWS = 16;  // keys per warp, and dQ rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory of one H100 block

template <typename T>
struct Pad;  // shared-memory row padding, in elements (keeps 16-byte rows)
template <>
struct Pad<float> {
  static constexpr int v = 4;
};
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int v = 8;
};

// Shared-memory plan. Every region and every 16-row/16-column tile inside it
// starts on a 32-byte boundary, as WMMA loads and stores require.
template <typename T, int D>
struct Plan {
  static constexpr int LD = D + Pad<T>::v;   // K, V, Q, dO rows
  static constexpr int LDP = BQ + Pad<T>::v; // P^T, dS^T rows (key-major)
  static constexpr int LDS = BQ + 4;         // f32 S^T, dP^T rows
  static constexpr int LDQ = D + 4;          // f32 dQ / dK / dV rows
  static constexpr size_t tile = sizeof(T) * 64 * LD;
  static constexpr size_t scores = sizeof(float) * BK * LDS;
  static constexpr size_t probs = sizeof(T) * BK * LDP;
  static constexpr size_t o_k = 0;
  static constexpr size_t o_v = tile;
  static constexpr size_t o_q = 2 * tile;
  static constexpr size_t o_do = 3 * tile;
  static constexpr size_t o_s = 4 * tile;       // S^T, then P (f32)
  static constexpr size_t o_dp = o_s + scores;  // dP^T (f32)
  // f32 rows of dQ (and at the end dK, dV) alias S^T/dP^T: they are written
  // only after every warp has finished reading its scores
  static constexpr size_t o_out = o_s;
  static constexpr size_t o_pt = o_dp + scores;  // P^T in T
  static constexpr size_t o_ds = o_pt + probs;   // dS^T in T
  static constexpr size_t o_lse = o_ds + probs;  // lse * log2(e) of the tile
  static constexpr size_t o_di = o_lse + sizeof(float) * BQ;
  static constexpr size_t total = o_di + sizeof(float) * BQ;
  static_assert(sizeof(float) * BQ * LDQ <= 2 * scores, "dQ rows overflow");
  static_assert(total <= SMEM_LIMIT, "shared-memory plan too large");
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_t(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_t(float v, __nv_bfloat16) {
  return __float2bfloat16(v);
}

// Copy 64 rows [row0, row0 + 64) of one head into shared memory with
// 16-byte loads; rows at or past n are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride_n, int row0, int n,
                                          int tid) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int VPR = D / EPV;
  for (int i = tid; i < 64 * VPR; i += THREADS) {
    const int rr = i / VPR;
    const int cc = (i % VPR) * EPV;
    const int g = row0 + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < n) {
      val = *reinterpret_cast<const uint4*>(src + (long long)g * stride_n + cc);
    }
    *reinterpret_cast<uint4*>(dst + rr * Plan<T, D>::LD + cc) = val;
  }
}

// float32 products, one warp, lane pair (2r, 2r+1) on output row r of 16:
//   acc[j] += sum_k a[r * a_r + k * a_k] * b[k * b_k + (c0 + j) * b_c]
// with c0 = (lane % 2) * NC / 2, for the NC / 2 columns the lane owns.
template <int NC, int KD>
__device__ __forceinline__ void fma_rows(const float* a, int a_r, int a_k,
                                         const float* b, int b_k, int b_c,
                                         float (&acc)[NC / 2]) {
  const int lane = threadIdx.x & 31;
  const float* ar = a + (lane >> 1) * a_r;
  const float* bc = b + (lane & 1) * (NC / 2) * b_c;
  for (int k = 0; k < KD; ++k) {
    const float av = ar[k * a_k];
    const float* bk = bc + k * b_k;
#pragma unroll
    for (int j = 0; j < NC / 2; ++j) acc[j] = fmaf(av, bk[j * b_c], acc[j]);
  }
}

// out[16, 64] (f32, row stride LDS) = a[16, D] . b[64, D]^T, both row-major
// with row stride LD: the warp's S^T (a = its keys, b = the query tile) and
// dP^T (a = its values, b = the dO tile).
template <typename T, int D>
__device__ __forceinline__ void rows_by_tile_t(const T* a, const T* b,
                                               float* out) {
  using P = Plan<T, D>;
  if constexpr (std::is_same<T, float>::value) {
    float acc[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) acc[j] = 0.0f;
    fma_rows<BQ, D>(a, P::LD, 1, b, 1, P::LD, acc);
    const int lane = threadIdx.x & 31;
    float* o = out + (lane >> 1) * P::LDS + (lane & 1) * (BQ / 2);
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) o[j] = acc[j];
  } else {
    using namespace nvcuda;
#pragma unroll
    for (int nt = 0; nt < BQ / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, a + kk * 16, P::LD);
        wmma::load_matrix_sync(fb, b + nt * 16 * P::LD + kk * 16, P::LD);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(out + nt * 16, c, P::LDS, wmma::mem_row_major);
    }
  }
}

// The per-warp dK / dV accumulators [16, D] in f32.
template <typename T, int D, bool IS_F32 = std::is_same<T, float>::value>
struct KVAcc;

template <typename T, int D>
struct KVAcc<T, D, false> {  // bf16: WMMA accumulator fragments
  using P = Plan<T, D>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[D / 16];

  __device__ void zero() {
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) nvcuda::wmma::fill_fragment(f[dt], 0.0f);
  }
  // f += a[16, 64] . b[64, D]; a key-major (row stride LDP), b row-major (LD)
  __device__ void add(const T* a, const T* b) {
    using namespace nvcuda;
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a + kk * 16, P::LDP);
        wmma::load_matrix_sync(fb, b + kk * 16 * P::LD + dt * 16, P::LD);
        wmma::mma_sync(f[dt], fa, fb, f[dt]);
      }
    }
  }
  // write the 16 rows to dst (contiguous [B, N, H, D] row pointer per key)
  // through the warp's f32 staging rows
  __device__ void store(float* stage, T* dst_base, long long row_stride,
                        int row0, int n) {
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      nvcuda::wmma::store_matrix_sync(stage + dt * 16, f[dt], P::LDQ,
                                      nvcuda::wmma::mem_row_major);
    }
    __syncwarp();
    const int lane = threadIdx.x & 31;
    for (int i = lane; i < WROWS * D; i += 32) {
      const int r = i / D;
      const int c = i % D;
      if (row0 + r < n) {
        dst_base[(long long)(row0 + r) * row_stride + c] =
            to_t(stage[r * P::LDQ + c], T());
      }
    }
    __syncwarp();
  }
};

template <typename T, int D>
struct KVAcc<T, D, true> {  // float32: lane pair per row, D / 2 columns each
  using P = Plan<T, D>;
  float f[D / 2];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) f[j] = 0.0f;
  }
  __device__ void add(const float* a, const float* b) {
    fma_rows<D, BQ>(a, P::LDP, 1, b, P::LD, 1, f);
  }
  __device__ void store(float*, float* dst_base, long long row_stride,
                        int row0, int n) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 1;
    if (row0 + r < n) {
      float* o = dst_base + (long long)(row0 + r) * row_stride + (lane & 1) * (D / 2);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = f[j];
    }
  }
};

// out[16, D] (f32, row stride LDQ) = dS[16 queries, 64 keys] . K[64, D] for
// the warp's 16 query columns of dS^T (key-major, row stride LDP).
template <typename T, int D>
__device__ __forceinline__ void ds_by_k(const T* dst_cols, const T* k,
                                        float* out) {
  using P = Plan<T, D>;
  if constexpr (std::is_same<T, float>::value) {
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;
    fma_rows<D, BK>(dst_cols, 1, P::LDP, k, P::LD, 1, acc);
    const int lane = threadIdx.x & 31;
    float* o = out + (lane >> 1) * P::LDQ + (lane & 1) * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = acc[j];
  } else {
    using namespace nvcuda;
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, dst_cols + kk * 16 * P::LDP, P::LDP);
        wmma::load_matrix_sync(fb, k + kk * 16 * P::LD + dt * 16, P::LD);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(out + dt * 16, c, P::LDQ, wmma::mem_row_major);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dq_acc,
                     T* __restrict__ dk, T* __restrict__ dv, int n, int heads,
                     long long qsb, long long qsn, long long qsh,
                     long long ksb, long long ksn, long long ksh,
                     long long vsb, long long vsn, long long vsh,
                     float scale) {
  using P = Plan<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + P::o_k);
  T* vs = reinterpret_cast<T*>(smem + P::o_v);
  T* qs = reinterpret_cast<T*>(smem + P::o_q);
  T* dos = reinterpret_cast<T*>(smem + P::o_do);
  float* s_all = reinterpret_cast<float*>(smem + P::o_s);
  float* dp_all = reinterpret_cast<float*>(smem + P::o_dp);
  float* out_all = reinterpret_cast<float*>(smem + P::o_out);
  T* pt = reinterpret_cast<T*>(smem + P::o_pt);
  T* dst = reinterpret_cast<T*>(smem + P::o_ds);
  float* lse2_s = reinterpret_cast<float*>(smem + P::o_lse);
  float* di_s = reinterpret_cast<float*>(smem + P::o_di);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = scale * LOG2E;
  const long long row_stride = (long long)heads * D;  // contiguous outputs
  const long long head_off = ((long long)b * n * heads + h) * D;
  const float* lse_bh = lse + ((long long)b * heads + h) * n;
  const float* di_bh = di + ((long long)b * heads + h) * n;

  load_tile<T, D>(ks, k + b * ksb + h * ksh, ksn, k0, n, tid);
  load_tile<T, D>(vs, v + b * vsb + h * vsh, vsn, k0, n, tid);

  const int wk = warp * WROWS;  // the warp's first key row in the block
  float* sw = s_all + wk * P::LDS;
  float* dpw = dp_all + wk * P::LDS;
  T* ptw = pt + wk * P::LDP;
  T* dsw = dst + wk * P::LDP;
  float* outw = out_all + wk * P::LDQ;

  KVAcc<T, D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();

  // lane pair (2r, 2r+1) owns key row r of the warp's 16 in the elementwise
  // step, each lane half of the query columns
  const int r = lane >> 1;
  const int half = lane & 1;
  const bool key_ok = k0 + wk + r < n;

  const int n_tiles = (n + BQ - 1) / BQ;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, D>(qs, q + b * qsb + h * qsh, qsn, q0, n, tid);
    load_tile<T, D>(dos, dout + head_off, row_stride, q0, n, tid);
    if (tid < BQ) {
      const bool ok = q0 + tid < n;
      lse2_s[tid] = ok ? lse_bh[q0 + tid] * LOG2E : 0.0f;
      di_s[tid] = ok ? di_bh[q0 + tid] : 0.0f;
    }
    __syncthreads();

    rows_by_tile_t<T, D>(ks + wk * P::LD, qs, sw);   // S^T  [16 keys, 64 q]
    rows_by_tile_t<T, D>(vs + wk * P::LD, dos, dpw); // dP^T [16 keys, 64 q]
    __syncwarp();

#pragma unroll 8
    for (int j = 0; j < BQ / 2; ++j) {
      const int c = half * (BQ / 2) + j;
      // masked pairs get -inf BEFORE the exp: exp of a garbage logit could
      // be inf, and inf * 0 is NaN
      const float x = (key_ok && q0 + c < n)
                          ? sw[r * P::LDS + c] * scale_log2 - lse2_s[c]
                          : -INFINITY;
      const float p = exp2f(x);
      const float ds = p * (dpw[r * P::LDS + c] - di_s[c]) * scale;
      ptw[r * P::LDP + c] = to_t(p, T());
      dsw[r * P::LDP + c] = to_t(ds, T());
    }
    __syncwarp();

    dv_acc.add(ptw, dos);  // dV += P^T dO
    dk_acc.add(dsw, qs);   // dK += dS^T Q
    __syncthreads();       // dS^T complete; every warp is done with S^T, dP^T

    // dQ rows [q0 + wk, q0 + wk + 16) += dS K over the block's 64 keys
    ds_by_k<T, D>(dst + wk, ks, outw);
    __syncwarp();
    for (int i = lane; i < WROWS * D; i += 32) {
      const int rr = i / D;
      const int cc = i % D;
      const int row = q0 + wk + rr;
      if (row < n) {
        atomicAdd(dq_acc + head_off + (long long)row * row_stride + cc,
                  outw[rr * P::LDQ + cc]);
      }
    }
  }

  __syncthreads();  // the staging rows alias every warp's scores
  dk_acc.store(outw, dk + head_off, row_stride, k0 + wk, n);
  dv_acc.store(outw, dv + head_off, row_stride, k0 + wk, n);
}

// di[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in f32; one warp per
// (b, t, h) row of the contiguous [B, N, H, D] tensors.
template <typename T>
__global__ void flash_bwd_di_kernel(const T* __restrict__ o,
                                    const T* __restrict__ dout,
                                    float* __restrict__ di, long long rows,
                                    int n, int heads, int head_dim) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const T* orow = o + row * head_dim;
  const T* drow = dout + row * head_dim;
  float acc = 0.0f;
  for (int d = lane; d < head_dim; d += 32) {
    acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const int h = (int)(row % heads);
    const long long bt = row / heads;
    const int t = (int)(bt % n);
    const long long b = bt / n;
    di[(b * heads + h) * n + t] = acc;
  }
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst,
                                   long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    dst[i] = __float2bfloat16(src[i]);
  }
}

int grid_for(long long work, int threads) {
  const long long want = (work + threads - 1) / threads;
  return (int)(want < (1LL << 30) ? want : (1LL << 30));
}

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *dq_acc, *di;
  int batch, n, heads;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Args& a) {
  using P = Plan<T, D>;
  const long long rows = (long long)a.batch * a.n * a.heads;
  cudaError_t e =
      cudaMemsetAsync(a.dq_acc, 0, sizeof(float) * rows * D, a.stream);
  if (e != cudaSuccess) return e;
  flash_bwd_di_kernel<T><<<grid_for(rows * 32, 256), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.di), rows, a.n, a.heads, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto kern = flash_bwd_kernel<T, D>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)P::total);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + BK - 1) / BK, a.heads, a.batch);
  kern<<<grid, THREADS, P::total, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<float*>(a.dq_acc), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.n, a.heads, a.qsb, a.qsn, a.qsh, a.ksb, a.ksn,
      a.ksh, a.vsb, a.vsn, a.vsh, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  if (!std::is_same<T, float>::value) {
    f32_to_bf16_kernel<<<grid_for(rows * D, 256), 256, 0, a.stream>>>(
        static_cast<const float*>(a.dq_acc),
        static_cast<__nv_bfloat16*>(a.dq), rows * D);
    e = cudaGetLastError();
  }
  return e;
}

template <typename T>
cudaError_t dispatch(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 48: return launch<T, 48>(a);
    case 64: return launch<T, 64>(a);
    case 80: return launch<T, 80>(a);
    case 96: return launch<T, 96>(a);
    case 112: return launch<T, 112>(a);
    case 128: return launch<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v: [batch, n, heads, head_dim]
// with unit stride on head_dim and the given element strides for batch,
// token and head (16-byte aligned rows); o, dout: contiguous [batch, n,
// heads, head_dim]; lse: contiguous float32 [batch, heads, n], natural-log
// row log-sum-exp of the scaled logits (clipself_flash_fwd writes it).
// Outputs dq, dk, dv: contiguous [batch, n, heads, head_dim] in dtype.
// Scratch: dq_acc, float32 [batch, n, heads, head_dim] (dq itself for
// float32), and di, float32 [batch, heads, n]. Returns the first failing
// launch's cudaError_t.
extern "C" int clipself_flash_bwd(int dtype, const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* lse, const void* dout, void* dq,
                                  void* dk, void* dv, void* dq_acc, void* di,
                                  int batch, int n, int heads, int head_dim,
                                  long long qsb, long long qsn, long long qsh,
                                  long long ksb, long long ksn, long long ksh,
                                  long long vsb, long long vsn, long long vsh,
                                  float scale, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return (int)cudaSuccess;
  const Args a{q,   k,   v,   o,   lse, dout, dq,  dk,   dv,  dq_acc, di,
               batch, n, heads, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh,
               scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch<float>(head_dim, a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}
