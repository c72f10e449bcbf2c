// Flash-attention forward: softmax(Q K^T * scale) V per (batch, head).
//
// Replaces the TPU kernel that clipself_tpu/ops/attention.py:_bundled_fwd
// reaches (JAX's bundled Pallas `_flash_attention_impl`), which the JAX towers
// feed [B, H, N, D] copies padded to a block multiple (4097 -> 4224) with a
// segment row masking the pad tail.
//
// Here one block of 4 warps owns 64 query rows of one (batch, head); each
// warp owns 16 of them. The block loops over 64-key K/V tiles staged in
// shared memory, keeping the running row max and row sum in f32 registers
// (online softmax) and the 16 x D output accumulator split across each
// warp's lane pairs. The ragged tail is masked inside the kernel: keys at or
// past N get -inf before exp, query rows past N are never stored, so there
// is neither padding nor a segment tensor. Q, K and V are read through their
// strides from the [B, N, H * D] projection layout, so the head transposes
// of attention.py:494-496 disappear; the output is written as a contiguous
// [B, N, H, D].
//
// Training also asks for the row log-sum-exp, lse [B, H, N] f32, the
// residual of the one-pass backward (csrc/flash_attention_bwd.cu) in place
// of the Pallas kernel's (l, m) pair. It is a NATURAL-log value: the running
// max m is kept in the log2 domain (the scale carries log2(e), exp is exp2),
// so the kernel stores lse = (m + log2(l)) * ln(2). A null lse pointer (the
// no-grad teacher and evaluator) skips the write.
//
// Bound on the H100: at N = 4097, D = 64 the block does 4 * 64 * D flops per
// key against 2 * D * sizeof(T) bytes of K/V, so it is bound by math issue
// and by shared-memory traffic, not by device memory. bf16 runs both
// products (QK^T and PV) on the tensor cores through WMMA 16x16x16 tiles
// with f32 accumulation; float32 runs them as f32 FMAs so that it keeps full
// f32 precision (WMMA on f32 inputs would round them to TF32). This first
// version stages tiles with plain vector loads and no double buffering;
// wgmma, TMA and a pipelined K/V ring are the known next steps.
//
// The shared-memory tile loader and the Pad/Plan conventions are repeated in
// flash_attention_bwd.cu: each .cu file is compiled on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per K/V tile
constexpr int WARPS = 4;
constexpr int WROWS = BQ / WARPS;  // query rows per warp
constexpr int THREADS = WARPS * 32;

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
  static constexpr int LD = D + Pad<T>::v;             // Q, K, V rows
  static constexpr int LDS = (D > BK ? D : BK) + 4;    // f32 scores / PV rows
  static constexpr int LDP = BK + Pad<T>::v;           // probability rows
  static constexpr size_t q_bytes = sizeof(T) * BQ * LD;
  static constexpr size_t kv_bytes = sizeof(T) * BK * LD;
  static constexpr size_t s_bytes = sizeof(float) * WARPS * WROWS * LDS;
  static constexpr size_t p_bytes = sizeof(T) * WARPS * WROWS * LDP;
  static constexpr size_t total = q_bytes + 2 * kv_bytes + s_bytes + p_bytes;
};

__device__ __forceinline__ float to_out(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16) {
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

// The two products of one tile for one warp:
//   qk: s[16, 64] = q[16, D] . k[64, D]^T      (raw dot products, f32)
//   pv: o[16, D]  = p[16, 64] . v[64, D]        (f32)
template <typename T, int D>
struct Products;

template <int D>
struct Products<__nv_bfloat16, D> {
  using P = Plan<__nv_bfloat16, D>;
  using bf16 = __nv_bfloat16;

  __device__ static void qk(const bf16* q, const bf16* k, float* s) {
    using namespace nvcuda;
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, q + kk * 16, P::LD);
        wmma::load_matrix_sync(b, k + nt * 16 * P::LD + kk * 16, P::LD);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(s + nt * 16, c, P::LDS, wmma::mem_row_major);
    }
  }

  __device__ static void pv(const bf16* p, const bf16* v, float* o) {
    using namespace nvcuda;
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, p + kk * 16, P::LDP);
        wmma::load_matrix_sync(b, v + kk * 16 * P::LD + dt * 16, P::LD);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(o + dt * 16, c, P::LDS, wmma::mem_row_major);
    }
  }
};

template <int D>
struct Products<float, D> {
  using P = Plan<float, D>;

  // each lane computes the entries its softmax step owns: row lane / 2,
  // columns (lane % 2) * 32 .. + 32
  __device__ static void qk(const float* q, const float* k, float* s) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 1;
    const int c0 = (lane & 1) * (BK / 2);
    const float* qr = q + r * P::LD;
    for (int j = 0; j < BK / 2; ++j) {
      const float* kr = k + (c0 + j) * P::LD;
      float acc = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      s[r * P::LDS + c0 + j] = acc;
    }
  }

  // row lane / 2, output columns (lane % 2) * D / 2 .. + D / 2
  __device__ static void pv(const float* p, const float* v, float* o) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 1;
    const int c0 = (lane & 1) * (D / 2);
    for (int j = 0; j < D / 2; ++j) {
      float acc = 0.0f;
#pragma unroll 16
      for (int kk = 0; kk < BK; ++kk) {
        acc = fmaf(p[r * P::LDP + kk], v[kk * P::LD + c0 + j], acc);
      }
      o[r * P::LDS + c0 + j] = acc;
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n,
                     int heads, long long qsb, long long qsn, long long qsh,
                     long long ksb, long long ksn, long long ksh,
                     long long vsb, long long vsn, long long vsh,
                     float scale_log2) {
  using P = Plan<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + P::q_bytes);
  T* vs = reinterpret_cast<T*>(smem + P::q_bytes + P::kv_bytes);
  float* s_all = reinterpret_cast<float*>(smem + P::q_bytes + 2 * P::kv_bytes);
  T* p_all = reinterpret_cast<T*>(smem + P::q_bytes + 2 * P::kv_bytes +
                                  P::s_bytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qg = q + b * qsb + h * qsh;
  const T* kg = k + b * ksb + h * ksh;
  const T* vg = v + b * vsb + h * vsh;

  load_tile<T, D>(qs, qg, qsn, q0, n, tid);

  const T* qw = qs + warp * WROWS * P::LD;
  float* sw = s_all + warp * WROWS * P::LDS;  // scores, then PV of the tile
  T* pw = p_all + warp * WROWS * P::LDP;

  // lane pair (2r, 2r+1) owns row r of the warp's 16; each lane holds half
  // of the row's key columns and half of its output columns
  const int r = lane >> 1;
  const int half = lane & 1;
  float m = -INFINITY;  // running row max, log2 domain
  float l = 0.0f;       // running row sum
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;

  const int n_tiles = (n + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(ks, kg, ksn, k0, n, tid);
    load_tile<T, D>(vs, vg, vsn, k0, n, tid);
    __syncthreads();

    Products<T, D>::qk(qw, ks, sw);
    __syncwarp();

    float sv[BK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = half * (BK / 2) + j;
      const float x =
          (k0 + c < n) ? sw[r * P::LDS + c] * scale_log2 : -INFINITY;
      sv[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    // every tile holds at least one key below n, so m_new is finite and the
    // first tile's alpha is exp2(-inf) = 0
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float p = exp2f(sv[j] - m_new);
      psum += p;
      pw[r * P::LDP + half * (BK / 2) + j] = to_out(p, T());
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // P complete, and every lane has read its scores

    Products<T, D>::pv(pw, vs, sw);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      acc[j] = acc[j] * alpha + sw[r * P::LDS + half * (D / 2) + j];
    }
  }

  const int row = q0 + warp * WROWS + r;
  if (row < n) {
    const float inv = 1.0f / l;
    T* og = o + (((long long)b * n + row) * heads + h) * D + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) og[j] = to_out(acc[j] * inv, T());
    if (lse != nullptr && half == 0) {
      lse[((long long)b * heads + h) * n + row] =
          (m + log2f(l)) * 0.6931471805599453f;
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int batch, n, heads;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh;
  float scale_log2;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Args& a) {
  using P = Plan<T, D>;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::total);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + BQ - 1) / BQ, a.heads, a.batch);
  kern<<<grid, THREADS, P::total, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.n, a.heads, a.qsb,
      a.qsn, a.qsh, a.ksb, a.ksn, a.ksh, a.vsb, a.vsn, a.vsh, a.scale_log2);
  return cudaGetLastError();
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
// token and head (16-byte aligned rows); o: contiguous [batch, n, heads,
// head_dim]; lse: null, or contiguous float32 [batch, heads, n] for the
// natural-log row log-sum-exp of the scaled logits. Returns the launch's
// cudaError_t.
extern "C" int clipself_flash_fwd(int dtype, const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  int batch, int n,
                                  int heads, int head_dim, long long qsb,
                                  long long qsn, long long qsh, long long ksb,
                                  long long ksn, long long ksh, long long vsb,
                                  long long vsn, long long vsh, float scale,
                                  void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return (int)cudaSuccess;
  const Args a{q,   k,   v,   o,   static_cast<float*>(lse), batch, n,
               heads, qsb, qsn, qsh, ksb, ksn, ksh, vsb,   vsn, vsh,
               scale * 1.4426950408889634f,  // fold log2(e): exp -> exp2
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch<float>(head_dim, a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* clipself_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
