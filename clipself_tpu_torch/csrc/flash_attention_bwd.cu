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
// instead of eight. dQ accumulates in a zeroed f32 buffer through f32
// additions in the L2, and a last pass rounds it to bf16 (a float32 dq is
// its own accumulator). The order of the f32 additions into dQ changes from
// run to run, so dQ is not bitwise repeatable; the checks use tolerances.
//
// Three designs, picked by dtype and head_dim alone
// (clipself_flash_bwd_design); all read K, V, Q and dO through the
// [B, N, H, D] strides the forward takes, write dK and dV as contiguous
// [B, N, H, D], mask the ragged tail (-inf before the exp) and run the small
// di = rowsum(dO * O) pass first instead of recomputing it for every key block:
//
//  * bfloat16 at head_dim 64, every backward of the EVA02 towers: the
//    warpgroup design in namespace `wg` below (its own note says how). All
//    five products run as wgmma (csrc/hopper_mma.cuh), S^T, dP^T,
//    P^T and dS^T live in registers, Q/dO tiles arrive through a four-stage
//    cp.async ring, and the f32 dQ accumulator is fed by bulk reductions.
//  * bfloat16 at the other head dims: one block of 4 warps owns 64 keys and
//    keeps their dK and dV in WMMA accumulator fragments; it loops over
//    64-row query tiles staged with plain loads, every product's result
//    passes through shared memory in f32, and dQ leaves by scalar atomicAdd.
//  * float32 (the parity path): the same blocking with f32 FMAs, so that it
//    keeps full f32 precision (tensor cores would round the inputs to TF32);
//    dq is its own accumulator.
//
// Bound on the H100: at N = 4097, D = 64 a (key, query) pair costs 10 * D
// flops against Q/dO tiles that every key block reads again from the L2, so
// the kernel is bound by operations. What holds the warpgroup design below
// the tensor cores' rate is the elementwise work between the products (a
// warpgroup's exponentials, dS and bf16 packing take about as long as its 20
// wgmma operations a tile, at two warps a scheduler), shared-memory
// bandwidth (m64n64k16 with both operands in shared memory reads 4 KB for 32
// tensor-core cycles) and the 254 registers a thread that leave one block of
// 8 warps an SM. The dQ additions, 33 partial sums an element at N = 4097,
// cost nothing visible once the copy engine does them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "hopper_mma.cuh"

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

// ---- bf16, head_dim 64: the warpgroup design --------------------------------
//
// A block of two warpgroups owns 128 keys of one (batch, head), 64 a
// warpgroup, and keeps their dK and dV in wgmma accumulators for the whole
// kernel. 64-row Q and dO tiles with their lse and di come through a ring of
// STAGES shared-memory stages filled by cp.async, tile t + AHEAD in flight
// while tile t is computed, with one block barrier a tile. A warpgroup's work
// on a tile has two phases:
//
//   phase 1: S^T = K Q^T and dP^T = V dO^T in registers (one wgmma group),
//            P^T and dS^T formed there and rounded to bf16, dS^T also
//            written to shared memory;
//   phase 2: dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A
//            operands against the dO and Q tiles read MN-major, and the
//            warpgroup's 64-key partial of dQ = dS K, with the stored dS^T
//            as a transposed A operand (one wgmma group).
//
// The tensor cores idle while a warpgroup does phase 1's elementwise work, so
// the two warpgroups run half a tile apart: between two block barriers
// warpgroup 0 runs phase 1 then phase 2 of tile t, warpgroup 1 phase 2 of
// tile t - 1 then phase 1 of tile t, and one's products overlap the other's
// exponentials. The same lag halves the dQ additions: warpgroup 0 leaves its
// partial dQ tile in shared memory, and warpgroup 1, a barrier later, adds
// its own partial of that tile on top and sends the 128-key sum to the f32
// accumulator with one bulk reduction (cp.reduce.async.bulk: the copy engine
// and the L2 do the 16 KB of additions, no thread waits for them). The
// accumulator therefore holds dQ tile by tile in the fragment's own order,
// and the last pass rounds it to bf16 rows.

namespace wg {

using namespace hopper;

constexpr int STAGES = 4;  // tiles t - 1 (warpgroup 1), t, t + 1, t + 2
constexpr int AHEAD = 2;   // tiles in flight beyond the current one
constexpr int THREADS = 256;
constexpr int KEYS = 128;                           // keys a block
constexpr int QDO_STAGE_BYTES = 2 * TILE64_BYTES;   // one Q and one dO tile
constexpr int ROWVEC_BYTES = 2 * 64 * 4;            // lse and di of a tile
constexpr int DQ_TILE_BYTES = 64 * 64 * 4;          // a partial dQ tile, f32
constexpr int O_K = 0;
constexpr int O_V = O_K + KEYS * ROW_BYTES;
constexpr int O_RING = O_V + KEYS * ROW_BYTES;
constexpr int O_DS = O_RING + STAGES * QDO_STAGE_BYTES;  // [warpgroup][2] tiles
constexpr int O_DQ = O_DS + 4 * TILE64_BYTES;            // [2] partial dQ tiles
constexpr int O_VEC = O_DQ + 2 * DQ_TILE_BYTES;
constexpr int SMEM_BYTES = ATOM_BYTES + O_VEC + STAGES * ROWVEC_BYTES;
static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared-memory plan too large");

__device__ __forceinline__ void block_barrier() {
  // by number, not by place in the code: the two warpgroups meet it from
  // different loops
  asm volatile("bar.sync 0, 256;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_barrier(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
}

__global__ void __launch_bounds__(THREADS)
    flash_bwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           float* __restrict__ dq_acc,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int n, int heads,
                           long long qsb, long long qsn, long long qsh,
                           long long ksb, long long ksn, long long ksh,
                           long long vsb, long long vsn, long long vsh,
                           float scale) {
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;
  const int t128 = tid & 127;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * KEYS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = scale * LOG2E;
  const long long row_stride = (long long)heads * 64;  // contiguous tensors
  const long long head_off = ((long long)b * n * heads + h) * 64;
  const __nv_bfloat16* qg = q + b * qsb + h * qsh;
  const __nv_bfloat16* dog = dout + head_off;
  const float* lse_bh = lse + ((long long)b * heads + h) * n;
  const float* di_bh = di + ((long long)b * heads + h) * n;

  const uint32_t base = align_1024(smem_u32(smem));
  const uint32_t ring_s = base + O_RING;
  const uint32_t vec_s = base + O_VEC;
  const unsigned char* smem_base = smem + (base - smem_u32(smem));
  const int n_tiles = (n + 63) / 64;

  // Tile `tile` of Q, dO, lse and di into stage `st`. Warpgroup 0 starts
  // the ring's copies alone: warpgroup 1 has the longer tile (it sums and
  // sends the dQ tiles).
  auto load_stage = [&](int tile, int st) {
    if (wgi == 0) {
      const int row0 = tile * 64;
      load_tile_async<64, 128>(ring_s + st * QDO_STAGE_BYTES, qg, qsn, row0, n, tid);
      load_tile_async<64, 128>(ring_s + st * QDO_STAGE_BYTES + TILE64_BYTES, dog,
                               row_stride, row0, n, tid);
      const int r = row0 + (tid & 63);
      const bool ok = r < n;
      const float* src = tid < 64 ? lse_bh : di_bh;
      cp_async_4(vec_s + st * ROWVEC_BYTES + tid * 4, ok ? src + r : src, ok);
    }
  };
  // The block barrier of the ring; it also frees the dQ tile that a bulk
  // reduction started before it may still be reading.
  auto ring_barrier = [&]() {
    if (t128 == 0) bulk_wait_read();
    block_barrier();
  };
  // Tile t has landed for every thread, and every warp is done with what the
  // barrier before it allowed; then tile t + AHEAD starts into the stage that
  // tile t - 2 left (warpgroup 1 was done with it before this barrier).
  auto ring_step = [&](int t) {
    cp_async_wait<AHEAD - 1>();
    fence_async_proxy();
    ring_barrier();
    const int tn = t + AHEAD;
    if (tn < n_tiles) load_stage(tn, tn % STAGES);
    cp_async_commit();
  };

  load_tile_async<KEYS, THREADS>(base + O_K, k + b * ksb + h * ksh, ksn, k0, n, tid);
  load_tile_async<KEYS, THREADS>(base + O_V, v + b * vsb + h * vsh, vsn, k0, n, tid);
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_tiles) load_stage(s, s);
    cp_async_commit();
  }

  const int key_base = k0 + wgi * 64;  // the warpgroup's first key
  const bool pair = k0 + 64 < n;       // warpgroup 1 holds keys too
  const uint32_t k_s = base + O_K + wgi * TILE64_BYTES;
  const uint32_t v_s = base + O_V + wgi * TILE64_BYTES;
  const uint64_t k_desc = tile_desc(k_s);
  const uint64_t v_desc = tile_desc(v_s);
  const uint32_t ds_s = base + O_DS + wgi * 2 * TILE64_BYTES;
  // this thread's key rows of the warpgroup's 64: r0 and r0 + 8
  const int r0 = frag_row(t128, 0);
  const bool key_ok0 = key_base + r0 < n;
  const bool key_ok1 = key_base + r0 + 8 < n;

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }

  // Phase 1 of tile t: P^T and dS^T of [64 keys, 64 queries] as bf16 pairs
  // in the A-fragment order, dS^T also in shared memory.
  auto phase1 = [&](int t, uint32_t (&pt)[16], uint32_t (&dst)[16]) {
    const int st = t % STAGES;
    const int q0 = t * 64;
    const uint64_t q_desc = tile_desc(ring_s + st * QDO_STAGE_BYTES);
    const uint64_t do_desc = tile_desc(ring_s + st * QDO_STAGE_BYTES + TILE64_BYTES);
    const float* lse_s =
        reinterpret_cast<const float*>(smem_base + O_VEC + st * ROWVEC_BYTES);
    const float* di_s = lse_s + 64;

    float st_acc[32], dp_acc[32];  // S^T and dP^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_ss<0, 0>(st_acc, k_desc + kk * K_SLICE_K_MAJOR,
                               q_desc + kk * K_SLICE_K_MAJOR, kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_ss<0, 0>(dp_acc, v_desc + kk * K_SLICE_K_MAJOR,
                               do_desc + kk * K_SLICE_K_MAJOR, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st_acc);
    fence_regs(dp_acc);

    // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)) and
    // dS^T = P^T * (dP^T - di) * scale
    const bool ragged = q0 + 64 > n || key_base + 64 > n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);  // query column of the tile
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dd = *reinterpret_cast<const float2*>(di_s + c);
      const float nl0 = -ls.x * LOG2E;
      const float nl1 = -ls.y * LOG2E;
      float x00 = fmaf(st_acc[4 * j], scale_log2, nl0);      // key r0
      float x01 = fmaf(st_acc[4 * j + 1], scale_log2, nl1);
      float x10 = fmaf(st_acc[4 * j + 2], scale_log2, nl0);  // key r0 + 8
      float x11 = fmaf(st_acc[4 * j + 3], scale_log2, nl1);
      if (ragged) {
        // masked pairs get -inf BEFORE the exp: exp of a logit without its
        // row's lse could be inf, and inf * 0 is NaN
        const bool q_ok0 = q0 + c < n;
        const bool q_ok1 = q0 + c + 1 < n;
        if (!(key_ok0 && q_ok0)) x00 = -INFINITY;
        if (!(key_ok0 && q_ok1)) x01 = -INFINITY;
        if (!(key_ok1 && q_ok0)) x10 = -INFINITY;
        if (!(key_ok1 && q_ok1)) x11 = -INFINITY;
      }
      const float p00 = exp2_approx(x00), p01 = exp2_approx(x01);
      const float p10 = exp2_approx(x10), p11 = exp2_approx(x11);
      pt[2 * j] = pack_bf16(p00, p01);
      pt[2 * j + 1] = pack_bf16(p10, p11);
      dst[2 * j] = pack_bf16(p00 * (dp_acc[4 * j] - dd.x) * scale,
                             p01 * (dp_acc[4 * j + 1] - dd.y) * scale);
      dst[2 * j + 1] = pack_bf16(p10 * (dp_acc[4 * j + 2] - dd.x) * scale,
                                 p11 * (dp_acc[4 * j + 3] - dd.y) * scale);
    }

    // Two dS^T buffers in turn: a warp may write tile t + 1's while another
    // warp's share of tile t's dQ product still reads.
    const uint32_t ds_buf = ds_s + (t & 1) * TILE64_BYTES;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      st_shared_u32(ds_buf + swizzle_offset(r0, j) + 4 * (lane & 3), dst[2 * j]);
      st_shared_u32(ds_buf + swizzle_offset(r0 + 8, j) + 4 * (lane & 3), dst[2 * j + 1]);
    }
    fence_async_proxy();
  };

  // Phase 2 of tile t: dV and dK grow, dq is the warpgroup's partial tile.
  auto phase2 = [&](int t, uint32_t (&pt)[16], uint32_t (&dst)[16], float (&dq)[32]) {
    const int st = t % STAGES;
    const uint64_t q_desc = tile_desc(ring_s + st * QDO_STAGE_BYTES);
    const uint64_t do_desc = tile_desc(ring_s + st * QDO_STAGE_BYTES + TILE64_BYTES);
    const uint64_t ds_desc = tile_desc(ds_s + (t & 1) * TILE64_BYTES);
    warpgroup_barrier(wgi);  // every warp's rows of dS^T are in shared memory
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pt);
    fence_regs(dst);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dV += P^T dO
      wgmma_m64n64k16_rs<1>(dv_acc, pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2],
                            pt[4 * kk + 3], do_desc + kk * K_SLICE_MN_MAJOR, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dK += dS^T Q
      wgmma_m64n64k16_rs<1>(dk_acc, dst[4 * kk], dst[4 * kk + 1], dst[4 * kk + 2],
                            dst[4 * kk + 3], q_desc + kk * K_SLICE_MN_MAJOR, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dQ = dS K
      wgmma_m64n64k16_ss<1, 1>(dq, ds_desc + kk * K_SLICE_MN_MAJOR,
                               k_desc + kk * K_SLICE_MN_MAJOR, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(dq);
    fence_regs(pt);
    fence_regs(dst);
  };

  // A dQ tile in shared memory and in the f32 accumulator: [8][128] slots of
  // four floats, slot [i][t128] holding registers 4 i .. 4 i + 3 of thread
  // t128, so the same thread of both warpgroups meets the same entries and
  // one bulk reduction adds the whole 16 KB tile.
  auto dq_slot = [&](int t, int i) {
    return base + O_DQ + (t & 1) * DQ_TILE_BYTES + (i * 128 + t128) * 16;
  };
  float* dq_tiles = dq_acc + ((long long)b * heads + h) * n_tiles * (64 * 64);
  auto send_dq = [&](int t) {
    fence_async_proxy();
    warpgroup_barrier(wgi);
    if (t128 == 0) {
      bulk_reduce_add_f32(dq_tiles + (long long)t * (64 * 64),
                          base + O_DQ + (t & 1) * DQ_TILE_BYTES, DQ_TILE_BYTES);
      bulk_commit();
    }
  };

  if (wgi == 0) {
    for (int t = 0; t < n_tiles; ++t) {
      ring_step(t);
      uint32_t pt[16], dst[16];
      float dq[32];
      phase1(t, pt, dst);
      phase2(t, pt, dst, dq);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        st_shared_f32x4(dq_slot(t, i), dq[4 * i], dq[4 * i + 1], dq[4 * i + 2],
                        dq[4 * i + 3]);
      }
      // with keys in warpgroup 1, that one adds its partial a barrier later
      if (!pair) send_dq(t);
    }
    ring_barrier();
  } else {
    uint32_t pt[16], dst[16];
    float dq[32];
    // tile t's dQ: this warpgroup's partial on top of warpgroup 0's
    auto finish = [&](int t) {
      phase2(t, pt, dst, dq);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 o = ld_shared_f32x4(dq_slot(t, i));
        st_shared_f32x4(dq_slot(t, i), dq[4 * i] + o.x, dq[4 * i + 1] + o.y,
                        dq[4 * i + 2] + o.z, dq[4 * i + 3] + o.w);
      }
      send_dq(t);
    };
    for (int t = 0; t < n_tiles; ++t) {
      ring_step(t);
      if (pair) {
        if (t > 0) finish(t - 1);
        phase1(t, pt, dst);
      }
    }
    ring_barrier();
    if (pair) finish(n_tiles - 1);
  }
  if (t128 == 0) bulk_wait_read();
  cp_async_wait<0>();
  warpgroup_barrier(wgi);  // every product that reads this warpgroup's K and V is done

  if (key_base < n) {  // each warp stages its 16 keys in its own rows of K, then V
    store_acc_rows(dk_acc, k_s, dk + head_off + (long long)key_base * row_stride,
                   row_stride, n - key_base);
    store_acc_rows(dv_acc, v_s, dv + head_off + (long long)key_base * row_stride,
                   row_stride, n - key_base);
  }
}

}  // namespace wg

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

// Which design a call takes: fixed by dtype and head_dim.
enum Design { DESIGN_FMA = 0, DESIGN_WMMA = 1, DESIGN_WGMMA = 2 };

constexpr Design design_rule(bool is_f32, int head_dim) {
  return is_f32 ? DESIGN_FMA : head_dim == 64 ? DESIGN_WGMMA : DESIGN_WMMA;
}

template <typename T, int D>
constexpr Design design_of() {
  return design_rule(std::is_same<T, float>::value, D);
}

// The wgmma design's dQ accumulator, [B, H, tiles, 8, 128] slots of four
// floats (slot [i][t] = accumulator registers 4 i .. 4 i + 3 of warpgroup
// thread t of a [64, 64] tile), to bf16 rows of dq [B, N, H, 64].
__global__ void dq_tiles_to_bf16_kernel(const float4* __restrict__ tiles,
                                        __nv_bfloat16* __restrict__ dq,
                                        long long slots, int n, int heads,
                                        int n_tiles) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < slots;
       s += stride) {
    const int t128 = (int)(s & 127);
    const int i = (int)((s >> 7) & 7);
    const long long tile = s >> 10;
    const int t = (int)(tile % n_tiles);
    const long long bh = tile / n_tiles;
    const int h = (int)(bh % heads);
    const long long b = bh / heads;
    const int row = t * 64 + hopper::frag_row(t128, 0);
    const int col = hopper::frag_col(t128, 4 * i);
    const float4 v = tiles[s];
    __nv_bfloat16* out = dq + ((b * n + row) * heads + h) * 64 + col;
    if (row < n) {
      *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v.x, v.y);
    }
    if (row + 8 < n) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8LL * heads * 64) =
          __floats2bfloat162_rn(v.z, v.w);
    }
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

// Floats of the dQ accumulator: [B, N, H, D] for the WMMA design, whole
// [64, 64] tiles for the wgmma design, none for float32 (dq accumulates in
// place).
long long scratch_floats(Design design, long long batch, long long n,
                         long long heads, long long head_dim) {
  if (design == DESIGN_FMA) return 0;
  if (design == DESIGN_WGMMA) return batch * heads * ((n + 63) / 64) * 64 * 64;
  return batch * n * heads * head_dim;
}

template <typename T, int D>
cudaError_t launch(const Args& a) {
  constexpr Design design = design_of<T, D>();
  const long long rows = (long long)a.batch * a.n * a.heads;
  const long long acc_floats = design == DESIGN_FMA
                                   ? rows * D
                                   : scratch_floats(design, a.batch, a.n, a.heads, D);
  cudaError_t e = cudaMemsetAsync(a.dq_acc, 0, sizeof(float) * acc_floats, a.stream);
  if (e != cudaSuccess) return e;
  flash_bwd_di_kernel<T><<<grid_for(rows * 32, 256), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.di), rows, a.n, a.heads, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  if constexpr (design == DESIGN_WGMMA) {
    auto kern = wg::flash_bwd_wgmma_kernel;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.n + wg::KEYS - 1) / wg::KEYS, a.heads, a.batch);
    kern<<<grid, wg::THREADS, wg::SMEM_BYTES, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
        static_cast<float*>(a.dq_acc), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.n, a.heads, a.qsb, a.qsn, a.qsh, a.ksb,
        a.ksn, a.ksh, a.vsb, a.vsn, a.vsh, a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dq_tiles_to_bf16_kernel<<<grid_for(acc_floats / 4, 256), 256, 0, a.stream>>>(
        static_cast<const float4*>(a.dq_acc), static_cast<__nv_bfloat16*>(a.dq),
        acc_floats / 4, a.n, a.heads, (a.n + 63) / 64);
    return cudaGetLastError();
  } else {
    using P = Plan<T, D>;
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
        static_cast<T*>(a.dv), a.n, a.heads, a.qsb, a.qsn, a.qsh, a.ksb,
        a.ksn, a.ksh, a.vsb, a.vsn, a.vsh, a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (design == DESIGN_WMMA) {
      f32_to_bf16_kernel<<<grid_for(rows * D, 256), 256, 0, a.stream>>>(
          static_cast<const float*>(a.dq_acc),
          static_cast<__nv_bfloat16*>(a.dq), rows * D);
      e = cudaGetLastError();
    }
    return e;
  }
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

// The design that clipself_flash_bwd runs for this dtype and head_dim:
// 0 = f32 FMA, 1 = WMMA tiles, 2 = wgmma (bf16 at head_dim 64); -1 if the
// pair is not taken.
extern "C" int clipself_flash_bwd_design(int dtype, int head_dim) {
  if (head_dim % 16 || head_dim < 16 || head_dim > 128) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  return design_rule(dtype == 0, head_dim);
}

// Floats of the dq_acc scratch that clipself_flash_bwd needs for this call;
// 0 where dq is its own accumulator (float32), -1 for a pair not taken.
extern "C" long long clipself_flash_bwd_scratch_floats(int dtype, int batch, int n,
                                                       int heads, int head_dim) {
  const int design = clipself_flash_bwd_design(dtype, head_dim);
  if (design < 0) return -1;
  return scratch_floats(static_cast<Design>(design), batch, n, heads, head_dim);
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v: [batch, n, heads, head_dim]
// with unit stride on head_dim and the given element strides for batch,
// token and head (16-byte aligned rows); o, dout: contiguous [batch, n,
// heads, head_dim]; lse: contiguous float32 [batch, heads, n], natural-log
// row log-sum-exp of the scaled logits (clipself_flash_fwd writes it).
// Outputs dq, dk, dv: contiguous [batch, n, heads, head_dim] in dtype.
// Scratch: dq_acc, float32 of clipself_flash_bwd_scratch_floats elements (dq
// itself for float32), and di, float32 [batch, heads, n]. Returns the first failing
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
