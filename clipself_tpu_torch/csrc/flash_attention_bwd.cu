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
// and carries dQ in a VMEM scratch between grid steps, so each element of dQ
// receives its key-block partials in ascending key order and the result
// repeats bit for bit from call to call. Hopper runs blocks in parallel and
// in no order, so a sum across blocks needs atomics, a second pass, or
// blocks that wait on each other. This file takes the second pass, and every
// sum it forms is in a fixed order:
//
//  * the dK / dV pass: a block owns a run of keys of one (batch, head),
//    keeps their dK and dV in registers or WMMA fragments and walks the
//    query tiles in order (S, dP, dV, dK: four products a tile pair);
//  * the dQ pass: a block owns a run of queries, keeps their dQ the same
//    way and walks the key tiles in ascending order, as the TPU kernel's kv
//    grid does (S and dP again, then dQ: three products a tile pair).
//
// So dQ, dK and dV are bitwise repeatable, and no block waits on another:
// nothing depends on the order in which the card dispatches blocks, no
// thread spins on a flag, and there is no f32 accumulator in device memory
// to zero and round afterwards. The price is S and dP computed twice: seven
// products a tile pair where one pass that adds dQ by atomics runs five.
// The alternative that keeps five, each key block adding its dQ tile only
// after the key block before it has added its own, chains the 33 key
// blocks of a query tile at N = 4097 one after another on every tile, and
// makes the result depend on the blocks being dispatched in index order.
// Each call runs three kernels: di = rowsum(dO * O), then the two passes,
// each reading di instead of recomputing it.
//
// Three designs, picked by dtype and head_dim alone
// (clipself_flash_bwd_design); all read K, V, Q and dO through the
// [B, N, H, D] strides the forward takes, write dQ, dK and dV as contiguous
// [B, N, H, D] and mask the ragged tail (-inf before the exp):
//
//  * bfloat16 at head_dim 64-128 (the EVA02 towers' 64; ViT-H-14's 80,
//    ViT-g-14's and EVA01-g-14's 88, ViT-bigG-14's 104, bigE-14's and
//    ViT-e-14's 112): the warpgroup kernels in namespace `wg` below (their
//    own note says how). Every product runs as wgmma (csrc/hopper_mma.cuh)
//    on tiles of one or two 64-column panels; the scores, P and dS live in
//    registers, and the streamed tiles arrive through cp.async rings.
//  * bfloat16 below head_dim 64 (the tiny test towers): a block of 4 warps
//    owns 64 keys (64 queries in the dQ pass), keeps its accumulators in
//    WMMA fragments and loops over the other side's 64-row tiles staged
//    with plain loads; every product's result passes through shared memory
//    in f32.
//  * float32 (the HF trunks and every parity path): "tf32x3", namespace
//    `x3` below: a block of 8 warps owns 128 keys (128 queries in the dQ
//    pass) and walks the other side's 32-row tiles through a cp.async ring,
//    with every product on the tensor cores at float32 accuracy: three TF32
//    products of a hi + lo split of each operand (csrc/hopper_mma.cuh), the
//    scores on wgmma against split tiles up to tile width 96 and on
//    mma.sync past it, the value products on mma.sync from registers, no
//    tile transposed; each tile's share of dQ, dK and dV is summed apart and
//    added in float32.
//
// Every design takes every head_dim d that is a multiple of 8 up to 128 by
// zero-fill, as the forward does: instantiated at the tile width DP = d
// rounded up to 16, the true d at run time. Columns d to DP - 1 of the K, V,
// Q and dO tiles load as zeros, which add nothing to S, dP, dS^T Q or dS K;
// the extra columns of dQ, dK and dV (zero too) are never stored (the
// float32 design skips the 8-wide slices past d altogether);
// di = rowsum(dO * O) runs over the true d.
//
// Bound on the H100: at N = 4097 a (key, query) pair costs 14 * d flops in
// the two passes against tiles that every block reads again from the L2,
// so the kernels are bound by operations (in float32, three TF32 products a
// float32 product at the TF32 peak). What holds the float32 kernels below
// it: the split of the operands in registers (three instructions a float),
// the value products on mma.sync and, in the dK / dV pass, the registers (dK and dV's DP floats a
// thread beside the tile's scores: 224-255 a thread from head_dim 48, so one
// block of 8 warps an SM, whose other warps are a warp's only latency
// cover). What holds the warpgroup kernels below the tensor cores' rate is
// the elementwise work
// between the products (the exponentials, dS and bf16 packing take about as
// long as a tile's wgmma operations at d = 64), shared-memory bandwidth
// (m64n64k16 with both operands in shared memory reads 4 KB for 32
// tensor-core cycles) and, in the dK / dV kernel, the registers: dK and dV's
// accumulators take d floats a thread, which leaves one block of 8 warps an
// SM (232-255 registers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int WROWS = 16;  // a warp's rows: keys in the dK / dV pass, queries in the dQ pass
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory of one H100 block
// bf16 head_dim 64-128: sequences up to this length take one warpgroup a
// block in the dQ pass (the forward's rule: short sequences give few blocks)
constexpr int WGMMA_ONE_WARPGROUP_MAX_N = 384;

template <typename T>
struct Pad;  // shared-memory row padding, in elements (keeps 16-byte rows)
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int v = 8;
};

// Shared-memory plan of both passes of the two older designs ("own" rows:
// the block's keys in the dK / dV pass, its queries in the dQ pass; "other"
// rows: the tile it streams). Every region and every 16-row/16-column tile
// inside it starts on a 32-byte boundary, as WMMA loads and stores require.
template <typename T, int D>
struct Plan {
  static constexpr int LD = D + Pad<T>::v;   // K, V, Q, dO rows
  static constexpr int LDP = BQ + Pad<T>::v; // P, dS rows (own-major, in T)
  static constexpr int LDS = BQ + 4;         // f32 S, dP rows (own-major)
  static constexpr int LDQ = D + 4;          // f32 rows of an accumulator
  static constexpr size_t tile = sizeof(T) * 64 * LD;
  static constexpr size_t scores = sizeof(float) * BK * LDS;
  static constexpr size_t probs = sizeof(T) * BK * LDP;
  static constexpr size_t o_k = 0;
  static constexpr size_t o_v = tile;
  static constexpr size_t o_q = 2 * tile;
  static constexpr size_t o_do = 3 * tile;
  static constexpr size_t o_s = 4 * tile;       // S (f32)
  static constexpr size_t o_dp = o_s + scores;  // dP (f32)
  // f32 rows of the accumulators at the end alias S / dP: they are written
  // only after every warp has finished reading its scores
  static constexpr size_t o_out = o_s;
  static constexpr size_t o_pt = o_dp + scores;  // P in T (dK / dV pass)
  static constexpr size_t o_ds = o_pt + probs;   // dS in T
  static constexpr size_t o_lse = o_ds + probs;  // lse * log2(e) of the query tile
  static constexpr size_t o_di = o_lse + sizeof(float) * BQ;
  static constexpr size_t total = o_di + sizeof(float) * BQ;
  static_assert(sizeof(float) * BQ * LDQ <= 2 * scores, "accumulator rows overflow");
  static_assert(total <= SMEM_LIMIT, "shared-memory plan too large");
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ __nv_bfloat16 to_t(float v, __nv_bfloat16) {
  return __float2bfloat16(v);
}

// Copy 64 rows [row0, row0 + 64) of one head into shared memory with
// 16-byte loads; rows at or past n and columns at or past the true head_dim
// d (a multiple of 8, so a vector is wholly in or out) are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride_n, int row0, int n,
                                          int d, int tid) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int VPR = D / EPV;
  for (int i = tid; i < 64 * VPR; i += THREADS) {
    const int rr = i / VPR;
    const int cc = (i % VPR) * EPV;
    const int g = row0 + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < n && cc < d) {
      val = *reinterpret_cast<const uint4*>(src + (long long)g * stride_n + cc);
    }
    *reinterpret_cast<uint4*>(dst + rr * Plan<T, D>::LD + cc) = val;
  }
}

// out[16, 64] (f32, row stride LDS) = a[16, D] . b[64, D]^T, both row-major
// with row stride LD: the warp's 16 own rows against the streamed tile
// (keys against queries give S^T and values against dO give dP^T in the
// dK / dV pass; queries against keys S and dO against values dP in the dQ
// pass).
template <typename T, int D>
__device__ __forceinline__ void rows_by_tile_t(const T* a, const T* b,
                                               float* out) {
  using P = Plan<T, D>;
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

// A warp's [16, D] accumulator in f32 WMMA fragments: dK and dV in the
// dK / dV pass, dQ in the dQ pass.
template <typename T, int D>
struct Acc {
  using P = Plan<T, D>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[D / 16];

  __device__ void zero() {
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) nvcuda::wmma::fill_fragment(f[dt], 0.0f);
  }
  // f += a[16, 64] . b[64, D]; a row-major with row stride LDP, b row-major
  // (LD); the 64 terms of each element in order of b's rows
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
  // write the 16 rows' first d columns to dst (contiguous [B, N, H, d] row
  // pointer per row) through the warp's f32 staging rows
  __device__ void store(float* stage, T* dst_base, long long row_stride,
                        int row0, int n, int d) {
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
      if (row0 + r < n && c < d) {
        dst_base[(long long)(row0 + r) * row_stride + c] =
            to_t(stage[r * P::LDQ + c], T());
      }
    }
    __syncwarp();
  }
};

// The dK / dV pass. D is the tile width, d <= D the true head_dim (the row
// length of dout and of the outputs).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, T* __restrict__ dk,
                          T* __restrict__ dv, int n, int d, int heads,
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
  const long long row_stride = (long long)heads * d;  // contiguous outputs
  const long long head_off = ((long long)b * n * heads + h) * d;
  const float* lse_bh = lse + ((long long)b * heads + h) * n;
  const float* di_bh = di + ((long long)b * heads + h) * n;

  load_tile<T, D>(ks, k + b * ksb + h * ksh, ksn, k0, n, d, tid);
  load_tile<T, D>(vs, v + b * vsb + h * vsh, vsn, k0, n, d, tid);

  const int wk = warp * WROWS;  // the warp's first key row in the block
  float* sw = s_all + wk * P::LDS;
  float* dpw = dp_all + wk * P::LDS;
  T* ptw = pt + wk * P::LDP;
  T* dsw = dst + wk * P::LDP;
  float* outw = out_all + wk * P::LDQ;

  Acc<T, D> dk_acc, dv_acc;
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
    load_tile<T, D>(qs, q + b * qsb + h * qsh, qsn, q0, n, d, tid);
    load_tile<T, D>(dos, dout + head_off, row_stride, q0, n, d, tid);
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
  }

  __syncthreads();  // the staging rows alias every warp's scores
  dk_acc.store(outw, dk + head_off, row_stride, k0 + wk, n, d);
  dv_acc.store(outw, dv + head_off, row_stride, k0 + wk, n, d);
}

// The dQ pass: a block owns 64 query rows, 16 a warp, and walks the key
// tiles in ascending order.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dq,
                        int n, int d, int heads,
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
  T* ds_all = reinterpret_cast<T*>(smem + P::o_ds);
  float* lse2_s = reinterpret_cast<float*>(smem + P::o_lse);
  float* di_s = reinterpret_cast<float*>(smem + P::o_di);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = scale * LOG2E;
  const long long row_stride = (long long)heads * d;  // contiguous dO and dQ
  const long long head_off = ((long long)b * n * heads + h) * d;
  const float* lse_bh = lse + ((long long)b * heads + h) * n;
  const float* di_bh = di + ((long long)b * heads + h) * n;

  load_tile<T, D>(qs, q + b * qsb + h * qsh, qsn, q0, n, d, tid);
  load_tile<T, D>(dos, dout + head_off, row_stride, q0, n, d, tid);
  if (tid < BQ) {
    const bool ok = q0 + tid < n;
    lse2_s[tid] = ok ? lse_bh[q0 + tid] * LOG2E : 0.0f;
    di_s[tid] = ok ? di_bh[q0 + tid] : 0.0f;
  }

  const int wq = warp * WROWS;  // the warp's first query row in the block
  float* sw = s_all + wq * P::LDS;
  float* dpw = dp_all + wq * P::LDS;
  T* dsw = ds_all + wq * P::LDP;
  float* outw = out_all + wq * P::LDQ;

  Acc<T, D> dq_acc;
  dq_acc.zero();

  // lane pair (2r, 2r+1) owns query row r of the warp's 16 in the
  // elementwise step, each lane half of the key columns
  const int r = lane >> 1;
  const int half = lane & 1;
  const bool query_ok = q0 + wq + r < n;

  const int n_tiles = (n + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {  // ascending key order
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_tile<T, D>(ks, k + b * ksb + h * ksh, ksn, k0, n, d, tid);
    load_tile<T, D>(vs, v + b * vsb + h * vsh, vsn, k0, n, d, tid);
    __syncthreads();

    rows_by_tile_t<T, D>(qs + wq * P::LD, ks, sw);   // S  [16 q, 64 keys]
    rows_by_tile_t<T, D>(dos + wq * P::LD, vs, dpw); // dP [16 q, 64 keys]
    __syncwarp();

    const float lse2 = lse2_s[wq + r];
    const float dd = di_s[wq + r];
#pragma unroll 8
    for (int j = 0; j < BK / 2; ++j) {
      const int c = half * (BK / 2) + j;
      const float x = (query_ok && k0 + c < n) ? sw[r * P::LDS + c] * scale_log2 - lse2
                                               : -INFINITY;
      const float p = exp2f(x);
      dsw[r * P::LDP + c] = to_t(p * (dpw[r * P::LDS + c] - dd) * scale, T());
    }
    __syncwarp();

    dq_acc.add(dsw, ks);  // dQ += dS K
  }

  __syncthreads();  // the staging rows alias every warp's scores
  dq_acc.store(outw, dq + head_off, row_stride, q0 + wq, n, d);
}

// ---- bf16, head_dim 64-128: the warpgroup design ---------------------------
//
// The tile width DP is the head_dim rounded up to 16: a tile of DP columns is
// one or two 64-column panels (csrc/hopper_mma.cuh), its columns at or past
// the true head_dim load as zeros (they add nothing to S, dP, dS^T Q or
// dS K), and the outputs' are not stored. A product that contracts over the
// head_dim runs DP / 16 k-slices; one whose N is the head_dim runs one
// product a k-slice at DP 64, two past it (N = 64, then N = DP - 64).
//
// The dK / dV pass. A block of two warpgroups owns 128 keys of one (batch,
// head), 64 a warpgroup, and keeps their dK and dV in wgmma accumulators for
// the whole kernel. 64-row Q and dO tiles with their lse and di come through
// a ring of STAGES shared-memory stages filled by cp.async, tile t + AHEAD
// in flight while tile t is computed, with one block barrier a tile. A
// warpgroup takes a tile in rounds of QW queries (the whole 64 up to DP 96;
// 32 past it, so that S^T, dP^T, P^T and dS^T of a round take half the
// registers beside dK and dV's DP floats a thread); a round has two phases:
//
//   phase 1: S^T = K Q^T and dP^T = V dO^T in registers (one wgmma group),
//            P^T and dS^T formed there and rounded to bf16;
//   phase 2: dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A
//            operands against the dO and Q rows read MN-major (one wgmma
//            group).
//
// The tensor cores idle while a warpgroup does phase 1's elementwise work, so
// the two warpgroups run half a round apart: between two block barriers
// warpgroup 0 runs phase 1 then phase 2 of each round of tile t, warpgroup 1
// phase 2 of the last round of tile t - 1, then the rounds of tile t with
// the last one's phase 2 left for after the next barrier, and one's products
// overlap the other's exponentials. Each dK and dV element sums its query
// k-slices in ascending order.
//
// The dQ pass has the forward's shape: a block of one or two warpgroups owns
// 64 query rows a warpgroup, with their Q and dO tiles resident, and walks
// the 64-key K and V tiles in ascending order through a three-stage cp.async
// ring, one block barrier a tile: S = Q K^T and dP = dO V^T in registers, dS
// formed there and packed to bf16 as the A operand of dQ += dS K, with the
// K tile read MN-major; dQ stays in the accumulator and leaves as bf16 rows.

namespace wg {

using namespace hopper;

constexpr int STAGES = 4;  // tiles t - 1 (warpgroup 1), t, t + 1, t + 2
constexpr int AHEAD = 2;   // tiles in flight beyond the current one
constexpr int THREADS = 256;
constexpr int KEYS = 128;                 // keys a block
constexpr int ROWVEC_BYTES = 2 * 64 * 4;  // lse and di of a tile

// queries a round of the dK / dV pass: 64 up to DP 96 (252-255 registers,
// no spills; on an H100 SXM 32 there took 1.14-1.20x the time), 32 past it
// (64 would not fit beside dK and dV's DP floats a thread)
__host__ __device__ constexpr int round_queries(int dp) { return dp <= 96 ? 64 : 32; }

template <int DP>
struct DkdvPlan {
  static constexpr int KV = tile_bytes(KEYS, DP);  // the resident K (or V)
  static constexpr int QDO = tile_bytes(64, DP);   // a Q (or dO) tile of the ring
  static constexpr int O_K = 0;
  static constexpr int O_V = KV;
  static constexpr int O_RING = 2 * KV;
  static constexpr int O_VEC = O_RING + STAGES * 2 * QDO;
  static constexpr int SMEM = ATOM_BYTES + O_VEC + STAGES * ROWVEC_BYTES;
  static_assert(SMEM <= SMEM_LIMIT, "shared-memory plan too large");
};

constexpr int DQ_STAGES = 3;  // K / V tiles of the dQ pass

template <int DP, int NWG>
constexpr int dq_smem_bytes() {
  return ATOM_BYTES + 2 * tile_bytes(NWG * 64, DP) + DQ_STAGES * 2 * tile_bytes(64, DP);
}
static_assert(dq_smem_bytes<128, 2>() <= SMEM_LIMIT, "shared-memory plan too large");

__device__ __forceinline__ void block_barrier() {
  // by number, not by place in the code: the two warpgroups meet it from
  // different loops
  asm volatile("bar.sync 0, 256;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_barrier(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ di,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int n, int d, int heads,
                                long long qsb, long long qsn, long long qsh,
                                long long ksb, long long ksn, long long ksh,
                                long long vsb, long long vsn, long long vsh,
                                float scale) {
  using P = DkdvPlan<DP>;
  constexpr int QW = round_queries(DP);
  constexpr int ROUNDS = 64 / QW;
  constexpr uint32_t K_PANEL = KEYS * ROW_BYTES;  // bytes between K's (V's) panels
  constexpr uint32_t R_PANEL = TILE64_BYTES;      // ... a ring tile's
  if (DP == 64) d = 64;  // the head_dim a tile of 64 takes: strides fold to shifts
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;
  const int t128 = tid & 127;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * KEYS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = scale * LOG2E;
  const long long row_stride = (long long)heads * d;  // contiguous tensors
  const long long head_off = ((long long)b * n * heads + h) * d;
  const __nv_bfloat16* qg = q + b * qsb + h * qsh;
  const __nv_bfloat16* dog = dout + head_off;
  const float* lse_bh = lse + ((long long)b * heads + h) * n;
  const float* di_bh = di + ((long long)b * heads + h) * n;

  const uint32_t base = align_1024(smem_u32(smem));
  const uint32_t ring_s = base + P::O_RING;
  const uint32_t vec_s = base + P::O_VEC;
  const unsigned char* smem_base = smem + (base - smem_u32(smem));
  const int n_tiles = (n + 63) / 64;

  // Tile `tile` of Q, dO, lse and di into stage `st`. Warpgroup 0 starts
  // the ring's copies alone: warpgroup 1 has the longer tile (it runs two
  // phases after the barrier).
  auto load_stage = [&](int tile, int st) {
    if (wgi == 0) {
      const int row0 = tile * 64;
      load_tile_async<64, DP, 128>(ring_s + st * 2 * P::QDO, qg, qsn, row0, n, d, tid);
      load_tile_async<64, DP, 128>(ring_s + st * 2 * P::QDO + P::QDO, dog, row_stride, row0,
                                   n, d, tid);
      const int r = row0 + (tid & 63);
      const bool ok = r < n;
      const float* src = tid < 64 ? lse_bh : di_bh;
      cp_async_4(vec_s + st * ROWVEC_BYTES + tid * 4, ok ? src + r : src, ok);
    }
  };
  // Tile t has landed for every thread, and every warp is done with what the
  // barrier before it allowed; then tile t + AHEAD starts into the stage that
  // tile t - 2 left (warpgroup 1 was done with it before this barrier).
  auto ring_step = [&](int t) {
    cp_async_wait<AHEAD - 1>();
    fence_async_proxy();
    block_barrier();
    const int tn = t + AHEAD;
    if (tn < n_tiles) load_stage(tn, tn % STAGES);
    cp_async_commit();
  };

  load_tile_async<KEYS, DP, THREADS>(base + P::O_K, k + b * ksb + h * ksh, ksn, k0, n, d, tid);
  load_tile_async<KEYS, DP, THREADS>(base + P::O_V, v + b * vsb + h * vsh, vsn, k0, n, d, tid);
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_tiles) load_stage(s, s);
    cp_async_commit();
  }

  const int key_base = k0 + wgi * 64;  // the warpgroup's first key
  const bool pair = k0 + 64 < n;       // warpgroup 1 holds keys too
  const uint32_t k_rows = base + P::O_K + wgi * TILE64_BYTES;
  const uint32_t v_rows = base + P::O_V + wgi * TILE64_BYTES;
  // this thread's key rows of the warpgroup's 64: r0 and r0 + 8
  const int r0 = frag_row(t128, 0);
  const bool key_ok0 = key_base + r0 < n;
  const bool key_ok1 = key_base + r0 + 8 < n;

  WideAcc<DP> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();

  // Phase 1 of round rd of tile t: P^T and dS^T of [64 keys, QW queries] as
  // bf16 pairs in the A-fragment order.
  auto phase1 = [&](int t, int rd, uint32_t (&pt)[QW / 4], uint32_t (&dst)[QW / 4]) {
    const int st = t % STAGES;
    const int q0 = t * 64 + rd * QW;  // the round's first query
    const uint32_t q_rows = ring_s + st * 2 * P::QDO + rd * QW * ROW_BYTES;
    const uint32_t do_rows = q_rows + P::QDO;
    const float* lse_s = reinterpret_cast<const float*>(smem_base + P::O_VEC +
                                                        st * ROWVEC_BYTES) + rd * QW;
    const float* di_s = lse_s + 64;
    // past DP 64 the resident K and V descriptors are formed here, each
    // round, not held across the loop: the registers go to dK and dV
    const uint32_t k_at = DP > 64 ? opaque(k_rows) : k_rows;
    const uint32_t v_at = DP > 64 ? opaque(v_rows) : v_rows;

    float st_acc[QW / 2], dp_acc[QW / 2];  // S^T and dP^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<QW, 0, 0>(st_acc, k_slice_desc(k_at, kk, K_PANEL),
                         k_slice_desc(q_rows, kk, R_PANEL), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<QW, 0, 0>(dp_acc, k_slice_desc(v_at, kk, K_PANEL),
                         k_slice_desc(do_rows, kk, R_PANEL), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st_acc);
    fence_regs(dp_acc);

    // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)) and
    // dS^T = P^T * (dP^T - di) * scale
    const bool ragged = q0 + QW > n || key_base + 64 > n;
#pragma unroll
    for (int j = 0; j < QW / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);  // query column of the round
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
  };

  // Phase 2 of round rd of tile t: dV and dK grow.
  auto phase2 = [&](int t, int rd, uint32_t (&pt)[QW / 4], uint32_t (&dst)[QW / 4]) {
    const int st = t % STAGES;
    const uint32_t q_rows = ring_s + st * 2 * P::QDO + rd * QW * ROW_BYTES;
    const uint64_t q_desc = tile_desc(q_rows);
    const uint64_t do_desc = tile_desc(q_rows + P::QDO);
    dv_acc.fence();
    dk_acc.fence();
    fence_regs(pt);
    fence_regs(dst);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QW / 16; ++kk) {  // dV += P^T dO
      dv_acc.add_rs(pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2], pt[4 * kk + 3],
                    do_desc + kk * K_SLICE_MN_MAJOR, R_PANEL);
    }
#pragma unroll
    for (int kk = 0; kk < QW / 16; ++kk) {  // dK += dS^T Q
      dk_acc.add_rs(dst[4 * kk], dst[4 * kk + 1], dst[4 * kk + 2], dst[4 * kk + 3],
                    q_desc + kk * K_SLICE_MN_MAJOR, R_PANEL);
    }
    wgmma_commit();
    wgmma_wait<0>();
    dv_acc.fence();
    dk_acc.fence();
    fence_regs(pt);
    fence_regs(dst);
  };

  if (wgi == 0) {
    for (int t = 0; t < n_tiles; ++t) {
      ring_step(t);
#pragma unroll
      for (int rd = 0; rd < ROUNDS; ++rd) {
        uint32_t pt[QW / 4], dst[QW / 4];
        phase1(t, rd, pt, dst);
        phase2(t, rd, pt, dst);
      }
    }
    block_barrier();
  } else {
    uint32_t pt[QW / 4], dst[QW / 4];
    for (int t = 0; t < n_tiles; ++t) {
      ring_step(t);
      if (pair) {
        if (t > 0) phase2(t - 1, ROUNDS - 1, pt, dst);
#pragma unroll
        for (int rd = 0; rd < ROUNDS; ++rd) {
          phase1(t, rd, pt, dst);
          if (rd < ROUNDS - 1) phase2(t, rd, pt, dst);
        }
      }
    }
    block_barrier();
    if (pair) phase2(n_tiles - 1, ROUNDS - 1, pt, dst);
  }
  cp_async_wait<0>();
  warpgroup_barrier(wgi);  // every product that reads this warpgroup's K and V is done

  if (key_base < n) {  // each warp stages its 16 keys in its own rows of K, then V
    store_wide_rows(dk_acc, k_rows, K_PANEL, dk + head_off + (long long)key_base * row_stride,
                    row_stride, n - key_base, d);
    store_wide_rows(dv_acc, v_rows, K_PANEL, dv + head_off + (long long)key_base * row_stride,
                    row_stride, n - key_base, d);
  }
}

template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * 128)
    flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              __nv_bfloat16* __restrict__ dq, int n, int d, int heads,
                              long long qsb, long long qsn, long long qsh,
                              long long ksb, long long ksn, long long ksh,
                              long long vsb, long long vsn, long long vsh,
                              float scale) {
  constexpr int NT = NWG * 128;
  constexpr uint32_t Q_PANEL = NWG * TILE64_BYTES;  // bytes between Q's (dO's) panels
  constexpr uint32_t KV_PANEL = TILE64_BYTES;       // ... a K or a V tile's
  constexpr uint32_t KV_TILE = tile_bytes(64, DP);
  if (DP == 64) d = 64;  // the head_dim a tile of 64 takes: strides fold to shifts
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;   // warpgroup of the block
  const int t128 = tid & 127;  // thread of the warpgroup
  const int q0 = blockIdx.x * (NWG * 64);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = scale * LOG2E;
  const long long row_stride = (long long)heads * d;  // contiguous dO and dQ
  const long long head_off = ((long long)b * n * heads + h) * d;
  const __nv_bfloat16* qg = q + b * qsb + h * qsh;
  const __nv_bfloat16* kg = k + b * ksb + h * ksh;
  const __nv_bfloat16* vg = v + b * vsb + h * vsh;
  const float* lse_bh = lse + ((long long)b * heads + h) * n;
  const float* di_bh = di + ((long long)b * heads + h) * n;

  const uint32_t q_s = align_1024(smem_u32(smem));
  const uint32_t do_s = q_s + tile_bytes(NWG * 64, DP);
  const uint32_t kv_s = do_s + tile_bytes(NWG * 64, DP);
  const int n_tiles = (n + 63) / 64;

  // Q and dO ride in the first group with the first K / V stage
  load_tile_async<NWG * 64, DP, NT>(q_s, qg, qsn, q0, n, d, tid);
  load_tile_async<NWG * 64, DP, NT>(do_s, dout + head_off, row_stride, q0, n, d, tid);
#pragma unroll
  for (int s = 0; s < DQ_STAGES - 1; ++s) {
    if (s < n_tiles) {
      load_tile_async<64, DP, NT>(kv_s + s * 2 * KV_TILE, kg, ksn, s * 64, n, d, tid);
      load_tile_async<64, DP, NT>(kv_s + s * 2 * KV_TILE + KV_TILE, vg, vsn, s * 64, n, d,
                                  tid);
    }
    cp_async_commit();
  }

  const uint32_t q_rows = q_s + wgi * TILE64_BYTES;  // the warpgroup's rows
  const uint32_t do_rows = do_s + wgi * TILE64_BYTES;
  // this thread's query rows: r0 and r0 + 8, with -lse * log2(e) and di
  // (rows past n: zero, and never stored)
  const int row0 = q0 + wgi * 64;  // first row of the warpgroup
  const int r0 = row0 + frag_row(t128, 0);
  const float nl0 = r0 < n ? -lse_bh[r0] * LOG2E : 0.0f;
  const float nl1 = r0 + 8 < n ? -lse_bh[r0 + 8] * LOG2E : 0.0f;
  const float dd0 = r0 < n ? di_bh[r0] : 0.0f;
  const float dd1 = r0 + 8 < n ? di_bh[r0 + 8] : 0.0f;

  WideAcc<DP> acc;
  acc.zero();

  for (int t = 0; t < n_tiles; ++t) {  // ascending key order
    cp_async_wait<DQ_STAGES - 2>();  // this thread's part of tile t has landed
    fence_async_proxy();
    __syncthreads();  // tile t complete; every warp is done with tile t - 1
    {
      const int tn = t + DQ_STAGES - 1;
      if (tn < n_tiles) {
        const uint32_t st = kv_s + (tn % DQ_STAGES) * 2 * KV_TILE;
        load_tile_async<64, DP, NT>(st, kg, ksn, tn * 64, n, d, tid);
        load_tile_async<64, DP, NT>(st + KV_TILE, vg, vsn, tn * 64, n, d, tid);
      }
      cp_async_commit();
    }
    const uint32_t k_s = kv_s + (t % DQ_STAGES) * 2 * KV_TILE;
    const uint32_t v_s = k_s + KV_TILE;
    const int k0 = t * 64;

    float s[32], dp[32];  // S and dP of [64 queries, 64 keys]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<64, 0, 0>(s, k_slice_desc(q_rows, kk, Q_PANEL), k_slice_desc(k_s, kk, KV_PANEL),
                         kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<64, 0, 0>(dp, k_slice_desc(do_rows, kk, Q_PANEL),
                         k_slice_desc(v_s, kk, KV_PANEL), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS = exp2(S * scale * log2(e) - lse * log2(e)) * (dP - di) * scale,
    // keys at or past n at -inf before the exp; registers 4 j, 4 j + 1 are
    // row r0 at columns c, c + 1, registers 4 j + 2, 4 j + 3 row r0 + 8
    const bool ragged = k0 + 64 > n;
    uint32_t ds[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x00 = fmaf(s[4 * j], scale_log2, nl0);
      float x01 = fmaf(s[4 * j + 1], scale_log2, nl0);
      float x10 = fmaf(s[4 * j + 2], scale_log2, nl1);
      float x11 = fmaf(s[4 * j + 3], scale_log2, nl1);
      if (ragged) {
        const int c = k0 + frag_col(t128, 4 * j);
        if (c >= n) x00 = x10 = -INFINITY;
        if (c + 1 >= n) x01 = x11 = -INFINITY;
      }
      const float p00 = exp2_approx(x00), p01 = exp2_approx(x01);
      const float p10 = exp2_approx(x10), p11 = exp2_approx(x11);
      ds[2 * j] = pack_bf16(p00 * (dp[4 * j] - dd0) * scale,
                            p01 * (dp[4 * j + 1] - dd0) * scale);
      ds[2 * j + 1] = pack_bf16(p10 * (dp[4 * j + 2] - dd1) * scale,
                                p11 * (dp[4 * j + 3] - dd1) * scale);
    }

    acc.fence();
    fence_regs(ds);
    wgmma_fence();
    const uint64_t k_desc = tile_desc(k_s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // dQ += dS K
      acc.add_rs(ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3],
                 k_desc + kk * K_SLICE_MN_MAJOR, KV_PANEL);
    }
    wgmma_commit();
    wgmma_wait<0>();
    acc.fence();
    fence_regs(ds);
  }
  cp_async_wait<0>();

  // each warp stages its 16 rows in its own rows of the Q tile, which only
  // its own warpgroup's (finished) products read
  store_wide_rows(acc, q_rows, Q_PANEL, dq + (((long long)b * n + row0) * heads + h) * d,
                  row_stride, n - row0, d);
}

}  // namespace wg

// ---- float32, every head_dim: the TF32 three-product design ----------------
//
// Every product is three TF32 products of the split x = hi + lo
// (hopper_mma.cuh). The products contracted over the head_dim, the scores
// (S^T = K Q^T and dP^T = V dO^T in the dK / dV pass, S = Q K^T and
// dP = dO V^T in the dQ pass), take the block's resident rows as the A side
// (ldmatrix from row-major tiles of DP + 4 floats, split in registers) and
// the streamed tile as the B side; up to DP 96 they are wgmma m64n32k8 on
// each warpgroup (two k-slices a commit group), the streamed tiles landing
// as split tiles (hi and lo planes in the swizzled K-major layout, split
// once a block by the threads that copied them, before the barrier that
// publishes them); past DP 96 they are mma.sync m16n8k8 with the streamed
// tiles row-major and their B fragments read by ldmatrix and split in every
// warp. The value products (dV, dK, dQ), contracted over the streamed
// tile's rows, are mma.sync: TF32 wgmma takes no transposed shared-memory
// operand, so their B operand would need the tile stored again transposed;
// they take P^T, dS^T or dS from registers as the A fragment under the
// renumbered contraction and the B fragment from the tile's rows (its hi
// and lo planes as stored, or two 32-bit loads split in registers). dK, dV
// and dQ sum over every tile of the other side: each tile's (or round's)
// share goes to a fresh accumulator first and is added to the float32 sum
// with an ordinary add (the tensor cores' own sums would drift). The tile
// width DP is the head_dim rounded up to 16; the k-slice or output n-tile
// wholly past the true d is skipped at run time.
//
// Why past DP 96 the scores stay on mma.sync: two ring stages of two
// 32-row split tiles beside the 128 resident rows pass a block's shared
// memory there, and on 16-row split tiles (m64n16k8) the backward ran
// slower than on mma.sync. Timed in one call (tools/side_by_side.py, the
// trees in the order FMA parent, an mma.sync build (the scores on mma.sync
// at every width, the value products' B split in registers), a build with
// the scores on wgmma at every width (16-row tiles past DP 96), this, this
// and back, H100 80GB HBM3 at 700 W), f32 backward ms, mma.sync / wgmma
// everywhere / this: [2,197,12,64] 0.0686-0.0688 / 0.0633-0.0634 /
// 0.0633-0.0635, [2,4097,12,64] 6.1232-6.1265 / 5.7911-5.8021 /
// 5.7933-5.7945, [1,4097,16,d] d = 80: 5.6612-5.6628 / 5.4065-5.4366 /
// 5.4340-5.4365, 88: 5.8845-5.8855 / 5.4553-5.4631 / 5.4623-5.4629, 104:
// 7.4625-7.4788 / 8.3815-8.4379 / 7.4249-7.4254, 112: 7.9432-7.9589 /
// 8.8328-8.8818 / 7.9085-7.9268.
//
// The dK / dV pass: a block of 8 warps owns 128 keys of one (batch, head),
// 16 a warp, with their K and V rows resident and dK, dV in registers, and
// walks the 32-row Q and dO tiles with their lse and di through a two-stage
// cp.async ring, one block barrier a tile (S^T, dP^T and the split P^T,
// dS^T of a tile beside dK and dV's DP floats a thread): S^T = K Q^T and
// dP^T = V dO^T, P^T and dS^T in registers, then dV += P^T dO and
// dK += dS^T Q. The dQ pass: a block of 8 warps owns 128 query rows, with Q
// and dO resident, and walks the 32-key K and V tiles in ascending order the
// same way: S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K. Each
// output element sums its k-slices, each k-slice its three split products,
// and its tiles, in one fixed order.
//
// Why 8 warps and 32-row tiles: the dK / dV pass's registers allow one
// block an SM from head_dim 48 up, so the block is the SM's only source of
// warps. 4 warps over 64-row tiles left one warp to each scheduler and ran
// slower on an H100 at every long-sequence shape (most at head_dim
// 104-112); 128 resident rows and 64-row tiles do not fit in shared memory
// past DP 96.

namespace x3 {

using namespace hopper;

constexpr int W = 8;         // warps a block: 128 own rows, 16 a warp
constexpr int THREADS = W * 32;

// The scores' products on wgmma up to DP 96, on mma.sync past it (see the
// note above for the times that chose it)
__host__ __device__ constexpr bool scores_on_wgmma(int dp) { return dp <= 96; }

// Shared memory of both passes: two ring stages, each the streamed pair of
// TR-row tiles (K and V, or Q and dO: split tiles where the scores run on
// wgmma, else row-major) and, in the dK / dV pass, TR lse and TR di values
// (the dQ pass keeps its rows' in registers), then the block's resident
// pair of W * 16-row row-major tiles (Q and dO, or K and V); 1024 bytes
// more for the split tiles' alignment.
template <int DP>
struct Plan {
  static constexpr bool WG = scores_on_wgmma(DP);
  static constexpr int TR = 32;      // rows of a streamed tile
  static constexpr int NJ = TR / 8;  // its 8-row slices
  static constexpr int LD = DP + F32_PAD;
  static constexpr int OWN = W * 16 * LD * 4;  // a resident tile
  static constexpr int TILE = WG ? 2 * f32_plane_bytes(TR, DP) : TR * LD * 4;  // a streamed tile
  static constexpr int STAGE = (2 * TILE + 2 * TR * 4 + ATOM_BYTES - 1) / ATOM_BYTES * ATOM_BYTES;
  static constexpr int SMEM = ATOM_BYTES + 2 * STAGE + 2 * OWN;
  static_assert(SMEM <= SMEM_LIMIT, "shared-memory plan too large");
};

// The streamed pair of a stage: start their copies, and (split tiles) split
// what this thread copied once it has landed.
template <int DP>
__device__ __forceinline__ void load_pair(uint32_t at, const float* a, long long a_stride,
                                          const float* b, long long b_stride, int row0, int n,
                                          int d, int tid) {
  constexpr int TR = Plan<DP>::TR;
  if constexpr (Plan<DP>::WG) {
    load_split_async<TR, DP, THREADS>(at, a, a_stride, row0, n, d, tid);
    load_split_async<TR, DP, THREADS>(at + Plan<DP>::TILE, b, b_stride, row0, n, d, tid);
  } else {
    load_rows_f32<TR, DP, THREADS>(at, a, a_stride, row0, n, d, tid);
    load_rows_f32<TR, DP, THREADS>(at + Plan<DP>::TILE, b, b_stride, row0, n, d, tid);
  }
}

template <int DP>
__device__ __forceinline__ void split_pair(uint32_t at, int tid) {
  constexpr int TR = Plan<DP>::TR;
  if constexpr (Plan<DP>::WG) {
    split_tile<TR, DP, THREADS>(at, tid);
    split_tile<TR, DP, THREADS>(at + Plan<DP>::TILE, tid);
    fence_async_proxy();
  }
}

// x[16 rows, TR] = a[16, DP] . b[TR, DP]^T and y = c . e^T for this warp
// (x, y: n-tile j in x[j], the mma.sync C layout), a and c the warp's rows
// of resident row-major tiles (`a_rows`, `c_rows` as `a_frag` takes them),
// b and e the stage's streamed pair at `b_tile`. On wgmma the warpgroup's
// four warps form the [64, TR] product together; the k-slice past the true
// width d is skipped.
template <int DP, int NJ = Plan<DP>::NJ>
__device__ __forceinline__ void score_pair(float (&x)[NJ][4], float (&y)[NJ][4], uint32_t a_rows,
                                           uint32_t c_rows, uint32_t b_tile, int d, int lane) {
  constexpr int TR = Plan<DP>::TR;
  constexpr int KT = DP / 8;
  constexpr uint32_t E = Plan<DP>::TILE;
  if constexpr (Plan<DP>::WG) {
    constexpr uint32_t LO_UNITS = f32_plane_bytes(TR, DP) >> 4;
    float(&xf)[TR / 2] = reinterpret_cast<float(&)[TR / 2]>(x);
    float(&yf)[TR / 2] = reinterpret_cast<float(&)[TR / 2]>(y);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk + 1 < KT || 8 * kk < d) {
        SplitA a, c;
        a_frag(a, a_rows, kk);
        a_frag(c, c_rows, kk);
        wgmma_fence();
        wgmma_tf32x3<TR>(xf, a, k_slice_desc(b_tile, kk, TR * ROW_BYTES), LO_UNITS, kk > 0);
        wgmma_tf32x3<TR>(yf, c, k_slice_desc(b_tile + E, kk, TR * ROW_BYTES), LO_UNITS, kk > 0);
      }
      // two k-slices a commit group, at most two in flight, so that only
      // their A fragments hold registers (every slice's held to the end
      // spilled at DP 80-96)
      if (kk & 1) {
        wgmma_commit();
        if (kk + 1 < KT) wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();
    fence_regs(xf);
    fence_regs(yf);
  } else {
    constexpr int LD = Plan<DP>::LD;
    const uint32_t bl = b_tile + b_lane_offset<LD>(lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[j][i] = y[j][i] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk + 1 < KT || 8 * kk < d) {
        SplitA a, c;
        a_frag(a, a_rows, kk);
        a_frag(c, c_rows, kk);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint32_t at = bl + 8 * j * LD * 4;
          SplitB b, e;
          b_frag(b, at, kk);
          mma_tf32x3(x[j], a, b);
          b_frag(e, at + E, kk);
          mma_tf32x3(y[j], c, e);
        }
      }
    }
  }
}

// The B fragment of k-slice kk, n-tile j of a value product from a streamed
// tile (`tile` its start in shared memory, as floats), split or row-major
template <int DP>
__device__ __forceinline__ void value_b(SplitB& b, const float* tile, int kk, int j, int lane) {
  if constexpr (Plan<DP>::WG) {
    b_rows_split<Plan<DP>::TR, DP>(b, tile, kk, j, lane);
  } else {
    b_rows<Plan<DP>::LD>(b, tile + b_rows_lane<Plan<DP>::LD>(lane), kk, j);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ di,
                             float* __restrict__ dk, float* __restrict__ dv, int n, int d,
                             int heads, long long qsb, long long qsn, long long qsh,
                             long long ksb, long long ksn, long long ksh,
                             long long vsb, long long vsn, long long vsh, float scale) {
  using P = Plan<DP>;
  constexpr int TR = P::TR;
  constexpr int NJ = P::NJ;
  constexpr int LD = P::LD;
  constexpr int KT = DP / 8;
  // column tiles of dK and dV a group of the value products: all of them up
  // to DP 64; past it four, so that the group's fresh sums fit beside dK and
  // dV's DP floats a thread; at DP 112 seven (two groups, each splitting P^T
  // and dS^T once), which ran faster on an H100 than four though it spills
  // more (`tools/kernel_resources.py`)
  constexpr int G = DP <= 64 ? KT : DP == 112 ? 7 : 4;
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = lane & 3;
  const int k0 = blockIdx.x * W * 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = scale * LOG2E;
  const long long row_stride = (long long)heads * d;  // contiguous tensors
  const long long head_off = ((long long)b * n * heads + h) * d;
  const float* qg = q + b * qsb + h * qsh;
  const float* dog = dout + head_off;
  const float* lse_bh = lse + ((long long)b * heads + h) * n;
  const float* di_bh = di + ((long long)b * heads + h) * n;

  const uint32_t ring = align_1024(smem_u32(smem));
  const uint32_t k_s = ring + 2 * P::STAGE;
  const float* ring_f = reinterpret_cast<const float*>(smem + (ring - smem_u32(smem)));
  const int n_tiles = (n + TR - 1) / TR;

  // tile `tile` of Q, dO, lse and di into stage `st`
  auto load_stage = [&](int tile, int st) {
    const uint32_t at = ring + st * P::STAGE;
    const int row0 = tile * TR;
    load_pair<DP>(at, qg, qsn, dog, row_stride, row0, n, d, tid);
    if (tid < 2 * TR) {
      const int r = row0 + tid % TR;
      const bool ok = r < n;
      const float* src = tid < TR ? lse_bh : di_bh;
      cp_async_4(at + 2 * P::TILE + tid * 4, ok ? src + r : src, ok);
    }
  };

  load_rows_f32<W * 16, DP, THREADS>(k_s, k + b * ksb + h * ksh, ksn, k0, n, d, tid);
  load_rows_f32<W * 16, DP, THREADS>(k_s + P::OWN, v + b * vsb + h * vsh, vsn, k0, n, d, tid);
  load_stage(0, 0);
  cp_async_commit();

  const uint32_t ka = k_s + warp * 16 * LD * 4 + a_lane_offset<LD>(lane);  // the warp's keys
  const uint32_t va = ka + P::OWN;
  // this thread's keys r0 and r0 + 8
  const int r0 = k0 + warp * 16 + (lane >> 2);
  const bool key_ok0 = r0 < n;
  const bool key_ok1 = r0 + 8 < n;

  float dk_acc[KT][4], dv_acc[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stg = t & 1;
    const uint32_t q_t = ring + stg * P::STAGE;
    cp_async_wait<0>();  // this thread's part of tile t has landed
    split_pair<DP>(q_t, tid);
    __syncthreads();     // tile t complete; every warp is done with tile t - 1
    if (t + 1 < n_tiles) load_stage(t + 1, stg ^ 1);
    cp_async_commit();
    const float* q_f = ring_f + stg * (P::STAGE / 4);
    const float* do_f = q_f + P::TILE / 4;
    const float* vec = q_f + 2 * P::TILE / 4;

    // S^T = K Q^T and dP^T = V dO^T of [16 keys, TR queries]: registers
    // 0, 1 of n-tile j are key r0 at queries 8 j + 2 c, 8 j + 2 c + 1,
    // registers 2, 3 key r0 + 8
    float st[NJ][4], dpt[NJ][4];
    score_pair<DP>(st, dpt, ka, va, q_t, d, lane);

    // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)) and
    // dS^T = P^T * (dP^T - di) * scale, in place
    const bool ragged = t * TR + TR > n || k0 + W * 16 > n;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 8 * j + 2 * c;
      const float2 ls = *reinterpret_cast<const float2*>(vec + col);
      const float2 dd = *reinterpret_cast<const float2*>(vec + TR + col);
      float x[4] = {fmaf(st[j][0], scale_log2, -ls.x * LOG2E),
                    fmaf(st[j][1], scale_log2, -ls.y * LOG2E),
                    fmaf(st[j][2], scale_log2, -ls.x * LOG2E),
                    fmaf(st[j][3], scale_log2, -ls.y * LOG2E)};
      if (ragged) {
        // masked pairs get -inf BEFORE the exp: exp of a logit without its
        // row's lse could be inf, and inf * 0 is NaN
        const bool q_ok0 = t * TR + col < n;
        const bool q_ok1 = t * TR + col + 1 < n;
        if (!(key_ok0 && q_ok0)) x[0] = -INFINITY;
        if (!(key_ok0 && q_ok1)) x[1] = -INFINITY;
        if (!(key_ok1 && q_ok0)) x[2] = -INFINITY;
        if (!(key_ok1 && q_ok1)) x[3] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st[j][i] = exp2f(x[i]);
        dpt[j][i] = st[j][i] * (dpt[j][i] - ((i & 1) ? dd.y : dd.x)) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries, each summed
    // apart first, G column tiles at a time (2 G independent sums); P^T
    // and dS^T are split as A fragments once a group (slots renumbered:
    // c0, c2, c1, c3), and the Q and dO rows of the tile are the B side
#pragma unroll
    for (int j0 = 0; j0 < KT; j0 += G) {
      float pv[G][4], pk[G][4];
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[j][i] = pk[j][i] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        SplitA pa, da;
        pa.set(st[kk][0], st[kk][2], st[kk][1], st[kk][3]);
        da.set(dpt[kk][0], dpt[kk][2], dpt[kk][1], dpt[kk][3]);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j0 + j < KT && (j0 + j + 1 < KT || 8 * (j0 + j) < d)) {
            SplitB bb;
            value_b<DP>(bb, do_f, kk, j0 + j, lane);
            mma_tf32x3(pv[j], pa, bb);
            value_b<DP>(bb, q_f, kk, j0 + j, lane);
            mma_tf32x3(pk[j], da, bb);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j0 + j < KT) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[j0 + j][i] += pv[j][i];
            dk_acc[j0 + j][i] += pk[j][i];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* dk0 = dk + head_off + (long long)r0 * row_stride + 2 * c;
  float* dv0 = dv + head_off + (long long)r0 * row_stride + 2 * c;
  const long long eight = 8 * row_stride;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j + 1 < KT || 8 * j < d) {  // the zero-filled columns are not stored
      if (key_ok0) {
        *reinterpret_cast<float2*>(dk0 + 8 * j) = make_float2(dk_acc[j][0], dk_acc[j][1]);
        *reinterpret_cast<float2*>(dv0 + 8 * j) = make_float2(dv_acc[j][0], dv_acc[j][1]);
      }
      if (key_ok1) {
        *reinterpret_cast<float2*>(dk0 + eight + 8 * j) = make_float2(dk_acc[j][2], dk_acc[j][3]);
        *reinterpret_cast<float2*>(dv0 + eight + 8 * j) = make_float2(dv_acc[j][2], dv_acc[j][3]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           float* __restrict__ dq, int n, int d, int heads,
                           long long qsb, long long qsn, long long qsh,
                           long long ksb, long long ksn, long long ksh,
                           long long vsb, long long vsn, long long vsh, float scale) {
  using P = Plan<DP>;
  constexpr int TR = P::TR;
  constexpr int NJ = P::NJ;
  constexpr int LD = P::LD;
  constexpr int KT = DP / 8;
  constexpr int G = DP <= 64 ? KT : 8;  // column tiles of dQ a group of fresh sums
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = lane & 3;
  const int q0 = blockIdx.x * W * 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = scale * LOG2E;
  const long long row_stride = (long long)heads * d;  // contiguous dO and dQ
  const long long head_off = ((long long)b * n * heads + h) * d;
  const float* kg = k + b * ksb + h * ksh;
  const float* vg = v + b * vsb + h * vsh;
  const float* lse_bh = lse + ((long long)b * heads + h) * n;
  const float* di_bh = di + ((long long)b * heads + h) * n;

  const uint32_t ring = align_1024(smem_u32(smem));
  const uint32_t q_s = ring + 2 * P::STAGE;
  const float* ring_f = reinterpret_cast<const float*>(smem + (ring - smem_u32(smem)));
  const int n_tiles = (n + TR - 1) / TR;

  load_rows_f32<W * 16, DP, THREADS>(q_s, q + b * qsb + h * qsh, qsn, q0, n, d, tid);
  load_rows_f32<W * 16, DP, THREADS>(q_s + P::OWN, dout + head_off, row_stride, q0, n, d, tid);
  load_pair<DP>(ring, kg, ksn, vg, vsn, 0, n, d, tid);
  cp_async_commit();

  const uint32_t qa = q_s + warp * 16 * LD * 4 + a_lane_offset<LD>(lane);  // the warp's queries
  const uint32_t doa = qa + P::OWN;
  // this thread's query rows r0 and r0 + 8, with -lse * log2(e) and di
  // (rows past n: zero, and never stored)
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const float nl0 = r0 < n ? -lse_bh[r0] * LOG2E : 0.0f;
  const float nl1 = r0 + 8 < n ? -lse_bh[r0 + 8] * LOG2E : 0.0f;
  const float dd0 = r0 < n ? di_bh[r0] : 0.0f;
  const float dd1 = r0 + 8 < n ? di_bh[r0 + 8] : 0.0f;

  float acc[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {  // ascending key order
    const int stg = t & 1;
    const uint32_t k_t = ring + stg * P::STAGE;
    cp_async_wait<0>();
    split_pair<DP>(k_t, tid);
    __syncthreads();
    if (t + 1 < n_tiles) {
      load_pair<DP>(ring + (stg ^ 1) * P::STAGE, kg, ksn, vg, vsn, (t + 1) * TR, n, d, tid);
    }
    cp_async_commit();
    const float* k_f = ring_f + stg * (P::STAGE / 4);
    const int k0 = t * TR;

    float s[NJ][4], dp[NJ][4];  // S and dP of [16 queries, TR keys]
    score_pair<DP>(s, dp, qa, doa, k_t, d, lane);

    // dS = exp2(S * scale * log2(e) - lse * log2(e)) * (dP - di) * scale in
    // place, keys at or past n at -inf before the exp
    const bool ragged = k0 + TR > n;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = fmaf(s[j][i], scale_log2, i < 2 ? nl0 : nl1);
        if (ragged && k0 + 8 * j + 2 * c + (i & 1) >= n) x = -INFINITY;
        s[j][i] = exp2f(x) * (dp[j][i] - (i < 2 ? dd0 : dd1)) * scale;
      }
    }

    // dQ += dS K, the tile's share summed apart first, G column tiles at a
    // time; dS split as the A fragment of k-slice kk (S's n-tile kk, slots
    // renumbered: c0, c2, c1, c3), K's rows 8 kk + 2 c and 8 kk + 2 c + 1
    // its B fragment
#pragma unroll
    for (int j0 = 0; j0 < KT; j0 += G) {
      float part[G][4];
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[j][i] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        SplitA a;
        a.set(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j0 + j < KT && (j0 + j + 1 < KT || 8 * (j0 + j) < d)) {
            SplitB bk;
            value_b<DP>(bk, k_f, kk, j0 + j, lane);
            mma_tf32x3(part[j], a, bk);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j0 + j < KT) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j0 + j][i] += part[j][i];
        }
      }
    }
  }
  cp_async_wait<0>();

  float* dq0 = dq + head_off + (long long)r0 * row_stride + 2 * c;
  const long long eight = 8 * row_stride;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j + 1 < KT || 8 * j < d) {
      if (r0 < n) *reinterpret_cast<float2*>(dq0 + 8 * j) = make_float2(acc[j][0], acc[j][1]);
      if (r0 + 8 < n) {
        *reinterpret_cast<float2*>(dq0 + eight + 8 * j) = make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

}  // namespace x3

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

// Which design a call takes: fixed by dtype and head_dim.
enum Design { DESIGN_WMMA = 1, DESIGN_WGMMA = 2, DESIGN_TF32X3 = 3 };

constexpr Design design_rule(bool is_f32, int head_dim) {
  return is_f32 ? DESIGN_TF32X3 : head_dim >= 64 ? DESIGN_WGMMA : DESIGN_WMMA;
}

// The head dims taken: multiples of 8 up to 128.
constexpr bool head_dim_taken(int head_dim) {
  return head_dim % 8 == 0 && head_dim >= 8 && head_dim <= 128;
}

int grid_for(long long work, int threads) {
  const long long want = (work + threads - 1) / threads;
  return (int)(want < (1LL << 30) ? want : (1LL << 30));
}

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *di;
  int batch, n, heads, head_dim;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_di(const Args& a) {
  const long long rows = (long long)a.batch * a.n * a.heads;
  flash_bwd_di_kernel<T><<<grid_for(rows * 32, 256), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.di), rows, a.n, a.heads, a.head_dim);
  return cudaGetLastError();
}

template <int DP, int NWG>
cudaError_t launch_dq_wgmma(const Args& a) {
  using bf16 = __nv_bfloat16;
  auto kern = wg::flash_bwd_dq_wgmma_kernel<DP, NWG>;
  constexpr int bytes = wg::dq_smem_bytes<DP, NWG>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + NWG * 64 - 1) / (NWG * 64), a.heads, a.batch);
  kern<<<grid, NWG * 128, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<bf16*>(a.dq), a.n, a.head_dim, a.heads, a.qsb, a.qsn, a.qsh, a.ksb, a.ksn,
      a.ksh, a.vsb, a.vsn, a.vsh, a.scale);
  return cudaGetLastError();
}

// bfloat16 at head_dim 64-128: the two warpgroup passes at tile width DP
// (the di pass is the caller's).
template <int DP>
cudaError_t launch_wgmma(const Args& a) {
  using bf16 = __nv_bfloat16;
  auto kern = wg::flash_bwd_dkdv_wgmma_kernel<DP>;
  constexpr int bytes = wg::DkdvPlan<DP>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + wg::KEYS - 1) / wg::KEYS, a.heads, a.batch);
  kern<<<grid, wg::THREADS, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.n, a.head_dim, a.heads, a.qsb,
      a.qsn, a.qsh, a.ksb, a.ksn, a.ksh, a.vsb, a.vsn, a.vsh, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return a.n > WGMMA_ONE_WARPGROUP_MAX_N ? launch_dq_wgmma<DP, 2>(a) : launch_dq_wgmma<DP, 1>(a);
}

// float32: the two TF32 three-product passes at tile width DP (the di pass
// is the caller's).
template <int DP>
cudaError_t launch_x3(const Args& a) {
  auto dkdv = x3::flash_bwd_dkdv_x3_kernel<DP>;
  auto dqk = x3::flash_bwd_dq_x3_kernel<DP>;
  constexpr int bytes = x3::Plan<DP>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + x3::W * 16 - 1) / (x3::W * 16), a.heads, a.batch);
  dkdv<<<grid, x3::THREADS, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.n, a.head_dim, a.heads, a.qsb,
      a.qsn, a.qsh, a.ksb, a.ksn, a.ksh, a.vsb, a.vsn, a.vsh, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dqk<<<grid, x3::THREADS, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<float*>(a.dq), a.n, a.head_dim, a.heads, a.qsb, a.qsn, a.qsh, a.ksb, a.ksn,
      a.ksh, a.vsb, a.vsn, a.vsh, a.scale);
  return cudaGetLastError();
}

// The WMMA design's two passes (bf16 below head_dim 64). D: the tile width,
// a.head_dim rounded up to 16.
template <typename T, int D>
cudaError_t launch(const Args& a) {
  const int d = a.head_dim;
  using P = Plan<T, D>;
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dqk = flash_bwd_dq_kernel<T, D>;
  cudaError_t e =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::total);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::total);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3((a.n + BK - 1) / BK, a.heads, a.batch), THREADS, P::total, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.n, d, a.heads, a.qsb, a.qsn,
      a.qsh, a.ksb, a.ksn, a.ksh, a.vsb, a.vsn, a.vsh, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dqk<<<dim3((a.n + BQ - 1) / BQ, a.heads, a.batch), THREADS, P::total, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<T*>(a.dq), a.n, d, a.heads, a.qsb, a.qsn, a.qsh, a.ksb, a.ksn, a.ksh,
      a.vsb, a.vsn, a.vsh, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  if (!head_dim_taken(a.head_dim)) return cudaErrorInvalidValue;
  const cudaError_t e = launch_di<T>(a);
  if (e != cudaSuccess) return e;
  const int dp = (a.head_dim + 15) / 16 * 16;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (design_rule(false, a.head_dim) == DESIGN_WGMMA) {
      switch (dp) {
        case 64: return launch_wgmma<64>(a);
        case 80: return launch_wgmma<80>(a);
        case 96: return launch_wgmma<96>(a);
        case 112: return launch_wgmma<112>(a);
        default: return launch_wgmma<128>(a);
      }
    }
    switch (dp) {  // head_dim 8-56
      case 16: return launch<T, 16>(a);
      case 32: return launch<T, 32>(a);
      case 48: return launch<T, 48>(a);
      default: return launch<T, 64>(a);
    }
  } else {
    switch (dp) {
      case 16: return launch_x3<16>(a);
      case 32: return launch_x3<32>(a);
      case 48: return launch_x3<48>(a);
      case 64: return launch_x3<64>(a);
      case 80: return launch_x3<80>(a);
      case 96: return launch_x3<96>(a);
      case 112: return launch_x3<112>(a);
      default: return launch_x3<128>(a);
    }
  }
}

}  // namespace

// The design that clipself_flash_bwd runs for this dtype and head_dim:
// 1 = WMMA tiles (bf16 below head_dim 64), 2 = wgmma (bf16 at head_dim
// 64-128), 3 = the TF32 three-product split (float32); -1 if the pair is not
// taken.
extern "C" int clipself_flash_bwd_design(int dtype, int head_dim) {
  if (!head_dim_taken(head_dim)) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  return design_rule(dtype == 0, head_dim);
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v: [batch, n, heads, head_dim],
// head_dim a multiple of 8 up to 128, with unit stride on head_dim and the
// given element strides for batch, token and head (16-byte aligned rows); o,
// dout: contiguous [batch, n, heads, head_dim]; lse: contiguous float32 [batch,
// heads, n], natural-log row log-sum-exp of the scaled logits
// (clipself_flash_fwd writes it). Outputs dq, dk, dv: contiguous [batch, n,
// heads, head_dim] in dtype. Scratch: di, float32 [batch, heads, n]. Returns
// the first failing launch's cudaError_t.
extern "C" int clipself_flash_bwd(int dtype, const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* lse, const void* dout, void* dq,
                                  void* dk, void* dv, void* di,
                                  int batch, int n, int heads, int head_dim,
                                  long long qsb, long long qsn, long long qsh,
                                  long long ksb, long long ksn, long long ksh,
                                  long long vsb, long long vsn, long long vsh,
                                  float scale, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return (int)cudaSuccess;
  const Args a{q,   k,   v,   o,   lse, dout, dq,  dk,   dv,  di,
               batch, n, heads, head_dim, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh,
               scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch<float>(a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
