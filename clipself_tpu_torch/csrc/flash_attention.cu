// Flash-attention forward: softmax(Q K^T * scale) V per (batch, head).
//
// Replaces the TPU kernel that clipself_tpu/ops/attention.py:_bundled_fwd
// reaches (JAX's bundled Pallas `_flash_attention_impl`), which the JAX towers
// feed [B, H, N, D] copies padded to a block multiple (4097 -> 4224) with a
// segment row masking the pad tail.
//
// What every design here shares: a block owns a tile of query rows of one
// (batch, head) and loops over 64-key K/V tiles in shared memory, keeping
// the running row max and row sum in f32 registers (online softmax). The
// ragged tail is masked inside the kernel: keys at or past N get -inf before
// the exp, query rows past N are never stored, so there is neither padding
// nor a segment tensor. Q, K and V are read through their strides from the
// [B, N, H * D] projection layout, so the head transposes of
// attention.py:494-496 disappear; the output is written as a contiguous
// [B, N, H, D]. Training also asks for the row log-sum-exp, lse [B, H, N]
// f32, the residual of the backward (csrc/flash_attention_bwd.cu)
// in place of the Pallas kernel's (l, m) pair. It is a NATURAL-log value:
// the running max m is kept in the log2 domain (the scale carries log2(e),
// exp is exp2), so the kernel stores lse = (m + log2(l)) * ln(2). A null lse
// pointer (the no-grad teacher and evaluator) skips the write.
//
// Bound on the H100: at N = 4097, D = 64 a query row does 4 * D flops per key
// against K/V tiles that every query tile of the head reads again from the
// L2, so the kernel is bound by operations (the card's bound is the products
// at the bf16 tensor-core peak; in float32, three TF32 products a float32
// product at the TF32 peak, 494.7 / 3 TFLOP/s), and on the way there by what
// feeds the tensor cores: shared-memory traffic, the exponentials (one SFU
// result per score against 4 * D tensor-core flops: at D = 64 the two take
// about as long), in float32 the split of every loaded operand, and the
// waits between a product and the code that needs it.
//
// Three designs, picked by dtype and head_dim alone (clipself_flash_fwd_design):
//
//  * bfloat16 at head_dim 64-128 (64: every attention call of the EVA02
//    towers; 80: ViT-H-14; 88: ViT-g-14, EVA01-CLIP-g-14; 104: ViT-bigG-14;
//    112: EVA02-CLIP-bigE-14, ViT-e-14): the warpgroup design in namespace
//    `wg` below. Both products run as wgmma (csrc/hopper_mma.cuh); K/V
//    tiles arrive through a cp.async ring (three stages at head_dim 64, two
//    past it) in the tensor cores' 128-byte-swizzled layout, one block
//    barrier a tile; the scores stay in the accumulator registers, the
//    softmax runs there (a row lives in a quad of lanes) with ex2.approx,
//    and P goes to the second product as a register operand, never through
//    shared memory. One or two warpgroups (64 or 128 query rows) a block, by
//    N. Past head_dim 64 a tile is two 64-column panels.
//  * bfloat16 below head_dim 64 (8-56: the tiny test towers): 4 warps of 16
//    rows, WMMA 16x16x16 tiles with f32 accumulation, scores and P staged
//    in shared memory, tiles loaded with plain vector loads, one buffer.
//  * float32 (the HF trunks, which compute in float32 in every model, and
//    every parity path): "tf32x3", the design in namespace `x3` below. Both
//    products run on the tensor cores at float32 accuracy as three TF32
//    products of a split x = hi + lo of each operand (csrc/hopper_mma.cuh;
//    one TF32 product alone keeps three decimal digits): S = Q K^T as wgmma
//    with Q's fragments split in registers and K landing as a split tile
//    (hi and lo planes in shared memory, split once a block); P V as
//    mma.sync with P split in the softmax's registers and V's fragments by
//    32-bit loads under a renumbered contraction, so that V is never
//    transposed. The tensor cores sum each tile's P V apart and the running
//    O is rescaled and added in float32, since their own sums cut low bits.
//    What bounds it on this card: the split's instructions beside the
//    products and the value product on mma.sync; see the kernel's note for
//    what was measured.
//
// Every design takes every head_dim d that is a multiple of 8 up to 128 by
// zero-fill: it is instantiated at the tile width DP = d rounded up to 16
// (ViT-g-14's 88 runs 96-wide tiles, ViT-bigG-14's 104 112-wide ones) and
// takes the true d at run time. The loads fill columns d to DP - 1 of every
// Q, K and V tile with zeros, which add nothing to Q K^T, and P V's extra
// output columns (zero too) are never stored; the float32 design, whose
// k-slices are 8 wide, skips the slice and the output tile that lie wholly
// past d. The softmax scale is the caller's, d ** -0.5 of the true d.
//
// The shared-memory tile loader and the Pad/Plan conventions of the WMMA
// design are repeated in flash_attention_bwd.cu: each .cu file is compiled
// on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per K/V tile
constexpr int WARPS = 4;
constexpr int WROWS = BQ / WARPS;  // query rows per warp
constexpr int THREADS = WARPS * 32;
// bf16 head_dim 64-128: sequences up to this length take one warpgroup a block
constexpr int WGMMA_ONE_WARPGROUP_MAX_N = 384;

template <typename T>
struct Pad;  // shared-memory row padding, in elements (keeps 16-byte rows)
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

__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16) {
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

// D is the tile width, d <= D the true head_dim (the row length of o).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n, int d,
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

  load_tile<T, D>(qs, qg, qsn, q0, n, d, tid);

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
    load_tile<T, D>(ks, kg, ksn, k0, n, d, tid);
    load_tile<T, D>(vs, vg, vsn, k0, n, d, tid);
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
    T* og = o + (((long long)b * n + row) * heads + h) * d;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      const int c = half * (D / 2) + j;
      if (c < d) og[c] = to_out(acc[j] * inv, T());  // zero-fill columns dropped
    }
    if (lse != nullptr && half == 0) {
      lse[((long long)b * heads + h) * n + row] =
          (m + log2f(l)) * 0.6931471805599453f;
    }
  }
}

// ---- bf16, head_dim 64-128: the warpgroup design ---------------------------
//
// A block owns NWG * 64 query rows of one (batch, head), 64 for each of its
// NWG warpgroups. Q is loaded once; 64-key K and V tiles come through a ring
// of STAGES swizzled shared-memory stages filled by cp.async, tile
// t + STAGES - 1 in flight while tile t is computed, with one block barrier a
// tile (it publishes tile t and frees the stage of tile t - 1). S = Q K^T is
// one wgmma group of DP / 16 k-slices with both operands in shared memory
// and the scores in registers; the online softmax runs on the accumulator
// fragment (a row lives in the four lanes of a quad: two shuffles for its
// max, the sum is reduced once at the end); P is packed to bf16 in registers
// and is the register A operand of O += P V, with V read as an MN-major
// tile: one product a k-slice at DP 64, two past it (N = 64 on the first
// panel, N = DP - 64 on the second). The tile width DP is the head_dim
// rounded up to 16; a tile's Q, K and V columns at or past the true head_dim
// load as zeros (they add nothing to S), and the output's are not stored.

namespace wg {

using namespace hopper;

// K/V stages of the ring. Past DP 64 two: a block of two warpgroups then
// takes 99 KB of shared memory and (__launch_bounds__) at most 128
// registers a thread, so that two blocks share an SM (three stages and more
// registers gave one block and 1.2-1.3x the time at head_dim 80-128 on an
// H100 SXM).
__host__ __device__ constexpr int stages(int dp) { return dp > 64 ? 2 : 3; }

template <int DP, int NWG>
constexpr int smem_bytes() {
  return ATOM_BYTES + tile_bytes(NWG * 64, DP) + stages(DP) * 2 * tile_bytes(64, DP);
}
static_assert(smem_bytes<128, 2>() <= 232448, "shared-memory plan too large");

template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * 128, 2)
    flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int n, int d, int heads,
                           long long qsb, long long qsn, long long qsh,
                           long long ksb, long long ksn, long long ksh,
                           long long vsb, long long vsn, long long vsh,
                           float scale_log2) {
  constexpr int THREADS = NWG * 128;
  constexpr int STAGES = stages(DP);
  if (DP == 64) d = 64;  // the head_dim a tile of 64 takes: strides fold to shifts
  constexpr uint32_t Q_PANEL = NWG * TILE64_BYTES;  // bytes between Q's panels
  constexpr uint32_t KV_PANEL = TILE64_BYTES;       // ... a K or a V tile's
  constexpr uint32_t KV_TILE = tile_bytes(64, DP);
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;   // warpgroup of the block
  const int t128 = tid & 127;  // thread of the warpgroup
  const int lane = tid & 31;
  const int q0 = blockIdx.x * (NWG * 64);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qg = q + b * qsb + h * qsh;
  const __nv_bfloat16* kg = k + b * ksb + h * ksh;
  const __nv_bfloat16* vg = v + b * vsb + h * vsh;

  const uint32_t q_s = align_1024(smem_u32(smem));
  const uint32_t kv_s = q_s + tile_bytes(NWG * 64, DP);
  const int n_tiles = (n + 63) / 64;

  load_tile_async<NWG * 64, DP, THREADS>(q_s, qg, qsn, q0, n, d, tid);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) {
      load_tile_async<64, DP, THREADS>(kv_s + s * 2 * KV_TILE, kg, ksn, s * 64, n, d, tid);
      load_tile_async<64, DP, THREADS>(kv_s + s * 2 * KV_TILE + KV_TILE, vg, vsn, s * 64, n,
                                       d, tid);
    }
    cp_async_commit();
  }

  const uint32_t q_rows = q_s + wgi * TILE64_BYTES;  // the warpgroup's rows
  // this thread's rows of the warpgroup's 64: r0 and r0 + 8
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max, log2 domain
  float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the row sums
  WideAcc<DP> acc;
  acc.zero();

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's part of tile t has landed
    fence_async_proxy();
    __syncthreads();  // tile t complete; every warp is done with tile t - 1
    {
      const int tn = t + STAGES - 1;
      if (tn < n_tiles) {
        const uint32_t st = kv_s + (tn % STAGES) * 2 * KV_TILE;
        // past DP 96 the loader's per-thread offsets are formed here, each
        // tile, not held across the loop: within 128 registers they spill
        const int ltid = DP > 96 ? (int)opaque(tid) : tid;
        load_tile_async<64, DP, THREADS>(st, kg, ksn, tn * 64, n, d, ltid);
        load_tile_async<64, DP, THREADS>(st + KV_TILE, vg, vsn, tn * 64, n, d, ltid);
      }
      cp_async_commit();
    }
    const uint32_t k_s = kv_s + (t % STAGES) * 2 * KV_TILE;
    const uint64_t v_desc = tile_desc(k_s + KV_TILE);
    const int k0 = t * 64;
    // past DP 64 Q's descriptors are formed here, each tile, not held
    // across the loop: the registers go to the accumulator
    const uint32_t q_at = DP > 64 ? opaque(q_rows) : q_rows;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<64, 0, 0>(s, k_slice_desc(q_at, kk, Q_PANEL),
                         k_slice_desc(k_s, kk, KV_PANEL), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scaled logits in the log2 domain; keys at or past n get -inf. Every
    // tile holds at least one key below n, so the new max is finite and the
    // first tile's alpha is exp2(-inf) = 0.
    const bool ragged = k0 + 64 > n;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (ragged && k0 + frag_col(t128, i) >= n) x = -INFINITY;
      s[i] = x;
      if ((i >> 1) & 1) {
        mx1 = fmaxf(mx1, x);
      } else {
        mx0 = fmaxf(mx0, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2_approx(m0 - mn0);
    const float alpha1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    uint32_t p[16];
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = exp2_approx(s[4 * j] - mn0);
      const float p01 = exp2_approx(s[4 * j + 1] - mn0);
      const float p10 = exp2_approx(s[4 * j + 2] - mn1);
      const float p11 = exp2_approx(s[4 * j + 3] - mn1);
      ps0 += p00 + p01;
      ps1 += p10 + p11;
      p[2 * j] = pack_bf16(p00, p01);
      p[2 * j + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
    acc.scale_rows(alpha0, alpha1);

    acc.fence();
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc.add_rs(p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                 v_desc + kk * K_SLICE_MN_MAJOR, KV_PANEL);
    }
    wgmma_commit();
    wgmma_wait<0>();
    acc.fence();
    fence_regs(p);
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  acc.scale_rows(1.0f / l0, 1.0f / l1);
  // each warp stages its 16 rows in its own rows of the Q tile, which only
  // its own (finished) products read
  const int row0 = q0 + wgi * 64;  // first row of the warpgroup
  store_wide_rows(acc, q_rows, Q_PANEL, o + (((long long)b * n + row0) * heads + h) * d,
                  (long long)heads * d, n - row0, d);
  if (lse != nullptr && (lane & 3) == 0) {
    const int r = row0 + frag_row(t128, 0);
    float* lse_bh = lse + ((long long)b * heads + h) * n;
    if (r < n) lse_bh[r] = (m0 + log2f(l0)) * 0.6931471805599453f;
    if (r + 8 < n) lse_bh[r + 8] = (m1 + log2f(l1)) * 0.6931471805599453f;
  }
}

}  // namespace wg

// ---- float32, every head_dim: the TF32 three-product design ----------------
//
// A block of W warps owns 16 W query rows of one (batch, head), 16 a warp,
// with its Q rows resident in shared memory (row-major, DP + 4 floats a
// row); K and V tiles of 64 or 32 keys come through a two-stage cp.async
// ring, tile t + 1 in flight while tile t is computed, one block barrier a
// tile. Every product is three TF32 products of the split x = hi + lo
// (hopper_mma.cuh). S = Q K^T is wgmma m64nNk8 on each warpgroup (N = the
// tile's keys): Q's A fragment of a k-slice comes by ldmatrix and is split
// in registers, two k-slices a commit group; K lands as a split tile, its
// hi and lo planes in the swizzled K-major layout, split once a block by
// the threads that copied it, before the barrier that publishes it. The
// online softmax runs on S's accumulator fragment (a row lives in a quad of
// lanes) with exp2f. P V contracts over the keys, so wgmma would need V
// transposed (TF32 takes no transposed shared-memory operand) and stored
// twice: it is mma.sync m16n8k8 with P split in registers as the A operand
// under the renumbered contraction and V's B fragments two 32-bit loads
// from its row-major tile, split in registers. The tile's P V goes to fresh
// accumulators and O = O * alpha + P V is a float32 FMA (the tensor cores'
// sums would drift over 65 tiles).
//
// wgmma or mma.sync for S, timed in one call (tools/side_by_side.py, the
// trees in the order FMA parent, an mma.sync build, a build with the
// backward's scores on wgmma at every width, this, this and back, H100 80GB
// HBM3 at 700 W; the mma.sync build read K's B fragments by ldmatrix and
// split them in every warp, on 64-key tiles), f32 ms on mma.sync -> here:
// [2,197,12,64] 0.0225-0.0229 -> 0.0166-0.0169, [50,197,12,64]
// 0.2580-0.2603 -> 0.1730-0.1747, [2,4097,12,64] 1.8187-1.8313 ->
// 1.6975-1.7035, [1,4097,16,d] d = 80: 1.6717-1.6720 -> 1.3500-1.3504, 88:
// 1.7737-1.7852 -> 1.5241-1.5283, 104: 2.0532-2.0584 -> 2.0406-2.0431, 112:
// 2.2136-2.2195 -> 2.1243. S is on wgmma at every width.
//
// The tile width DP is the head_dim rounded up to 16; columns d to DP - 1
// of Q, K and V load as zeros, and the k-slice or output n-tile wholly past
// the true d (d = 8 modulo 16) is skipped at run time, so no product runs on
// zero-filled columns.

namespace x3 {

using namespace hopper;

// W warps a block: 4 (64 rows, one warpgroup) up to
// WGMMA_ONE_WARPGROUP_MAX_N tokens, 8 (128 rows: each K and V tile feeds
// twice the rows) past it. Keys a K/V tile: 64 in the 8-warp blocks up to
// DP 96, else 32 (shared memory: past DP 96 two stages of 64-key tiles do
// not fit beside 128 Q rows; a 4-warp block on 64-key tiles leaves one
// block an SM, where 32-key tiles leave three: the crops' [50, 197] ran
// 2.4x slower on 64 keys). Shared memory: two ring stages of the split K
// tile, then two of the row-major V tile, then the Q rows (1024 bytes more
// for the split tiles' alignment).
template <int DP, int W>
struct Plan {
  static constexpr int BKT = W == 8 && DP <= 96 ? 64 : 32;
  static constexpr int LD = DP + F32_PAD;
  static constexpr uint32_t K_SPLIT = 2 * f32_plane_bytes(BKT, DP);
  static constexpr uint32_t V_TILE = BKT * LD * 4;
  static constexpr int SMEM = ATOM_BYTES + 2 * (K_SPLIT + V_TILE) + W * 16 * LD * 4;
};
static_assert(Plan<128, 8>::SMEM <= 232448 && Plan<96, 8>::SMEM <= 232448,
              "shared-memory plan too large");

template <int DP, int W>
__global__ void __launch_bounds__(W * 32)
    flash_fwd_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int n, int d, int heads,
                        long long qsb, long long qsn, long long qsh,
                        long long ksb, long long ksn, long long ksh,
                        long long vsb, long long vsn, long long vsh,
                        float scale_log2) {
  using P = Plan<DP, W>;
  constexpr int BKT = P::BKT;
  constexpr int THREADS = W * 32;
  constexpr int LD = P::LD;
  constexpr int ROWS = W * 16;
  constexpr int KT = DP / 8;  // k-slices of the head_dim, n-tiles of the output
  constexpr int NJ = BKT / 8;  // n-tiles of S, k-slices of P V
  constexpr uint32_t LO_UNITS = f32_plane_bytes(BKT, DP) >> 4;
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // the fragment's row (of 8) and column pair
  const int c = lane & 3;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* kg = k + b * ksb + h * ksh;
  const float* vg = v + b * vsb + h * vsh;

  const uint32_t base = align_1024(smem_u32(smem));
  const uint32_t k_split = base;                   // two stages
  const uint32_t v_s = base + 2 * P::K_SPLIT;      // two stages
  const uint32_t q_s = v_s + 2 * P::V_TILE;
  const float* smem_f = reinterpret_cast<const float*>(smem + (base - smem_u32(smem)));
  const int n_tiles = (n + BKT - 1) / BKT;

  load_rows_f32<ROWS, DP, THREADS>(q_s, q + b * qsb + h * qsh, qsn, q0, n, d, tid);
  load_split_async<BKT, DP, THREADS>(k_split, kg, ksn, 0, n, d, tid);
  load_rows_f32<BKT, DP, THREADS>(v_s, vg, vsn, 0, n, d, tid);
  cp_async_commit();

  const uint32_t qa = q_s + warp * 16 * LD * 4 + a_lane_offset<LD>(lane);
  const int vb = b_rows_lane<LD>(lane);

  float acc[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8, log2 domain
  float l0 = 0.0f, l1 = 0.0f;            // this thread's share of their sums

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    cp_async_wait<0>();  // this thread's part of tile t has landed
    split_tile<BKT, DP, THREADS>(k_split + st * P::K_SPLIT, tid);
    fence_async_proxy();
    __syncthreads();     // tile t complete and split; every warp is done with tile t - 1
    if (t + 1 < n_tiles) {
      load_split_async<BKT, DP, THREADS>(k_split + (st ^ 1) * P::K_SPLIT, kg, ksn, (t + 1) * BKT,
                                         n, d, tid);
      load_rows_f32<BKT, DP, THREADS>(v_s + (st ^ 1) * P::V_TILE, vg, vsn, (t + 1) * BKT, n, d,
                                      tid);
    }
    cp_async_commit();
    const uint32_t k_t = k_split + st * P::K_SPLIT;
    const int k0 = t * BKT;

    // S = Q K^T of the warpgroup's 64 rows and the tile's keys: per k-slice
    // the warp's Q fragment split in registers, K's planes by descriptor.
    // Register 4 j + i is an mma.sync C fragment: n-tile j is keys 8 j .. 8 j + 7
    float s[BKT / 2];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk + 1 < KT || 8 * kk < d) {
        SplitA a;
        a_frag(a, qa, kk);
        wgmma_fence();
        wgmma_tf32x3<BKT>(s, a, k_slice_desc(k_t, kk, BKT * ROW_BYTES), LO_UNITS, kk > 0);
      }
      // two k-slices a commit group, at most two groups in flight, so that
      // only their A fragments hold registers, as in the backward's scores
      // (where every slice's held to the end spilled)
      if (kk & 1) {
        wgmma_commit();
        if (kk + 1 < KT) wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();
    fence_regs(s);

    // scaled logits in the log2 domain; keys at or past n get -inf. Every
    // tile holds at least one key below n, so the new max is finite and the
    // first tile's alpha is exp2(-inf) = 0.
    const bool ragged = k0 + BKT > n;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BKT / 2; ++i) {
      float x = s[i] * scale_log2;
      if (ragged && k0 + 8 * (i >> 2) + 2 * c + (i & 1) >= n) x = -INFINITY;
      s[i] = x;
      if ((i >> 1) & 1) {
        mx1 = fmaxf(mx1, x);
      } else {
        mx0 = fmaxf(mx0, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0);
    const float alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // O = O * alpha + P V, the tile's P V summed apart (a fresh accumulator
    // a column tile). k-slice kk of the value product is S's n-tile kk, P's
    // slots renumbered (c0, c2, c1, c3 are a0..a3), V's rows 8 kk + 2 c and
    // 8 kk + 2 c + 1 its B fragment.
    const float* v_rows = smem_f + (v_s - base) / 4 + st * (P::V_TILE / 4) + vb;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      s[4 * kk] = exp2f(s[4 * kk] - mn0);
      s[4 * kk + 1] = exp2f(s[4 * kk + 1] - mn0);
      s[4 * kk + 2] = exp2f(s[4 * kk + 2] - mn1);
      s[4 * kk + 3] = exp2f(s[4 * kk + 3] - mn1);
      ps0 += s[4 * kk] + s[4 * kk + 1];
      ps1 += s[4 * kk + 2] + s[4 * kk + 3];
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
    float pv[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[j][i] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      SplitA p;
      p.set(s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]);
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j + 1 < KT || 8 * j < d) {
          SplitB bv;
          b_rows<LD>(bv, v_rows, kk, j);
          mma_tf32x3(pv[j], p, bv);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      acc[j][0] = fmaf(acc[j][0], alpha0, pv[j][0]);
      acc[j][1] = fmaf(acc[j][1], alpha0, pv[j][1]);
      acc[j][2] = fmaf(acc[j][2], alpha1, pv[j][2]);
      acc[j][3] = fmaf(acc[j][3], alpha1, pv[j][3]);
    }
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  float* o0 = o + (((long long)b * n + r0) * heads + h) * d + 2 * c;
  float* o1 = o0 + 8LL * heads * d;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j + 1 < KT || 8 * j < d) {  // the zero-filled columns are not stored
      if (r0 < n) *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(acc[j][0] * inv0, acc[j][1] * inv0);
      if (r0 + 8 < n) *reinterpret_cast<float2*>(o1 + 8 * j) = make_float2(acc[j][2] * inv1, acc[j][3] * inv1);
    }
  }
  if (lse != nullptr && c == 0) {
    float* lse_bh = lse + ((long long)b * heads + h) * n;
    if (r0 < n) lse_bh[r0] = (m0 + log2f(l0)) * 0.6931471805599453f;
    if (r0 + 8 < n) lse_bh[r0 + 8] = (m1 + log2f(l1)) * 0.6931471805599453f;
  }
}

}  // namespace x3

// Which design a call takes: fixed by dtype and head_dim.
enum Design { DESIGN_WMMA = 1, DESIGN_WGMMA = 2, DESIGN_TF32X3 = 3 };

constexpr Design design_rule(bool is_f32, int head_dim) {
  return is_f32 ? DESIGN_TF32X3 : head_dim >= 64 ? DESIGN_WGMMA : DESIGN_WMMA;
}

// The head dims taken: multiples of 8 up to 128.
constexpr bool head_dim_taken(int head_dim) {
  return head_dim % 8 == 0 && head_dim >= 8 && head_dim <= 128;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int batch, n, heads, head_dim;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh;
  float scale_log2;
  cudaStream_t stream;
};

template <int DP, int NWG>
cudaError_t launch_wgmma_blocks(const Args& a) {
  auto kern = wg::flash_fwd_wgmma_kernel<DP, NWG>;
  constexpr int bytes = wg::smem_bytes<DP, NWG>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + NWG * 64 - 1) / (NWG * 64), a.heads, a.batch);
  kern<<<grid, NWG * 128, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.lse,
      a.n, a.head_dim, a.heads, a.qsb, a.qsn, a.qsh, a.ksb, a.ksn, a.ksh, a.vsb, a.vsn,
      a.vsh, a.scale_log2);
  return cudaGetLastError();
}

// rows a block, from the shape: short sequences (the crop passes) give few
// blocks a (batch, head), so they take 64-row blocks
template <int DP>
cudaError_t launch_wgmma(const Args& a) {
  return a.n > WGMMA_ONE_WARPGROUP_MAX_N ? launch_wgmma_blocks<DP, 2>(a)
                                         : launch_wgmma_blocks<DP, 1>(a);
}

template <int DP, int W>
cudaError_t launch_x3_blocks(const Args& a) {
  auto kern = x3::flash_fwd_x3_kernel<DP, W>;
  constexpr int bytes = x3::Plan<DP, W>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + W * 16 - 1) / (W * 16), a.heads, a.batch);
  kern<<<grid, W * 32, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.n, a.head_dim,
      a.heads, a.qsb, a.qsn, a.qsh, a.ksb, a.ksn, a.ksh, a.vsb, a.vsn, a.vsh, a.scale_log2);
  return cudaGetLastError();
}

// float32: rows a block from the shape, as the bf16 warpgroup design does
// (short sequences take 64-row blocks)
template <int DP>
cudaError_t launch_x3(const Args& a) {
  return a.n > WGMMA_ONE_WARPGROUP_MAX_N ? launch_x3_blocks<DP, 8>(a) : launch_x3_blocks<DP, 4>(a);
}

// The WMMA design (bf16 below head_dim 64). D: the tile width, a.head_dim
// rounded up to 16.
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
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.n, a.head_dim, a.heads,
      a.qsb, a.qsn, a.qsh, a.ksb, a.ksn, a.ksh, a.vsb, a.vsn, a.vsh, a.scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  if (!head_dim_taken(a.head_dim)) return cudaErrorInvalidValue;
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

// dtype: 0 = float32, 1 = bfloat16. q, k, v: [batch, n, heads, head_dim],
// head_dim a multiple of 8 up to 128, with unit stride on head_dim and the
// given element strides for batch, token and head (16-byte aligned rows); o:
// contiguous [batch, n, heads, head_dim]; lse: null, or contiguous float32
// [batch, heads, n] for the natural-log row log-sum-exp of the scaled logits.
// Returns the launch's cudaError_t.
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
               heads, head_dim, qsb, qsn, qsh, ksb, ksn, ksh, vsb,   vsn, vsh,
               scale * 1.4426950408889634f,  // fold log2(e): exp -> exp2
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch<float>(a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

// The design that clipself_flash_fwd runs for this dtype and head_dim:
// 1 = WMMA tiles (bf16 below head_dim 64), 2 = wgmma (bf16 at head_dim
// 64-128), 3 = the TF32 three-product split (float32); -1 if the pair is not
// taken.
extern "C" int clipself_flash_fwd_design(int dtype, int head_dim) {
  if (!head_dim_taken(head_dim)) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  return design_rule(dtype == 0, head_dim);
}

extern "C" const char* clipself_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
