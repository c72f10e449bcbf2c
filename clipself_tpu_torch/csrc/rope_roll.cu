// Rolled 2-D RoPE on the flat [B, N, W] q/k projection layout, one or two
// tensors (q and k) in one launch.
//
// Replaces the TPU kernel clipself_tpu/ops/rope_roll.py:_rope_kernel (launched
// by _rope_call), which computes
//
//     y = x * cos + roll(x, -1) * sin_a + roll(x, +1) * sin_b
//
// along the lane axis, with the rotation signs and lane parity folded into
// sin_a (nonzero on even lanes only) and sin_b (nonzero on odd lanes only),
// as clipself_tpu/models/rope.py:_split_sin_np builds them. Both rolls stay
// inside one (even, odd) lane pair,
//
//     y[2i]   = x[2i]   * cos[2i]   + x[2i+1] * sin_a[2i]
//     y[2i+1] = x[2i+1] * cos[2i+1] + x[2i]   * sin_b[2i+1]
//
// computed in f32 and rounded once to the output type, so the Pallas block
// plan and its in-VMEM lane rotates have no counterpart here, and the three
// [N, head_dim] tables come packed as one [N, head_dim / 2] array of
// float4 {cos[2i], cos[2i+1], sin_a[2i], sin_b[2i+1]} (ops/rope_roll.py:
// pack_tables): the zero halves of sin_a and sin_b are never stored.
//
// Bound on the H100: device-memory bytes, two multiply-adds an element
// against 2 x sizeof(T) bytes moved. The tables are the same for every head
// and every image, so the design is tiled by table row: a thread owns one
// 16-byte span of a head at one token (8 bfloat16 or 4 float32 lanes: whole
// pairs), loads that span's table entries ONCE into registers, and then walks
// heads and images at that token with one 16-byte load and one 16-byte store
// each, four of them in flight; the offset steps by additions (no division
// an element). blockIdx.y cuts the (image, head) walk into ranges, so that a
// short sequence with many images still fills the card (each range loads the
// table row again, from the L2), and blockIdx.z picks the tensor, so that q
// and k of an attention block share one launch. A head_dim whose bytes do not
// split into 16-byte spans runs the same kernel with a span of one pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Measured on an H100 at the towers' shapes: 128 or 256 threads a block and
// 2 or 4 spans in flight time alike (8 is 5-25% slower); aiming for 256 K
// threads a launch is 5-8% faster for two tensors than 64 K or 128 K.
constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // spans a thread has in flight
constexpr long long kTargetThreads = 256 * 1024;  // threads a launch aims for

struct Tensors {
  const void* x[2];
  void* y[2];
};

// VEC values of T moved as one access, widened to f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_span(const T* p, float (&f)[VEC]) {
  if constexpr (sizeof(T) == 4 && VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else if constexpr (sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x, f[1] = v.y;
  } else if constexpr (VEC == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned raw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 pair =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[i]));
      f[2 * i] = pair.x, f[2 * i + 1] = pair.y;
    }
  } else {
    const float2 pair = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = pair.x, f[1] = pair.y;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_span(T* p, const float (&f)[VEC]) {
  if constexpr (sizeof(T) == 4 && VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else if constexpr (VEC == 8) {
    unsigned raw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      raw[i] = *reinterpret_cast<const unsigned*>(&pair);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(raw[0], raw[1], raw[2], raw[3]);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(f[0], f[1]);
  }
}

// grid (blocks of token spans, ranges of the (image, head) walk, tensor).
template <typename T, int VEC>
__global__ void rope_roll_kernel(const Tensors t, const float4* __restrict__ table,
                                 const int batch, const int n, const int heads,
                                 const int head_dim, const int walk) {
  const int spans = head_dim / VEC;  // spans a head
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n * spans) return;
  const int tok = g / spans;
  const int span = g - tok * spans;

  // this span's pairs of the token's table row, read once
  float4 tab[VEC / 2];
  const float4* row = table + (long long)tok * (head_dim / 2) + span * (VEC / 2);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) tab[i] = row[i];

  const T* x = static_cast<const T*>(blockIdx.z ? t.x[1] : t.x[0]);
  T* y = static_cast<T*>(blockIdx.z ? t.y[1] : t.y[0]);
  const int width = heads * head_dim;
  const int items = batch * heads;
  const int it0 = blockIdx.y * walk;
  const int it1 = min(it0 + walk, items);
  int h = it0 % heads;
  long long off =
      ((long long)(it0 / heads) * n + tok) * width + h * head_dim + span * VEC;
  const long long next_image = (long long)(n - 1) * width;  // on top of one row

  for (int it = it0; it < it1; it += kInFlight) {
    long long offs[kInFlight];
    float f[kInFlight][VEC];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      offs[u] = off;
      off += head_dim;
      if (++h == heads) {
        h = 0;
        off += next_image;
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (it + u < it1) load_span<T, VEC>(x + offs[u], f[u]);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (it + u >= it1) continue;
      float out[VEC];
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        const float even = f[u][2 * i], odd = f[u][2 * i + 1];
        out[2 * i] = fmaf(odd, tab[i].z, even * tab[i].x);
        out[2 * i + 1] = fmaf(even, tab[i].w, odd * tab[i].y);
      }
      store_span<T, VEC>(y + offs[u], out);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const Tensors& t, int count, const void* table, int batch, int n,
                   int width, int head_dim, cudaStream_t stream) {
  const int heads = width / head_dim;
  const long long per_walk = (long long)n * (head_dim / VEC);  // threads one range takes
  const long long items = (long long)batch * heads;
  if (per_walk == 0 || items == 0) return cudaSuccess;
  if (per_walk > (1LL << 30) || items > (1LL << 30)) return cudaErrorInvalidValue;
  // as many ranges as fill the card, each at least one round of loads long
  long long ranges =
      (kTargetThreads + per_walk * count - 1) / (per_walk * count);
  const long long most = (items + kInFlight - 1) / kInFlight;
  if (ranges > most) ranges = most;
  if (ranges > 65535) ranges = 65535;
  if (ranges < 1) ranges = 1;
  const int walk = (int)((items + ranges - 1) / ranges);
  ranges = (items + walk - 1) / walk;
  const dim3 grid((unsigned)((per_walk + kThreads - 1) / kThreads), (unsigned)ranges,
                  (unsigned)count);
  rope_roll_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      t, static_cast<const float4*>(table), batch, n, heads, head_dim, walk);
  return cudaGetLastError();
}

bool aligned(const Tensors& t, int count, const void* table, size_t bytes) {
  bool ok = reinterpret_cast<size_t>(table) % 16 == 0;
  for (int i = 0; i < count; ++i) {
    ok = ok && reinterpret_cast<size_t>(t.x[i]) % bytes == 0 &&
         reinterpret_cast<size_t>(t.y[i]) % bytes == 0;
  }
  return ok;
}

// Lanes a thread moves at once: 16 bytes' worth where head_dim splits into
// such spans, else one pair.
int span_lanes(int dtype, int head_dim) {
  const int full = dtype == 0 ? 4 : 8;
  return head_dim % full == 0 ? full : 2;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. count (1 or 2) tensors x0, x1 ->
// y0, y1, each contiguous [batch, n, width] and aligned to its span's bytes;
// table: contiguous float32 [n, head_dim / 2, 4], 16-byte aligned;
// width % head_dim == 0 and head_dim even. Returns the launch's cudaError_t.
extern "C" int clipself_rope_roll(int dtype, int count, const void* x0, const void* x1,
                                  const void* table, void* y0, void* y1, int batch,
                                  int n, int width, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 0 || head_dim % 2 || width % head_dim || count < 1 || count > 2 ||
      batch < 0 || n < 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Tensors t = {{x0, x1}, {y0, y1}};
  const int span = span_lanes(dtype, head_dim);
  if (!aligned(t, count, table, (size_t)span * (dtype == 0 ? 4 : 2))) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (dtype == 0) {
    return (int)(span == 4 ? launch<float, 4>(t, count, table, batch, n, width, head_dim, s)
                           : launch<float, 2>(t, count, table, batch, n, width, head_dim, s));
  }
  return (int)(span == 8
                   ? launch<__nv_bfloat16, 8>(t, count, table, batch, n, width, head_dim, s)
                   : launch<__nv_bfloat16, 2>(t, count, table, batch, n, width, head_dim, s));
}
