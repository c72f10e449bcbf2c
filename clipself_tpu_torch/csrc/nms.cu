// Greedy non-maximum suppression over score-sorted boxes, all images of a
// batch in one launch.
//
// Replaces the TPU kernel clipself_tpu/ops/nms_pallas.py:_nms_kernel (launched
// by nms_keep_mask), which keeps the four coordinate rows, the areas and a
// suppression row on-core and walks the boxes in score order: a box that no
// kept box has suppressed is kept and suppresses every later box j with
//
//     iou = inter / max(area_j + area_i - inter, 1e-6) > thr      (strict)
//     inter = max(min(x1_j, x1_i) - max(x0_j, x0_i), 0)
//           * max(min(y1_j, y1_i) - max(y0_j, y0_i), 0)
//     area  = max(x1 - x0, 0) * max(y1 - y0, 0)
//
// Invalid slots start suppressed; a suppressed box suppresses nothing.
//
// The TPU kernel picks box i's scalars out of lane-major rows with masked row
// sums, pads N to 128 lanes and is vmapped over images; none of that carries
// over. Here one thread block owns one image: its coordinates, areas (five
// float rows) and a byte row of suppression flags live in shared memory
// (21 bytes a box), the block's threads stride over the later boxes j, and
// one __syncthreads() follows each KEPT box (a suppressed box costs one
// broadcast read of its flag and no barrier). Any N is taken as it is.
//
// Bound on the H100: neither device-memory bytes (20 N read, N written) nor
// the card's arithmetic (at most N^2 / 2 IoUs of ~12 operations) but the
// sequence: box i + 1 cannot be judged before box i's row is done, and one
// image's rows all run on ONE streaming multiprocessor. An image costs
// (kept boxes) x (one barrier + ceil((N - i) / threads) IoUs a thread); at
// N = 2000 with ~1100 kept that is ~1 M IoUs of some 60 instructions through
// one SM's four schedulers, which is what the measured time amounts to
// (PERF.md). The batch's images run side by side on separate SMs, so a batch
// costs what its slowest image costs. 1024 threads a block measured fastest
// (128: 3.3x slower), and leaving a pair at its first empty extent (most
// pairs of a spread-out set are disjoint) took 18% off the RPN's candidates
// and 38% off the class-offset ones. The design that would spread one image over the card
// builds the [N, N / 64] bit matrix of IoU > thr on all SMs and scans it with
// one warp; it computes the same mask.
//
// The keep mask is discrete, so the arithmetic is pinned: every product,
// sum, difference and quotient is a single IEEE round-to-nearest operation
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn are never contracted into an
// FMA), in the operand order of the TPU kernel. The plain PyTorch version
// (ops/nms.py:nms_keep_mask_plain) does the same operations one by one, and
// the two masks are compared for equality, not within a tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kBytesPerBox = 5 * (int)sizeof(float) + 1;
constexpr int kStaticLimit = 48 * 1024;
constexpr int kDynamicLimit = 232448;  // 227 KB a block on sm_90

__global__ void nms_kernel(const float4* __restrict__ boxes,
                           const unsigned char* __restrict__ valid, float thr,
                           unsigned char* __restrict__ keep, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* x0 = reinterpret_cast<float*>(smem);
  float* y0 = x0 + n;
  float* x1 = y0 + n;
  float* y1 = x1 + n;
  float* area = y1 + n;
  unsigned char* sup = reinterpret_cast<unsigned char*>(area + n);

  const long long base = (long long)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float4 b = boxes[base + j];
    x0[j] = b.x;
    y0[j] = b.y;
    x1[j] = b.z;
    y1[j] = b.w;
    area[j] = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                        fmaxf(__fsub_rn(b.w, b.y), 0.0f));
    sup[j] = valid[base + j] ? 0 : 1;
  }
  __syncthreads();

  const bool skip_empty = thr >= 0.0f;
  for (int i = 0; i < n; ++i) {
    // sup[i] is final here: only kept boxes before i wrote it, and a barrier
    // followed each of them. Every thread reads the same flag.
    if (sup[i]) continue;
    const float xi0 = x0[i], yi0 = y0[i], xi1 = x1[i], yi1 = y1[i];
    const float ai = area[i];
    for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
      if (sup[j]) continue;
      // an empty intersection gives iou = 0, which no threshold >= 0 is
      // below: such a pair is done without the rows of y, the areas and the
      // division (a NaN intersection compares false either way)
      const float iw =
          fmaxf(__fsub_rn(fminf(x1[j], xi1), fmaxf(x0[j], xi0)), 0.0f);
      if (skip_empty && !(iw > 0.0f)) continue;
      const float ih =
          fmaxf(__fsub_rn(fminf(y1[j], yi1), fmaxf(y0[j], yi0)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      if (skip_empty && !(inter > 0.0f)) continue;
      const float uni =
          fmaxf(__fsub_rn(__fadd_rn(area[j], ai), inter), 1e-6f);
      if (__fdiv_rn(inter, uni) > thr) sup[j] = 1;
    }
    __syncthreads();
  }

  // a box was kept exactly if nothing suppressed it
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    keep[base + j] = sup[j] ? 0 : 1;
  }
}

}  // namespace

// Largest N one block's shared memory holds.
extern "C" int clipself_nms_max_boxes() { return kDynamicLimit / kBytesPerBox; }

// boxes: contiguous float32 [batch, n, 4] xyxy, sorted by score within each
// image, 16-byte aligned; valid: bytes [batch, n] (nonzero = a real box);
// keep: bytes [batch, n], written 1 (kept) or 0. threads: the block size, a
// multiple of 32 up to 1024. Returns the launch's cudaError_t.
extern "C" int clipself_nms(const void* boxes, const void* valid, float thr,
                            void* keep, int batch, int n, int threads,
                            void* stream) {
  if (batch < 0 || n < 0 || threads < 32 || threads > 1024 || threads % 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || n == 0) return (int)cudaSuccess;
  const long long bytes = (long long)n * kBytesPerBox;
  if (bytes > kDynamicLimit) return (int)cudaErrorInvalidValue;
  if (bytes > kStaticLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  nms_kernel<<<batch, threads, (size_t)bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes),
      static_cast<const unsigned char*>(valid), thr,
      static_cast<unsigned char*>(keep), n);
  return (int)cudaGetLastError();
}
