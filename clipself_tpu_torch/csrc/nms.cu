// Greedy non-maximum suppression over score-sorted boxes, all images of a
// batch in one call: a suppression bit matrix built by the whole card, then
// a block-wise scan of it.
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
// The TPU kernel walks one image's boxes one after the other on one core.
// On the H100 that order is the bound: neither device-memory bytes (20 N
// read, N written) nor the arithmetic (N (N - 1) / 2 IoUs of ~14 operations)
// but the chain of decisions. Whether box j overlaps box i does not depend
// on any decision, only whether box i is kept does, so the work is split:
//
// 1. nms_matrix_kernel, on every SM: the [N, ceil(N / 64)] matrix of 64-bit
//    words whose bit j % 64 of word (i, j / 64) says "j > i and
//    iou(i, j) > thr". A block stages the 64 boxes of one column word (and
//    their areas) in shared memory, a thread owns one row box and writes one
//    word. Words left of the diagonal word of a row are never written and
//    never read. Validity is not folded in.
// 2. nms_scan_kernel, one block an image: `removed` (a bit a box, in shared
//    memory) starts as ~valid. For each block of 64 boxes in order, the 64
//    boxes are resolved against the block's diagonal words (box r is kept
//    iff its bit is clear; if kept, its diagonal word is ORed in: 64 short
//    dependent register steps, a bit test and two ORs under its predicate,
//    done by every thread alike so that the result needs no broadcast), then
//    the rows of the kept boxes are ORed into the later words of `removed`,
//    a word a lane, the 64 rows split over the block's warps. A suppressed
//    box suppresses nothing because its row is never ORed. Which rows a
//    block needs does not depend on the decisions, so a thread loads its
//    words of the next tile (64 rows by 32 words) into a second set of
//    registers while this tile is resolved; only the 64 diagonal words pass
//    through shared memory, and one barrier a tile orders everything. (A
//    cp.async ring in shared memory was measured first: issuing its 8-byte
//    copies cost as much as the resolution itself.) The chain is
//    ceil(N / 64) links (32 at N = 2000) instead of one barrier a kept box
//    (1095-1884 there).
//
// The matrix is scratch from the caller ([batch, N, ceil(N / 64)] words,
// 4.1 MB at [8, 2000]: it stays in the L2); nothing is allocated here and no
// block's shared memory has to hold an image's boxes (the scan keeps N / 8
// bytes of `removed`, and takes up to 131072 boxes an image).
//
// The keep mask is discrete, so the arithmetic is pinned: every product,
// sum, difference and quotient is a single IEEE round-to-nearest operation
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn are never contracted into an
// FMA), in the operand order of the TPU kernel. A pair with an empty
// intersection has iou 0, which no threshold >= 0 is below: it is done
// without the y extents, the areas and the division (a NaN intersection
// compares false either way); below zero the shortcut is off. The plain
// PyTorch versions (ops/nms.py) do the same operations one by one, and the
// masks are compared for equality, not within a tolerance.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kWord = 64;        // boxes a word of the matrix
constexpr int kChunkWords = 32;  // words of a row in one tile of the scan: a lane each
// the scan's `removed` row lives in the shared memory that a block may take
// without asking: 2048 words are 131072 boxes an image
constexpr int kMaxWords = 2048;
// Rows a block of the matrix kernel (a multiple of kWord) and warps of the
// scan's block (a thread holds kWord / kScanParts rows of one word in
// registers). On an H100 at 2000 boxes an image, 64-512 rows and 4-16 warps
// all came within 8% of this pair.
constexpr int kMatrixRows = 128;
constexpr int kScanParts = 8;

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// Whether the earlier box i (bi, area ai) suppresses the later box j.
__device__ __forceinline__ bool suppresses(const float4 bi, const float ai,
                                           const float4 bj, const float aj,
                                           const float thr, const bool skip_empty) {
  const float iw = fmaxf(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 0.0f);
  if (skip_empty && !(iw > 0.0f)) return false;
  const float ih = fmaxf(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (skip_empty && !(inter > 0.0f)) return false;
  const float uni = fmaxf(__fsub_rn(__fadd_rn(aj, ai), inter), 1e-6f);
  return __fdiv_rn(inter, uni) > thr;
}

// One word of the matrix: the 64 column boxes staged in shared memory
// against the row box i. EDGE: the word holds the diagonal or the end of the
// image, so each j is tested for first <= j < last.
template <bool EDGE>
__device__ __forceinline__ u64 matrix_word(const float4 bi, const float ai,
                                           const float4* cbox, const float* carea,
                                           const float thr, const int first,
                                           const int last) {
  const bool skip_empty = thr >= 0.0f;
  u64 word = 0;
#pragma unroll 8
  for (int jj = 0; jj < kWord; ++jj) {
    if (EDGE && (jj < first || jj >= last)) continue;
    if (suppresses(bi, ai, cbox[jj], carea[jj], thr, skip_empty)) word |= 1ull << jj;
  }
  return word;
}

// grid (column word, row block, image); kMatrixRows threads, a row each.
__global__ void nms_matrix_kernel(const float4* __restrict__ boxes, const float thr,
                                  u64* __restrict__ matrix, const int n, const int words) {
  const int cw = blockIdx.x;
  const int col0 = cw * kWord;
  const int row0 = blockIdx.y * kMatrixRows;
  // row i needs word cw iff cw >= i / 64: a block wholly below the diagonal
  // has nothing to write
  if (col0 + kWord - 1 < row0) return;

  __shared__ float4 cbox[kWord];
  __shared__ float carea[kWord];
  const long long base = (long long)blockIdx.z * n;
  if (threadIdx.x < kWord && col0 + threadIdx.x < n) {
    const float4 b = boxes[base + col0 + threadIdx.x];
    cbox[threadIdx.x] = b;
    carea[threadIdx.x] = box_area(b);
  }
  __syncthreads();

  const int i = row0 + threadIdx.x;
  if (i >= n || col0 + kWord - 1 < i) return;
  const float4 bi = boxes[base + i];
  const float ai = box_area(bi);
  const int first = i >= col0 ? i - col0 + 1 : 0;  // only later boxes, j > i
  const int last = min(kWord, n - col0);           // and none past the end
  // the same branch for a whole block unless it holds the diagonal
  const u64 word = first == 0 && last == kWord
                       ? matrix_word<false>(bi, ai, cbox, carea, thr, first, last)
                       : matrix_word<true>(bi, ai, cbox, carea, thr, first, last);
  matrix[(base + i) * words + cw] = word;
}

// One step of a block's resolution: if the bit of `probe`'s box is clear,
// the box is kept and its diagonal word (dx, dy) is ORed in. A bit test and
// ORs under its predicate: the shortest chain from one step to the next.
__device__ __forceinline__ void resolve_low(unsigned& lo, unsigned& hi, const uint2 d,
                                            const unsigned bit) {
  asm("{\n .reg .pred p;\n .reg .b32 t;\n and.b32 t, %0, %4;\n setp.eq.u32 p, t, 0;\n"
      " @p or.b32 %0, %0, %2;\n @p or.b32 %1, %1, %3;\n}"
      : "+r"(lo), "+r"(hi)
      : "r"(d.x), "r"(d.y), "r"(bit));
}
__device__ __forceinline__ void resolve_high(unsigned& hi, const unsigned dy,
                                             const unsigned bit) {
  asm("{\n .reg .pred p;\n .reg .b32 t;\n and.b32 t, %0, %2;\n setp.eq.u32 p, t, 0;\n"
      " @p or.b32 %0, %0, %1;\n}"
      : "+r"(hi)
      : "r"(dy), "r"(bit));
}

// The scan walks tiles (k, w0): words w0 .. w0 + 31 of the 64 rows of box
// block k, the diagonal tile (w0 == k) of a block first.
__device__ __forceinline__ void next_tile(int& k, int& w0, const int words) {
  w0 += kChunkWords;
  if (w0 >= words) {
    ++k;
    w0 = k;
  }
}

// grid (image); 32 * kScanParts threads. A thread holds one word (its lane)
// of kWord / kScanParts rows (its warp) of a tile in registers. Dynamic
// shared memory: `words` words of `removed`.
__global__ void __launch_bounds__(32 * kScanParts)
    nms_scan_kernel(const u64* __restrict__ matrix, const unsigned char* __restrict__ valid,
                    unsigned char* __restrict__ keep, const int n, const int words) {
  constexpr int kRows = kWord / kScanParts;
  static_assert(kChunkWords == 32 && kRows >= 1 && kRows <= 32, "a lane a word");
  __shared__ uint2 diag[2][kWord];  // a block's diagonal words, for every thread
  extern __shared__ __align__(8) u64 removed[];
  const int tid = threadIdx.x, lane = tid & 31, part = tid >> 5;
  const long long base = (long long)blockIdx.x * n;

  // this thread's words of tile (k, w0); what does not exist reads as 0
  auto fetch = [&](const int k, const int w0, u64(&rows)[kRows]) {
    const int w = w0 + lane;
    const int row0 = k * kWord + part * kRows;
    const u64* src = matrix + (base + row0) * words + w;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      rows[i] = k < words && w < words && row0 + i < n ? __ldg(src + (long long)i * words) : 0;
    }
  };

  u64 kept = 0;       // the block's kept boxes
  unsigned mine = 0;  // those of this thread's rows
  // One tile: publish and resolve the diagonal words if it is a block's
  // first, then OR the kept rows into the later words of `removed`.
  auto step = [&](const int k, const int w0, const u64(&rows)[kRows], const int buf) {
    const bool first = w0 == k;
    if (first && lane == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        diag[buf][part * kRows + i] = make_uint2((unsigned)rows[i], (unsigned)(rows[i] >> 32));
      }
    }
    // the diagonal words are there, and so is every OR of the tiles before
    __syncthreads();
    if (first) {
      // bit j of a row is set only for j > i, so a box's own bit is final
      // when its turn comes, and the kept boxes are the bits still clear at
      // the end. Rows past the end read as 0 and their bits start set.
      const u64 cur = removed[k];
      unsigned lo = (unsigned)cur, hi = (unsigned)(cur >> 32);
#pragma unroll
      for (int r = 0; r < 32; ++r) resolve_low(lo, hi, diag[buf][r], 1u << r);
#pragma unroll
      for (int r = 0; r < 32; ++r) resolve_high(hi, diag[buf][32 + r].y, 1u << r);
      kept = ~(((u64)hi << 32) | lo);
      mine = (unsigned)(kept >> (part * kRows)) & (unsigned)((1ull << kRows) - 1);
      const int j = k * kWord + tid;
      if (tid < kWord && j < n) keep[base + j] = (unsigned char)((kept >> tid) & 1ull);
    }
    const int w = w0 + lane;
    if (w < words && w != k) {  // the diagonal word is done with
      u64 acc = 0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (mine & (1u << i)) acc |= rows[i];
      }
      // the warps of one word meet here, in 32-bit atomics
      unsigned* word = reinterpret_cast<unsigned*>(&removed[w]);
      if ((unsigned)acc) atomicOr(word, (unsigned)acc);
      if ((unsigned)(acc >> 32)) atomicOr(word + 1, (unsigned)(acc >> 32));
    }
  };

  u64 rows_a[kRows], rows_b[kRows];
  int k = 0, w0 = 0;
  fetch(k, w0, rows_a);

  // invalid slots, and the bits past the end, start suppressed: a warp reads
  // 32 validity bytes side by side and votes them into half a word
  unsigned* removed32 = reinterpret_cast<unsigned*>(removed);
#pragma unroll 4
  for (int j = tid; j < words * kWord; j += 32 * kScanParts) {
    const bool gone = j >= n || !valid[base + j];
    const unsigned votes = __ballot_sync(0xffffffffu, gone);
    if (lane == 0) removed32[j >> 5] = votes;
  }

  // two tiles a round, so that the next tile's loads are in flight in the
  // other set of registers while this one is resolved
  while (k < words) {
    int nk = k, nw0 = w0;
    next_tile(nk, nw0, words);
    fetch(nk, nw0, rows_b);
    step(k, w0, rows_a, 0);
    if (nk >= words) break;
    k = nk, w0 = nw0;
    next_tile(k, w0, words);
    fetch(k, w0, rows_a);
    step(nk, nw0, rows_b, 1);
  }
}

}  // namespace

// boxes: contiguous float32 [batch, n, 4] xyxy, sorted by score within each
// image, 16-byte aligned; valid: bytes [batch, n] (nonzero = a real box);
// matrix: scratch of batch * n * ceil(n / 64) 64-bit words, 8-byte aligned;
// keep: bytes [batch, n], written 1 (kept) or 0; n at most 131072.
// Returns the first launch's cudaError_t that is not cudaSuccess.
extern "C" int clipself_nms(const void* boxes, const void* valid, float thr,
                            void* matrix, void* keep, int batch, int n, void* stream) {
  if (batch < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return (int)cudaSuccess;
  const int words = (n + kWord - 1) / kWord;
  const int row_blocks = (n + kMatrixRows - 1) / kMatrixRows;
  if (words > kMaxWords || batch > 65535 || row_blocks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_matrix_kernel<<<dim3(words, row_blocks, batch), kMatrixRows, 0, s>>>(
      static_cast<const float4*>(boxes), thr, static_cast<u64*>(matrix), n, words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<batch, 32 * kScanParts, (size_t)words * sizeof(u64), s>>>(
      static_cast<const u64*>(matrix), static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), n, words);
  return (int)cudaGetLastError();
}
