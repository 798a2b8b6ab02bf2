// Greedy NMS suppression sweep, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pautdx/ops/pallas_nms.py::nms_suppress
// (_suppress_kernel), for a batch of images at once. Input: the (K, K) f32
// IoU of each image's K score-sorted candidates and a (K,) f32 valid mask.
// keep starts as valid; in order i = 0 .. K-1, if keep[i] > 0, every j > i
// with iou[i, j] > thr gets keep[j] = 0. Output: keep (K,) f32.
//
// The kernels only compare values of the input against the threshold and
// copy valid, so the result is bit-identical to the plain PyTorch loop
// beside it (pautdx_torch/ops/suppress.py).
//
// What bounds it on the H100: neither bytes nor operations but the chain
// of dependent steps. At the YOLO predict shape (32 images, K = 300) the
// IoU is 11.5 MB, of which the rows still alive need 2.6 MB (0.8 us at
// 3.35 TB/s); but whether row i acts depends on every alive row before it.
// A block-per-image sweep with one thread per candidate pays a block
// barrier and a load for each of the K steps, on 32 of the 132 SMs.
//
// Design, the parallel bitmask of GPU NMS, in two launches (the wrapper
// gives them a (B, K, ceil(K / 32)) int32 scratch from torch.empty and
// counts the pair as one launch):
// - mask_kernel, over the whole card: a warp per (image, row i). For each
//   32-bit word w it sets the bits of j in [32w, 32w + 32) with j > i,
//   j < K and iou[i, j] > thr: every load of the row is issued before any
//   is compared (coalesced 128-byte pieces, from the diagonal's word on),
//   then one __ballot_sync per word. An invalid row never acts and gets
//   no bits; words below the diagonal are 0.
// - sweep_kernel, a block per image: the image's words (12 KB at K = 300)
//   are copied into shared memory; then one warp sweeps. Lane w holds word
//   w of the removed set (K <= 1024, so at most 32 words). For each word
//   w in order, the alive bits (valid and not yet removed) are broadcast
//   by one shuffle and resolved in candidate order by 32 register
//   selects: candidate 32w + b, if alive, clears the later candidates of
//   word w that it removes, a word that lane b loaded before the chain
//   began and that a shuffle hands over off the chain. Then every lane
//   ORs the rows of the word's kept candidates into its removed word.
//   The dependent chain is a select per candidate and a shuffle per
//   word, with no block barrier and no memory access on it.
//   Then keep[j] = removed ? 0 : valid[j], written by the whole block.
// Two first versions were slower than the one-thread-per-candidate sweep
// this replaces (PERF.md): one did both phases in one block per
// image, which left the mask to 32 SMs; one walked the kept boxes with
// __ffs, a shared-memory load on the chain for each of them.
//
// Past K = 1,024 (up to 4,096, more than the TPU kernel's VMEM holds of
// its (K, K) f32 IoU, about K = 2,000) the bitmask no longer fits shared
// memory (K^2 / 8 bytes: 2 MB at K = 4,096), so a second pair of kernels
// takes over and the first pair is left as it was:
// - mask_kernel_wide walks a row's words 32 at a time, the loads of each
//   32 issued before any is compared;
// - sweep_kernel_wide copies only the diagonal blocks (word w of rows
//   32w .. 32w + 31, 16 KB at K = 4,096) into shared memory, which is all
//   the in-word resolution reads; each lane holds ceil(W / 32) words of
//   the removed set, and the rows of a word's kept candidates are read
//   from device memory (L2) once the word is resolved: all 32 rows'
//   words, masked by the alive bits, so that every load of the word is
//   issued before any is ORed and the chain pays one L2 round trip a
//   word.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 1024;          // the sweep with the mask in shared memory
constexpr int kMaxWords = kMaxK / 32;
constexpr int kMaxWideK = 4096;      // the sweep that reads rows from L2
constexpr int kMaxWideWords = kMaxWideK / 32;
constexpr int kSlots = kMaxWideWords / 32;   // removed-set words a lane
constexpr int kRowsPerBlock = 8;      // mask_kernel: a warp per row
constexpr int kSweepThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kRowsPerBlock * 32)
mask_kernel(const float* __restrict__ iou, const float* __restrict__ valid,
            unsigned* __restrict__ mask, int K, int W, float thr) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const long long b = blockIdx.y;
  if (i >= K) return;                      // warp-uniform
  const float* row = iou + (b * K + i) * K;
  unsigned* out = mask + (b * K + i) * W;
  if (!(valid[b * K + i] > 0.0f)) {        // never acts: no bits
    if (lane < W) out[lane] = 0u;
    return;
  }
  // every load of the row issued before any is used: words from the
  // diagonal on, an index past the row clamped to its last element
  float x[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w)
    if (w < W && w >= (i >> 5)) x[w] = __ldg(row + min(32 * w + lane, K - 1));
  unsigned hits = 0u;                      // bit w: this lane's j of word w
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    const int j = 32 * w + lane;
    if (w < W && w >= (i >> 5) && j > i && j < K && x[w] > thr)
      hits |= 1u << w;
  }
  unsigned word = 0u;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    if (w >= W) break;                     // warp-uniform
    const unsigned bits = __ballot_sync(kFull, hits >> w & 1u);
    if (lane == w) word = bits;
  }
  if (lane < W) out[lane] = word;
}

__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(const unsigned* __restrict__ mask,
             const float* __restrict__ valid, float* __restrict__ keep,
             int K, int W) {
  extern __shared__ unsigned s_mask[];     // K rows of W words
  __shared__ unsigned s_valid[kMaxWords];
  __shared__ unsigned s_removed[kMaxWords];
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.x;
  const float* vb = valid + b * K;
  const unsigned* mb = mask + b * K * W;
#pragma unroll 4
  for (int e = threadIdx.x; e < K * W; e += kSweepThreads) s_mask[e] = mb[e];
  for (int w = threadIdx.x >> 5; w < W; w += kSweepThreads / 32) {
    const int j = 32 * w + lane;
    const unsigned bits = __ballot_sync(kFull, j < K && vb[j] > 0.0f);
    if (lane == 0) s_valid[w] = bits;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const unsigned my_valid = lane < W ? s_valid[lane] : 0u;
    unsigned removed = 0u;
    for (int w = 0; w < W; ++w) {
      // lane l: the later candidates of word w that candidate 32w + l
      // removes; then the word's alive bits resolved in order, with the
      // shuffles off the dependent chain
      const int mine = 32 * w + lane;
      const unsigned diag = mine < K ? s_mask[mine * W + w] : 0u;
      unsigned alive = __shfl_sync(kFull, my_valid & ~removed, w);
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) {
        const unsigned r = __shfl_sync(kFull, diag, bit);
        if (alive >> bit & 1u) alive &= ~r;
      }
      // the kept candidates of word w remove their rows from every word
#pragma unroll
      for (int bit = 0; bit < 32; ++bit)
        if ((alive >> bit & 1u) && lane < W)
          removed |= s_mask[(32 * w + bit) * W + lane];
    }
    if (lane < W) s_removed[lane] = removed;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < K; j += kSweepThreads)
    keep[b * K + j] = (s_removed[j >> 5] >> (j & 31) & 1u) ? 0.0f : vb[j];
}

// K > kMaxK: the words of row i in chunks of 32, one ballot a word
__global__ void __launch_bounds__(kRowsPerBlock * 32)
mask_kernel_wide(const float* __restrict__ iou,
                 const float* __restrict__ valid, unsigned* __restrict__ mask,
                 int K, int W, float thr) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const long long b = blockIdx.y;
  if (i >= K) return;                      // warp-uniform
  const float* row = iou + (b * K + i) * K;
  unsigned* out = mask + (b * K + i) * W;
  const bool acts = valid[b * K + i] > 0.0f;   // else no bits
  for (int w0 = 0; w0 < W; w0 += 32) {
    float x[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int w = w0 + u;
      x[u] = acts && w < W && w >= (i >> 5)
                 ? __ldg(row + min(32 * w + lane, K - 1))
                 : 0.0f;
    }
    unsigned word = 0u;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int w = w0 + u;
      if (w >= W) break;                   // warp-uniform
      const int j = 32 * w + lane;
      const unsigned bits = __ballot_sync(
          kFull, acts && w >= (i >> 5) && j > i && j < K && x[u] > thr);
      if (lane == u) word = bits;
    }
    if (w0 + lane < W) out[w0 + lane] = word;
  }
}

__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel_wide(const unsigned* __restrict__ mask,
                  const float* __restrict__ valid, float* __restrict__ keep,
                  int K, int W) {
  __shared__ unsigned s_diag[kMaxWideWords * 32];   // [w][lane]
  __shared__ unsigned s_valid[kMaxWideWords];
  __shared__ unsigned s_removed[kMaxWideWords];
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.x;
  const float* vb = valid + b * K;
  const unsigned* mb = mask + b * K * W;
  for (int e = threadIdx.x; e < 32 * W; e += kSweepThreads) {
    const int w = e >> 5, r = 32 * w + (e & 31);
    s_diag[e] = r < K ? mb[(long long)r * W + w] : 0u;
  }
  for (int w = threadIdx.x >> 5; w < W; w += kSweepThreads / 32) {
    const int j = 32 * w + lane;
    const unsigned bits = __ballot_sync(kFull, j < K && vb[j] > 0.0f);
    if (lane == 0) s_valid[w] = bits;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    unsigned removed[kSlots] = {}, my_valid[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      my_valid[s] = 32 * s + lane < W ? s_valid[32 * s + lane] : 0u;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      for (int u = 0; u < 32; ++u) {
        const int w = 32 * s + u;
        if (w >= W) break;                 // warp-uniform
        // as sweep_kernel: word w's alive bits resolved in order
        const unsigned diag = s_diag[32 * w + lane];
        unsigned alive = __shfl_sync(kFull, my_valid[s] & ~removed[s], u);
#pragma unroll
        for (int bit = 0; bit < 32; ++bit) {
          const unsigned r = __shfl_sync(kFull, diag, bit);
          if (alive >> bit & 1u) alive &= ~r;
        }
        // the kept candidates' rows, from word w on (the words before it
        // are 0): every row of the word is loaded, at clamped addresses,
        // and masked by its alive bit, so that no load waits on a branch
        // and all of them are in flight before the first OR
        const unsigned* rows = mb + (long long)(32 * w) * W;
        const int last = min(31, K - 1 - 32 * w);
#pragma unroll
        for (int s2 = s; s2 < kSlots; ++s2) {
          const int w2 = min(32 * s2 + lane, W - 1);
          unsigned acc = 0u;
#pragma unroll
          for (int bit = 0; bit < 32; ++bit)
            acc |= __ldg(rows + (long long)min(bit, last) * W + w2) &
                   (0u - (alive >> bit & 1u));
          removed[s2] |= 32 * s2 + lane < W ? acc : 0u;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (32 * s + lane < W) s_removed[32 * s + lane] = removed[s];
  }
  __syncthreads();

  for (int j = threadIdx.x; j < K; j += kSweepThreads)
    keep[b * K + j] = (s_removed[j >> 5] >> (j & 31) & 1u) ? 0.0f : vb[j];
}

}  // namespace

// iou (B, K, K), valid (B, K), keep (B, K): f32, contiguous,
// 1 <= K <= 4096; mask: B * K * ceil(K / 32) words of scratch. Returns
// the first non-zero cudaError_t of the two launches.
extern "C" int pautdx_nms_suppress(const void* iou, const void* valid,
                                   void* keep, void* mask, int B, int K,
                                   float thr, void* stream) {
  if (B == 0) return cudaSuccess;
  if (B < 0 || K < 1 || K > kMaxWideK) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = (K + 31) / 32;
  const dim3 grid((K + kRowsPerBlock - 1) / kRowsPerBlock, B);
  if (K > kMaxK) {
    mask_kernel_wide<<<grid, kRowsPerBlock * 32, 0, s>>>(
        static_cast<const float*>(iou), static_cast<const float*>(valid),
        static_cast<unsigned*>(mask), K, W, thr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    sweep_kernel_wide<<<B, kSweepThreads, 0, s>>>(
        static_cast<const unsigned*>(mask), static_cast<const float*>(valid),
        static_cast<float*>(keep), K, W);
    return cudaGetLastError();
  }
  mask_kernel<<<grid, kRowsPerBlock * 32, 0, s>>>(
      static_cast<const float*>(iou), static_cast<const float*>(valid),
      static_cast<unsigned*>(mask), K, W, thr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(unsigned) * (size_t)K * W;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  sweep_kernel<<<B, kSweepThreads, smem, s>>>(
      static_cast<const unsigned*>(mask), static_cast<const float*>(valid),
      static_cast<float*>(keep), K, W);
  return cudaGetLastError();
}
