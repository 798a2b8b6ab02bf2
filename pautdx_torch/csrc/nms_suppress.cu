// Greedy NMS suppression sweep, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pautdx/ops/pallas_nms.py::nms_suppress
// (_suppress_kernel), for a batch of images at once. Input: the (K, K) f32
// IoU of each image's K score-sorted candidates and a (K,) f32 valid mask.
// keep starts as valid; in order i = 0 .. K-1, if keep[i] > 0, every j > i
// with iou[i, j] > thr gets keep[j] = 0. Output: keep (K,) f32.
//
// The kernel only compares values of its input against the threshold and
// copies valid, so it is bit-identical to the plain PyTorch loop beside it
// (pautdx_torch/ops/suppress.py).
//
// What bounds it on the H100: neither bytes nor operations but the K serial
// steps. The work at the YOLO predict shape (32 images, K = 300) is at most
// 32 x 300^2 x 4 B = 11.5 MB of IoU, read once, about 3.4 us at 3.35 TB/s;
// the sweep has a dependency chain of K steps, each a barrier and a load.
//
// Design: one block per image, one thread per candidate j (the block is K
// rounded up to a warp, so K <= 1024). The keep mask lives in shared
// memory. Step i: each thread loads iou[i, j] for its own j before the
// barrier (row i is read coalesced, and the load's latency overlaps the
// wait), then after the barrier reads keep[i] as a broadcast and clears its
// own keep[j]. Only thread j writes keep[j], and keep[i] is not written in
// step i, so one barrier per step orders everything.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 1024;

__global__ void suppress_kernel(const float* __restrict__ iou,
                                const float* __restrict__ valid,
                                float* __restrict__ keep, int K, float thr) {
  __shared__ float s_keep[kMaxK];
  const int j = threadIdx.x;
  const long long b = blockIdx.x;
  const float* rows = iou + b * K * K;
  if (j < K) s_keep[j] = valid[b * K + j];
  for (int i = 0; i < K; ++i) {
    const float v = (j > i && j < K) ? __ldg(rows + (long long)i * K + j)
                                     : 0.0f;
    __syncthreads();
    if (j > i && j < K && s_keep[i] > 0.0f && v > thr) s_keep[j] = 0.0f;
  }
  __syncthreads();
  if (j < K) keep[b * K + j] = s_keep[j];
}

}  // namespace

// iou (B, K, K), valid (B, K), keep (B, K): f32, contiguous, 1 <= K <= 1024.
// Returns cudaGetLastError() of the launch.
extern "C" int pautdx_nms_suppress(const void* iou, const void* valid,
                                   void* keep, int B, int K, float thr,
                                   void* stream) {
  if (B == 0) return cudaSuccess;
  if (B < 0 || K < 1 || K > kMaxK) return cudaErrorInvalidValue;
  const int threads = (K + 31) / 32 * 32;
  suppress_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const float*>(valid),
      static_cast<float*>(keep), K, thr);
  return cudaGetLastError();
}
