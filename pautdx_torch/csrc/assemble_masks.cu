// YOLO-seg prototype mask decode, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pautdx/ops/pallas_mask.py::pallas_assemble_masks
// (_mask_kernel): for each image b, detection k and proto pixel (y, x),
//   out[b, k, y, x] = sigmoid(sum_p coeffs[b, k, p] * protos[b, y, x, p])
// inside the box scaled to proto pixels, [x1, x2) x [y1, y2) on the float
// pixel indices, and 0 outside. Boxes arrive in image pixels; the kernel
// scales them by (sx, sy) = (Wp / W, Hp / H) in f32, as the TPU wrapper
// does before its kernel.
//
// What bounds it on the H100: bytes. At the YOLO-seg predict shape
// (B = 32, 160 x 160 protos, P = 32, K = 100) it reads 105 MB of protos and
// writes 328 MB of masks, about 0.13 ms at 3.35 TB/s, against 5.2 GFLOP of
// f32 dot products (0.08 ms at 67 TFLOP/s on the CUDA cores). The TPU
// kernel's (K, P) x (P, TH * Wp) MXU tile is shaped for the TPU; here the
// product is too thin (P = 32) to pay for tensor cores, and the output
// write is the cost to keep at its floor.
//
// Design: one thread per proto pixel, a 256-thread block over a run of
// pixels of one image. The thread loads its pixel's P values once (P * 4
// contiguous bytes in NHWC, as float4) into registers. The image's
// coefficients and scaled boxes sit in shared memory (K * (P + 4) floats,
// 14.4 KB at K = 100). The thread loops over k: the window test first, and
// only inside the box the P-term dot product and the sigmoid; then it
// stores out[b, k, pixel], so a warp writes 128 contiguous bytes per k.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int P = 32;               // prototypes: Ultralytics' nm

__global__ void masks_kernel(const float* __restrict__ protos,
                             const float* __restrict__ coeffs,
                             const float* __restrict__ boxes,
                             float* __restrict__ out, int K, int Hp, int Wp,
                             float sx, float sy) {
  extern __shared__ float smem[];
  float* s_coeffs = smem;              // K * P
  float* s_boxes = smem + K * P;       // K * 4, scaled to proto pixels
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < K * P; i += blockDim.x)
    s_coeffs[i] = coeffs[(long long)b * K * P + i];
  for (int i = threadIdx.x; i < K * 4; i += blockDim.x)
    s_boxes[i] = boxes[(long long)b * K * 4 + i] * ((i & 1) ? sy : sx);
  __syncthreads();

  const int npix = Hp * Wp;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= npix) return;
  const float row = (float)(pix / Wp);
  const float col = (float)(pix % Wp);

  float pr[P];
  const float4* src =
      reinterpret_cast<const float4*>(protos + ((long long)b * npix + pix) * P);
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    const float4 v = __ldg(src + q);
    pr[4 * q] = v.x;
    pr[4 * q + 1] = v.y;
    pr[4 * q + 2] = v.z;
    pr[4 * q + 3] = v.w;
  }

  float* dst = out + (long long)b * K * npix + pix;
  for (int k = 0; k < K; ++k) {
    const float* bx = s_boxes + 4 * k;
    float m = 0.0f;
    if (col >= bx[0] && col < bx[2] && row >= bx[1] && row < bx[3]) {
      const float* c = s_coeffs + k * P;
      float acc = 0.0f;
#pragma unroll
      for (int p = 0; p < P; ++p) acc = fmaf(c[p], pr[p], acc);
      m = 1.0f / (1.0f + expf(-acc));
    }
    dst[(long long)k * npix] = m;
  }
}

}  // namespace

// protos (B, Hp, Wp, 32), coeffs (B, K, 32), boxes (B, K, 4) in image
// pixels, out (B, K, Hp, Wp): f32, contiguous, protos 16-byte aligned,
// K * (32 + 4) * 4 bytes within a block's default 48 KB of shared memory
// (K <= 341). Returns cudaGetLastError() of the launch.
extern "C" int pautdx_assemble_masks(const void* protos, const void* coeffs,
                                     const void* boxes, void* out, int B,
                                     int K, int Hp, int Wp, int protos_dim,
                                     float sx, float sy, void* stream) {
  if (protos_dim != P) return cudaErrorInvalidValue;
  if (B == 0 || K == 0 || Hp == 0 || Wp == 0) return cudaSuccess;
  const size_t smem = (size_t)K * (P + 4) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((Hp * Wp + kThreads - 1) / kThreads, B);
  masks_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(protos), static_cast<const float*>(coeffs),
      static_cast<const float*>(boxes), static_cast<float*>(out), K, Hp, Wp,
      sx, sy);
  return cudaGetLastError();
}
