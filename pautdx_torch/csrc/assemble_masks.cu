// YOLO-seg prototype mask decode, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pautdx/ops/pallas_mask.py::pallas_assemble_masks
// (_mask_kernel): for each image b, detection k and proto pixel (y, x),
//   out[b, k, y, x] = sigmoid(sum_p coeffs[b, k, p] * protos[b, y, x, p])
// inside the box scaled to proto pixels, [x1, x2) x [y1, y2) on the float
// pixel indices, and 0 outside. Boxes arrive in image pixels; the kernel
// scales them by (sx, sy) = (Wp / W, Hp / H) in f32, as the TPU wrapper
// does before its kernel. Any number of prototypes P and detections K;
// f32 inputs (the wrapper casts others, as the TPU wrapper does).
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
// pixels of one image; it walks the image's detections in chunks that its
// shared memory holds (the boxes, scaled, and, while P <= 32, the
// coefficients, each row padded with zeros to 32). For each detection the
// window test comes first, and only inside the box the dot product and the
// sigmoid; then the thread stores out[b, k, pixel], so a warp writes 128
// contiguous bytes per k.
// - P <= 32 (YOLO's nm = 32): the thread keeps its pixel's P values in 32
//   registers, zero past P, loaded once as float4 when P % 4 == 0 (and
//   protos 16-byte aligned), else one float at a time; the dot runs over
//   32 terms with no bounds test.
// - P > 32: the pixel's values are re-read from L1/L2 32 at a time for
//   each detection inside its box, and the coefficients are read from
//   global memory, the same address across the warp.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int PR = 32;              // prototype values kept in registers
constexpr int kChunkBytes = 48 * 1024;

// n <= 32 values of src into r[0..32), zeros past n: float4 loads when
// src is 16-byte aligned and n % 4 == 0, else one float at a time
__device__ __forceinline__ void load_piece(const float* __restrict__ src,
                                           int n, bool vec, float (&r)[PR]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < PR / 4; ++q) {
      const float4 v = 4 * q < n
          ? __ldg(reinterpret_cast<const float4*>(src) + q)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < PR; ++p) r[p] = p < n ? __ldg(src + p) : 0.f;
  }
}

// grid (pixel runs, images); dynamic shared memory holds a chunk of kc
// detections: kc * 4 scaled box floats, then (kRegs: P <= 32) kc * 32
// padded coefficient rows. One instantiation per side of P <= 32, so that
// the predict path's carries no code (and no registers) of the other.
template <bool kRegs>
__global__ void __launch_bounds__(kThreads)
masks_kernel(const float* __restrict__ protos,
             const float* __restrict__ coeffs,
             const float* __restrict__ boxes, float* __restrict__ out,
             int K, int Hp, int Wp, int P, int kc, float sx, float sy) {
  extern __shared__ float smem[];
  float* s_boxes = smem;                 // kc * 4
  float* s_coeffs = smem + 4 * kc;       // kc * PR, kRegs only
  const int b = blockIdx.y;
  const int npix = Hp * Wp;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = pix < npix;
  const float row = (float)(pix / Wp);
  const float col = (float)(pix % Wp);
  const float* src = protos + ((long long)b * npix + (active ? pix : 0)) * P;
  const bool vec = P % 4 == 0 && (reinterpret_cast<size_t>(protos) & 15) == 0;
  const float* cb = coeffs + (long long)b * K * P;

  float pr[PR];
  if constexpr (kRegs) load_piece(src, active ? P : 0, vec, pr);

  float* dst = out + (long long)b * K * npix + pix;
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int n = min(kc, K - k0);
    __syncthreads();                     // the last chunk fully read
    for (int i = threadIdx.x; i < n * 4; i += blockDim.x)
      s_boxes[i] = boxes[((long long)b * K + k0) * 4 + i] *
                   ((i & 1) ? sy : sx);
    if constexpr (kRegs)
      for (int i = threadIdx.x; i < n * PR; i += blockDim.x) {
        const int kk = i / PR, p = i % PR;
        s_coeffs[i] = p < P ? cb[(long long)(k0 + kk) * P + p] : 0.f;
      }
    __syncthreads();
    if (!active) continue;
    for (int kk = 0; kk < n; ++kk) {
      const float* bx = s_boxes + 4 * kk;
      float m = 0.0f;
      if (col >= bx[0] && col < bx[2] && row >= bx[1] && row < bx[3]) {
        float acc = 0.0f;
        if constexpr (kRegs) {
          const float* c = s_coeffs + kk * PR;
#pragma unroll
          for (int p = 0; p < PR; ++p) acc = fmaf(c[p], pr[p], acc);
        } else {
          const float* c = cb + (long long)(k0 + kk) * P;
          for (int p0 = 0; p0 < P; p0 += PR) {
            float piece[PR];
            load_piece(src + p0, min(PR, P - p0), vec, piece);
#pragma unroll
            for (int p = 0; p < PR; ++p)
              if (p0 + p < P) acc = fmaf(__ldg(c + p0 + p), piece[p], acc);
          }
        }
        m = 1.0f / (1.0f + expf(-acc));
      }
      dst[(long long)(k0 + kk) * npix] = m;
    }
  }
}

}  // namespace

// protos (B, Hp, Wp, P), coeffs (B, K, P), boxes (B, K, 4) in image
// pixels, out (B, K, Hp, Wp): f32, contiguous, any P and K. Returns
// cudaGetLastError() of the launch.
extern "C" int pautdx_assemble_masks(const void* protos, const void* coeffs,
                                     const void* boxes, void* out, int B,
                                     int K, int Hp, int Wp, int P, float sx,
                                     float sy, void* stream) {
  if (P < 0) return cudaErrorInvalidValue;
  if (B == 0 || K == 0 || Hp == 0 || Wp == 0) return cudaSuccess;
  // detections per chunk: their boxes and (P <= 32) padded coefficients
  // within the default 48 KB of shared memory
  const int per_det = (4 + (P <= PR ? PR : 0)) * (int)sizeof(float);
  const int kc = K < kChunkBytes / per_det ? K : kChunkBytes / per_det;
  const dim3 grid((Hp * Wp + kThreads - 1) / kThreads, B);
  auto kernel = P <= PR ? masks_kernel<true> : masks_kernel<false>;
  kernel<<<grid, kThreads, (size_t)kc * per_det,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(protos), static_cast<const float*>(coeffs),
      static_cast<const float*>(boxes), static_cast<float*>(out), K, Hp, Wp,
      P, kc, sx, sy);
  return cudaGetLastError();
}
