// Fused AIFI self-attention for the D-FINE encoder, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pautdx/ops/pallas_attention.py::fused_attention
// (_attn_kernel): o = softmax(q k^T - rowmax) v for every (batch, head),
// q pre-scaled by dh^-0.5, scores and the PV sum in f32, the output in the
// input dtype. No mask, no dropout, inference only.
//
// What bounds it on the H100: at the serving shape (B=128, 8 heads, N=400,
// dh=16, bf16) the kernel must read q, k, v and write o, 52 MB, which is
// 16 us at 3.35 TB/s; its 10.5 GFLOP are 11 us on the bf16 tensor cores.
// The (B, h, N, N) score tensor (1.3 GB in f32 at that batch) is what an
// unfused chain would move, and this kernel never writes it.
//
// Design, a simple first version on the CUDA cores: one block of QT
// threads per (batch, head, tile of QT queries), one thread per query. The
// block stages the head's keys and values through shared memory in tiles
// of KT rows (converted to f32), and each thread keeps its query row, its
// f32 accumulator and a running max and sum in registers (online softmax,
// rescaled once every SUB keys), so scores live only in registers. The
// kernel reads q/k/v and writes o through (batch, head, token) strides, so
// the (B, N, D) projections are read in place: no split or merge of heads
// is ever materialised. Far from the bound (FMA- and shared-load-bound on
// the CUDA cores); wgmma tiles are a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int QT = 64;     // queries per block, one per thread
constexpr int SUB = 16;    // keys per online-softmax rescale

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);     // round to nearest even, as astype does
}

template <typename T, int DH>
__global__ void __launch_bounds__(QT)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int H, int N,
            long long sb, long long sh, long long sn) {
  constexpr int KT = 2048 / DH;   // keys per shared tile: 16 KB of f32 k+v
  __shared__ float ks[KT][DH];
  __shared__ float vs[KT][DH];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long base = b * sb + h * sh;
  const int qi = blockIdx.y * QT + threadIdx.x;
  const bool active = qi < N;     // ragged last tile: load, do not compute

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? to_f32(q[base + qi * sn + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += KT) {
    const int kn = min(KT, N - k0);
    __syncthreads();              // previous tile fully consumed
    for (int e = threadIdx.x; e < kn * DH; e += QT) {
      const int j = e / DH, d = e % DH;
      const long long off = base + (long long)(k0 + j) * sn + d;
      ks[j][d] = to_f32(k[off]);
      vs[j][d] = to_f32(v[off]);
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < kn; j0 += SUB) {
      float s[SUB];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        float dot = -INFINITY;
        if (j < kn) {
          dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], ks[j][d], dot);
        }
        s[jj] = dot;
        mx = fmaxf(mx, dot);
      }
      const float corr = expf(m - mx);   // 0 on the first step (m = -inf)
      l *= corr;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        if (j < kn) {
          const float p = expf(s[jj] - mx);
          l += p;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
        }
      }
      m = mx;
    }
  }
  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      o[base + qi * sn + d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int N, int DH, long long sb, long long sh,
                   long long sn, cudaStream_t stream) {
  const dim3 grid(B * H, (N + QT - 1) / QT);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (DH != 16) return cudaErrorInvalidValue;   // AIFI: 128 channels / 8 heads
  attn_kernel<T, 16><<<grid, QT, 0, stream>>>(qp, kp, vp, op, H, N, sb, sh,
                                              sn);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o share one layout: element (b, h, n, d) at b*sb + h*sh + n*sn + d.
// dtype 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
extern "C" int pautdx_aifi_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype,
                                     int B, int H, int N, int DH,
                                     long long sb, long long sh, long long sn,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, B, H, N, DH, sb, sh, sn, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, N, DH, sb, sh, sn, s);
  return cudaErrorInvalidValue;
}
