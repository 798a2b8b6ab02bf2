// Bilinear deformable sampling as a weighted row gather, and its backward,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pautdx/ops/pallas_gather.py::pallas_weighted_gather
// (_weighted_kernel) and its custom VJP (pallas_gather.py:196-210, XLA there):
//
//   out[b, t, :]  = sum_k w[b, t, k] * flat[b, j(b, t, k), :]
//   d_flat[b, j, :] += w[b, t, k] * g[b, t, :]       for every (t, k) with j
//   d_w[b, t, k]  = <g[b, t, :], flat[b, j(b, t, k), :]>
//
// with j = clip(idx, 0, L - 1), f32 throughout. d_w is taken at the clipped
// row even where the caller gave the corner weight 0, as the reference does.
// On the TPU the interpolation matrix (K nonzeros per tap row) is built in
// VMEM and multiplied on the MXU; on the H100 the same function is memory
// traffic with 2K flops per element, so both kernels move rows and do the
// arithmetic in registers.
//
// What bounds them on the H100: bytes. At the training shape (16 frames, a
// 2000-row x 128-channel f32 table per frame, T = 1200 taps, K = 4) the
// forward reads at most the 16.4 MB table plus 0.6 MB of idx/w and writes
// 9.8 MB (8.0 us at 3.35 TB/s); the backward reads g (9.8 MB), the table and
// idx/w and writes d_flat (16.4 MB) and d_w, and the wrapper zeroes d_flat
// first (about 18 us with the zeroing).
//
// Design: one warp per tap, in a grid-stride loop over taps. Lane l owns the
// float4 columns l, l + 32, ... of the row (C = 128: one float4 a lane), so a
// warp reads and writes whole 512-byte rows, coalesced. The lane reads the
// tap's K indices and weights itself (they sit in one 16-byte line for K = 4)
// and clamps. A frame's table is 1 MB and the batch's 16 MB fit the 50 MB L2,
// so corner rows shared by neighbouring taps come from L2.
// Backward: each lane adds w_k * g into d_flat's corner rows with one float4
// atomicAdd per corner (global memory, sm_90), skipping corners of weight 0,
// and forms its share of <g, row_k>; a shuffle reduction over the warp gives
// d_w. The atomics make d_flat's summation order vary from run to run: it
// matches its plain version to rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
  return acc;
}

// one 16-byte atomic where the toolkit has the vector overload (sm_90,
// CUDA 12.1 on), else four scalar ones
__device__ __forceinline__ void atomic_add4(float4* p, float4 v) {
#if __CUDACC_VER_MAJOR__ > 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(p, v);
#else
  float* q = reinterpret_cast<float*>(p);
  atomicAdd(q, v.x);
  atomicAdd(q + 1, v.y);
  atomicAdd(q + 2, v.z);
  atomicAdd(q + 3, v.w);
#endif
}

__global__ void __launch_bounds__(kThreads)
weighted_gather_fwd(const float4* __restrict__ flat, const int* __restrict__ idx,
                    const float* __restrict__ w, float4* __restrict__ out,
                    int L, int T, int K, int C4, long long taps) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long tap = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       tap < taps; tap += nwarps) {
    const long long base = (tap / T) * L;
    const int* ip = idx + tap * K;
    const float* wp = w + tap * K;
    for (int c = lane; c < C4; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < K; ++k) {
        const int j = min(max(__ldg(ip + k), 0), L - 1);
        acc = fma4(__ldg(wp + k), __ldg(flat + (base + j) * C4 + c), acc);
      }
      out[tap * C4 + c] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
weighted_gather_bwd(const float4* __restrict__ flat, const int* __restrict__ idx,
                    const float* __restrict__ w, const float4* __restrict__ g,
                    float4* __restrict__ d_flat, float* __restrict__ d_w,
                    int L, int T, int K, int C4, long long taps) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long tap = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       tap < taps; tap += nwarps) {
    const long long base = (tap / T) * L;
    const int* ip = idx + tap * K;
    const float* wp = w + tap * K;
    for (int k = 0; k < K; ++k) {
      const int j = min(max(__ldg(ip + k), 0), L - 1);
      const float wk = __ldg(wp + k);
      const long long row = (base + j) * C4;
      float part = 0.f;
      for (int c = lane; c < C4; c += 32) {
        const float4 gv = __ldg(g + tap * C4 + c);
        const float4 fv = __ldg(flat + row + c);
        part = fmaf(gv.x, fv.x, part);
        part = fmaf(gv.y, fv.y, part);
        part = fmaf(gv.z, fv.z, part);
        part = fmaf(gv.w, fv.w, part);
        if (wk != 0.f)
          atomic_add4(d_flat + row + c,
                      make_float4(wk * gv.x, wk * gv.y, wk * gv.z, wk * gv.w));
      }
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) d_w[tap * K + k] = part;
    }
  }
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

unsigned grid_for(long long taps) {
  long long blocks = (taps + kWarps - 1) / kWarps;
  const long long cap = 132LL * 16;     // 16 blocks per SM, then grid-stride
  return (unsigned)(blocks < cap ? blocks : cap);
}

}  // namespace

// flat (B, L, C) f32, idx (B, T, K) int32, w (B, T, K) f32, out (B, T, C)
// f32, all contiguous, C a multiple of 4, flat and out 16-byte aligned.
// Returns cudaGetLastError() of the launch.
extern "C" int pautdx_weighted_gather(const void* flat, const void* idx,
                                      const void* w, void* out, int B, int L,
                                      int T, int K, int C, void* stream) {
  const long long taps = (long long)B * T;
  if (taps == 0) return cudaSuccess;
  if (L <= 0 || K <= 0 || C <= 0 || C % 4 || !aligned(flat) || !aligned(out))
    return cudaErrorInvalidValue;
  weighted_gather_fwd<<<grid_for(taps), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(flat), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<float4*>(out), L, T, K, C / 4,
      taps);
  return cudaGetLastError();
}

// g (B, T, C) f32 the gradient of out; d_flat (B, L, C) f32, ZEROED by the
// caller; d_w (B, T, K) f32. The rest as above. Returns cudaGetLastError().
extern "C" int pautdx_weighted_gather_backward(
    const void* flat, const void* idx, const void* w, const void* g,
    void* d_flat, void* d_w, int B, int L, int T, int K, int C,
    void* stream) {
  const long long taps = (long long)B * T;
  if (taps == 0) return cudaSuccess;
  if (L <= 0 || K <= 0 || C <= 0 || C % 4 || !aligned(flat) || !aligned(g) ||
      !aligned(d_flat))
    return cudaErrorInvalidValue;
  weighted_gather_bwd<<<grid_for(taps), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(flat), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const float4*>(g),
      static_cast<float4*>(d_flat), static_cast<float*>(d_w), L, T, K, C / 4,
      taps);
  return cudaGetLastError();
}
