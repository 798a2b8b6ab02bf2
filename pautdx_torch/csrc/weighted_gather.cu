// Bilinear deformable sampling as a weighted row gather, its backward, and
// the backward of the one-hot row gather, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pautdx/ops/pallas_gather.py::pallas_weighted_gather
// (_weighted_kernel) and its custom VJP (pallas_gather.py:196-210, XLA there):
//
//   out[b, t, :]  = sum_k w[b, t, k] * flat[b, j(b, t, k), :]
//   d_flat[b, j, :] = sum of w[b, t, k] * g[b, t, :] over every (t, k) with j
//   d_w[b, t, k]  = <g[b, t, :], flat[b, j(b, t, k), :]>
//
// and the VJP of pallas_gather.py::pallas_onehot_gather (:107-112), which is
// d_flat above with K = 1 and w = 1. Here j = clip(idx, 0, L - 1) in both:
// the one-hot forward reads clipped rows, so its gradient goes to them too
// (the reference's _bwd scatters at the raw index). d_w is taken at the
// clipped row even where the caller gave the corner weight 0, as the
// reference does.
//
// dtypes: the table, out, g and d_flat share one element type, float32 or
// bfloat16; w and d_w are float32 or bfloat16 on their own. As in
// _weighted_kernel and _wbwd, w is rounded to the table's dtype before it
// multiplies a row; every product and sum is f32 here (exact products of
// bf16 values, f32 sums), and each output is rounded once, to the table's
// dtype (out, d_flat) or w's (d_w). The reference sums d_flat and d_w in
// g's dtype; these sums are the more accurate. On the TPU the interpolation
// matrix (K nonzeros per tap row) is built in VMEM and multiplied on the
// MXU; on the H100 the same function is memory traffic with 2K flops per
// element.
//
// What bounds them on the H100: bytes. At the training shape (16 frames, a
// 2000-row x 128-channel f32 table per frame, T = 1200 taps, K = 4) the
// forward reads the table rows the taps touch plus 0.6 MB of idx/w and
// writes 9.8 MB; the backward reads g (9.8 MB), those rows and idx/w and
// writes d_flat (16.4 MB) and d_w.
//
// Forward: one warp per tap, in a grid-stride loop over taps. Lane l owns
// the 4-element pieces l, l + 32, ... of the row (a float4, or 8 bytes of
// bf16; C = 128: one piece a lane), so a warp reads and writes whole rows,
// coalesced; the corner rows shared by neighbouring taps come from the
// 50 MB L2. At a denoising step's b4 (T = 2736) the bound is about 2.6 us,
// a chain of DRAM latencies (indices, rows, stores) more than bytes. A
// design that brings a tile's corner rows into shared memory by bulk
// asynchronous copies (cp.async.bulk, as onehot_gather.cu does) was
// slower than this one at every path shape on an H100: an SM's copy
// engine takes about one bulk copy every 25 ns whatever its size, while
// these plain loads reach L2's rate (PERF.md, section 6).
//
// Backward, d_flat (scatter_tile): one block per (row range, channel slice,
// frame) keeps that tile of the frame's d_flat, rows x cs f32, in dynamic
// shared memory. It zeroes the tile, walks all the frame's taps, reads each
// tap's cs-wide piece of g once and adds w_k * g into the tile rows of the
// corners that fall in its range with shared-memory atomics, then writes the
// whole tile, zero rows included, with coalesced 16-byte (f32) or 8-byte
// (bf16) stores. Every
// element of d_flat is written once: no memset, no global atomics. The
// caller picks cs and rows (a tile fits the 227 KB a block can have; at
// L = 2000 one frame's rows fit whole). On sm_90 a float atomicAdd to shared
// memory compiles to a compare-and-swap loop (ATOMS.CAST.SPIN), not one
// instruction, and these adds are most of the kernel's time. The lanes of
// one tap take the four words of their float4 in a rotated order, so that
// taps of one warp whose rows share a bank group meet on fewer banks. The
// order of the adds varies from run to run: d_flat matches its plain
// version to rounding, not bit for bit.
// Backward, d_w (weighted_gather_dw): one warp per tap as in the forward;
// the tap's corner rows are loaded together, four at a time, and the four
// dot products with g reduced over the warp together. No atomics: d_w is
// the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScatterThreads = 1024;

// loads and stores of 4 consecutive elements of a row, and of one weight,
// as f32: float4 (16 bytes) or 4 bf16 (8 bytes)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// a weight rounded to the table's dtype E, as the reference casts it
template <typename E>
__device__ __forceinline__ float round_to(float x) {
  return x;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
  return acc;
}

template <typename E, typename Wt>
__global__ void __launch_bounds__(kThreads)
weighted_gather_fwd(const E* __restrict__ flat, const int* __restrict__ idx,
                    const Wt* __restrict__ w, E* __restrict__ out, int L,
                    int T, int K, int C4, long long taps) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long tap = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       tap < taps; tap += nwarps) {
    const long long base = (tap / T) * L;
    const int* ip = idx + tap * K;
    const Wt* wp = w + tap * K;
    for (int c = lane; c < C4; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < K; ++k) {
        const int j = min(max(__ldg(ip + k), 0), L - 1);
        acc = fma4(round_to<E>(load1(wp + k)),
                   load4(flat + ((base + j) * C4 + c) * 4), acc);
      }
      store4(out + (tap * C4 + c) * 4, acc);
    }
  }
}

// One (tap, 4-element column) of a block's walk: its piece of g, and its
// first corner's row and weight, loaded ahead of the adds.
struct Task {
  float4 g;
  int j;
  float w;
};

template <bool kWeighted, typename E, typename Wt>
__device__ __forceinline__ Task load_task(const E* __restrict__ g,
                                          const int* __restrict__ idx,
                                          const Wt* __restrict__ w,
                                          long long tap, int K, int C4,
                                          int col) {
  Task a;
  a.g = load4(g + (tap * C4 + col) * 4);
  a.j = __ldg(idx + tap * K);
  a.w = kWeighted ? round_to<E>(load1(w + tap * K)) : 1.f;
  return a;
}

// adds w_k * a.g to the tile rows of the tap's corners that are this
// block's; the word order is rotated by rot (0..3)
template <bool kWeighted, typename E, typename Wt>
__device__ __forceinline__ void add_task(float4* tile, const Task& a,
                                         const int* __restrict__ idx,
                                         const Wt* __restrict__ w,
                                         long long tap, int K, int L, int r0,
                                         int nr, int cs4, int c, int rot) {
  for (int k = 0; k < K; ++k) {
    int j = a.j;
    float wk = a.w;
    if (k > 0) {
      j = __ldg(idx + tap * K + k);
      wk = kWeighted ? round_to<E>(load1(w + tap * K + k)) : 1.f;
    }
    const int row = min(max(j, 0), L - 1) - r0;
    if ((unsigned)row >= (unsigned)nr || (kWeighted && wk == 0.f)) continue;
    float4 v = make_float4(wk * a.g.x, wk * a.g.y, wk * a.g.z, wk * a.g.w);
    if (rot & 1) v = make_float4(v.y, v.z, v.w, v.x);
    if (rot & 2) v = make_float4(v.z, v.w, v.x, v.y);
    float* p = reinterpret_cast<float*>(tile + row * cs4 + c);
    atomicAdd(p + (rot & 3), v.x);
    atomicAdd(p + ((rot + 1) & 3), v.y);
    atomicAdd(p + ((rot + 2) & 3), v.z);
    atomicAdd(p + ((rot + 3) & 3), v.w);
  }
}

// grid (row ranges, channel slices, frames); rows x cs4 float4 of dynamic
// shared memory. Each thread walks (tap, 4-element column) tasks two at a
// time, both tasks' loads issued before either's adds.
template <bool kWeighted, typename E, typename Wt>
__global__ void __launch_bounds__(kScatterThreads)
scatter_tile(const E* __restrict__ g, const int* __restrict__ idx,
             const Wt* __restrict__ w, E* __restrict__ d_flat, int L, int T,
             int K, int C4, int cs4, int rows) {
  extern __shared__ float4 tile[];
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, L - r0);
  const int c0 = blockIdx.y * cs4;
  const long long b = blockIdx.z;
  const int n_tile = nr * cs4;
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x)
    tile[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int n = T * cs4;
  for (int i = threadIdx.x; i < n; i += 2 * blockDim.x) {
    const int i2 = i + blockDim.x;
    const int t1 = i / cs4, t2 = i2 / cs4;
    const int c1 = i - t1 * cs4, c2 = i2 - t2 * cs4;
    const Task a1 = load_task<kWeighted>(g, idx, w, b * T + t1, K, C4,
                                         c0 + c1);
    Task a2;
    if (i2 < n)
      a2 = load_task<kWeighted>(g, idx, w, b * T + t2, K, C4, c0 + c2);
    add_task<kWeighted, E>(tile, a1, idx, w, b * T + t1, K, L, r0, nr, cs4,
                           c1, t1);
    if (i2 < n)
      add_task<kWeighted, E>(tile, a2, idx, w, b * T + t2, K, L, r0, nr,
                             cs4, c2, t2);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
    const int row = i / cs4;
    store4(d_flat + ((b * L + r0 + row) * C4 + c0 + (i - row * cs4)) * 4,
           tile[i]);
  }
}

// The sums over the warp of four values a[0..3] in 6 shuffles instead of
// 20: each exchange halves the values a lane keeps. Lane l returns the sum
// of a[l >> 3].
__device__ __forceinline__ float sum4_over_warp(const float (&a)[4],
                                                int lane) {
  const bool h16 = lane & 16, h8 = lane & 8;
  const float k0 = (h16 ? a[2] : a[0]) +
                   __shfl_xor_sync(0xffffffffu, h16 ? a[0] : a[2], 16);
  const float k1 = (h16 ? a[3] : a[1]) +
                   __shfl_xor_sync(0xffffffffu, h16 ? a[1] : a[3], 16);
  float v = (h8 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, h8 ? k0 : k1, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

template <typename E, typename Wt>
__global__ void __launch_bounds__(kThreads)
weighted_gather_dw(const E* __restrict__ flat, const int* __restrict__ idx,
                   const E* __restrict__ g, Wt* __restrict__ d_w, int L,
                   int T, int K, int C4, long long taps) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long tap = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       tap < taps; tap += nwarps) {
    const long long base = (tap / T) * L;
    for (int k0 = 0; k0 < K; k0 += 4) {
      long long row[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        row[u] = k0 + u < K
                     ? (base + min(max(__ldg(idx + tap * K + k0 + u), 0),
                                   L - 1)) * C4
                     : -1;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = lane; c < C4; c += 32) {
        const float4 gv = load4(g + (tap * C4 + c) * 4);
        float4 fv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          fv[u] = row[u] >= 0 ? load4(flat + (row[u] + c) * 4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          part[u] = fmaf(gv.x, fv[u].x, fmaf(gv.y, fv[u].y,
                    fmaf(gv.z, fv[u].z, fmaf(gv.w, fv[u].w, part[u]))));
      }
      // lanes 0, 8, 16, 24 end with the dot products of corners k0..k0+3
      const float dot = sum4_over_warp(part, lane);
      const int u = lane >> 3;
      if ((lane & 7) == 0 && k0 + u < K) store1(d_w + tap * K + k0 + u, dot);
    }
  }
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

unsigned grid_for(long long warps) {
  long long blocks = (warps + kWarps - 1) / kWarps;
  const long long cap = 132LL * 16;     // 16 blocks per SM, then grid-stride
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <typename X>
struct Tag {
  using type = X;
};

// calls f(Tag<E>{}, Tag<Wt>{}) for dtype codes 0 = float32, 1 = bfloat16
// of the table (E) and of the weights (Wt)
template <typename F>
int with_types(int dtype, int wdtype, F&& f) {
  if (dtype == 0 && wdtype == 0) return f(Tag<float>{}, Tag<float>{});
  if (dtype == 0 && wdtype == 1)
    return f(Tag<float>{}, Tag<__nv_bfloat16>{});
  if (dtype == 1 && wdtype == 0)
    return f(Tag<__nv_bfloat16>{}, Tag<float>{});
  if (dtype == 1 && wdtype == 1)
    return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// d_flat (B, L, C) from g (B, T, C), idx and w (B, T, K): every element
// written, tiles of rows x cs. Returns the CUDA error of the launch.
template <bool kWeighted, typename E, typename Wt>
int launch_scatter(const void* g, const void* idx, const void* w,
                   void* d_flat, int B, int L, int T, int K, int C, int cs,
                   int rows, cudaStream_t stream) {
  if (cs <= 0 || cs % 4 || C % cs || rows <= 0 || B > 65535 ||
      C / cs > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * cs * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      scatter_tile<kWeighted, E, Wt>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  scatter_tile<kWeighted, E, Wt><<<dim3((L + rows - 1) / rows, C / cs, B),
                                   kScatterThreads, smem, stream>>>(
      static_cast<const E*>(g), static_cast<const int*>(idx),
      static_cast<const Wt*>(w), static_cast<E*>(d_flat), L, T, K, C / 4,
      cs / 4, rows);
  return cudaGetLastError();
}

}  // namespace

// flat (B, L, C), idx (B, T, K) int32, w (B, T, K), out (B, T, C), all
// contiguous, C a multiple of 4, flat and out 16-byte aligned; dtype is
// that of flat and out, wdtype that of w (0 = float32, 1 = bfloat16).
// Returns cudaGetLastError() of the launch.
extern "C" int pautdx_weighted_gather(const void* flat, const void* idx,
                                      const void* w, void* out, int B, int L,
                                      int T, int K, int C, int dtype,
                                      int wdtype, void* stream) {
  const long long taps = (long long)B * T;
  if (taps == 0) return cudaSuccess;
  if (L <= 0 || K <= 0 || C <= 0 || C % 4 || !aligned(flat) || !aligned(out))
    return cudaErrorInvalidValue;
  return with_types(dtype, wdtype, [&](auto te, auto tw) {
    using E = typename decltype(te)::type;
    using Wt = typename decltype(tw)::type;
    weighted_gather_fwd<E, Wt><<<grid_for(taps), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(flat), static_cast<const int*>(idx),
        static_cast<const Wt*>(w), static_cast<E*>(out), L, T, K, C / 4,
        taps);
    return (int)cudaGetLastError();
  });
}

// g (B, T, C) the gradient of out, in flat's dtype; d_flat (B, L, C) in
// flat's dtype and d_w (B, T, K) in w's, every element written by the
// kernels (the caller need not zero them); the d_flat tile of one block is
// rows x cs (cs a multiple of 4 dividing C, rows * cs * 4 bytes at most
// 227 KB). The rest as above. Two launches, d_flat then d_w. Returns the
// first CUDA error.
extern "C" int pautdx_weighted_gather_backward(
    const void* flat, const void* idx, const void* w, const void* g,
    void* d_flat, void* d_w, int B, int L, int T, int K, int C, int cs,
    int rows, int dtype, int wdtype, void* stream) {
  if ((long long)B * L * C == 0) return cudaSuccess;
  if (L <= 0 || K <= 0 || C <= 0 || C % 4 || !aligned(flat) || !aligned(g) ||
      !aligned(d_flat))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dtype, wdtype, [&](auto te, auto tw) {
    using E = typename decltype(te)::type;
    using Wt = typename decltype(tw)::type;
    const int err = launch_scatter<true, E, Wt>(g, idx, w, d_flat, B, L, T,
                                                K, C, cs, rows, s);
    const long long taps = (long long)B * T;
    if (err != cudaSuccess || taps == 0) return err;
    weighted_gather_dw<E, Wt><<<grid_for(taps), kThreads, 0, s>>>(
        static_cast<const E*>(flat), static_cast<const int*>(idx),
        static_cast<const E*>(g), static_cast<Wt*>(d_w), L, T, K, C / 4,
        taps);
    return (int)cudaGetLastError();
  });
}

// The backward of the one-hot gather: g (B, T, C) of dtype 0 = float32 or
// 1 = bfloat16, idx (B, T) int32, d_flat (B, L, C) in g's dtype = the sum
// of g over the taps of each clipped row (in f32, rounded once), every
// element written; tiles as above. Returns the CUDA error of the launch.
extern "C" int pautdx_onehot_gather_backward(const void* g, const void* idx,
                                             void* d_flat, int B, int L,
                                             int T, int C, int cs, int rows,
                                             int dtype, void* stream) {
  if ((long long)B * L * C == 0) return cudaSuccess;
  if (L <= 0 || C <= 0 || C % 4 || !aligned(g) || !aligned(d_flat))
    return cudaErrorInvalidValue;
  return with_types(dtype, 0, [&](auto te, auto) {
    using E = typename decltype(te)::type;
    return launch_scatter<false, E, float>(
        g, idx, nullptr, d_flat, B, L, T, 1, C, cs, rows,
        static_cast<cudaStream_t>(stream));
  });
}
