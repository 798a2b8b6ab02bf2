// Activation-int8 convolution, s8 x s8 -> s32, CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves this convolution to
// XLA (pautdx/ops/qconv.py::int8_conv, the conv_general_dilated at
// :58-62, with preferred_element_type=int32), and no PyTorch call computes
// it: F.conv2d has no int8 path that accumulates in int32. It computes,
// for NCHW input x (f32 or bf16, any strides), a symmetric per-tensor
// input scale s and int8 OIHW weights q with per-output-channel scales,
//   xq  = clip(rint(x / s), -127, 127)            (f32 division, half-even)
//   acc = conv(xq, q)                               (exact int32)
//   out = (float)acc * out_scale[o]                 (per output channel)
// rounded once to the output dtype (f32 or bf16), or acc itself in the
// accumulator mode the checks use. The input is quantized while it is
// loaded, so no int8 copy of the activation goes through device memory.
//
// What bounds it on the H100: at the serving sites (D-FINE-nano at b128,
// YOLOv8n-seg at b32) the bytes: the bf16 (f32) input read once, the
// output written once and the int8 weights, at 3.35 TB/s, against
// 2 * M * Cout * K operations at 1,979 int8 TOP/s dense. A 64-channel
// 3x3 site does 1,152 operations per output element and moves 4 bytes.
//
// Design (a simple, correct first kernel; wgmma and TMA are later work):
// - dense (groups 1): an implicit GEMM, M = N * Ho * Wo output pixels by
//   Cout by K = kh * kw * Cin with the input channel fastest, on
//   mma.sync.m16n8k32.s8.s8.s32. A 128-thread block computes a 64 x 64
//   tile, four warps of 32 x 32; per k-step of 32 it gathers the 64 x 32
//   activation tile (quantizing as it loads: 16 bf16 or f32 values a
//   thread, as 16-byte vector loads when the channels are contiguous and
//   Cin % 16 == 0, else one value at a time with bounds tests) and the
//   64 x 32 weight tile (one 16-byte load a thread from the packed
//   (Cout rounded to 64) x (K rounded to 32) int8 matrix the wrapper
//   prepares once per site) into shared memory, rows of 32 bytes whose
//   two 16-byte halves swap every four rows, so that the fragment reads
//   of a warp hit 32 distinct banks; two shared stages, one barrier a
//   k-step, the next k-step's loads in flight during this one's products;
//   channel pairs of a channels-last output stored together;
// - depthwise (groups == Cin == Cout): an 8 x 8 tile of outputs by 32
//   channels a block; the input tile with its halo quantized once into
//   shared memory, then int32 multiply-adds over the taps from there.
// Each activation value is quantized once per 64 output channels (dense)
// or about (7 stride + k)^2 / 64 times (depthwise); the f32 division is
// the IEEE one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output pixels a block
constexpr int BN = 64;       // output channels a block
constexpr int BK = 32;       // int8 depth of one k-step (one mma)
constexpr int kThreads = 128;
constexpr int kDwThreads = 256;

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutAcc = 2 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// clip(rint(v / s), -127, 127), the reference's order of operations
__device__ __forceinline__ int quantize(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int>(q);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) |
         ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) |
         ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

// word w (0..7) of row r of a 32-byte-row tile: the 16-byte halves swap
// every four rows
__device__ __forceinline__ int swz(int r, int w) {
  return r * 8 + (w ^ (((r >> 2) & 1) << 2));
}

struct Geometry {
  int N, C, H, W;            // input
  long long sN, sC, sH, sW;  // input strides, elements
  int Cout, Ho, Wo, kh, kw, stride, pad;
  long long oN, oC, oH, oW;  // output strides, elements
};

__device__ __forceinline__ void store_out(void* out, int kind, long long off,
                                          int acc, float scale) {
  if (kind == kOutAcc) {
    static_cast<int*>(out)[off] = acc;
  } else {
    const float y = __fmul_rn(__int2float_rn(acc), scale);
    if (kind == kOutBF16)
      static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[off] = y;
  }
}

// the raw bits of 16 consecutive input values, loaded ahead of their use
template <typename T>
struct Raw16;
template <>
struct Raw16<float> {
  float4 v[4];
};
template <>
struct Raw16<__nv_bfloat16> {
  uint4 v[2];
};

__device__ __forceinline__ void load_raw(const float* p, Raw16<float>& r) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r.v[i] = __ldg(reinterpret_cast<const float4*>(p) + i);
}
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p,
                                         Raw16<__nv_bfloat16>& r) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    r.v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}
__device__ __forceinline__ void raw_values(const Raw16<float>& r,
                                           float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[4 * i] = r.v[i].x;
    v[4 * i + 1] = r.v[i].y;
    v[4 * i + 2] = r.v[i].z;
    v[4 * i + 3] = r.v[i].w;
  }
}
__device__ __forceinline__ void raw_values(const Raw16<__nv_bfloat16>& r,
                                           float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t w[4] = {r.v[i].x, r.v[i].y, r.v[i].z, r.v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a bf16 is the top half of an f32
      v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint4 pack16(const int (&q)[16]) {
  return make_uint4(
      pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
      pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
}

// an output pair (channels co and co + 1, adjacent in memory) in one store
__device__ __forceinline__ void store_pair(void* out, int kind, long long off,
                                           int a, int b, float sa, float sb) {
  if (kind == kOutAcc) {
    *reinterpret_cast<int2*>(static_cast<int*>(out) + off) = make_int2(a, b);
    return;
  }
  const float ya = __fmul_rn(__int2float_rn(a), sa);
  const float yb = __fmul_rn(__int2float_rn(b), sb);
  if (kind == kOutBF16) {
    __nv_bfloat162 h;
    h.x = __float2bfloat16_rn(ya);
    h.y = __float2bfloat16_rn(yb);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       off) = h;
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
        make_float2(ya, yb);
  }
}

// grid (ceil(M / 64), Cout_pad / 64); wq: (Cout_pad, Kp) int8, row-major.
// Two shared-memory stages: a k-step's tiles are stored while the other
// stage may still be read, so one barrier a k-step; with kVec the next
// k-step's activation and weight loads are issued before this one's
// products, so they are in flight while the tensor cores work.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
             const float* __restrict__ out_scale, float s, void* out,
             int out_kind, Geometry g, int K, int Kp) {
  __shared__ __align__(16) uint32_t sA[2][BM * 8];
  __shared__ __align__(16) uint32_t sB[2][BN * 8];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const long long M = (long long)g.N * g.Ho * g.Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the activation row this thread gathers, and which 16 of the 32 k's
  const int ar = tid >> 1, ah = tid & 1;
  const long long am = m0 + ar;
  const bool a_ok = am < M;
  int iy0 = 0, ix0 = 0;
  const T* xb = x;
  if (a_ok) {
    const int hw = g.Ho * g.Wo;
    const int img = static_cast<int>(am / hw);
    const int rem = static_cast<int>(am - (long long)img * hw);
    const int oy = rem / g.Wo, ox = rem - (rem / g.Wo) * g.Wo;
    iy0 = oy * g.stride - g.pad;
    ix0 = ox * g.stride - g.pad;
    xb = x + (long long)img * g.sN;
  }
  const int8_t* wrow = wq + (long long)(n0 + ar) * Kp + ah * 16;

  // kVec: C % 16 == 0, so the 16 k's from kk are 16 contiguous channels
  // of one tap; loads them (or marks them zero: padding, past K or M)
  auto fetch = [&](int k0, Raw16<T>& raw) -> bool {
    const int kk = k0 + ah * 16;
    if (!a_ok || kk >= K) return false;
    const int tap = kk / g.C;
    const int ci = kk - tap * g.C;
    const int ky = tap / g.kw;
    const int iy = iy0 + ky, ix = ix0 + (tap - ky * g.kw);
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return false;
    load_raw(xb + iy * g.sH + ix * g.sW + ci, raw);
    return true;
  };
  // any layout: 16 values one at a time, quantized
  auto gather = [&](int k0, int (&qv)[16]) {
    const int kk = k0 + ah * 16;
    int tap = kk / g.C;
    int ci = kk - tap * g.C;
    int ky = tap / g.kw, kx = tap - (tap / g.kw) * g.kw;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      int q = 0;
      if (a_ok && kk + e < K) {
        const int iy = iy0 + ky, ix = ix0 + kx;
        if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
          q = quantize(to_f32<T>(xb[ci * g.sC + iy * g.sH + ix * g.sW]), s);
      }
      qv[e] = q;
      if (++ci == g.C) {
        ci = 0;
        if (++kx == g.kw) {
          kx = 0;
          ++ky;
        }
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  Raw16<T> raw;
  bool raw_ok = false;
  uint4 b_next = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kVec) {
    raw_ok = fetch(0, raw);
    b_next = __ldg(reinterpret_cast<const uint4*>(wrow));
  }
  int stage = 0;
  for (int k0 = 0; k0 < Kp; k0 += BK, stage ^= 1) {
    int qv[16];
    uint4 b4;
    if constexpr (kVec) {
      float v[16];
      if (raw_ok) {
        raw_values(raw, v);
#pragma unroll
        for (int e = 0; e < 16; ++e) qv[e] = quantize(v[e], s);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) qv[e] = 0;
      }
      b4 = b_next;
      if (k0 + BK < Kp) {
        raw_ok = fetch(k0 + BK, raw);
        b_next = __ldg(reinterpret_cast<const uint4*>(wrow + k0 + BK));
      }
    } else {
      gather(k0, qv);
      b4 = __ldg(reinterpret_cast<const uint4*>(wrow + k0));
    }
    *reinterpret_cast<uint4*>(&sA[stage][swz(ar, ah * 4)]) = pack16(qv);
    *reinterpret_cast<uint4*>(&sB[stage][swz(ar, ah * 4)]) = b4;
    __syncthreads();

    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm * 32 + i * 16 + gid;
      af[i][0] = sA[stage][swz(r, tig)];
      af[i][1] = sA[stage][swz(r + 8, tig)];
      af[i][2] = sA[stage][swz(r, 4 + tig)];
      af[i][3] = sA[stage][swz(r + 8, 4 + tig)];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wn * 32 + j * 8 + gid;
      bf[j][0] = sB[stage][swz(r, tig)];
      bf[j][1] = sB[stage][swz(r, 4 + tig)];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(acc[i][j][0]), "+r"(acc[i][j][1]), "+r"(acc[i][j][2]),
              "+r"(acc[i][j][3])
            : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
              "r"(bf[j][0]), "r"(bf[j][1]));
  }

  // epilogue: c0, c1 at row gid, columns 2 tig and 2 tig + 1; c2, c3 at
  // row gid + 8. With channels adjacent in memory (channels-last output,
  // Cout even) each pair goes out in one store.
  const bool pairs = g.oC == 1 && (g.Cout & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 32 + i * 16 + gid + 8 * h;
      if (m >= M) continue;
      const int hw = g.Ho * g.Wo;
      const int img = static_cast<int>(m / hw);
      const int rem = static_cast<int>(m - (long long)img * hw);
      const int oy = rem / g.Wo, ox = rem - (rem / g.Wo) * g.Wo;
      const long long base = (long long)img * g.oN + (long long)oy * g.oH +
                             (long long)ox * g.oW;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + wn * 32 + j * 8 + 2 * tig;
        if (co >= g.Cout) continue;
        const int a = acc[i][j][2 * h], b = acc[i][j][2 * h + 1];
        const bool acc_mode = out_kind == kOutAcc;
        if (pairs) {
          store_pair(out, out_kind, base + co, a, b,
                     acc_mode ? 0.0f : out_scale[co],
                     acc_mode ? 0.0f : out_scale[co + 1]);
        } else {
          store_out(out, out_kind, base + (long long)co * g.oC, a,
                    acc_mode ? 0.0f : out_scale[co]);
          if (co + 1 < g.Cout)
            store_out(out, out_kind, base + (long long)(co + 1) * g.oC, b,
                      acc_mode ? 0.0f : out_scale[co + 1]);
        }
      }
    }
}

// Depthwise (C == Cout, one input channel a group): a block takes an
// 8 x 8 tile of output pixels of one image and 32 channels, 256 threads.
// It quantizes the input tile it needs (with the halo, (7 * stride + k)^2
// pixels x 32 channels, channel fastest, so a warp reads 32 neighbouring
// channels of a channels-last input) once into shared memory as int8, and
// the 32 channels' weights beside it; each thread then sums one channel's
// taps for one row of 8 outputs from shared memory. An input value is
// quantized about (7 s + k)^2 / 64 times (2.25 at k5 s1, 4.5 at k3 s2)
// instead of k^2.
constexpr int kDwTile = 8;
constexpr int kDwC = 32;

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
depthwise_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ out_scale, float s, void* out,
                 int out_kind, Geometry g, int tiles_w) {
  extern __shared__ int8_t dw_smem[];
  const int IH = (kDwTile - 1) * g.stride + g.kh;
  const int IW = (kDwTile - 1) * g.stride + g.kw;
  const int taps = g.kh * g.kw;
  int8_t* s_in = dw_smem;                   // [IH * IW][32]
  int8_t* s_w = dw_smem + IH * IW * kDwC;   // [taps][32]
  const int ty = blockIdx.x / tiles_w, tx = blockIdx.x - ty * tiles_w;
  const int c0 = blockIdx.y * kDwC;
  const int img = blockIdx.z;
  const int oy0 = ty * kDwTile, ox0 = tx * kDwTile;
  const int iy0 = oy0 * g.stride - g.pad, ix0 = ox0 * g.stride - g.pad;
  const T* xb = x + (long long)img * g.sN;
  for (int i = threadIdx.x; i < IH * IW * kDwC; i += kDwThreads) {
    const int c = i % kDwC, p = i / kDwC;
    const int iy = iy0 + p / IW, ix = ix0 + p % IW;
    int q = 0;
    if (c0 + c < g.C && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
      q = quantize(to_f32<T>(xb[(long long)(c0 + c) * g.sC +
                                (long long)iy * g.sH + (long long)ix * g.sW]),
                   s);
    s_in[i] = static_cast<int8_t>(q);
  }
  for (int i = threadIdx.x; i < taps * kDwC; i += kDwThreads) {
    const int t = i / kDwC, c = i % kDwC;
    s_w[i] = c0 + c < g.C ? wq[(long long)(c0 + c) * taps + t] : 0;
  }
  __syncthreads();
  const int c = threadIdx.x % kDwC, r = threadIdx.x / kDwC;
  const int oy = oy0 + r;
  if (c0 + c >= g.C || oy >= g.Ho) return;
  int acc[kDwTile];
#pragma unroll
  for (int j = 0; j < kDwTile; ++j) acc[j] = 0;
  for (int ky = 0; ky < g.kh; ++ky) {
    const int8_t* row = s_in + (r * g.stride + ky) * IW * kDwC + c;
    for (int kx = 0; kx < g.kw; ++kx) {
      const int w = s_w[(ky * g.kw + kx) * kDwC + c];
#pragma unroll
      for (int j = 0; j < kDwTile; ++j)
        acc[j] += static_cast<int>(row[(j * g.stride + kx) * kDwC]) * w;
    }
  }
  const float sc = out_kind == kOutAcc ? 0.0f : out_scale[c0 + c];
  const long long base = (long long)img * g.oN + (long long)(c0 + c) * g.oC +
                         (long long)oy * g.oH;
#pragma unroll
  for (int j = 0; j < kDwTile; ++j)
    if (ox0 + j < g.Wo)
      store_out(out, out_kind, base + (long long)(ox0 + j) * g.oW, acc[j],
                sc);
}

template <typename T>
cudaError_t launch(const void* x, const void* wq, const float* out_scale,
                   float s, void* out, int out_kind, const Geometry& g,
                   int depthwise, int vec, int Kp, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* w = static_cast<const int8_t*>(wq);
  if (depthwise) {
    const int tiles_w = (g.Wo + kDwTile - 1) / kDwTile;
    const int tiles_h = (g.Ho + kDwTile - 1) / kDwTile;
    const size_t smem =
        (size_t)(((kDwTile - 1) * g.stride + g.kh) *
                     ((kDwTile - 1) * g.stride + g.kw) +
                 g.kh * g.kw) *
        kDwC;
    if (smem > 48 * 1024 || g.N > 65535) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(tiles_h * tiles_w),
                    static_cast<unsigned>((g.C + kDwC - 1) / kDwC),
                    static_cast<unsigned>(g.N));
    depthwise_kernel<T><<<grid, kDwThreads, smem, stream>>>(
        xt, w, out_scale, s, out, out_kind, g, tiles_w);
  } else {
    const long long M = (long long)g.N * g.Ho * g.Wo;
    const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                    static_cast<unsigned>((g.Cout + BN - 1) / BN));
    const int K = g.kh * g.kw * g.C;
    if (vec)
      dense_kernel<T, true><<<grid, kThreads, 0, stream>>>(
          xt, w, out_scale, s, out, out_kind, g, K, Kp);
    else
      dense_kernel<T, false><<<grid, kThreads, 0, stream>>>(
          xt, w, out_scale, s, out, out_kind, g, K, Kp);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (N, C, H, W) f32 (x_bf16 = 0) or bf16 (1) at strides (sN, sC, sH, sW)
// in elements. Dense (depthwise = 0): wq is (ceil(Cout / 64) * 64, Kp)
// int8, each row k = (ky * kw + kx) * C + ci, zero past K = kh * kw * C
// and past Cout, Kp % 32 == 0; vec = 1 promises C % 16 == 0, sC == 1 and
// 16-byte aligned 16-channel pieces. Depthwise (Cout == C): wq is
// (C, kh * kw) int8 and Kp is unread. out_scale: (Cout,) f32 (unread in
// the accumulator mode). out: (N, Cout, Ho, Wo) at strides (oN, oC, oH,
// oW), f32 (out_kind 0), bf16 (1) or int32 accumulators (2). Returns
// cudaGetLastError() of the launch.
extern "C" int pautdx_int8_conv(
    const void* x, int x_bf16, int N, int C, int H, int W, long long sN,
    long long sC, long long sH, long long sW, const void* wq,
    const void* out_scale, float in_scale, void* out, int out_kind,
    long long oN, long long oC, long long oH, long long oW, int Cout, int Ho,
    int Wo, int kh, int kw, int stride, int pad, int depthwise, int vec,
    int Kp, void* stream) {
  if (N <= 0 || Cout <= 0 || Ho <= 0 || Wo <= 0) return cudaSuccess;
  if (out_kind < 0 || out_kind > 2 || (!depthwise && Kp % BK != 0))
    return cudaErrorInvalidValue;
  Geometry g{N, C, H, W, sN, sC, sH, sW, Cout, Ho, Wo, kh, kw, stride, pad,
             oN, oC, oH, oW};
  const float* os = static_cast<const float*>(out_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, wq, os, in_scale, out, out_kind, g,
                                 depthwise, vec, Kp, st);
  return launch<float>(x, wq, os, in_scale, out, out_kind, g, depthwise, vec,
                       Kp, st);
}
