// Activation-int8 convolution, s8 x s8 -> s32, CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves this convolution to
// XLA (pautdx/ops/qconv.py::int8_conv, the conv_general_dilated at
// :58-62, with preferred_element_type=int32), and no PyTorch call computes
// it: F.conv2d has no int8 path that accumulates in int32. It computes,
// for input x (N, C, H, W) (f32 or bf16, any strides), a symmetric
// per-tensor input scale s and int8 OIHW weights q with per-output-channel
// scales,
//   xq  = clip(rint(__fdiv_rn(x, s)), -127, 127)    (IEEE f32 division;
//                                                    NaN gives 0)
//   acc = conv(xq, q)                                (exact int32)
//   out = __fmul_rn(__int2float_rn(acc), out_scale[o])
// rounded once to the output dtype (f32 or bf16), or acc itself in the
// accumulator mode the checks use. The input is quantized in shared
// memory, so no int8 copy of the activation goes through device memory.
//
// What bounds it on the H100: the bytes. At the serving sites (D-FINE-nano
// at b128 bf16, YOLOv8n-seg at b32 f32) the input read once, the output
// written once and the int8 weights take longer at 3.35 TB/s than the
// 2 * M * Cout * K operations at 1,979 int8 TOP/s dense: a 64-channel 3x3
// site does 1,152 operations per output element and moves 4 bytes (bf16).
// The IEEE division of every input value (about ten instructions) is the
// next limit, so each value is divided once.
//
// Three routes; ops/qconv.py picks one from the shape alone, before the
// launch, and a route that cannot take a shape returns an error (no
// fallback):
// - dense on wgmma (groups 1; channels-last input whose base, strides and
//   C * element size are 16-byte multiples, TMA's rules; kernel 1 or 3,
//   stride 1 or 2). A block is two consumer warpgroups (M = 128 output
//   pixels, 64 each) and one producer warp, persistent over output tiles.
//   The N tile covers all of Cout, rounded up to a wgmma width (16, 32,
//   48, 64, 80, 128 or 256); Cout above 256 takes 256-wide tiles, one a
//   grid row. Input channels run in chunks of 32, 64 or 128. The producer
//   brings each chunk's raw bf16 / f32 box in by TMA: a 4-d map over
//   (C, W, H, N), or, for 1x1 stride-1 kernels, a 2-d one over
//   (C, N * H * W) whose 128 rows are consecutive pixels. Out-of-bounds
//   boxes are zero-filled, which is the padding (0 quantizes to 0). The 256
//   consumer threads quantize the chunk ONCE into an int8 tile in shared
//   memory: the whole input region under the block's 16 x 8 or 8 x 16
//   output tile, halo included (18 x 10 inputs at 3x3 stride 1), laid out
//   [16-channel group][y][x parity][x / stride][16 bytes]. Every tap's A
//   operand is a no-swizzle shared-memory descriptor into that tile: a
//   core matrix is 8 output pixels of one row, 16 bytes apart; the tap
//   moves the start address, the next output row is SBO away, the other 16
//   channels LBO. Stride 2 keeps even and odd columns apart, so that
//   neighbouring outputs stay 16 bytes apart. So each input value is
//   divided once per N tile: once per site up to Cout 256, once per
//   256-wide tile above (D-FINE's 256 -> 512 site), not once per tap or per
//   64 outputs. The int8 weights, packed once per site by
//   prepare_int8_weight K-major per k-step in 8 x 16-byte core matrices,
//   stay resident in shared memory where they fit beside the ring, else
//   stream by chunk through two slots (YOLO's 128 -> 256 3x3, 295 KB). A
//   chunk's k-steps run as wgmma.m64nNk32.s32.s8.s8 while the threads
//   quantize the next chunk; TMA keeps up to 64 KB of raw boxes in flight
//   a block, two blocks an SM where the N tile's accumulators allow.
//   Channels past C are zero (TMA fill, zero weights): a 16- or 48-channel
//   input pads its last chunk to 32 rather than pairing taps in one
//   k-step, which costs tensor-core work, not bytes. The epilogue
//   dequantizes in registers; the lanes of a quad trade values so that
//   each stores 16 contiguous bytes of the channels-last output.
// - depthwise on dp4a (groups == C == Cout, the same layout rules, kernel
//   3 or 5, stride 1 or 2): a block takes 128 bytes of channels (64 bf16,
//   32 f32) and a TH x TW output tile chosen per shape, within 72 KB of
//   shared memory (three blocks an SM). One TMA box brings the raw halo
//   in; it is quantized once into int8 [channel][y][x] ((TH - 1) s + k by
//   (TW - 1) s + k inputs for TH x TW outputs), and each thread sums 8
//   outputs of one channel with dp4a over four taps of a kernel row at a
//   time from 32-bit shared loads; a warp's 32 channels of one pixel are
//   stored together.
// - generic, for everything else: NCHW input, YOLO's 3-channel stem
//   (channels-last rows of 12 bytes are no TMA stride), misaligned bases
//   or strides, other kernels. The first design: mma.sync.m16n8k32 s8
//   with loads by threads for dense (a 128-thread block computes 64 x 64,
//   each value divided once per 64 output channels and per tap), 8 x 8
//   shared-memory tiles for depthwise.
// The IEEE division is the largest cost after the bytes: __fdiv_rn's
// range check and slow-path branch serialize about ten instructions a
// value, which the threads cannot overlap.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <chrono>
#include <mutex>

namespace {

constexpr int BM = 64;       // generic dense: output pixels a block
constexpr int BN = 64;       // generic dense: output channels a block
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

// clip(rint(v / s), -127, 127) with the IEEE f32 division. Where |v| <
// s / 2 (s normal, so that s / 2 is exact) the quotient rounds to at most
// 0.5 in magnitude and rint gives 0: such values, zeros above all, are
// divided as s / s instead and give 0, since __fdiv_rn's range check
// sends zero and subnormal dividends down its slow path. NaN fails every
// comparison, so the test is written !(|v| >= s / 2): NaN takes the same
// branch and gives 0, as the reference's int8 cast of a NaN does; +-inf
// give +-127. The result is clipped before the rounding conversion:
// +-127 are integers, so this is clip(rint(v / s)).
__device__ __forceinline__ int quantize(float v, float s) {
  const float half = s >= 2.3509887e-38f ? 0.5f * s : 0.0f;
  const bool small = !(fabsf(v) >= half);
  const float q = __fdiv_rn(small ? s : v, s);
  return small ? 0
               : __float2int_rn(fminf(fmaxf(q, -127.0f), 127.0f));
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

// ------------------------------------------------ Hopper: TMA, mbarrier, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// contiguous bytes (a multiple of 16, 16-byte aligned at both ends)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the generic proxy's shared-memory stores, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 256 consumer threads (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x
// 16 bytes, `lbo` bytes apart along K and `sbo` bytes apart along M/N
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from touching an accumulator before the wait
template <int R>
__device__ __forceinline__ void wg_hold(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (m64 x nN s32, this thread's N / 2) = a . b, or += where acc: a (m64 x
// k32 s8) and b (nN x k32 s8), both K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<48>(int (&d)[24], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<80>(int (&d)[40], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39"
      "}, %40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
        "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
        "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
        "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
        "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}


// ------------------------------------------------- dense on wgmma, TMA-fed

constexpr int kDenseThreads = 288;   // two consumer warpgroups, one producer
constexpr int kK32 = 32;             // input channels a k-step
constexpr int kMaxStages = 4;

struct DenseTma {
  int C, Cout, Ho, Wo, k, s, pad;
  int flat;                       // 1x1 stride 1 over flattened pixels
  long long M;                    // flat: N * H * W
  int tiles_x, tiles_y, m_tiles;  // 4-d: tiles a row, a column; all tiles
  int TH, TW, wg_dy, wg_dx;       // output tile, warpgroup 1's offset in it
  int IH, IW, IWp, RS, GS;        // int8 tile: rows, columns, columns a
                                  // parity, bytes a row, bytes a group
  int band, nbands, box_bytes;    // raw rows a TMA box, boxes a chunk
  int slot_bytes, stages;
  int ch, lg_groups;              // channels a chunk (32, 64 or 128),
                                  // log2 of its 16-channel groups
  int nchunks, nk32, taps;        // chunks, k-steps of 32 channels a tap
  int b_resident;
  int off_a, a_bytes, off_b, b_chunk_bytes, off_bar;
  const int8_t* wq;               // (n tiles, nk32, taps, NT/8, 2, 8, 16)
  const float* out_scale;
  void* out;
  long long oN, oH, oW;           // channels-last output, channel stride 1
  int out_kind, x_bf16;
  float s_in;
};

// 16 channels of one pixel of the raw box, quantized, as 16 bytes
__device__ __forceinline__ uint4 quantize16(const uint8_t* src, int bf16,
                                            float s) {
  float v[16];
  if (bf16) {
    Raw16<__nv_bfloat16> r;
    r.v[0] = reinterpret_cast<const uint4*>(src)[0];
    r.v[1] = reinterpret_cast<const uint4*>(src)[1];
    raw_values(r, v);
  } else {
    Raw16<float> r;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.v[i] = reinterpret_cast<const float4*>(src)[i];
    raw_values(r, v);
  }
  int q[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) q[e] = quantize(v[e], s);
  return pack16(q);
}

// the first input pixel (x, y, image) of tile t's halo, and whether the
// output pixel (oy, ox) of warpgroup wg's row r is inside the output
struct TileOrigin {
  int img, oy0, ox0;
};

__device__ __forceinline__ TileOrigin tile_origin(const DenseTma& p, int t) {
  const int per_img = p.tiles_x * p.tiles_y;
  const int img = t / per_img;
  const int rem = t - img * per_img;
  const int ty = rem / p.tiles_x;
  return TileOrigin{img, ty * p.TH, (rem - ty * p.tiles_x) * p.TW};
}

template <int NT>
__global__ void __launch_bounds__(kDenseThreads, NT <= 128 ? 2 : 1)
dense_tma_kernel(__grid_constant__ const CUtensorMap xmap,
                 __grid_constant__ const DenseTma p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar0 = s_base + p.off_bar;
  // full[stages], empty[stages], b_full[2], b_empty[2]
  auto full = [&](int i) { return bar0 + 8u * i; };
  auto empty = [&](int i) { return bar0 + 8u * (kMaxStages + i); };
  auto b_full = [&](int i) { return bar0 + 8u * (2 * kMaxStages + i); };
  auto b_empty = [&](int i) { return bar0 + 8u * (2 * kMaxStages + 2 + i); };
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(b_full(i), 1);
      mbar_init(b_empty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int step_bytes = NT * 32;  // one k-step of the weight
  const int ksub = p.ch / kK32;    // k-steps a tap in a chunk
  const int8_t* wq = p.wq + (size_t)blockIdx.y * p.nk32 * p.taps * step_bytes;
  // the weight bytes of chunk j (the last may hold fewer k-steps)
  auto chunk_b_bytes = [&](int j) {
    return min(ksub, p.nk32 - j * ksub) * p.taps * step_bytes;
  };
  const int my_tiles =
      blockIdx.x < p.m_tiles
          ? (p.m_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  const int items = my_tiles * p.nchunks;  // (tile, chunk) in order

  if (tid >= 256) {
    // ---- producer: one thread issues every copy, in the consumers' order
    if (tid != 256) return;
    int slot = 0, bslot = 0;
    uint32_t phase = 0, bphase = 0;
    for (int i = 0; i < items; ++i) {
      const int tile = blockIdx.x + (i / p.nchunks) * gridDim.x;
      const int chunk = i - (i / p.nchunks) * p.nchunks;
      if (!p.b_resident) {
        mbar_wait(b_empty(bslot), bphase ^ 1);
        mbar_expect_tx(b_full(bslot), chunk_b_bytes(chunk));
        bulk_load(s_base + p.off_b + bslot * p.b_chunk_bytes,
                  wq + (size_t)chunk * p.b_chunk_bytes, chunk_b_bytes(chunk),
                  b_full(bslot));
        if (++bslot == 2) {
          bslot = 0;
          bphase ^= 1;
        }
      }
      for (int b = 0; b < p.nbands; ++b) {
        mbar_wait(empty(slot), phase ^ 1);
        mbar_expect_tx(full(slot), p.box_bytes);
        const uint32_t dst = s_base + slot * p.slot_bytes;
        if (p.flat) {
          tma_load_2d(dst, &xmap, chunk * p.ch, tile * 128, full(slot));
        } else {
          const TileOrigin o = tile_origin(p, tile);
          tma_load_4d(dst, &xmap, chunk * p.ch, o.ox0 * p.s - p.pad,
                      o.oy0 * p.s - p.pad + b * p.band, o.img, full(slot));
        }
        if (++slot == p.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      // resident weights: after the first item's boxes, which the
      // consumers quantize while the weights arrive
      if (p.b_resident && i == 0) {
        const uint32_t total = (uint32_t)p.nk32 * p.taps * step_bytes;
        mbar_expect_tx(b_full(0), total);
        for (uint32_t off = 0; off < total; off += 32768u) {
          const uint32_t n = total - off < 32768u ? total - off : 32768u;
          bulk_load(s_base + p.off_b + off, wq + off, n, b_full(0));
        }
      }
    }
    return;
  }

  // ---- consumers: 256 threads quantize; each warpgroup multiplies 64 rows
  const int wg = tid >> 7, lane = tid & 31, warp = tid >> 5;
  const int elt = p.x_bf16 ? 2 : 4;
  int slot = 0, bslot = 0;
  uint32_t phase = 0, bphase = 0;

  // quantize item j's chunk into int8 buffer `buf`: each 16 channels of a
  // pixel of the halo once, from the raw boxes as they arrive
  auto quantize_item = [&](int j, int buf) {
    const int chunk = j % p.nchunks;
    uint8_t* dst = smem + p.off_a + buf * p.a_bytes;
    for (int b = 0; b < p.nbands; ++b) {
      mbar_wait(full(slot), phase);
      const uint8_t* raw = smem + slot * p.slot_bytes;
      const int rows = min(p.band, p.IH - b * p.band);
      const int units = (rows * p.IW) << p.lg_groups;
      for (int u = tid; u < units; u += 256) {
        const int pix = u >> p.lg_groups;
        const int g = u - (pix << p.lg_groups);
        const int yb = pix / p.IW;
        const int x = pix - yb * p.IW;
        const int y = b * p.band + yb;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (chunk * p.ch + g * 16 < p.C)
          v = quantize16(raw + (pix * p.ch + g * 16) * elt, p.x_bf16,
                         p.s_in);
        const int xp = p.s == 1 ? 0 : (x & 1);
        const int xh = p.s == 1 ? x : (x >> 1);
        *reinterpret_cast<uint4*>(dst + g * p.GS + y * p.RS +
                                  xp * p.IWp * 16 + xh * 16) = v;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(slot));
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
  };

  int acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
  if (items > 0) quantize_item(0, 0);
  if (p.b_resident && items > 0) mbar_wait(b_full(0), 0);
  const int n0 = blockIdx.y * NT;
  const uint32_t wg_off =
      wg * (p.wg_dy * p.s * p.RS + p.wg_dx * 16);
  for (int i = 0; i < items; ++i) {
    const int chunk = i % p.nchunks;
    const int tile = blockIdx.x + (i / p.nchunks) * gridDim.x;
    fence_proxy_async();
    consumers_sync();
    uint32_t b_addr;
    if (p.b_resident) {
      b_addr = s_base + p.off_b + chunk * ksub * p.taps * step_bytes;
    } else {
      mbar_wait(b_full(bslot), bphase);
      b_addr = s_base + p.off_b + bslot * p.b_chunk_bytes;
    }
    const uint32_t a_addr = s_base + p.off_a + (i & 1) * p.a_bytes + wg_off;
    wg_fence();
    // k-steps (32 channels of the chunk, tap) in the packed weight's order
    const int halves = min(ksub, p.nk32 - chunk * ksub);
    for (int h = 0; h < halves; ++h) {
      int t = 0;
      for (int ky = 0; ky < p.k; ++ky)
        for (int kx = 0; kx < p.k; ++kx, ++t) {
          const uint32_t a_tap = a_addr + h * 2 * p.GS + ky * p.RS +
                                 (p.s == 1 ? kx * 16
                                           : (kx & 1) * p.IWp * 16 +
                                                 (kx >> 1) * 16);
          wgmma_s8<NT>(acc, gmma_desc(a_tap, p.GS, p.s * p.RS),
                       gmma_desc(b_addr + (h * p.taps + t) * step_bytes, 128,
                                 256),
                       chunk > 0 || h > 0 || t > 0);
        }
    }
    wg_commit();
    if (i + 1 < items) quantize_item(i + 1, (i + 1) & 1);
    wg_wait_all();
    wg_hold(acc);
    if (!p.b_resident) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b_empty(bslot));
      if (++bslot == 2) {
        bslot = 0;
        bphase ^= 1;
      }
    }
    if (chunk != p.nchunks - 1) continue;

    // epilogue: rows r0 and r0 + 8 of this warpgroup's 64 (r0 = 16 warp +
    // lane / 4); the accumulators hold columns 8 g + 2 q and 8 g + 2 q + 1
    // of each 8-column group g (q = lane % 4). The lanes of a quad trade
    // values so that each stores 16 contiguous bytes: f32 and int32 between
    // lanes q and q ^ 1 (4 columns of a group), bf16 among all four (a 4 x 4
    // transpose: 8 columns of a group).
    const int r0 = 16 * (warp & 3) + (lane >> 2);
    const int q = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      long long base = 0;
      bool ok;
      if (p.flat) {
        const long long m = (long long)tile * 128 + wg * 64 + r;
        ok = m < p.M;
        base = m * p.oW;
      } else {
        const TileOrigin o = tile_origin(p, tile);
        const int oy = o.oy0 + wg * p.wg_dy + (r >> 3);
        const int ox = o.ox0 + wg * p.wg_dx + (r & 7);
        ok = oy < p.Ho && ox < p.Wo;
        base = (long long)o.img * p.oN + (long long)oy * p.oH +
               (long long)ox * p.oW;
      }
      if (p.out_kind == kOutBF16) {
        constexpr int G = NT / 8;
#pragma unroll
        for (int b = 0; b < (G + 3) / 4; ++b) {
          // v: this lane's pair of group 4 b + j; w: lane j's pair of
          // group 4 b + q
          int v0[4], v1[4], w0[4], w1[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = 4 * b + j < G;
            v0[j] = in ? acc[4 * min(4 * b + j, G - 1) + 2 * h] : 0;
            v1[j] = in ? acc[4 * min(4 * b + j, G - 1) + 2 * h + 1] : 0;
            w0[j] = j == q ? v0[j] : 0;
            w1[j] = j == q ? v1[j] : 0;
          }
#pragma unroll
          for (int x = 1; x < 4; ++x) {
            const int src = q ^ x;
            int s0 = v0[0], s1 = v1[0];
#pragma unroll
            for (int j = 1; j < 4; ++j) {
              s0 = src == j ? v0[j] : s0;
              s1 = src == j ? v1[j] : s1;
            }
            s0 = __shfl_xor_sync(0xffffffffu, s0, x);
            s1 = __shfl_xor_sync(0xffffffffu, s1, x);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              w0[j] = src == j ? s0 : w0[j];
              w1[j] = src == j ? s1 : w1[j];
            }
          }
          const int co = n0 + 8 * (4 * b + q);
          if (!ok || co >= p.Cout || 4 * b + q >= G) continue;
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + base + co;
          if ((p.Cout & 7) == 0) {
            const float4 sa = __ldg(reinterpret_cast<const float4*>(p.out_scale + co));
            const float4 sb = __ldg(reinterpret_cast<const float4*>(p.out_scale + co + 4));
            const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
            uint32_t word[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              __nv_bfloat162 t;
              t.x = __float2bfloat16_rn(__fmul_rn(__int2float_rn(w0[j]), sc[2 * j]));
              t.y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(w1[j]), sc[2 * j + 1]));
              word[j] = *reinterpret_cast<uint32_t*>(&t);
            }
            *reinterpret_cast<uint4*>(o) =
                make_uint4(word[0], word[1], word[2], word[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (co + 2 * j < p.Cout)
                store_out(p.out, kOutBF16, base + co + 2 * j, w0[j],
                          __ldg(p.out_scale + co + 2 * j));
              if (co + 2 * j + 1 < p.Cout)
                store_out(p.out, kOutBF16, base + co + 2 * j + 1, w1[j],
                          __ldg(p.out_scale + co + 2 * j + 1));
            }
          }
        }
      } else {
#pragma unroll
        for (int b = 0; b < NT / 16; ++b) {
          // an even lane takes group 2 b (its pair and its neighbour's),
          // an odd one group 2 b + 1
          const bool even = (q & 1) == 0;
          const int a0 = acc[8 * b + 2 * h], a1 = acc[8 * b + 2 * h + 1];
          const int b0 = acc[8 * b + 4 + 2 * h], b1 = acc[8 * b + 5 + 2 * h];
          const int s0 = __shfl_xor_sync(0xffffffffu, even ? b0 : a0, 1);
          const int s1 = __shfl_xor_sync(0xffffffffu, even ? b1 : a1, 1);
          const int v[4] = {even ? a0 : s0, even ? a1 : s1, even ? s0 : b0,
                            even ? s1 : b1};
          const int co = n0 + (even ? 16 * b + 2 * q : 16 * b + 8 + 2 * (q - 1));
          if (!ok || co >= p.Cout) continue;
          if ((p.Cout & 3) == 0) {
            if (p.out_kind == kOutAcc) {
              *reinterpret_cast<int4*>(static_cast<int*>(p.out) + base + co) =
                  make_int4(v[0], v[1], v[2], v[3]);
            } else {
              const float4 sc =
                  __ldg(reinterpret_cast<const float4*>(p.out_scale + co));
              *reinterpret_cast<float4*>(static_cast<float*>(p.out) + base +
                                         co) =
                  make_float4(__fmul_rn(__int2float_rn(v[0]), sc.x),
                              __fmul_rn(__int2float_rn(v[1]), sc.y),
                              __fmul_rn(__int2float_rn(v[2]), sc.z),
                              __fmul_rn(__int2float_rn(v[3]), sc.w));
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (co + j < p.Cout)
                store_out(p.out, p.out_kind, base + co + j, v[j],
                          p.out_kind == kOutAcc ? 0.0f
                                                : __ldg(p.out_scale + co + j));
          }
        }
      }
    }
  }
}

// --------------------------------------------- depthwise on dp4a, TMA-fed

struct DwTma {
  int C, Ho, Wo, pad;
  int TH, TW, IH, IW;
  int row_words, ch_words;        // int8 tile: words a row, a channel (odd)
  int tiles_x;
  int box_bytes, off_q, off_bar;
  const int* wq;                  // (C, k, k rounded to 4) int8 as words
  const float* out_scale;
  void* out;
  long long oN, oH, oW;           // channels-last output, channel stride 1
  int out_kind, x_bf16;
  float s_in;
};

// A block: 128 bytes of channels (CB = 64 bf16 or 32 f32), TH x TW
// outputs of one image; 256 threads.
template <int K, int S, typename T>
__global__ void __launch_bounds__(256)
dw_tma_kernel(__grid_constant__ const CUtensorMap xmap,
              __grid_constant__ const DwTma p) {
  constexpr int CB = 128 / sizeof(T);
  constexpr int KQ = (K + 3) / 4;              // dp4a words a kernel row
  constexpr int NW = (7 * S + 4 * KQ + 3) / 4;  // words under 8 outputs
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const uint32_t bar = smem_u32(smem + p.off_bar);
  const int ty = blockIdx.x / p.tiles_x, tx = blockIdx.x - ty * p.tiles_x;
  const int c0 = blockIdx.y * CB, img = blockIdx.z;
  const int oy0 = ty * p.TH, ox0 = tx * p.TW;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, p.box_bytes);
    tma_load_4d(smem_u32(smem), &xmap, c0, ox0 * S - p.pad, oy0 * S - p.pad,
                img, bar);
  }
  mbar_wait(bar, 0);

  // quantize the raw [y][x][CB] box once into int8 [c][y][x], four x a word
  const T* raw = reinterpret_cast<const T*>(smem);
  uint32_t* q = reinterpret_cast<uint32_t*>(smem + p.off_q);
  const int units = CB * p.IH * p.row_words;
  for (int u = tid; u < units; u += 256) {
    const int c = u % CB;
    const int rest = u / CB;
    const int xw = rest % p.row_words, y = rest / p.row_words;
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * xw + e;
      v[e] = x < p.IW ? quantize(to_f32<T>(raw[(y * p.IW + x) * CB + c]),
                                 p.s_in)
                      : 0;
    }
    q[c * p.ch_words + y * p.row_words + xw] = pack4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  // each task: one channel, one output row, 8 outputs
  const int nseg = p.TW / 8;
  const int tasks = CB * p.TH * nseg;
  for (int task = tid; task < tasks; task += 256) {
    const int c = task % CB;
    const int rest = task / CB;
    const int seg = rest % nseg, r = rest / nseg;
    const int cg = c0 + c, oy = oy0 + r, oxs = ox0 + seg * 8;
    if (cg >= p.C || oy >= p.Ho || oxs >= p.Wo) continue;
    int acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const uint32_t* row = q + c * p.ch_words + (r * S + ky) * p.row_words +
                            seg * 2 * S;
      uint32_t w[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = row[i];
      int wk[KQ];
#pragma unroll
      for (int i = 0; i < KQ; ++i) wk[i] = __ldg(p.wq + (cg * K + ky) * KQ + i);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < KQ; ++i) {
          const int b = j * S + 4 * i;  // first byte of the window
          const uint32_t win =
              (b & 3) == 0 ? w[b >> 2]
                           : __funnelshift_r(w[b >> 2], w[(b >> 2) + 1],
                                             8 * (b & 3));
          acc[j] = __dp4a(static_cast<int>(win), wk[i], acc[j]);
        }
    }
    const float sc = p.out_kind == kOutAcc ? 0.0f : __ldg(p.out_scale + cg);
    const long long base =
        (long long)img * p.oN + (long long)oy * p.oH + cg;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (oxs + j < p.Wo)
        store_out(p.out, p.out_kind, base + (long long)(oxs + j) * p.oW,
                  acc[j], sc);
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda.so.1 the process has loaded
EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(
                              dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a tiled map over `rank` dims (innermost first), zero fill out of bounds
bool encode_map(CUtensorMap* map, const void* base, int bf16, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides_bytes,
                const cuuint32_t* box) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            rank, const_cast<void*>(base), dims, strides_bytes, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kSmemMax = 232448;  // a block's dynamic shared memory, sm_90
constexpr int kSmemTwoBlocks = 112 * 1024;  // two blocks an SM
constexpr int kSlotTarget = 32768;
constexpr int kInflightTarget = 64 * 1024;  // raw bytes in flight a block

int round_up(int v, int m) { return (v + m - 1) / m * m; }

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// blocks a kernel keeps on one SM at `smem` bytes, cached by kernel
// and size (the query costs host time on every call otherwise); callers
// may be on several host threads (ctypes releases the GIL)
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, int smem) {
  struct Entry {
    const void* k;
    int smem, n;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  const void* key = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < used; ++i)
    if (cache[i].k == key && cache[i].smem == smem) return cache[i].n;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemMax);
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  if (used < 64) cache[used++] = Entry{key, smem, n};
  return n;
}

// wgmma widths the dense route is built for
template <int NT>
cudaError_t launch_dense_nt(const CUtensorMap& map, const DenseTma& p,
                            int n_tiles, int smem, cudaStream_t stream) {
  auto kernel = dense_tma_kernel<NT>;
  const int per_sm = blocks_per_sm(kernel, kDenseThreads, smem);
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  int bx = per_sm * sm_count() / n_tiles;
  bx = bx < 1 ? 1 : (bx > p.m_tiles ? p.m_tiles : bx);
  kernel<<<dim3(bx, n_tiles), kDenseThreads, smem, stream>>>(map, p);
  return cudaGetLastError();
}

cudaError_t launch_dense_tma(const void* x, int x_bf16, int N, int C, int H,
                             int W, long long sN, long long sH, long long sW,
                             const void* wq, const float* out_scale, float s,
                             void* out, int out_kind, long long oN,
                             long long oH, long long oW, int Cout, int Ho,
                             int Wo, int k, int stride, int pad, int nt,
                             cudaStream_t stream) {
  const int elt = x_bf16 ? 2 : 4;
  DenseTma p{};
  p.C = C;
  p.Cout = Cout;
  p.Ho = Ho;
  p.Wo = Wo;
  p.k = k;
  p.s = stride;
  p.pad = pad;
  p.flat = k == 1 && stride == 1 && pad == 0 && sH == (long long)W * sW &&
           sN == (long long)H * sH && oH == (long long)Wo * oW &&
           oN == (long long)Ho * oH;
  p.M = (long long)N * H * W;
  p.nk32 = (C + kK32 - 1) / kK32;
  p.taps = k * k;
  CUtensorMap map;
  if (p.flat) {
    if (p.M > 0x7fffffffLL - 256) return cudaErrorInvalidValue;
    p.TH = 16;
    p.TW = 8;
    p.wg_dy = 8;
    p.wg_dx = 0;
    p.IH = 16;
    p.IW = 8;
    p.m_tiles = static_cast<int>((p.M + 127) / 128);
    p.tiles_x = p.tiles_y = 1;
  } else {
    // 16 x 8 or 8 x 16 outputs, whichever computes fewer past the edges
    const long long a16x8 = (long long)((Ho + 15) / 16 * 16) * ((Wo + 7) / 8 * 8);
    const long long a8x16 = (long long)((Ho + 7) / 8 * 8) * ((Wo + 15) / 16 * 16);
    if (a8x16 < a16x8) {
      p.TH = 8;
      p.TW = 16;
      p.wg_dy = 0;
      p.wg_dx = 8;
    } else {
      p.TH = 16;
      p.TW = 8;
      p.wg_dy = 8;
      p.wg_dx = 0;
    }
    p.IH = (p.TH - 1) * stride + k;
    p.IW = (p.TW - 1) * stride + k;
    p.tiles_x = (Wo + p.TW - 1) / p.TW;
    p.tiles_y = (Ho + p.TH - 1) / p.TH;
    const long long tiles = (long long)N * p.tiles_x * p.tiles_y;
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    p.m_tiles = static_cast<int>(tiles);
  }
  p.IWp = (p.IW + stride - 1) / stride;
  p.RS = stride * p.IWp * 16;
  p.GS = p.IH * p.RS;
  const int step_bytes = nt * 32;
  const int bars = 8 * (2 * kMaxStages + 4);
  // The shared-memory plan: a chunk width (channels whose raw rows stay
  // within 256 bytes), ring slots of at most kSlotTarget bytes (the halo's
  // rows split into bands), the weights resident or streamed by chunk.
  // Of the plans that fit, the one with the most bytes in flight (up to
  // kInflightTarget), resident weights before streamed ones, then the
  // widest chunk; within the half of an SM that lets two blocks share it
  // where the N tile's accumulators allow two, else within all of it.
  const int budgets[2] = {nt <= 128 ? kSmemTwoBlocks : kSmemMax, kSmemMax};
  long long best = -1;
  DenseTma q = p;
  for (int bi = 0; bi < 2 && best < 0; ++bi)
    for (int ch = 128; ch >= kK32; ch /= 2)
      for (int slot_max = kSlotTarget; slot_max >= 8192; slot_max /= 2) {
      if (ch * elt > 256 || (ch > kK32 && ch / 2 >= C)) continue;
      DenseTma c = p;
      c.ch = ch;
      c.lg_groups = ch == 128 ? 3 : (ch == 64 ? 2 : 1);
      c.nchunks = (C + ch - 1) / ch;
      c.a_bytes = round_up((ch / 16) * c.GS, 128);
      const int row_bytes = c.IW * ch * elt;
      const int rows = slot_max / row_bytes > 1 ? slot_max / row_bytes : 1;
      c.nbands = p.flat ? 1 : (c.IH + rows - 1) / rows;
      c.band = (c.IH + c.nbands - 1) / c.nbands;
      c.box_bytes = c.band * row_bytes;
      c.slot_bytes = round_up(c.box_bytes, 1024);
      c.b_chunk_bytes = (ch / kK32) * c.taps * step_bytes;
      const int b_total = c.nk32 * c.taps * step_bytes;
      for (int resident = 1; resident >= 0; --resident)
        for (int st = kMaxStages; st >= 2; --st) {
          const int b = round_up(resident ? b_total : 2 * c.b_chunk_bytes,
                                 128);
          const int smem = st * c.slot_bytes + 2 * c.a_bytes + b + bars;
          if (smem > budgets[bi]) continue;
          const long long inflight =
              st * c.box_bytes < kInflightTarget ? st * c.box_bytes
                                                 : kInflightTarget;
          const long long score = (inflight << 12) + (resident << 10) + ch;
          if (score > best) {
            best = score;
            q = c;
            q.stages = st;
            q.b_resident = resident;
          }
        }
    }
  if (best < 0) return cudaErrorInvalidValue;
  p = q;
  if (p.flat) {
    const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)p.M};
    const cuuint64_t strides[1] = {(cuuint64_t)(sW * elt)};
    const cuuint32_t box[2] = {(cuuint32_t)p.ch, 128};
    if (!encode_map(&map, x, x_bf16, 2, dims, strides, box))
      return cudaErrorInvalidValue;
  } else {
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)(sW * elt),
                                   (cuuint64_t)(sH * elt),
                                   (cuuint64_t)(sN * elt)};
    const cuuint32_t box[4] = {(cuuint32_t)p.ch, (cuuint32_t)p.IW,
                               (cuuint32_t)p.band, 1};
    if (!encode_map(&map, x, x_bf16, 4, dims, strides, box))
      return cudaErrorInvalidValue;
  }
  p.off_a = p.stages * p.slot_bytes;
  p.off_b = p.off_a + 2 * p.a_bytes;
  p.off_bar = p.off_b + round_up(p.b_resident ? p.nk32 * p.taps * step_bytes
                                              : 2 * p.b_chunk_bytes,
                                 128);
  const int smem = p.off_bar + bars;
  p.wq = static_cast<const int8_t*>(wq);
  p.out_scale = out_scale;
  p.out = out;
  p.oN = oN;
  p.oH = oH;
  p.oW = oW;
  p.out_kind = out_kind;
  p.x_bf16 = x_bf16;
  p.s_in = s;
  const int n_tiles = (Cout + nt - 1) / nt;
  switch (nt) {
    case 16: return launch_dense_nt<16>(map, p, n_tiles, smem, stream);
    case 32: return launch_dense_nt<32>(map, p, n_tiles, smem, stream);
    case 48: return launch_dense_nt<48>(map, p, n_tiles, smem, stream);
    case 64: return launch_dense_nt<64>(map, p, n_tiles, smem, stream);
    case 80: return launch_dense_nt<80>(map, p, n_tiles, smem, stream);
    case 128: return launch_dense_nt<128>(map, p, n_tiles, smem, stream);
    case 256: return launch_dense_nt<256>(map, p, n_tiles, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int K, int S, typename T>
cudaError_t launch_dw_kst(const CUtensorMap& map, const DwTma& p, dim3 grid,
                          int smem, cudaStream_t stream) {
  auto kernel = dw_tma_kernel<K, S, T>;
  if (blocks_per_sm(kernel, 256, smem) <= 0)
    return cudaErrorInvalidConfiguration;
  kernel<<<grid, 256, smem, stream>>>(map, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw_t(int k, int stride, const CUtensorMap& map,
                        const DwTma& p, dim3 grid, int smem,
                        cudaStream_t stream) {
  if (k == 3 && stride == 1) return launch_dw_kst<3, 1, T>(map, p, grid, smem, stream);
  if (k == 3 && stride == 2) return launch_dw_kst<3, 2, T>(map, p, grid, smem, stream);
  if (k == 5 && stride == 1) return launch_dw_kst<5, 1, T>(map, p, grid, smem, stream);
  if (k == 5 && stride == 2) return launch_dw_kst<5, 2, T>(map, p, grid, smem, stream);
  return cudaErrorInvalidValue;
}

constexpr int kDwSmemTarget = 72 * 1024;  // three blocks an SM

cudaError_t launch_dw_tma(const void* x, int x_bf16, int N, int C, int H,
                          int W, long long sN, long long sH, long long sW,
                          const void* wq, const float* out_scale, float s,
                          void* out, int out_kind, long long oN, long long oH,
                          long long oW, int Ho, int Wo, int k, int stride,
                          int pad, cudaStream_t stream) {
  const int elt = x_bf16 ? 2 : 4;
  const int CB = 128 / elt;
  const int KQ = (k + 3) / 4;
  const int NW = (7 * stride + 4 * KQ + 3) / 4;
  if (N > 65535) return cudaErrorInvalidValue;
  DwTma p{};
  // the tile that costs least: outputs computed (past the edges too) at
  // about 2 k KQ instructions each, input pixels quantized at about 12
  long long best = -1;
  for (int tw = 8; tw <= 16; tw += 8)
    for (int th = 4; th <= 40; ++th) {
      const int ih = (th - 1) * stride + k, iw = (tw - 1) * stride + k;
      const int row_words =
          (((tw / 8 - 1) * 8 * stride / 4 + NW) > (iw + 3) / 4)
              ? (tw / 8 - 1) * 8 * stride / 4 + NW
              : (iw + 3) / 4;
      const int ch_words = (ih * row_words) | 1;
      const int box = ih * iw * 128;
      const int smem = round_up(box, 1024) + CB * ch_words * 4 + 64;
      if (smem > kDwSmemTarget || iw > 256 || ih > 256) continue;
      const long long tiles =
          (long long)((Ho + th - 1) / th) * ((Wo + tw - 1) / tw);
      const long long cost =
          tiles * ((long long)th * tw * 2 * k * KQ + (long long)ih * iw * 12);
      if (best < 0 || cost < best) {
        best = cost;
        p.TH = th;
        p.TW = tw;
        p.IH = ih;
        p.IW = iw;
        p.row_words = row_words;
        p.ch_words = ch_words;
        p.box_bytes = box;
      }
    }
  if (best < 0) return cudaErrorInvalidValue;
  p.C = C;
  p.Ho = Ho;
  p.Wo = Wo;
  p.pad = pad;
  p.tiles_x = (Wo + p.TW - 1) / p.TW;
  p.off_q = round_up(p.box_bytes, 1024);
  p.off_bar = p.off_q + CB * p.ch_words * 4;
  p.off_bar = round_up(p.off_bar, 8);
  const int smem = p.off_bar + 8;
  p.wq = static_cast<const int*>(wq);
  p.out_scale = out_scale;
  p.out = out;
  p.oN = oN;
  p.oH = oH;
  p.oW = oW;
  p.out_kind = out_kind;
  p.x_bf16 = x_bf16;
  p.s_in = s;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)(sW * elt),
                                 (cuuint64_t)(sH * elt),
                                 (cuuint64_t)(sN * elt)};
  const cuuint32_t box[4] = {(cuuint32_t)CB, (cuuint32_t)p.IW,
                             (cuuint32_t)p.IH, 1};
  if (!encode_map(&map, x, x_bf16, 4, dims, strides, box))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)((Ho + p.TH - 1) / p.TH) * p.tiles_x;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((C + CB - 1) / CB),
                  static_cast<unsigned>(N));
  if (x_bf16)
    return launch_dw_t<__nv_bfloat16>(k, stride, map, p, grid, smem, stream);
  return launch_dw_t<float>(k, stride, map, p, grid, smem, stream);
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
// in elements. out_scale: (Cout,) f32 (unread in the accumulator mode).
// out: (N, Cout, Ho, Wo) at strides (oN, oC, oH, oW), f32 (out_kind 0),
// bf16 (1) or int32 accumulators (2). route:
// 0 generic. Dense (depthwise = 0): wq is (ceil(Cout / 64) * 64, Kp) int8,
//   each row k = (ky * kw + kx) * C + ci, zero past K = kh * kw * C and
//   past Cout, Kp % 32 == 0; vec = 1 promises C % 16 == 0, sC == 1 and
//   16-byte aligned 16-channel pieces. Depthwise (Cout == C): wq is
//   (C, kh * kw) int8 and Kp is unread.
// 1 dense on wgmma: wq is (ceil(Cout / nt), ceil(C / 32), kh * kw, nt / 8,
//   2, 8, 16) int8 (qconv.prepare_int8_weight); sC == 1 and oC == 1;
//   base, sN, sH, sW and C in 16-byte multiples; kh == kw.
// 2 depthwise on dp4a: wq is (C, kh, ceil(kw / 4) * 4) int8; the same
//   layout conditions; kh == kw in {3, 5}, stride 1 or 2.
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for
// what the route does not take.
extern "C" int pautdx_int8_conv(
    const void* x, int x_bf16, int N, int C, int H, int W, long long sN,
    long long sC, long long sH, long long sW, const void* wq,
    const void* out_scale, float in_scale, void* out, int out_kind,
    long long oN, long long oC, long long oH, long long oW, int Cout, int Ho,
    int Wo, int kh, int kw, int stride, int pad, int depthwise, int vec,
    int Kp, int route, int nt, void* stream) {
  if (N <= 0 || Cout <= 0 || Ho <= 0 || Wo <= 0) return cudaSuccess;
  if (out_kind < 0 || out_kind > 2) return cudaErrorInvalidValue;
  const float* os = static_cast<const float*>(out_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route != 0) {
    const int elt = x_bf16 ? 2 : 4;
    const bool layout =
        sC == 1 && oC == 1 && kh == kw &&
        reinterpret_cast<uintptr_t>(x) % 16 == 0 && (C * elt) % 16 == 0 &&
        (sW * elt) % 16 == 0 && (sH * elt) % 16 == 0 && (sN * elt) % 16 == 0;
    if (!layout) return cudaErrorInvalidValue;
    if (route == 1 && !depthwise)
      return launch_dense_tma(x, x_bf16, N, C, H, W, sN, sH, sW, wq, os,
                              in_scale, out, out_kind, oN, oH, oW, Cout, Ho,
                              Wo, kh, stride, pad, nt, st);
    if (route == 2 && depthwise && Cout == C)
      return launch_dw_tma(x, x_bf16, N, C, H, W, sN, sH, sW, wq, os,
                           in_scale, out, out_kind, oN, oH, oW, Ho, Wo, kh,
                           stride, pad, st);
    return cudaErrorInvalidValue;
  }
  if (!depthwise && Kp % BK != 0) return cudaErrorInvalidValue;
  Geometry g{N, C, H, W, sN, sC, sH, sW, Cout, Ho, Wo, kh, kw, stride, pad,
             oN, oC, oH, oW};
  if (x_bf16)
    return launch<__nv_bfloat16>(x, wq, os, in_scale, out, out_kind, g,
                                 depthwise, vec, Kp, st);
  return launch<float>(x, wq, os, in_scale, out, out_kind, g, depthwise, vec,
                       Kp, st);
}

// Host microseconds one cuTensorMapEncodeTiled call takes (a 4-d bf16 map,
// the dense route's), averaged over n calls; -1 where libcuda.so.1 lacks
// it. Every TMA-route call encodes one map, since the activation's
// address changes from call to call.
extern "C" double pautdx_int8_encode_us(int n) {
  static __align__(16) unsigned char fake[64];
  CUtensorMap map;
  const cuuint64_t dims[4] = {64, 40, 40, 128};
  const cuuint64_t strides[3] = {128, 128 * 40, 128 * 40 * 40};
  const cuuint32_t box[4] = {64, 10, 18, 1};
  if (n <= 0 || encode_fn() == nullptr) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i)
    if (!encode_map(&map, fake, 1, 4, dims, strides, box)) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / n;
}
