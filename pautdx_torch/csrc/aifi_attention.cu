// Fused AIFI self-attention for the D-FINE encoder, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pautdx/ops/pallas_attention.py::fused_attention
// (_attn_kernel): o = softmax(q k^T - rowmax) v for every (batch, head),
// q pre-scaled by dh^-0.5, scores and the PV sum in f32, the output in the
// input dtype. No mask, no dropout, inference only; any N >= 1. Head dims
// 16, 32 and 64, each its own instantiation of both kernels: the AIFI
// layers of the repo's configurations have 16 (dfine_nano, 128 channels /
// 8 heads) and 32 (DFineConfig(), 256 / 8).
//
// What bounds it on the H100: at the serving shape (B=128, 8 heads, N=400,
// dh=16, bf16) the kernel must read q, k, v and write o, 52 MB, which is
// 16 us at 3.35 TB/s, and its 10.5 GFLOP are 11 us on the bf16 tensor
// cores. Neither is the limit: with a head dimension of 16 every score
// costs as many multiply-adds as it costs one exponential, and the
// exponentials run on the special-function units (SFUs), 16 a clock on
// each SM. B*H*N^2 = 163.8 M exponentials over 132 SMs x 16 x 1.98 GHz are
// 39 us. At dh = 32 ((32, 8, 400, 32), the HF-architecture config) the
// exponentials (40.96 M, 9.8 us) still bound it above the bytes (26.2 MB,
// 7.8 us) and the products (5.24 GFLOP, 5.3 us); at dh = 64 the bytes
// catch up. The (B, h, N, N) score tensor (1.3 GB in f32 at b128) is what
// an unfused chain would move; this kernel never writes it.
//
// bf16, the serving path: tensor cores through mma.sync.m16n8k16 (bf16 in,
// f32 accumulate). wgmma would not move the bound: the products take 11
// us even well below peak, under the 39 us of exponentials.
// - One block of 8 warps per (batch, head, 512 queries); at N = 400 that
//   is one block per head, 1,024 blocks at b128, and the warps take the
//   head's 25 query tiles in turn. The block stages the head's K and V
//   rows (2 * dh bytes each) once into dynamic shared memory with 16-byte
//   cp.async straight from the strided layout, zero-filling the rows past
//   N up to a 64-key step (up to 512 keys at once: 128 KB for K and V at
//   dh = 64). The 16-byte chunks of a row are XORed with bits of the row
//   index, so that the 8 rows an ldmatrix reads at one chunk fall on 8
//   distinct bank groups at every dh.
// - A warp owns 16 query rows at a time (its A fragments, dh / 16 of them,
//   loaded once from device memory) and walks the keys 64 at a time:
//   8 x dh / 16 mma for S = Q K^T (K through ldmatrix as the col-major B
//   operand).
// - Online softmax in base 2: the scores are scaled by log2 e in f32, the
//   running max is kept in that base, and p = ex2.approx(s log2e - m) is
//   one FFMA and one SFU op per score (no expf, no -use_fast_math for the
//   other kernels). Row max by quad shuffles, one rescale per 64 keys; the
//   row sum is kept per thread and reduced by quad shuffles at the end.
// - The f32 score fragment is rounded to bf16 in registers and is, as it
//   stands, the A operand of P V (the layout FlashAttention-2 relies on);
//   V enters as the B operand through ldmatrix.trans, dh / 8 column tiles.
//   The unnormalized p is rounded to bf16 and the f32 sum divides at the
//   end, where the plain version rounds the normalized p: a different
//   rounding, held to the same gates.
//
// f32, the gate path: one thread per query on the CUDA cores, K and V
// staged through shared memory as f32 tiles of 2048 / dh keys, an online
// softmax rescaled every SUB keys. It stays off the tensor cores because
// its gate is 1e-5 with TF32 off: bf16 (8 bits of mantissa) or TF32 (10)
// products cannot hold it.
//
// Both read q, k, v and write o through (batch, head, token) strides, so
// the (B, N, D) projections are read in place: no split or merge of heads
// is materialised.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// ------------------------------------------------- f32, on the CUDA cores

constexpr int QT = 64;     // queries per block, one per thread
constexpr int SUB = 16;    // keys per online-softmax rescale

template <int DH>
__global__ void __launch_bounds__(QT)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int H,
                int N, long long sb, long long sh, long long sn) {
  constexpr int KT = 2048 / DH;   // keys per shared tile: 16 KB of k+v
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
    qr[d] = active ? q[base + qi * sn + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += KT) {
    const int kn = min(KT, N - k0);
    __syncthreads();              // previous tile fully consumed
    for (int e = threadIdx.x; e < kn * DH; e += QT) {
      const int j = e / DH, d = e % DH;
      const long long off = base + (long long)(k0 + j) * sn + d;
      ks[j][d] = k[off];
      vs[j][d] = v[off];
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
    for (int d = 0; d < DH; ++d) o[base + qi * sn + d] = acc[d] * inv;
  }
}

// -------------------------------------------- bf16, on the tensor cores

constexpr int WARPS = 8;
constexpr int TILES = 32;          // 16-query tiles per block: 512 queries
constexpr int KC = 512;            // keys staged in shared memory at once
constexpr int KB = 64;             // keys per online-softmax step
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of key row `row` (rows of 2 * DH
// bytes, DH / 8 chunks). Eight consecutive rows span 8 16-byte bank groups
// in all: 8 / CH rows share a 128-byte line, and the chunk index is XORed
// with the row's line within those 8 rows, so the 8 rows an ldmatrix
// reads at one chunk hit 8 distinct bank groups. The XOR term depends on
// row % 8 alone, so a 16-key group's offsets are its first row's plus
// those of rows 0-15.
template <int DH>
__device__ __forceinline__ unsigned swizzled(int row, int chunk) {
  constexpr int CH = DH / 8;
  return row * (2 * DH) + ((chunk ^ ((row / (8 / CH)) & (CH - 1))) << 4);
}

// 16 bytes from global to shared memory, or 16 zero bytes where !full
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr,
                                                  unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// d += a (16x16 bf16, row-major) . b (16x8 bf16, col-major), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one bf16x2 register, `lo` in the low half (round to nearest
// even, as astype does)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// K and V rows staged for keys [0, min(KC, N rounded up to KB)): the
// block's dynamic shared memory, in bytes
template <int DH>
size_t bf16_smem_bytes(int N) {
  const int rows = min(KC, (N + KB - 1) / KB * KB);
  return 2 * (size_t)rows * 2 * DH;
}

// At dh = 64 the fragments (acc and the scores, 64 f32 registers, plus
// Q and P) need more than the 128 registers ptxas gives by default at 256
// threads, which spilled: one resident block is asked for there, and the
// kernel takes 166 registers without spills. At dh = 16, asking for three
// blocks (80 registers, 16 B spilled) measured no faster than two.
template <int DH>
__global__ void __launch_bounds__(WARPS * 32, DH >= 64 ? 1 : 2)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int H, int N, long long sb,
                 long long sh, long long sn) {
  constexpr int CH = DH / 8;       // 16-byte chunks per K/V row
  constexpr int KS = DH / 16;      // k-steps of Q K^T; 16-column V blocks
  constexpr int NT = DH / 8;       // 8-column tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  const int staged = min(KC, (N + KB - 1) / KB * KB);
  unsigned char* ks = smem;
  unsigned char* vs = smem + (size_t)staged * 2 * DH;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long base = b * sb + h * sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;     // mma fragment row, column pair
  const int tile_end = min((N + 15) / 16, (int)(blockIdx.y + 1) * TILES);
  const bool one_chunk = N <= KC;
  const unsigned ks0 = smem_addr(ks), vs0 = smem_addr(vs);
  // this lane's ldmatrix row within a 16-key group: matrix lane / 8, row
  // lane % 8. K: matrices (keys 0-7 | 8-15) x (d 0-7 | 8-15 of a k-step),
  // key-major, giving the B fragments of two 8-key tiles; V, transposed:
  // (keys 0-7 | 8-15) x (d 0-7 | 8-15 of a column block), d-major, giving
  // those of two 8-column tiles.
  const int mi = lane >> 3, mr = lane & 7;
  const int k_row = ((mi >> 1) << 3) + mr, k_half = mi & 1;
  const int v_row = ((mi & 1) << 3) + mr, v_half = mi >> 1;

  // stage keys [c0, c0 + KC) of the head, zero rows up to a KB multiple
  auto stage = [&](int c0) {
    const int rows = min(KC, (N - c0 + KB - 1) / KB * KB);
    for (int e = threadIdx.x; e < CH * rows; e += WARPS * 32) {
      const int row = e / CH, chunk = e % CH;
      const bool in = c0 + row < N;
      const long long off =
          base + (long long)(in ? c0 + row : 0) * sn + chunk * 8;
      cp_async16(ks0 + swizzled<DH>(row, chunk), k + off, in);
      cp_async16(vs0 + swizzled<DH>(row, chunk), v + off, in);
    }
    cp_async_wait_all();
    __syncthreads();
  };

  if (one_chunk) stage(0);
  for (int round = blockIdx.y * TILES; round < tile_end; round += WARPS) {
    const int tile = round + warp;
    const bool active = tile < tile_end;      // warp-uniform
    const int r0 = tile * 16 + g, r1 = r0 + 8;
    const bool in0 = active && r0 < N, in1 = active && r1 < N;
    const unsigned* q0 =
        reinterpret_cast<const unsigned*>(q + base + r0 * sn + 2 * t);
    const unsigned* q1 =
        reinterpret_cast<const unsigned*>(q + base + r1 * sn + 2 * t);
    unsigned qa[KS][4];                       // Q: one A fragment a k-step
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      qa[s][0] = in0 ? q0[8 * s] : 0u;
      qa[s][1] = in1 ? q1[8 * s] : 0u;
      qa[s][2] = in0 ? q0[8 * s + 4] : 0u;    // columns 16s + 2t + 8, + 9
      qa[s][3] = in1 ? q1[8 * s + 4] : 0u;
    }

    float acc[NT][4] = {};                    // O: 16 rows x DH columns
    float m0 = -INFINITY, m1 = -INFINITY;     // rows g, g + 8, base 2
    float l0 = 0.f, l1 = 0.f;                 // this thread's part of l
    for (int c0 = 0; c0 < N; c0 += KC) {
      if (!one_chunk) {
        __syncthreads();                      // last chunk fully consumed
        stage(c0);
      }
      if (!active) continue;
      const int cn = min(KC, N - c0);
      for (int kb = 0; kb < cn; kb += KB) {
        float s[8][4] = {};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int st = 0; st < KS; ++st) {
            unsigned kf[4];
            ldmatrix_x4(ks0 + (kb + 16 * j) * (2 * DH) +
                            swizzled<DH>(k_row, 2 * st + k_half), kf);
            mma_bf16(s[2 * j], qa[st], kf[0], kf[1]);
            mma_bf16(s[2 * j + 1], qa[st], kf[2], kf[3]);
          }
        }
        if (kb + KB > cn) {                   // the ragged last step
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (kb + nt * 8 + 2 * t + (e & 1) >= cn) s[nt][e] = -INFINITY;
        }
        float bm0 = -INFINITY, bm1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          bm0 = fmaxf(bm0, fmaxf(s[nt][0], s[nt][1]));
          bm1 = fmaxf(bm1, fmaxf(s[nt][2], s[nt][3]));
        }
        bm0 = fmaxf(bm0, __shfl_xor_sync(FULL, bm0, 1));
        bm0 = fmaxf(bm0, __shfl_xor_sync(FULL, bm0, 2));
        bm1 = fmaxf(bm1, __shfl_xor_sync(FULL, bm1, 1));
        bm1 = fmaxf(bm1, __shfl_xor_sync(FULL, bm1, 2));
        // every step holds key kb < cn, so the new max is finite and the
        // first step's correction is ex2(-inf) = 0
        const float mn0 = fmaxf(m0, bm0 * LOG2E);
        const float mn1 = fmaxf(m1, bm1 * LOG2E);
        const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= corr0;
        l1 *= corr1;
#pragma unroll
        for (int d = 0; d < NT; ++d) {
          acc[d][0] *= corr0;
          acc[d][1] *= corr0;
          acc[d][2] *= corr1;
          acc[d][3] *= corr1;
        }
        unsigned pa[4][4];                    // P as four A fragments
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float p0 = ex2(fmaf(s[nt][0], LOG2E, -mn0));
          const float p1 = ex2(fmaf(s[nt][1], LOG2E, -mn0));
          const float p2 = ex2(fmaf(s[nt][2], LOG2E, -mn1));
          const float p3 = ex2(fmaf(s[nt][3], LOG2E, -mn1));
          l0 += p0 + p1;
          l1 += p2 + p3;
          pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
          pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int db = 0; db < KS; ++db) {
            unsigned vf[4];
            ldmatrix_x4_trans(vs0 + (kb + 16 * j) * (2 * DH) +
                                  swizzled<DH>(v_row, 2 * db + v_half), vf);
            mma_bf16(acc[2 * db], pa[j], vf[0], vf[1]);
            mma_bf16(acc[2 * db + 1], pa[j], vf[2], vf[3]);
          }
        }
      }
    }
    if (!active) continue;
    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      if (in0)
        *reinterpret_cast<unsigned*>(o + base + r0 * sn + d * 8 + 2 * t) =
            pack_bf16(acc[d][0] * inv0, acc[d][1] * inv0);
      if (in1)
        *reinterpret_cast<unsigned*>(o + base + r1 * sn + d * 8 + 2 * t) =
            pack_bf16(acc[d][2] * inv1, acc[d][3] * inv1);
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int dtype,
           int B, int H, int N, long long sb, long long sh, long long sn,
           cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid(B * H, (N + QT - 1) / QT);
    attn_f32_kernel<DH><<<grid, QT, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, N, sb, sh,
        sn);
    return cudaGetLastError();
  }
  if (dtype == 1) {
    // opt in on every launch (cheap), so it holds on whichever device is
    // current: past 48 KB (dh 32 from N = 385, dh 64 from N = 193) a
    // launch needs it
    const size_t smem = bf16_smem_bytes<DH>(N);
    const cudaError_t opted = cudaFuncSetAttribute(
        attn_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (opted != cudaSuccess) return opted;
    const dim3 grid(B * H, ((N + 15) / 16 + TILES - 1) / TILES);
    attn_bf16_kernel<DH><<<grid, WARPS * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), H, N, sb, sh, sn);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o share one layout: element (b, h, n, d) at b*sb + h*sh + n*sn + d.
// dtype 0 = float32, 1 = bfloat16 (16-byte aligned, strides multiples of
// 8); dh 16, 32 or 64. Returns cudaGetLastError() of the launch.
extern "C" int pautdx_aifi_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype,
                                     int B, int H, int N, int dh,
                                     long long sb, long long sh, long long sn,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || N < 1) return cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch<16>(q, k, v, o, dtype, B, H, N, sb, sh, sn, s);
    case 32: return launch<32>(q, k, v, o, dtype, B, H, N, sb, sh, sn, s);
    case 64: return launch<64>(q, k, v, o, dtype, B, H, N, sb, sh, sn, s);
    default: return cudaErrorInvalidValue;
  }
}
