// Fused AIFI self-attention for the D-FINE encoder, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pautdx/ops/pallas_attention.py::fused_attention
// (_attn_kernel): o = softmax(q k^T - rowmax) v for every (batch, head),
// q pre-scaled by dh^-0.5, scores and the PV sum in f32, the output in the
// input dtype. No mask, no dropout, inference only; any N >= 1 and any
// head dim dh from 1 to 256, in f32 and in bf16. The AIFI layers of the
// repo's configurations have 16 (dfine_nano, 128 channels / 8 heads) and
// 32 (DFineConfig(), 256 / 8).
//
// Head dims. Each kernel is instantiated at DK = 16, 32, 64, 128 and 256,
// the width its q and k rows are padded to (dh rounds up to the next), and
// computes DV = min(DK, 64) columns of v and o: a dh past 64 takes
// ceil(dh / 64) blocks along grid.z, each recomputing the scores for its
// 64 columns, which keeps the O accumulator at 32 f32 registers a thread.
// Columns past dh are zero in shared memory (a 0-byte cp.async or a 0
// store), so they change neither q k^T nor the kept columns, and o's
// padded columns are never written. Where q, k, v, o, a stride or dh is
// off 16-byte pieces (dh 1, 37, or 100 in bf16), an instantiation stages
// element by element instead (VEC = false). Past dh = 256 the caller gets
// cudaErrorInvalidValue: the port's own ceiling (the AIFI layers use 16
// and 32), not the TPU kernel's, which takes any dh.
//
// What bounds it on the H100: at the serving shape (B=128, 8 heads, N=400,
// dh=16, bf16) the kernel must read q, k, v and write o, 52 MB, which is
// 16 us at 3.35 TB/s, and its 10.5 GFLOP are 11 us on the bf16 tensor
// cores. Neither is the limit: with a head dimension of 16 every score
// costs as many multiply-adds as it costs one exponential, and the
// exponentials run on the special-function units (SFUs), 16 a clock on
// each SM. B*H*N^2 = 163.8 M exponentials over 132 SMs x 16 x 1.98 GHz are
// 39 us. At dh = 32 ((32, 8, 400, 32), the HF-architecture config) the
// exponentials (40.96 M, 9.8 us) still bound bf16 above the bytes (26.2
// MB, 7.8 us) and the products (5.24 GFLOP, 5.3 us). In f32 the products
// bound it: 5.24 GFLOP are 78 us on the CUDA cores (67 TFLOP/s) and 32 us
// as three TF32 products each (495 TFLOP/s). The (B, h, N, N) score
// tensor (1.3 GB in f32 at b128) is what an unfused chain would move;
// this kernel never writes it.
//
// Both dtypes share one shape of work: a block stages a head's K and V
// once into dynamic shared memory (in chunks of KC keys where N is
// larger), zero rows past N up to a key step; a warp's Q fragments come
// once from device memory; an online softmax in base 2 (scores scaled by
// log2 e in f32, p = ex2.approx(s log2e - m), one FFMA and one SFU op a
// score, no expf, one rescale a key step, row max and sum by quad
// shuffles); and P never leaves registers: the f32 score fragment is, as
// it stands, the A operand of P V.
//
// bf16, the serving path: mma.sync.m16n8k16 (bf16 in, f32 accumulate),
// 8 warps a block, a warp 16 queries at a time, 64 keys a step. wgmma
// would not move the bound: the products take 11 us even well below peak,
// under the 39 us of exponentials.
// - K and V rows (2 * DK and 2 * DV bytes) are staged by 16-byte cp.async
//   straight from the strided layout, K's and V's chunks of a row in one
//   loop, up to KC = 512 keys at once (256 at DK = 256, so that K and V
//   fit the 227 KB a block may have). V's rows start at the fixed offset
//   KC * 2 * DK: at dh 16, V at a runtime offset (N's rows after K) read
//   2 % slower (kernel_ab.py). The 16-byte chunks of a row are
//   XORed with bits of the row index, so that the 8 rows an ldmatrix
//   reads at one chunk fall on 8 distinct bank groups at every width.
// - S = Q K^T takes 8 x DK / 16 mma a step, K through ldmatrix as the
//   col-major B operand; P V takes 4 x DV / 8, V through ldmatrix.trans.
// - The unnormalized p is rounded to bf16 and the f32 sum divides at the
//   end, where the plain version rounds the normalized p: a different
//   rounding, held to the same gates.
//
// f32, the gate path (atol = rtol = 1e-5 with TF32 off): wgmma in TF32,
// each product split three ways (3xTF32). One TF32 product keeps 10 bits
// of mantissa and cannot hold the gate; the split x = big + small, big = x
// rounded to TF32 (to nearest, by adding half a TF32 ulp to the bits and
// masking), small = x - big (exact in f32), and a b ~ a_big b_big +
// a_big b_small + a_small b_big, summed in f32, keeps about 22 bits. The
// tensor core reads the small parts' top 10 mantissa bits and accumulates
// in f32 with truncation, so each key step's P V starts from zero and is
// merged into O by one f32 FFMA (which also applies the softmax rescale),
// and Q K^T runs in groups of 4 k-steps added in f32: max |err| against
// the plain version 2.15e-6 at (128, 8, 400, 16) (phase 3) and 3.34e-6
// over dh 1-256 (phase 14), where one chain across all keys read 5.7e-6
// and 8.5e-6 (chip_smoke.py).
// - Two warpgroups a block (three at dh 32: 5 % faster than two); a
//   warpgroup takes 64-query tiles (wgmma's M) in turn, 7 at N = 400. Q (big and small) and P are A operands in
//   registers; K and V^T, split once into big and small parts at staging,
//   are B operands in shared memory, K-major in 8 x 16-byte core matrices
//   without swizzle (descriptor LBO 128 B along K). V is staged transposed
//   with the keys of each 8 in the order of the score fragment's columns
//   (2t, 2t + 1 as A's columns t, t + 4), so P needs no shuffle.
// - A key step is 32 keys: three wgmma a k-step for S, then the softmax,
//   then three a key tile for P V, each batch waited for before its
//   result is read (issuing the next step's S before the softmax measured
//   slower). KC is as many keys as fit 104 KB at DK = 16 (two blocks an
//   SM) and 224 KB elsewhere: 416 and 448 keys, N = 400 in one chunk.
// - ptxas (sm_90a), DK 16/32/64/128/256 in 16-byte pieces (element
//   by element): f32 114/163/207/158/210 registers (128/157/220/164/223),
//   bf16 108/128/168/182/220 (110/128/168/194/234), no spills. The same
//   f32 design on mma.sync.m16n8k8 (a warp 16 queries, B split in
//   registers) read 13-19 % slower than wgmma with two warpgroups, and
//   neither pre-splitting K and V in shared memory nor two query tiles a
//   warp moved that one (PERF.md).
//
// Both read q, k, v and write o through (batch, head, token) strides, so
// the (B, N, D) projections are read in place: no split or merge of heads
// is materialised.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;            // bf16: warps a block
constexpr int TILES = 32;          // bf16: 16-query tiles a block, 512
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DV = 64;         // columns of v and o a block computes

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --------------------------------------- f32, 3xTF32 on wgmma (sm_90a)

constexpr int WKB = 32;                // keys an online-softmax step
constexpr int WTILES = 8;              // 64-query tiles a block: 512 queries

// warpgroups a block: 3 at dh 32, where one block takes an SM's shared
// memory and 3 x 128 threads x 163 registers fit its register file; 2
// elsewhere (two blocks an SM at DK = 16)
template <int DK>
__host__ __device__ constexpr int f32_wg() {
  return DK == 32 ? 3 : 2;
}

// keys staged at once (K and V^T, big and small parts: 8 * (DK + DV)
// bytes a key), a multiple of the key step, at most 512: two blocks an SM
// at DK = 16, one elsewhere
template <int DK, int DV>
__host__ __device__ constexpr int f32_kc() {
  return (DK <= 16 ? 104 : 224) * 1024 / ((DK + DV) * 8) / WKB * WKB < 512
             ? (DK <= 16 ? 104 : 224) * 1024 / ((DK + DV) * 8) / WKB * WKB
             : 512;
}

template <int DK, int DV>
size_t f32_smem_bytes(int N) {
  const int stride = min(f32_kc<DK, DV>(), (N + WKB - 1) / WKB * WKB);
  return (size_t)stride * (DK + DV) * 8;
}

// x = big + small: big rounded to TF32 (nearest, ties away), small exact
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x
// 16 bytes, `lbo` bytes apart along K and `sbo` bytes apart along M/N
__device__ __forceinline__ unsigned long long gmma_desc(unsigned addr,
                                                        unsigned lbo,
                                                        unsigned sbo) {
  return (unsigned long long)((addr >> 4) & 0x3FFF) |
         ((unsigned long long)((lbo >> 4) & 0x3FFF) << 16) |
         ((unsigned long long)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from touching an accumulator before the wait
template <int R>
__device__ __forceinline__ void wg_hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x nN, this thread's N / 2) = a . b, or += where acc: a (m64 x k8
// tf32) from registers, b from shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const unsigned (&a)[4],
                                           unsigned long long b, int acc) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
        "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  } else {
    static_assert(N == 64, "wgmma_tf32: n16, n32 or n64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
}

// 3xTF32: d (= or +=) a . b from the big and small parts of both, small
// terms first
template <int N>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[N / 2],
                                             const unsigned (&ab)[4],
                                             const unsigned (&as)[4],
                                             unsigned long long bb,
                                             unsigned long long bs, int acc) {
  wgmma_tf32<N>(d, as, bb, acc);
  wgmma_tf32<N>(d, ab, bs, 1);
  wgmma_tf32<N>(d, ab, bb, 1);
}

// K (keys x DK), K-major in core matrices of 8 keys x 4 columns
template <int DK>
__device__ __forceinline__ int wk_index(int key, int c) {
  return (((key >> 3) * (DK / 4) + (c >> 2)) << 5) | ((key & 7) << 2) |
         (c & 3);
}

// V^T (DV columns x `stride` keys), K-major in core matrices of 8 columns
// x 4 key positions; within 8 keys, position j holds key 2j (j < 4) or
// 2(j - 4) + 1, the order of the score fragment's columns
__device__ __forceinline__ int wv_index(int d, int key, int stride) {
  const int r = key & 7;
  const int pos = (key & ~7) | ((r & 1) ? 4 + (r >> 1) : (r >> 1));
  return (((d >> 3) * (stride / 4) + (pos >> 2)) << 5) | ((d & 7) << 2) |
         (pos & 3);
}

template <int DK, int DV, bool VEC>
__global__ void __launch_bounds__(f32_wg<DK>() * 128, DK <= 16 ? 2 : 1)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int H,
                int N, int dh, long long sb, long long sh, long long sn) {
  constexpr int KC = f32_kc<DK, DV>();
  constexpr int NK = WKB / 8;      // 8-key tiles a step
  constexpr int KS = DK / 8;       // k-steps of Q K^T
  constexpr int NT = DV / 8;       // 8-column blocks of O
  constexpr bool Q_IN_REGS = DK <= 64;
  constexpr int WG = f32_wg<DK>();
  constexpr int THREADS = WG * 128;
  extern __shared__ __align__(128) unsigned fsm[];
  const int stride = min(KC, (N + WKB - 1) / WKB * WKB);
  unsigned* kbig = fsm;                        // K, big and small parts
  unsigned* ksml = kbig + stride * DK;
  unsigned* vbig = ksml + stride * DK;         // V^T
  unsigned* vsml = vbig + stride * DV;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long base = b * sb + h * sh;
  const int col0 = blockIdx.z * DV;          // first column of v and o
  const int wg = threadIdx.x >> 7;
  const int wl = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;     // fragment row, column
  const int tile_end = min((N + 63) / 64, (int)(blockIdx.y + 1) * WTILES);
  const bool one_chunk = N <= KC;

  // 4 columns from column c of row r, zero past N or dh
  auto load4 = [&](const float* src, int r, int c, float (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = 0.f;
    if (r >= N) return;
    const float* p = src + base + (long long)r * sn + c;
    if constexpr (VEC) {
      if (c < dh) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(p));
        x[0] = w.x;
        x[1] = w.y;
        x[2] = w.z;
        x[3] = w.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < dh) x[i] = __ldg(p + i);
    }
  };

  // stage keys [c0, c0 + KC) of the head, zero rows up to a key step,
  // each value split once into the big and small parts wgmma reads; the
  // loads of four pieces are issued before any is stored
  auto stage = [&](int c0) {
    const int rows = min(KC, (N - c0 + WKB - 1) / WKB * WKB);
    for (int e0 = threadIdx.x; e0 < rows * (DK / 4); e0 += 4 * THREADS) {
      float x[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS;
        load4(k, e < rows * (DK / 4) ? c0 + e / (DK / 4) : N,
              4 * (e % (DK / 4)), x[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS;
        if (e >= rows * (DK / 4)) break;
        const int r = e / (DK / 4), c = 4 * (e % (DK / 4));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(x[u][i], kbig[wk_index<DK>(r, c + i)],
                     ksml[wk_index<DK>(r, c + i)]);
      }
    }
    // V^T: a thread takes 4 columns of one key, neighbours neighbouring
    // keys
    for (int e0 = threadIdx.x; e0 < rows * (DV / 4); e0 += 4 * THREADS) {
      float x[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS;
        load4(v, e < rows * (DV / 4) ? c0 + e % rows : N,
              col0 + 4 * (e / rows), x[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS;
        if (e >= rows * (DV / 4)) break;
        const int r = e % rows, c = 4 * (e / rows);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(x[u][i], vbig[wv_index(c + i, r, stride)],
                     vsml[wv_index(c + i, r, stride)]);
      }
    }
    // the generic stores, made visible to the async proxy wgmma reads
    // through
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  const unsigned kb0 = smem_addr(kbig), ks0 = smem_addr(ksml);
  const unsigned vb0 = smem_addr(vbig), vs0 = smem_addr(vsml);

  if (one_chunk) stage(0);
  for (int round = blockIdx.y * WTILES; round < tile_end; round += WG) {
    const int tile = round + wg;
    const bool active = tile < tile_end;     // warpgroup-uniform
    const int r0 = tile * 64 + wl * 16 + g, r1 = r0 + 8;
    const bool in0 = active && r0 < N, in1 = active && r1 < N;
    // Q's A fragments, big and small parts: rows g, g + 8 of the warp's
    // 16, columns t and t + 4 of k-step s
    auto q_frag = [&](int s, unsigned (&ab)[4], unsigned (&as)[4]) {
      auto qv = [&](bool in, int r, int c) {
        return in && c < dh ? __ldg(q + base + (long long)r * sn + c) : 0.f;
      };
      split_tf32(qv(in0, r0, 8 * s + t), ab[0], as[0]);
      split_tf32(qv(in1, r1, 8 * s + t), ab[1], as[1]);
      split_tf32(qv(in0, r0, 8 * s + t + 4), ab[2], as[2]);
      split_tf32(qv(in1, r1, 8 * s + t + 4), ab[3], as[3]);
    };
    unsigned qb[Q_IN_REGS ? KS : 1][4], qs[Q_IN_REGS ? KS : 1][4];
    if constexpr (Q_IN_REGS) {
#pragma unroll
      for (int s = 0; s < KS; ++s) q_frag(s, qb[s], qs[s]);
    }

    float acc[NT * 4] = {};                  // O: 16 rows x DV columns
    float m0 = -INFINITY, m1 = -INFINITY;    // rows g, g + 8, base 2
    float l0 = 0.f, l1 = 0.f;                // this thread's part of l
    for (int c0 = 0; c0 < N; c0 += KC) {
      if (!one_chunk) {
        __syncthreads();                     // last chunk fully consumed
        stage(c0);
      }
      if (!active) continue;
      const int cn = min(KC, N - c0);
      for (int kb = 0; kb < cn; kb += WKB) {
        // S in groups of 4 k-steps (32 columns), each group's chain from
        // zero and the groups added in f32: the tensor core's f32
        // accumulation truncates, and a chain's error grows with its length
        float s[NK * 4];
#pragma unroll
        for (int st0 = 0; st0 < KS; st0 += 4) {
          float sg[NK * 4] = {};
          unsigned ab[Q_IN_REGS ? 1 : 4][4], as[Q_IN_REGS ? 1 : 4][4];
          if constexpr (!Q_IN_REGS) {
#pragma unroll
            for (int st = 0; st < 4; ++st) q_frag(st0 + st, ab[st], as[st]);
          }
          wg_fence();
#pragma unroll
          for (int st = st0; st < st0 + 4 && st < KS; ++st) {
            const unsigned off = ((kb / 8) * (DK / 4) + 2 * st) * 128;
            const unsigned long long db = gmma_desc(kb0 + off, 128, 32 * DK);
            const unsigned long long ds = gmma_desc(ks0 + off, 128, 32 * DK);
            if constexpr (Q_IN_REGS)
              wgmma_3xtf32<WKB>(sg, qb[st], qs[st], db, ds, st > st0);
            else
              wgmma_3xtf32<WKB>(sg, ab[st - st0], as[st - st0], db, ds,
                                st > st0);
          }
          wg_commit_wait();
          wg_hold(sg);
#pragma unroll
          for (int e = 0; e < NK * 4; ++e)
            s[e] = st0 == 0 ? sg[e] : s[e] + sg[e];
        }
        // s[4n + e]: key kb + 8n + 2t + (e & 1) of row g (e < 2) or g + 8
        if (kb + WKB > cn) {                 // the ragged last step
#pragma unroll
          for (int e = 0; e < NK * 4; ++e)
            if (kb + (e >> 2) * 8 + 2 * t + (e & 1) >= cn) s[e] = -INFINITY;
        }
        float bm0 = -INFINITY, bm1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          bm0 = fmaxf(bm0, fmaxf(s[4 * n], s[4 * n + 1]));
          bm1 = fmaxf(bm1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
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
        // the score fragment as the A operand of P V: its columns (keys
        // 2t, 2t + 1) are A's columns t and t + 4, the key positions V^T
        // is staged in
        unsigned pb[NK][4], ps[NK][4];
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float p0 = ex2(fmaf(s[4 * n], LOG2E, -mn0));
          const float p1 = ex2(fmaf(s[4 * n + 1], LOG2E, -mn0));
          const float p2 = ex2(fmaf(s[4 * n + 2], LOG2E, -mn1));
          const float p3 = ex2(fmaf(s[4 * n + 3], LOG2E, -mn1));
          l0 += p0 + p1;
          l1 += p2 + p3;
          split_tf32(p0, pb[n][0], ps[n][0]);
          split_tf32(p2, pb[n][1], ps[n][1]);
          split_tf32(p1, pb[n][2], ps[n][2]);
          split_tf32(p3, pb[n][3], ps[n][3]);
        }
        // this step's P V from zero, merged into acc by one f32 FFMA
        float pv[NT * 4] = {};
        wg_fence();
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const unsigned off = ((kb + 8 * n) / 4) * 128;
          const unsigned long long db = gmma_desc(vb0 + off, 128, 32 * stride);
          const unsigned long long ds = gmma_desc(vs0 + off, 128, 32 * stride);
          wgmma_3xtf32<DV>(pv, pb[n], ps[n], db, ds, n > 0);
        }
        wg_commit_wait();
        wg_hold(pv);
#pragma unroll
        for (int d = 0; d < NT; ++d) {
          acc[4 * d] = fmaf(acc[4 * d], corr0, pv[4 * d]);
          acc[4 * d + 1] = fmaf(acc[4 * d + 1], corr0, pv[4 * d + 1]);
          acc[4 * d + 2] = fmaf(acc[4 * d + 2], corr1, pv[4 * d + 2]);
          acc[4 * d + 3] = fmaf(acc[4 * d + 3], corr1, pv[4 * d + 3]);
        }
      }
    }
    if (!active) continue;
    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    auto store = [&](bool in, int r, int c, float x, float y) {
      if (!in) return;
      float* p = o + base + (long long)r * sn + c;
      if constexpr (VEC) {
        if (c < dh) *reinterpret_cast<float2*>(p) = make_float2(x, y);
      } else {
        if (c < dh) p[0] = x;
        if (c + 1 < dh) p[1] = y;
      }
    };
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      const int c = col0 + 8 * d + 2 * t;
      store(in0, r0, c, acc[4 * d] * inv0, acc[4 * d + 1] * inv0);
      store(in1, r1, c, acc[4 * d + 2] * inv1, acc[4 * d + 3] * inv1);
    }
  }
}

// -------------------------------------------- bf16, on the tensor cores

constexpr int KB = 64;             // keys per online-softmax step

// keys staged at once: K and V of 512 keys fit up to DK = 128
template <int DK>
__host__ __device__ constexpr int bf16_kc() {
  return DK <= 128 ? 512 : 256;
}

// Byte offset of 16-byte chunk `chunk` of a row of CH chunks. Eight
// consecutive rows span 8 16-byte bank groups in all: where a row is
// narrower than 128 bytes, 8 / CH rows share a line and the chunk index
// is XORed with the row's line within those 8 rows; where it is 128 bytes
// or wider, with the row index's low 3 bits. Either way the 8 rows an
// ldmatrix reads at one chunk hit 8 distinct bank groups, and the XOR
// term depends on row % 16 alone.
template <int CH>
__device__ __forceinline__ unsigned swizzled(unsigned row, unsigned chunk) {
  if constexpr (CH >= 8)
    return row * (16 * CH) + ((chunk ^ (row & 7)) << 4);
  else
    return row * (16 * CH) + ((chunk ^ ((row / (8 / CH)) & (CH - 1))) << 4);
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

// two f32 -> one bf16x2 register, `lo` in the low half (round to nearest
// even, as astype does)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ unsigned short bf16_bits(__nv_bfloat16 x) {
  return *reinterpret_cast<unsigned short*>(&x);
}

// K rows for KC keys at offset 0, then V rows for keys [0, min(KC, N
// rounded up to KB)): the block's dynamic shared memory, in bytes
template <int DK, int DV>
size_t bf16_smem_bytes(int N) {
  const int rows = min(bf16_kc<DK>(), (N + KB - 1) / KB * KB);
  return (size_t)bf16_kc<DK>() * 2 * DK + (size_t)rows * 2 * DV;
}

// At DK >= 64 the fragments (acc and the scores, 64 f32 registers, plus
// Q and P) need more than the 128 registers ptxas gives by default at 256
// threads, which spilled: one resident block is asked for there, and the
// kernel took 166 registers without spills at dh 64. At dh = 16, asking
// for three blocks (80 registers, 16 B spilled) measured no faster than
// two.
template <int DK, int DV, bool VEC>
__global__ void __launch_bounds__(WARPS * 32, DK >= 64 ? 1 : 2)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int H, int N, int dh,
                 long long sb, long long sh, long long sn) {
  constexpr int KC = bf16_kc<DK>();
  constexpr int CHK = DK / 8;      // 16-byte chunks per K row
  constexpr int CHV = DV / 8;      // and per V row
  constexpr int KS = DK / 16;      // k-steps of Q K^T
  constexpr int VB = DV / 16;      // 16-column V blocks
  constexpr int NT = DV / 8;       // 8-column tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vs = smem + KC * 2 * DK;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long base = b * sb + h * sh;
  const int col0 = blockIdx.z * DV;          // first column of v and o
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
  const unsigned k_row = ((mi >> 1) << 3) + mr, k_half = mi & 1;
  const unsigned v_row = ((mi & 1) << 3) + mr, v_half = mi >> 1;

  // stage keys [c0, c0 + KC) of the head, zero rows up to a KB multiple:
  // 16-byte cp.async, or element by element off 16-byte alignment
  auto stage = [&](int c0) {
    const int rows = min(KC, (N - c0 + KB - 1) / KB * KB);
    if constexpr (VEC) {
      // K's and V's chunks of a row in one loop (V's rows are CHV <= CHK
      // chunks): measured faster at dh 16 than a loop for each
      for (int e = threadIdx.x; e < CHK * rows; e += WARPS * 32) {
        const int row = e / CHK, chunk = e % CHK;
        const bool in_row = c0 + row < N;
        const long long off = base + (long long)(in_row ? c0 + row : 0) * sn +
                              8 * chunk;
        // a copy of 0 bytes still gets an address inside the head
        const bool in_k = in_row && 8 * chunk < dh;
        cp_async16(ks0 + swizzled<CHK>(row, chunk), k + (in_k ? off : base),
                   in_k);
        const bool in_v = in_row && col0 + 8 * chunk < dh;
        if (chunk < CHV)
          cp_async16(vs0 + swizzled<CHV>(row, chunk),
                     v + (in_v ? off + col0 : base), in_v);
      }
      cp_async_wait_all();
    } else {
      for (int e = threadIdx.x; e < DK * rows; e += WARPS * 32) {
        const int row = e / DK, c = e % DK;
        const bool in = c0 + row < N && c < dh;
        *reinterpret_cast<__nv_bfloat16*>(
            ks + swizzled<CHK>(row, c >> 3) + 2 * (c & 7)) =
            in ? k[base + (long long)(c0 + row) * sn + c]
               : __float2bfloat16(0.f);
      }
      for (int e = threadIdx.x; e < DV * rows; e += WARPS * 32) {
        const int row = e / DV, c = e % DV;
        const bool in = c0 + row < N && col0 + c < dh;
        *reinterpret_cast<__nv_bfloat16*>(
            vs + swizzled<CHV>(row, c >> 3) + 2 * (c & 7)) =
            in ? v[base + (long long)(c0 + row) * sn + col0 + c]
               : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
  };

  // q's columns c, c + 1 of row r as one bf16x2, zero past N or dh
  auto q_pair = [&](bool in, int r, int c) -> unsigned {
    if (!in) return 0u;
    const __nv_bfloat16* p = q + base + (long long)r * sn + c;
    if constexpr (VEC)
      return c < dh ? *reinterpret_cast<const unsigned*>(p) : 0u;
    const unsigned lo = c < dh ? bf16_bits(p[0]) : 0u;
    const unsigned hi = c + 1 < dh ? bf16_bits(p[1]) : 0u;
    return lo | (hi << 16);
  };

  if (one_chunk) stage(0);
  for (int round = blockIdx.y * TILES; round < tile_end; round += WARPS) {
    const int tile = round + warp;
    const bool active = tile < tile_end;      // warp-uniform
    const int r0 = tile * 16 + g, r1 = r0 + 8;
    const bool in0 = active && r0 < N, in1 = active && r1 < N;
    unsigned qa[KS][4];                       // Q: one A fragment a k-step
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      qa[s][0] = q_pair(in0, r0, 16 * s + 2 * t);
      qa[s][1] = q_pair(in1, r1, 16 * s + 2 * t);
      qa[s][2] = q_pair(in0, r0, 16 * s + 2 * t + 8);
      qa[s][3] = q_pair(in1, r1, 16 * s + 2 * t + 8);
    }

    float acc[NT][4] = {};                    // O: 16 rows x DV columns
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
            ldmatrix_x4(ks0 + (kb + 16 * j) * (2 * DK) +
                            swizzled<CHK>(k_row, 2 * st + k_half), kf);
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
          for (int db = 0; db < VB; ++db) {
            unsigned vf[4];
            ldmatrix_x4_trans(vs0 + (kb + 16 * j) * (2 * DV) +
                                  swizzled<CHV>(v_row, 2 * db + v_half), vf);
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
    auto store = [&](bool in, int r, int c, float x, float y) {
      if (!in || c >= dh) return;
      __nv_bfloat16* p = o + base + (long long)r * sn + c;
      if constexpr (VEC) {
        *reinterpret_cast<unsigned*>(p) = pack_bf16(x, y);
      } else {
        p[0] = __float2bfloat16(x);
        if (c + 1 < dh) p[1] = __float2bfloat16(y);
      }
    };
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      const int c = col0 + 8 * d + 2 * t;
      store(in0, r0, c, acc[d][0] * inv0, acc[d][1] * inv0);
      store(in1, r1, c, acc[d][2] * inv1, acc[d][3] * inv1);
    }
  }
}

// dh in (DK / 2, DK] (or [1, 16] at DK = 16): ceil(dh / DV) column blocks
template <int DK, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, int dtype,
           int B, int H, int N, int dh, long long sb, long long sh,
           long long sn, cudaStream_t s) {
  constexpr int DV = DK < MAX_DV ? DK : MAX_DV;
  // opt in on every launch (cheap), so it holds on whichever device is
  // current: past 48 KB a launch needs it
  if (dtype == 0) {
    const size_t smem = f32_smem_bytes<DK, DV>(N);
    const cudaError_t opted = cudaFuncSetAttribute(
        attn_f32_kernel<DK, DV, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (opted != cudaSuccess) return opted;
    const dim3 grid(B * H, ((N + 63) / 64 + WTILES - 1) / WTILES,
                    (dh + DV - 1) / DV);
    attn_f32_kernel<DK, DV, VEC><<<grid, f32_wg<DK>() * 128, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, N, dh, sb,
        sh, sn);
    return cudaGetLastError();
  }
  const size_t smem = bf16_smem_bytes<DK, DV>(N);
  const cudaError_t opted = cudaFuncSetAttribute(
      attn_bf16_kernel<DK, DV, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opted != cudaSuccess) return opted;
  const dim3 grid(B * H, ((N + 15) / 16 + TILES - 1) / TILES,
                  (dh + DV - 1) / DV);
  attn_bf16_kernel<DK, DV, VEC><<<grid, WARPS * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, N, dh, sb, sh, sn);
  return cudaGetLastError();
}

// the instantiation of dh, with 16-byte pieces or element by element
template <bool VEC>
int dispatch(const void* q, const void* k, const void* v, void* o,
             int dtype, int B, int H, int N, int dh, long long sb,
             long long sh, long long sn, cudaStream_t s) {
  if (dh <= 16) return launch<16, VEC>(q, k, v, o, dtype, B, H, N, dh, sb, sh, sn, s);
  if (dh <= 32) return launch<32, VEC>(q, k, v, o, dtype, B, H, N, dh, sb, sh, sn, s);
  if (dh <= 64) return launch<64, VEC>(q, k, v, o, dtype, B, H, N, dh, sb, sh, sn, s);
  if (dh <= 128) return launch<128, VEC>(q, k, v, o, dtype, B, H, N, dh, sb, sh, sn, s);
  return launch<256, VEC>(q, k, v, o, dtype, B, H, N, dh, sb, sh, sn, s);
}

}  // namespace

// q, k, v, o share one layout: element (b, h, n, d) at b*sb + h*sh + n*sn + d.
// dtype 0 = float32, 1 = bfloat16; 1 <= dh <= 256. Returns
// cudaGetLastError() of the launch.
extern "C" int pautdx_aifi_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype,
                                     int B, int H, int N, int dh,
                                     long long sb, long long sh, long long sn,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || N < 1 || dh < 1 || dh > 256 || dtype < 0 ||
      dtype > 1)
    return cudaErrorInvalidValue;
  // 16-byte pieces: every pointer on a 16-byte boundary and every stride
  // and dh a whole number of pieces
  const long long e = dtype == 0 ? 4 : 8;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15) == 0 &&
      sb % e == 0 && sh % e == 0 && sn % e == 0 && dh % e == 0;
  return vec ? dispatch<true>(q, k, v, o, dtype, B, H, N, dh, sb, sh, sn, s)
             : dispatch<false>(q, k, v, o, dtype, B, H, N, dh, sb, sh, sn, s);
}
