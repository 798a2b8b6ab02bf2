// Row gather of the discrete deformable attention, CUDA C++ for sm_90a.
//
// Replaces the forward of the TPU kernel
// pautdx/ops/pallas_gather.py::pallas_onehot_gather (_gather_kernel):
// out[b, t, :] = flat[b, clip(idx[b, t], 0, L - 1), :], exact in any dtype.
// On the TPU the gather is a one-hot matmul on the MXU over a table held in
// VMEM; on the H100 a row gather is plain memory traffic, so this kernel
// copies rows and does no arithmetic at all.
//
// What bounds it on the H100: bytes, the copy engine, and at small batches
// the latency of each dependent step. At the serving shape (B=128 frames,
// a 2000-row x 128-channel bf16 table per frame, T=1200 taps) it writes
// 39.3 MB and reads 0.6 MB of indices plus the table rows the taps touch
// (at most 0.5 MB per frame): about 16 us at 3.35 TB/s. Every row goes
// through an SM's copy engine, which takes about one bulk copy every 25 ns
// whatever its size (kernel_ab.py times on an H100): 1,164 copies an SM
// here, near 26 us. At a denoising step's b4 (T = 2736 f32 taps) the bound
// is about 2 us, a few DRAM latencies: index load, row load and store are
// a chain, so the whole launch's rows must be in flight at once.
//
// Design: the taps are cut into tiles of tt taps of one frame, and each of
// their rows into pieces of cb bytes (the whole row unless a row outgrows
// the tile); the plan, and the grid, are ops/gather.py::forward_tiles. A
// block is one warp that walks tiles gridDim.x apart with `stages` tiles
// in flight, each in its own shared-memory buffer and mbarrier. To issue a
// tile, each lane loads up to 8 of its indices at once, clamps them, and
// only then issues one bulk asynchronous copy (cp.async.bulk) per row piece
// into the buffer, completing on the buffer's mbarrier, which expects the
// tile's bytes: no thread spends a register or an instruction on the
// bytes. When a tile has landed, its output rows, which lie next to each
// other in `out`, leave by one bulk store (a row at a time when rows are
// cut into pieces); once the store has read the buffer, the next tile is
// issued into it. So loads of later tiles overlap the stores of earlier
// ones. Rows must be a multiple of 16 bytes and the pointers 16-byte
// aligned; the wrapper refuses others.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kPerLane = 8;    // indices a lane loads before it issues copies
constexpr int kMaxStages = 8;  // tiles a block may have in flight

// 1-d grid, 32 threads, stages * tt * cb bytes of dynamic shared memory;
// tiles = B * ceil(T / tt) * pieces, tile (b * ceil(T / tt) + tile of T) *
// pieces + piece. kWhole: one piece, the row.
template <bool kWhole>
__global__ void __launch_bounds__(32)
onehot_tile(const char* __restrict__ flat, const int* __restrict__ idx,
            char* __restrict__ out, int L, int T, long long row_bytes,
            int tt, int cb, int pieces, int stages, int tiles) {
  extern __shared__ __align__(128) unsigned char tile[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const int lane = threadIdx.x;
  const int per_frame = (T + tt - 1) / tt * pieces;
  const uint32_t stage_bytes = (uint32_t)tt * cb;
  const uint32_t base = bulk::smem_u32(tile);
  if (lane == 0)
    for (int s = 0; s < stages; ++s) bulk::mbar_init(bulk::smem_u32(&full[s]), 1);
  __syncwarp();

  // tile `id`: frame b, taps t0 .. t0 + n - 1, bytes c0 .. c0 + nb - 1 of
  // each row
  struct Where {
    long long b, c0;
    int t0, n;
    uint32_t nb;
  };
  auto locate = [&](int id) {
    Where w;
    const int b = id / per_frame;
    int r = id - b * per_frame, piece = 0;
    if (!kWhole) {
      piece = r % pieces;
      r /= pieces;
    }
    w.b = b;
    w.t0 = r * tt;
    w.n = min(tt, T - w.t0);
    w.c0 = (long long)piece * cb;
    w.nb = (uint32_t)min((long long)cb, row_bytes - w.c0);
    return w;
  };
  // indices first, clamped, then one bulk copy per row, all into buffer s;
  // refill: once the stores from s have read it
  auto issue = [&](int id, int s, bool refill) {
    const Where w = locate(id);
    const uint32_t bar = bulk::smem_u32(&full[s]);
    const uint32_t dst = base + s * stage_bytes;
    const int* ip = idx + w.b * T + w.t0;
    const char* fp = flat + w.b * L * row_bytes + w.c0;
    for (int i0 = 0; i0 < w.n; i0 += 32 * kPerLane) {
      int j[kPerLane];
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int i = i0 + u * 32 + lane;
        j[u] = i < w.n ? min(max(__ldg(ip + i), 0), L - 1) : 0;
      }
      if (i0 == 0) {
        if (refill) bulk::wait_read();
        if (lane == 0) bulk::mbar_arrive_expect_tx(bar, w.n * w.nb);
        __syncwarp();
      }
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int i = i0 + u * 32 + lane;
        if (i < w.n) bulk::load(dst + i * cb, fp + j[u] * row_bytes, w.nb, bar);
      }
    }
  };

  int next = blockIdx.x;   // the next tile to issue
  for (int s = 0; s < stages && next < tiles; ++s, next += gridDim.x)
    issue(next, s, false);
  for (int k = 0, id = blockIdx.x; id < tiles; ++k, id += gridDim.x) {
    const int s = k % stages;
    if (k > 0 && next < tiles) {
      // the buffer of the previous tile, once its store has read it
      issue(next, (k - 1) % stages, true);
      next += gridDim.x;
    }
    bulk::mbar_wait(bulk::smem_u32(&full[s]), (k / stages) & 1);
    bulk::fence_async();
    const Where w = locate(id);
    char* op = out + (w.b * T + w.t0) * row_bytes + w.c0;
    const uint32_t src = base + s * stage_bytes;
    if (kWhole) {
      if (lane == 0) bulk::store(op, src, w.n * w.nb);
    } else {
      for (int i = lane; i < w.n; i += 32)
        bulk::store(op + i * row_bytes, src + i * cb, w.nb);
    }
    bulk::commit();
  }
  bulk::wait_read();   // shared memory stays until the stores have read it
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// flat (B, L, row_bytes), idx (B, T) int32, out (B, T, row_bytes), all
// contiguous, row_bytes a multiple of 16, flat and out 16-byte aligned. The
// plan: tiles of tt taps by cb bytes of each row (cb a multiple of 16),
// `stages` tiles in flight in each of `blocks` blocks (stages * tt * cb
// bytes at most 227 KB). Copies bytes, so any element type works. Returns
// cudaGetLastError() of the launch.
extern "C" int pautdx_onehot_gather(const void* flat, const void* idx,
                                    void* out, int B, int L, int T,
                                    long long row_bytes, int tt, int cb,
                                    int stages, int blocks, void* stream) {
  if ((long long)B * T == 0) return cudaSuccess;
  if (L <= 0 || row_bytes <= 0 || row_bytes % 16 || !aligned(flat) ||
      !aligned(out) || tt <= 0 || cb <= 0 || cb % 16 || stages < 1 ||
      stages > kMaxStages || blocks < 1)
    return cudaErrorInvalidValue;
  if (cb > row_bytes) cb = (int)row_bytes;
  const long long smem = (long long)stages * tt * cb;
  const long long pieces = (row_bytes + cb - 1) / cb;
  const long long tiles = (long long)B * ((T + tt - 1) / tt) * pieces;
  if (smem > bulk::kMaxSmem || tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto kernel = pieces == 1 ? &onehot_tile<true> : &onehot_tile<false>;
  if (smem > bulk::kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)(blocks < tiles ? blocks : tiles), 32, (size_t)smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(flat), static_cast<const int*>(idx),
      static_cast<char*>(out), L, T, row_bytes, tt, cb, (int)pieces, stages,
      (int)tiles);
  return cudaGetLastError();
}
