// Row gather of the discrete deformable attention, CUDA C++ for sm_90a.
//
// Replaces the forward of the TPU kernel
// pautdx/ops/pallas_gather.py::pallas_onehot_gather (_gather_kernel):
// out[b, t, :] = flat[b, clip(idx[b, t], 0, L - 1), :], exact in any dtype.
// On the TPU the gather is a one-hot matmul on the MXU over a table held in
// VMEM; on the H100 a row gather is plain memory traffic, so this kernel
// copies rows and does no arithmetic at all.
//
// What bounds it on the H100: bytes. At the serving shape (B=128 frames,
// a 2000-row x 128-channel bf16 table per frame, T=1200 taps) it writes
// 39.3 MB and reads 0.6 MB of indices plus the table rows the taps touch
// (at most 0.5 MB per frame, mostly served from the 50 MB L2): about 12 us
// at 3.35 TB/s.
//
// Design: the output is viewed as (B*T rows) x (row bytes / 16) uint4
// vectors (a 256-byte bf16 row is 16 of them). One thread per output vector,
// in a grid-stride loop: neighbouring threads read neighbouring pieces of one
// row and write neighbouring pieces of the output, so both sides coalesce.
// Each thread loads its row's index itself and clamps it; rows never
// straddle a frame, so the index is the only lookup. Rows must be a multiple
// of 16 bytes and the pointers 16-byte aligned; the wrapper refuses others.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_kernel(const uint4* __restrict__ flat,
                              const int* __restrict__ idx,
                              uint4* __restrict__ out, int L, int T,
                              long long rows, int vpr) {
  const long long n = rows * vpr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long row = i / vpr;
    const int c = (int)(i - row * vpr);
    const long long b = row / T;
    int j = __ldg(idx + row);
    j = min(max(j, 0), L - 1);
    out[i] = flat[(b * L + j) * vpr + c];
  }
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// flat (B, L, row_bytes), idx (B, T) int32, out (B, T, row_bytes), all
// contiguous, row_bytes a multiple of 16, flat and out 16-byte aligned.
// Copies bytes, so any element type works. Returns cudaGetLastError() of the
// launch.
extern "C" int pautdx_onehot_gather(const void* flat, const void* idx,
                                    void* out, int B, int L, int T,
                                    long long row_bytes, void* stream) {
  const long long rows = (long long)B * T;
  if (rows == 0) return cudaSuccess;
  if (L <= 0 || row_bytes <= 0 || row_bytes % 16 || !aligned(flat) ||
      !aligned(out))
    return cudaErrorInvalidValue;
  const int vpr = (int)(row_bytes / 16);
  const long long n = rows * vpr;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 16;     // 16 blocks per SM, then grid-stride
  if (blocks > cap) blocks = cap;
  gather_kernel<<<(unsigned)blocks, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(flat), static_cast<const int*>(idx),
      static_cast<uint4*>(out), L, T, rows, vpr);
  return cudaGetLastError();
}
