"""A/B of pautdx_torch's CUDA kernels between checkouts, on one card.

    python3 kernel_ab.py times [--tree DIR]
    python3 kernel_ab.py sass [--match NAME] [--out DIR] SRC.cu [SRC.cu ...]
    python3 kernel_ab.py mma

``times`` imports ``pautdx_torch`` from DIR (default: the checkout beside
this script), builds its kernels and times each kernel record's wrapper at
the main paths' shapes, on inputs made on the card from a fixed seed:
device time per call from ``torch.profiler`` (``chip_smoke.device_ms``,
the method of ``chip_smoke.py``'s kernel records), with L2 flushed before
each call and without. The timing code is this checkout's whatever DIR
is, so two checkouts run in turns in one call (parent, change, change,
parent) are measured alike. The last line is one JSON object.

``sass`` compiles each source with the port's nvcc flags to a cubin and
prints, for every kernel whose name holds NAME, its instruction count and
its opcodes by count (``cuobjdump -sass``); with ``--out`` it writes each
full listing there.

``mma`` times ``mma.sync`` alone on the card: TF32 m16n8k8 and bf16
m16n8k16 with f32 accumulators, 8 warps a block and 4 or 2 blocks an SM
(32 or 16 warps), or one warp an SM, each warp issuing C independent
chains (C = 1, 2, 4, 8): the rate an SM sustains, and, with one chain and
one warp, the latency of one product. All three
need the CUDA toolkit; ``times`` and ``mma`` need a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_calls(torch, dev) -> dict:
    """name -> a call of one kernel wrapper at a main path's shape."""
    from pautdx_torch.ops import attention, gather, masks, suppress
    from pautdx_torch.ops.nms import box_iou_matrix

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    calls = {}
    # AIFI attention: the serving shape (dh 16) and the HF predict's (32)
    for B, dh in ((128, 16), (32, 32)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn(B, 400, 8 * dh, dtype=dtype) for _ in range(3))
            q = q * dh ** -0.5
            name = f"aifi_attention_dh{dh}_{str(dtype).split('.')[1]}"
            calls[name] = (lambda q=q, k=k, v=v:
                           attention.aifi_attention(q, k, v, 8))
    # YOLO predict: NMS over (32, 300) candidates, masks of K=100 boxes
    xy = rand(32, 300, 2) * 560
    iou = box_iou_matrix(torch.cat([xy, xy + 10 + rand(32, 300, 2) * 150],
                                   -1))
    valid = rand(32, 300) > 0.2
    calls["nms_suppress"] = lambda: suppress.nms_suppress(iou, valid, 0.45)
    protos, coeffs = randn(32, 160, 160, 32), randn(32, 100, 32)
    mxy = rand(32, 100, 2) * 700 - 60
    mboxes = torch.cat([mxy, mxy + rand(32, 100, 2) * 320], -1)
    calls["assemble_masks"] = lambda: masks.assemble_masks(
        protos, coeffs, mboxes, (640, 640))
    # serving's one-hot gather; training's weighted gather and backwards
    table = randn(128, 2000, 128, dtype=torch.bfloat16)
    idx = torch.randint(0, 2000, (128, 1200), generator=gen, device=dev,
                        dtype=torch.int32)
    calls["onehot_gather"] = lambda: gather.onehot_gather(table, idx)
    flat, g = randn(16, 2000, 128), randn(16, 1200, 128)
    widx = torch.randint(-3, 2003, (16, 1200, 4), generator=gen, device=dev,
                         dtype=torch.int32)
    w = rand(16, 1200, 4)
    calls["weighted_gather"] = lambda: gather.weighted_gather(flat, widx, w)
    calls["weighted_gather_backward"] = lambda: (
        gather.weighted_gather_backward(flat, widx, w, g))
    oidx = widx[..., 0].contiguous()
    calls["onehot_gather_backward"] = lambda: (
        gather.onehot_gather_backward(g, oidx, 2000))
    # the weighted gather's two other training shapes: the b4 step with a
    # denoising group (342 queries x 8 points) and a temporal v3 step (one
    # 50-frame sequence as the batch)
    for suffix, B, T in (("_denoising", 4, 2736), ("_temporal_train", 50,
                                                   1200)):
        tf, tg = randn(B, 2000, 128), randn(B, T, 128)
        ti = torch.randint(-3, 2003, (B, T, 4), generator=gen, device=dev,
                           dtype=torch.int32)
        tw = rand(B, T, 4)
        calls["weighted_gather" + suffix] = (
            lambda tf=tf, ti=ti, tw=tw: gather.weighted_gather(tf, ti, tw))
        calls["weighted_gather_backward" + suffix] = (
            lambda tf=tf, ti=ti, tw=tw, tg=tg:
            gather.weighted_gather_backward(tf, ti, tw, tg))
    return calls


def times(tree: str) -> None:
    import chip_smoke  # this checkout's timing method, before DIR's package

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import pautdx_torch
    from pautdx_torch.ops import _build

    where = os.path.dirname(os.path.dirname(os.path.abspath(
        pautdx_torch.__file__)))
    chip_smoke.check(where == os.path.abspath(tree),
                     f"pautdx_torch imported from {where}, not {tree}")
    chip_smoke.check(torch.cuda.is_available(), "needs a card")
    chip_smoke.set_tf32(False)
    _build.build()
    calls = kernel_calls(torch, torch.device("cuda"))
    out = {"tree": os.path.abspath(tree), "card": chip_smoke.smi_line()}
    flush = chip_smoke.FLUSH_BYTES
    with torch.no_grad():
        for mode, nbytes in (("flushed", flush), ("warm", 0)):
            chip_smoke.FLUSH_BYTES = nbytes
            out[mode] = {name: chip_smoke.device_ms(fn)
                         for name, fn in calls.items()}
    chip_smoke.FLUSH_BYTES = flush
    for name in calls:
        print(f"{name}: device ms per call, L2 flushed "
              f"{out['flushed'][name]:.4f}, warm {out['warm'][name]:.4f}",
              flush=True)
    print(json.dumps(out))


_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T\d]+\s+)?([A-Z][A-Z0-9_]*)")


def sass(sources: list, match: str, out_dir: str) -> None:
    sys.path.insert(0, HERE)
    from pautdx_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    for src in sources:
        with tempfile.TemporaryDirectory() as tmp:
            cubin = os.path.join(tmp, "k.cubin")
            subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, src],
                           check=True, capture_output=True, text=True)
            listing = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                                     capture_output=True, text=True).stdout
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            name = os.path.basename(os.path.dirname(os.path.abspath(src)))
            with open(os.path.join(out_dir, f"{name}_{os.path.basename(src)}"
                                   ".sass"), "w") as f:
                f.write(listing)
        for part in listing.split("Function : ")[1:]:
            fname = part.split("\n", 1)[0].strip()
            if match not in fname:
                continue
            ops = collections.Counter(_OPCODE.findall(part))
            print(f"{src} {fname}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {n}" for k, n in ops.most_common()),
                  flush=True)


_MMA_SRC = r"""
#include <cuda_runtime.h>
template <int C, bool TF32>
__global__ void __launch_bounds__(256) bench(float* out, int iters) {
  float d[C][4] = {};
  const unsigned a0 = threadIdx.x, a1 = a0 * 3u, a2 = a0 ^ 5u, a3 = a0 + 7u;
  const unsigned b0 = blockIdx.x, b1 = b0 + 1u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (TF32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float x = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) x += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}
template <int C>
int go(bool tf32, float* out, int blocks, int threads, int iters, cudaStream_t s) {
  if (tf32) bench<C, true><<<blocks, threads, 0, s>>>(out, iters);
  else bench<C, false><<<blocks, threads, 0, s>>>(out, iters);
  return cudaGetLastError();
}
extern "C" int mma_bench(int tf32, int chains, float* out, int blocks,
                         int threads, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return go<1>(tf32, out, blocks, threads, iters, s);
    case 2: return go<2>(tf32, out, blocks, threads, iters, s);
    case 4: return go<4>(tf32, out, blocks, threads, iters, s);
    default: return go<8>(tf32, out, blocks, threads, iters, s);
  }
}
"""


def mma() -> None:
    import ctypes

    import torch

    sys.path.insert(0, HERE)
    import chip_smoke
    from pautdx_torch.ops import _build

    chip_smoke.check(torch.cuda.is_available(), "needs a card")
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "mma.cu"), os.path.join(tmp, "mma.so")
        with open(src, "w") as f:
            f.write(_MMA_SRC)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                       check=True, capture_output=True, text=True)
        fn = ctypes.CDLL(lib).mma_bench
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    f_sm = chip_smoke.max_sm_clock_hz()
    out = torch.empty(4 * n_sm * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(f"card {chip_smoke.smi_line()}, {n_sm} SMs, clocks.max.sm "
          f"{f_sm / 1e6:.0f} MHz", flush=True)
    for tf32, flop in ((1, 2 * 16 * 8 * 8), (0, 2 * 16 * 8 * 16)):
        for chains in (1, 2, 4, 8):
            for blocks, threads in ((4 * n_sm, 256), (2 * n_sm, 256),
                                    (n_sm, 32)):
                iters = 4096

                def run():
                    chip_smoke.check(fn(tf32, chains, out.data_ptr(), blocks,
                                        threads, iters, stream) == 0,
                                     "mma bench launch failed")

                ms = chip_smoke.time_ms(run, reps=10)
                n = blocks * threads // 32 * iters * chains
                print(f"{'tf32 m16n8k8' if tf32 else 'bf16 m16n8k16'}: "
                      f"{chains} chain(s) a warp, {blocks} blocks of "
                      f"{threads} threads: {ms:.4f} ms, "
                      f"{n * flop / ms / 1e9:.1f} TFLOP/s, "
                      f"{n / n_sm / (ms * 1e-3 * f_sm):.3f} mma a clock an "
                      f"SM at clocks.max.sm", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("times")
    t.add_argument("--tree", default=HERE)
    s = sub.add_parser("sass")
    s.add_argument("--match", default="")
    s.add_argument("--out", default="")
    s.add_argument("sources", nargs="+")
    sub.add_parser("mma")
    args = ap.parse_args()
    if args.cmd == "times":
        times(args.tree)
    elif args.cmd == "sass":
        sass(args.sources, args.match, args.out)
    else:
        mma()


if __name__ == "__main__":
    main()
