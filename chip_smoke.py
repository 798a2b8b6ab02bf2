"""Smoke run of pautdx_torch on one NVIDIA card: builds the CUDA kernels,
holds each against its plain PyTorch version, then drives the D-FINE-nano
640px serving path (the configuration of the root ``bench.py``) through
its entry points.

    python3 chip_smoke.py

Phases, one line each, in order; any failure exits non-zero:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: ``nvcc`` of every ``pautdx_torch/csrc/*.cu``, all at once;
3. attention kernel vs plain at (128, 8, 400, 16), f32 and bf16, and at a
   ragged N=37;
4. gather kernel vs plain at (128, 2000, 128) x 1200 taps, bf16 and f32,
   indices out of range included: bit for bit;
5. the full model in f32 at batch 4, once through the kernels and once
   through the plain versions, detection sets matched by assignment; each
   forward must launch the attention kernel once and the gather thrice;
6. the serving run: bf16 weights, folded uint8 stem, a (8, 128, 80, 80,
   192) uint8 slab; counts every kernel's launches over that run, checks
   the outputs are finite, and times frames/s (through the kernels and,
   in turns with it, through the plain versions), each kernel at the
   inputs that run gave it, its plain version and one library call that
   computes the same function.

The line before last is ``nvidia-smi``'s; before it, one JSON object with
a record per kernel. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a card, or without the package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM rate and dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12

BATCH = 128
N_STEPS = 8
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SERVING_ATTN_ULPS = 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call, from a CUDA event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def matched_costs(cost: np.ndarray) -> np.ndarray:
    """Costs of the minimum-cost perfect matching of a square cost matrix,
    one per row (the Hungarian method with potentials)."""
    n = cost.shape[0]
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    row_of = np.zeros(n + 1, dtype=int)      # column j -> its row (1-based)
    way = np.zeros(n + 1, dtype=int)
    for i in range(1, n + 1):
        row_of[0] = i
        j0 = 0
        minv = np.full(n + 1, np.inf)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = row_of[j0]
            free = ~used[1:]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            cand = np.where(free, minv[1:], np.inf)
            j1 = int(np.argmin(cand)) + 1
            delta = cand[j1 - 1]
            u[row_of[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if row_of[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            row_of[j0] = row_of[j1]
            j0 = j1
    rows = row_of[1:] - 1
    return cost[rows, np.arange(n)]


def same_detections(logits_a, boxes_a, logits_b, boxes_b) -> str:
    """The criterion of tests/test_dfine_parity.py: a bijection between the
    two query sets in which all but at most 4 pairs of (box, sigmoid score)
    lie within 2e-3 and the median pair within 1e-3. Returns "" or why
    not."""
    for b in range(logits_a.shape[0]):
        fa = np.concatenate([boxes_a[b], 1 / (1 + np.exp(-logits_a[b]))], -1)
        fb = np.concatenate([boxes_b[b], 1 / (1 + np.exp(-logits_b[b]))], -1)
        cost = np.linalg.norm(fa[:, None, :] - fb[None, :, :], axis=-1)
        m = matched_costs(cost)
        if (m < 2e-3).sum() < m.shape[0] - 4 or np.median(m) >= 1e-3:
            return (f"frame {b}: worst matched costs {np.sort(m)[-6:]}, "
                    f"median {np.median(m):.3g}")
    return ""


@contextmanager
def plain_kernels(attention, gather):
    """Route the model's kernel calls to the plain versions for a while."""
    saved = attention.aifi_attention, gather.onehot_gather
    attention.aifi_attention = attention.aifi_attention_reference
    gather.onehot_gather = gather.onehot_gather_reference
    try:
        yield
    finally:
        attention.aifi_attention, gather.onehot_gather = saved


@contextmanager
def first_inputs(attention, gather, captured: dict):
    """Keep the arguments of the first call of each kernel wrapper."""
    saved = attention.aifi_attention, gather.onehot_gather

    def attn(q, k, v, num_heads):
        captured.setdefault("attention", (q, k, v, num_heads))
        return saved[0](q, k, v, num_heads)

    def gath(flat, idx):
        captured.setdefault("gather", (flat, idx))
        return saved[1](flat, idx)

    attention.aifi_attention, gather.onehot_gather = attn, gath
    try:
        yield
    finally:
        attention.aifi_attention, gather.onehot_gather = saved


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA card and does not run on the CPU")
    sys.path.insert(0, HERE)
    try:
        import pautdx_torch
    except ImportError as e:
        fail(f"pautdx_torch is not beside this script: {e}")
    check(os.path.dirname(os.path.dirname(os.path.abspath(
        pautdx_torch.__file__))) == HERE,
        f"pautdx_torch imported from {pautdx_torch.__file__}, not from "
        f"this checkout")
    from pautdx_torch.models.vision.dfine import DFine
    from pautdx_torch.ops import _build, attention, gather
    from pautdx_torch.serve.throughput import (
        build_serving_model, fold_uint8_stem, make_streaming_forward,
        make_uint8_slab, measure_fps, serving_config,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # 1. device
    smi = smi_line()
    print(f"[1 device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    nvcc_s = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    print(f"[2 build] {len(_build.SOURCES)} kernels "
          f"({', '.join(_build.SOURCES)}): {nvcc_s:.2f} s of parallel nvcc, "
          f"{time.perf_counter() - t0:.2f} s to build and load", flush=True)

    # 3. attention kernel vs plain
    worst = {}
    for dtype, n in ((torch.float32, 400), (torch.bfloat16, 400),
                     (torch.float32, 37), (torch.bfloat16, 37)):
        name = str(dtype).split(".")[1]
        q, k, v = (randn(BATCH, 8, n, 16, dtype=dtype) for _ in range(3))
        q = q * 0.25                       # dh ** -0.5, as TorchMHA scales
        got = attention.fused_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention.fused_attention_reference(q, k, v)
        err = max_abs_err(got, want)
        check(got.dtype == dtype and got.shape == q.shape,
              f"attention {name} N={n}: got {got.dtype} {tuple(got.shape)}")
        tol = ATTN_TOL[name]
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"attention {name} N={n}: max |err| {err:.3g} beyond "
              f"{ATTN_TOL[name]}")
        worst[f"{name} N={n}"] = err
    print("[3 attention] kernel vs plain at (128, 8, N, 16), max |err| "
          + ", ".join(f"{k}: {v:.3g}" for k, v in worst.items())
          + "; tolerance atol=rtol 1e-5 in f32 (TF32 off), 2e-2 in bf16 "
          "(the plain version rounds the probabilities to bf16 before P.V, "
          "the kernel keeps them f32)", flush=True)

    # 4. gather kernel vs plain
    L, T = 2000, 1200
    for dtype in (torch.bfloat16, torch.float32):
        flat = randn(BATCH, L, 128, dtype=dtype)
        idx = torch.randint(0, L, (BATCH, T), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[:, :2] = torch.tensor([-3, L + 5], dtype=torch.int32, device=dev)
        got = gather.onehot_gather(flat, idx)
        torch.cuda.synchronize()
        check(torch.equal(got, gather.onehot_gather_reference(flat, idx)),
              f"gather {dtype}: kernel differs from the plain version")
    print(f"[4 gather] kernel == plain bit for bit at ({BATCH}, {L}, 128) x "
          f"{T} taps, bf16 and f32, indices -3 and L+5 clamped", flush=True)

    # 5. the full model, f32, kernels vs plain versions
    model = fold_uint8_stem(DFine(serving_config(), device=dev, seed=0))
    frames = make_uint8_slab((4, 80, 80, 192), seed=1, device=dev)
    attention.LAUNCHES = gather.LAUNCHES = 0
    out_k = model(frames)
    torch.cuda.synchronize()
    launches = (attention.LAUNCHES, gather.LAUNCHES)
    check(launches == (1, 3), f"one f32 forward launched (attention, "
          f"gather) = {launches}, want (1, 3)")
    with plain_kernels(attention, gather):
        out_p = model(frames)
    check(attention.LAUNCHES == 1 and gather.LAUNCHES == 3,
          "the plain forward launched a kernel")
    la, ba, lb, bb = (t.float().cpu().numpy() for t in (
        out_k["logits"], out_k["pred_boxes"], out_p["logits"],
        out_p["pred_boxes"]))
    why = same_detections(la, ba, lb, bb)
    check(not why, f"f32 model, kernels vs plain: {why}")
    print(f"[5 model] dfine_nano 640px f32 batch 4: kernels vs plain "
          f"detections match by assignment (max |logit diff| slot by slot "
          f"{np.abs(la - lb).max():.3g}); launches per forward: attention "
          f"{launches[0]}, gather {launches[1]}", flush=True)
    del model, out_k, out_p

    # 6. the serving run
    served = build_serving_model(device=dev, batch=BATCH, seed=0)
    slab = make_uint8_slab(served.slab_shape(N_STEPS), seed=2, device=dev)
    stream = make_streaming_forward(served.model)
    stream(slab[:1])                       # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()
    captured = {}
    with first_inputs(attention, gather, captured):
        attention.LAUNCHES = gather.LAUNCHES = 0
        logits, boxes, finite = stream(slab)
        torch.cuda.synchronize()
        counts = {"aifi_attention": attention.LAUNCHES,
                  "onehot_gather": gather.LAUNCHES}
    check(counts == {"aifi_attention": N_STEPS, "onehot_gather": 3 * N_STEPS},
          f"serving run launches {counts}, want {N_STEPS} and "
          f"{3 * N_STEPS}")
    check(bool(finite), "serving outputs are not all finite")
    check(tuple(logits.shape) == (BATCH, 150, 2)
          and tuple(boxes.shape) == (BATCH, 150, 4),
          f"serving outputs {tuple(logits.shape)} {tuple(boxes.shape)}")
    # frames/s through the kernels, and through the plain versions for
    # comparison, in turns (kernels, plain, plain, kernels) three times:
    # the host-bound eager loop drifts from call to call
    fps = {"kernels": [], "plain": []}
    for arm in ("kernels", "plain", "plain", "kernels") * 3:
        if arm == "plain":
            with plain_kernels(attention, gather):
                fps[arm].append(measure_fps(stream, slab))
        else:
            fps[arm].append(measure_fps(stream, slab))
    print(f"[6 serving] bench config, bf16, uint8 slab {tuple(slab.shape)}: "
          f"median {statistics.median(fps['kernels']):.1f} frames/s through "
          f"the kernels {[round(f, 1) for f in fps['kernels']]}, median "
          f"{statistics.median(fps['plain']):.1f} through the plain versions "
          f"{[round(f, 1) for f in fps['plain']]} ({N_STEPS} x {BATCH} "
          f"frames x 3 calls each, CUDA events, eager, no CUDA graphs); "
          f"launches over one slab: {counts}; outputs finite", flush=True)

    kernels = []
    # AIFI attention at the inputs the serving run gave it
    q, k, v, heads = captured["attention"]
    B, N, D = q.shape
    dh = D // heads
    got = attention.aifi_attention(q, k, v, heads)
    want = attention.aifi_attention_reference(q, k, v, heads)
    err = max_abs_err(got, want)
    # on the serving run's own inputs the limit is SERVING_ATTN_ULPS bf16
    # ulps at the output's largest magnitude: both outputs are rounded to
    # bf16 once, and the plain version also rounds P to bf16 before P.V
    peak = want.float().abs().max().item()
    tol = SERVING_ATTN_ULPS * 2.0 ** (np.floor(np.log2(peak)) - 7)
    check(err <= tol, f"serving attention: max |err| {err:.3g} beyond "
          f"{SERVING_ATTN_ULPS} bf16 ulps at |out| max {peak:.3g} "
          f"({tol:.3g})")
    qh, kh, vh = (t.reshape(B, N, heads, dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    F = torch.nn.functional
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4 * B * heads * N * N * dh
    kernels.append(dict(
        name="aifi_attention", route="cuda",
        source="pautdx_torch/csrc/aifi_attention.cu",
        replaces="pautdx/ops/pallas_attention.py:35",
        launches=counts["aifi_attention"], max_abs_err=err,
        ms=time_ms(lambda: attention.aifi_attention(q, k, v, heads)),
        plain_ms=time_ms(
            lambda: attention.aifi_attention_reference(q, k, v, heads)),
        bound_ms=1e3 * max(nbytes / PEAK_BYTES_PER_S,
                           flops / PEAK_BF16_FLOP_PER_S),
        bound_by=("bytes" if nbytes / PEAK_BYTES_PER_S
                  >= flops / PEAK_BF16_FLOP_PER_S else "operations"),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=1.0)),
        shape=f"q/k/v {tuple(q.shape)} {str(q.dtype).split('.')[1]}, "
              f"{heads} heads, |out| max {peak:.3g}, limit {tol:.3g}"))

    # one-hot row gather at the inputs the serving run gave it
    flat, idx = captured["gather"]
    got = gather.onehot_gather(flat, idx)
    want = gather.onehot_gather_reference(flat, idx)
    check(torch.equal(got, want), "serving gather differs from plain")
    Bf, Lf, C = flat.shape
    rows = torch.unique(idx.long().clamp(0, Lf - 1)
                        + Lf * torch.arange(Bf, device=dev)[:, None]).numel()
    nbytes = (got.numel() * got.element_size() + idx.numel() * 4
              + rows * C * flat.element_size())
    b_idx = torch.arange(Bf, device=dev)[:, None].expand_as(idx)
    idx_long = idx.long()
    kernels.append(dict(
        name="onehot_gather", route="cuda",
        source="pautdx_torch/csrc/onehot_gather.cu",
        replaces="pautdx/ops/pallas_gather.py:36",
        launches=counts["onehot_gather"], max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: gather.onehot_gather(flat, idx)),
        plain_ms=time_ms(lambda: gather.onehot_gather_reference(flat, idx)),
        bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes",
        library_ms=time_ms(lambda: flat[b_idx, idx_long]),
        shape=f"flat {tuple(flat.shape)} {str(flat.dtype).split('.')[1]}, "
              f"idx {tuple(idx.shape)}, {rows} distinct rows"))
    for r in kernels:
        print(f"[6 {r['name']}] {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['launches']} launches over the slab, max |err| "
              f"{r['max_abs_err']:.3g}", flush=True)

    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for r in kernels]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
