"""Smoke run of pautdx_torch on one NVIDIA card: builds the CUDA kernels,
holds each against its plain PyTorch version, then drives the D-FINE-nano
640px serving path (the configuration of the root ``bench.py``) and the
YOLOv8n-seg 640px predict path through their entry points.

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
   computes the same function;
7. NMS sweep kernel vs plain at (32, 300) candidates, ties at the
   threshold and invalid slots included: bit for bit;
8. mask decode kernel vs plain at (32, 160, 160, 32) protos, K=100, boxes
   off the image and of zero area included: max |err| <= 1e-5;
9. YOLOv8n-seg in f32 at batch 4: the network once, its outputs
   post-processed once through the kernels and once through the plain
   versions: identical detections, masks within 1e-5; one ``predict``
   launches each of the two kernels once and, with TF32 switched on for
   the process, gives the same detections and masks (the predictor runs
   in full f32 whatever the caller set); images laid out NCHW in memory
   go through too;
10. the predict run: ``build_yolo_predictor`` over a (4, 32, 640, 640, 3)
    uint8 slab made on the card, TF32 on for the process; counts every kernel's launches over that
    run, checks the outputs are finite, times frames/s (through the kernels
    and, in turns with it, through the plain versions) and each of the two
    kernels at the inputs that run gave it, beside its plain version.

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

# H100 SXM data sheet: HBM rate, dense bf16 tensor-core rate, and the f32
# rate of the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_F32_FLOP_PER_S = 67e12

BATCH = 128
N_STEPS = 8
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SERVING_ATTN_ULPS = 4
YOLO_BATCH = 32
YOLO_STEPS = 4
MASK_TOL = 1e-5
DETECTION_KEYS = ("boxes", "scores", "classes", "valid", "indices")


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
def swapped(wrappers: dict, make):
    """Replace each kernel wrapper ``module.<name>`` by ``make(name,
    module, wrapper)`` for a while; the call sites look the wrapper up in
    its module at every call."""
    saved = {name: getattr(mod, name) for name, mod in wrappers.items()}
    for name, mod in wrappers.items():
        setattr(mod, name, make(name, mod, saved[name]))
    try:
        yield
    finally:
        for name, mod in wrappers.items():
            setattr(mod, name, saved[name])


def plain_kernels(wrappers: dict):
    """Route the kernel calls to the plain versions for a while."""
    return swapped(wrappers, lambda name, mod, fn: getattr(
        mod, f"{name}_reference"))


def first_inputs(wrappers: dict, captured: dict):
    """Keep the arguments of the first call of each kernel wrapper."""
    def make(name, mod, fn):
        def wrapper(*args):
            captured.setdefault(name, args)
            return fn(*args)
        return wrapper
    return swapped(wrappers, make)


def set_tf32(on: bool) -> None:
    """The process-wide TF32 switches of cuDNN convolutions and of GEMMs."""
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def reset_counts(wrappers: dict) -> None:
    for mod in wrappers.values():
        mod.LAUNCHES = 0


def launch_counts(wrappers: dict) -> dict:
    return {name: mod.LAUNCHES for name, mod in wrappers.items()}


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
    from pautdx_torch.ops import _build, attention, gather, masks, suppress
    from pautdx_torch.ops.nms import box_iou_matrix
    from pautdx_torch.serve.throughput import (
        build_serving_model, fold_uint8_stem, make_streaming_forward,
        make_uint8_slab, measure_fps, serving_config,
    )
    from pautdx_torch.serve.yolo_predict import (
        IMG, build_yolo_predictor, make_frame_slab, make_yolo_stream,
        postprocess,
    )

    wrappers = {"aifi_attention": attention, "onehot_gather": gather,
                "nms_suppress": suppress, "assemble_masks": masks}

    dev = torch.device("cuda")
    set_tf32(False)
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
    reset_counts(wrappers)
    out_k = model(frames)
    torch.cuda.synchronize()
    launches = (attention.LAUNCHES, gather.LAUNCHES)
    check(launches == (1, 3), f"one f32 forward launched (attention, "
          f"gather) = {launches}, want (1, 3)")
    with plain_kernels(wrappers):
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
    with first_inputs(wrappers, captured):
        reset_counts(wrappers)
        logits, boxes, finite = stream(slab)
        torch.cuda.synchronize()
        counts = launch_counts(wrappers)
    check(counts == {"aifi_attention": N_STEPS, "onehot_gather": 3 * N_STEPS,
                     "nms_suppress": 0, "assemble_masks": 0},
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
            with plain_kernels(wrappers):
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
    q, k, v, heads = captured["aifi_attention"]
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
    flat, idx = captured["onehot_gather"]
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
    del served, slab, stream, captured, logits, boxes

    # 7. NMS sweep kernel vs plain
    nb, nk = YOLO_BATCH, 300
    xy = torch.rand((nb, nk, 2), generator=gen, device=dev) * 560
    wh = 10 + torch.rand((nb, nk, 2), generator=gen, device=dev) * 150
    iou = box_iou_matrix(torch.cat([xy, xy + wh], -1))
    ties = torch.randint(0, nk, (2, 4 * nk), generator=gen, device=dev)
    iou[0, ties[0], ties[1]] = 0.45              # exactly at the threshold
    iou[1, 5] = iou[1, 4]                        # two tied candidates
    valid = torch.rand((nb, nk), generator=gen, device=dev) > 0.2
    got = suppress.nms_suppress(iou, valid, 0.45)
    torch.cuda.synchronize()
    want = suppress.nms_suppress_reference(iou, valid, 0.45)
    check(torch.equal(got, want), "nms: kernel differs from the plain "
          f"version in {(got != want).sum().item()} slots")
    print(f"[7 nms] kernel == plain bit for bit at ({nb}, {nk}) candidates, "
          f"{int(valid.sum())} valid, {int(want.sum())} kept, ties at the "
          f"threshold 0.45 and a repeated row", flush=True)

    # 8. mask decode kernel vs plain
    protos = randn(nb, 160, 160, 32)
    coeffs = randn(nb, 100, 32)
    xy = torch.rand((nb, 100, 2), generator=gen, device=dev) * 700 - 60
    wh = torch.rand((nb, 100, 2), generator=gen, device=dev) * 320
    mboxes = torch.cat([xy, xy + wh], -1)
    mboxes[0, :4] = torch.tensor([[0, 0, 640, 640], [100, 200, 100, 260],
                                  [-90, -90, -10, -10], [700, 10, 900, 30]],
                                 dtype=torch.float32, device=dev)
    got = masks.assemble_masks(protos, coeffs, mboxes, (IMG, IMG))
    torch.cuda.synchronize()
    want = masks.assemble_masks_reference(protos, coeffs, mboxes, (IMG, IMG))
    err = max_abs_err(got, want)
    check(got.shape == want.shape and err <= MASK_TOL,
          f"masks: max |err| {err:.3g} beyond {MASK_TOL}")
    check(bool((got[0, 1:4] == 0).all()) and bool((got[0, 0] > 0).all()),
          "masks: the whole-frame box or the empty ones came out wrong")
    print(f"[8 masks] kernel vs plain at ({nb}, 160, 160, 32) protos, "
          f"K=100, f32 (TF32 off): max |err| {err:.3g} <= {MASK_TOL}; "
          f"zero-area and off-image boxes all zero", flush=True)
    del protos, coeffs, got, want

    # 9. YOLOv8n-seg f32, post-processed through kernels vs plain versions
    predictor = build_yolo_predictor(device=dev, seed=0)
    frames = make_frame_slab(1, 4, seed=3, device=dev)[0]
    out = predictor.model(frames.to(torch.float32) / 255.0)
    reset_counts(wrappers)
    det_k = postprocess(out, (IMG, IMG), predictor.cfg)
    torch.cuda.synchronize()
    post_counts = launch_counts(wrappers)
    with plain_kernels(wrappers):
        det_p = postprocess(out, (IMG, IMG), predictor.cfg)
    check(launch_counts(wrappers) == post_counts,
          "the plain post-process launched a kernel")
    differ = [k for k in DETECTION_KEYS if not torch.equal(det_k[k],
                                                           det_p[k])]
    check(not differ, f"yolo: detections through the kernels differ from "
          f"the plain versions' in {differ}")
    err = max_abs_err(det_k["masks"], det_p["masks"])
    check(err <= MASK_TOL, f"yolo: masks differ by {err:.3g}")
    # the predictor owns its precision: with TF32 switched on for the
    # whole process, as a caller may leave it, predict() still gives the
    # full-f32 detections above
    set_tf32(True)
    reset_counts(wrappers)
    det = predictor(frames)
    torch.cuda.synchronize()
    per_predict = launch_counts(wrappers)
    want = {"aifi_attention": 0, "onehot_gather": 0, "nms_suppress": 1,
            "assemble_masks": 1}
    check(per_predict == want and post_counts == want,
          f"one predict launched {per_predict}, want {want}")
    check(all(torch.equal(det[k], det_k[k]) for k in DETECTION_KEYS + (
        "masks",)), "yolo: predict() with TF32 on for the process differs "
        "from the model plus postprocess() in full f32")
    # images laid out NCHW in memory, the usual PyTorch form, reach the
    # mask kernel, which needs dense protos
    x = frames.to(torch.float32) / 255.0
    det_n = predictor.forward(x.permute(0, 3, 1, 2).contiguous()
                              .permute(0, 2, 3, 1))
    check(bool(torch.isfinite(det_n["masks"]).all())
          and tuple(det_n["masks"].shape) == (4, 100, 160, 160),
          "yolo: predict on NCHW-laid-out images")
    n_valid = det["valid"].sum(1).tolist()
    print(f"[9 yolo model] yolov8n-seg 640px f32 batch 4: kernels vs plain "
          f"detections identical ({n_valid} valid per frame), masks max "
          f"|err| {err:.3g}; launches per predict: {per_predict}; predict "
          f"with TF32 on for the process gives the same detections and "
          f"masks; NCHW-laid-out images: {det_n['valid'].sum(1).tolist()} "
          f"valid per frame", flush=True)
    del out, det_k, det_p, det, det_n, x

    # 10. the predict run
    yslab = make_frame_slab(YOLO_STEPS, YOLO_BATCH, seed=4, device=dev)
    ystream = make_yolo_stream(predictor)
    ystream(yslab[:1])                     # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()
    captured = {}
    with first_inputs(wrappers, captured):
        reset_counts(wrappers)
        det, finite = ystream(yslab)
        torch.cuda.synchronize()
        ycounts = launch_counts(wrappers)
    want = {"aifi_attention": 0, "onehot_gather": 0,
            "nms_suppress": YOLO_STEPS, "assemble_masks": YOLO_STEPS}
    check(ycounts == want, f"predict run launches {ycounts}, want {want}")
    check(bool(finite), "predict outputs are not all finite")
    check(tuple(det["boxes"].shape) == (YOLO_BATCH, 100, 4)
          and tuple(det["masks"].shape) == (YOLO_BATCH, 100, 160, 160),
          f"predict outputs {tuple(det['boxes'].shape)} "
          f"{tuple(det['masks'].shape)}")
    yfps = {"kernels": [], "plain": []}
    for arm in ("kernels", "plain", "plain", "kernels") * 3:
        if arm == "plain":
            with plain_kernels(wrappers):
                yfps[arm].append(measure_fps(ystream, yslab))
        else:
            yfps[arm].append(measure_fps(ystream, yslab))
    print(f"[10 yolo serving] yolov8n-seg f32, uint8 slab "
          f"{tuple(yslab.shape)}: median "
          f"{statistics.median(yfps['kernels']):.1f} frames/s through the "
          f"kernels {[round(f, 1) for f in yfps['kernels']]}, median "
          f"{statistics.median(yfps['plain']):.1f} through the plain "
          f"versions {[round(f, 1) for f in yfps['plain']]} ({YOLO_STEPS} x "
          f"{YOLO_BATCH} frames x 3 calls each, CUDA events, eager, TF32 "
          f"on for the process and off inside predict); "
          f"launches over one slab: {ycounts}; outputs finite; "
          f"{det['valid'].sum(1).tolist()} valid per frame in the last step",
          flush=True)

    set_tf32(False)

    # the NMS sweep at the inputs the predict run gave it
    iou, valid, thr = captured["nms_suppress"]
    got = suppress.nms_suppress(iou, valid, thr)
    want = suppress.nms_suppress_reference(iou, valid, thr)
    check(torch.equal(got, want), "predict nms differs from plain")
    Bn, Kn = valid.shape
    # bytes this run's data needs: the part j > i of each row i that is
    # still alive at its step (its final keep), valid read and keep written
    alive = (want > 0).nonzero()[:, 1]
    nbytes = 4 * int((Kn - 1 - alive).sum()) + 2 * 4 * Bn * Kn
    kernels.append(dict(
        name="nms_suppress", route="cuda",
        source="pautdx_torch/csrc/nms_suppress.cu",
        replaces="pautdx/ops/pallas_nms.py:30",
        launches=ycounts["nms_suppress"], max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: suppress.nms_suppress(iou, valid, thr)),
        plain_ms=time_ms(
            lambda: suppress.nms_suppress_reference(iou, valid, thr)),
        bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes",
        library_ms=None,
        shape=f"iou {tuple(iou.shape)} f32, {int(valid.sum())} valid, "
              f"{int(want.sum())} kept, {nbytes} bytes needed of "
              f"{iou.numel() * 4} ({Kn} serial steps)"))

    # the mask decode at the inputs the predict run gave it
    protos, coeffs, mboxes, img_size = captured["assemble_masks"]
    got = masks.assemble_masks(protos, coeffs, mboxes, img_size)
    want = masks.assemble_masks_reference(protos, coeffs, mboxes, img_size)
    err = max_abs_err(got, want)
    check(err <= MASK_TOL, f"predict masks: max |err| {err:.3g}")
    Bm, Hp, Wp, P = protos.shape
    nbytes = 4 * (protos.numel() + coeffs.numel() + mboxes.numel()
                  + got.numel())
    # the dot products this run's boxes need: one per pixel inside a box
    sx, sy = Wp / img_size[1], Hp / img_size[0]
    pb = mboxes * torch.tensor([sx, sy, sx, sy], device=dev)
    cols = torch.arange(Wp, device=dev, dtype=torch.float32)
    rows = torch.arange(Hp, device=dev, dtype=torch.float32)
    in_x = ((cols >= pb[..., 0:1]) & (cols < pb[..., 2:3])).sum(-1)
    in_y = ((rows >= pb[..., 1:2]) & (rows < pb[..., 3:4])).sum(-1)
    flops = 2 * P * int((in_x * in_y).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    kernels.append(dict(
        name="assemble_masks", route="cuda",
        source="pautdx_torch/csrc/assemble_masks.cu",
        replaces="pautdx/ops/pallas_mask.py:33",
        launches=ycounts["assemble_masks"], max_abs_err=err,
        ms=time_ms(lambda: masks.assemble_masks(protos, coeffs, mboxes,
                                                img_size)),
        plain_ms=time_ms(lambda: masks.assemble_masks_reference(
            protos, coeffs, mboxes, img_size)),
        bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        shape=f"protos {tuple(protos.shape)}, coeffs {tuple(coeffs.shape)} "
              f"f32 (protos contiguous: {protos.is_contiguous()}), {nbytes} "
              f"bytes, {flops} FLOP inside the boxes"))
    for r in kernels[2:]:
        print(f"[10 {r['name']}] {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, no library call, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['launches']} "
              f"launches over the slab, max |err| {r['max_abs_err']:.3g}",
              flush=True)

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
