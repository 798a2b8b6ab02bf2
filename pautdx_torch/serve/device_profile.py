"""Where a path's device time goes, on one card.

    python -m pautdx_torch.serve.device_profile          # D-FINE serving
    python -m pautdx_torch.serve.device_profile yolo     # YOLOv8n-seg predict
    python -m pautdx_torch.serve.device_profile yolo9c   # YOLOv9c-seg predict
    python -m pautdx_torch.serve.device_profile train    # D-FINE training
    python -m pautdx_torch.serve.device_profile hf       # HF D-FINE predict
    python -m pautdx_torch.serve.device_profile temporal # temporal D-FINE

Builds the serving model of ``throughput.build_serving_model`` (an
8 x 128-frame slab), the predictor of
``yolo_predict.build_yolo_predictor`` (a 4 x 32-frame slab; YOLOv8n-seg,
or ``yolo_config("yolov9c-seg")`` for ``yolo9c``), the f32
predictor of ``dfine_predict.build_dfine_predictor`` (the HF-architecture
D-FINE, a 4 x 32-frame slab), the temporal D-FINE v3 of
``temporal_predict.build_temporal_model`` (bf16, a 4 x 50-frame 640px
uint8 slab, 50 frames a chunk) or the trainer of
``train.detector.build_dfine_trainer`` (one step of a 16-frame 640px
batch, from numpy through the trainer's input pipeline), runs it once
warm, times three more runs (each to a synchronize, and three back to
back between CUDA events, as ``measure_fps`` does), then traces one more
with ``torch.profiler``
and prints, one line each: the traced run's wall time, the device's busy
time (the union of kernel intervals) and idle share of that wall, the same
share of the three untraced runs' median wall time, the top 30 PyTorch
operators by self device time and the top 30 kernels by device time; for
``train``, also the host time of the criterion's Hungarian solve in the
traced step (the ``losses.detr.SOLVE_SPAN`` spans of the trace); for
``temporal``, the device and host time of each part of a chunk (the
trunk, the temporal encoder, the attention pool, the GRU and the heads),
from ``torch.profiler.record_function`` ranges that forward hooks open
around those modules in the traced run only. The last line is one JSON
object with the same numbers. TF32 is off, as in
``chip_smoke.py``. Needs a card; nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from contextlib import ExitStack, contextmanager
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn
from torch.autograd import DeviceType

from pautdx_torch.device import resolve_device
from pautdx_torch.losses import detr
from pautdx_torch.serve import dfine_predict, temporal_predict, yolo_predict
from pautdx_torch.serve.throughput import (
    build_serving_model, make_streaming_forward, make_uint8_slab,
)
from pautdx_torch.train.detector import build_dfine_trainer, make_train_batches

TOP = 30


def busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    end = float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _table(rows, total_us: float) -> List[Dict]:
    rows = sorted(rows, key=lambda r: -r[2])[:TOP]
    return [{"name": name, "calls": n, "device_us": us,
             "share": us / total_us} for name, n, us in rows]


# the parts of a temporal D-FINE chunk, each a span of the traced run
TEMPORAL_PARTS = {
    "temporal.trunk": ("trunk",),
    "temporal.encoder": ("temporal_encoder",),
    "temporal.attention_pool": ("temporal_attention",),
    "temporal.gru": ("context_aggregator", "context_projector"),
    "temporal.heads": ("class_head", "bbox_head", "anomaly_detector"),
}


@contextmanager
def module_spans(model: nn.Module, parts: Dict[str, Tuple[str, ...]]):
    """For a while, each call of the submodules named in ``parts`` runs
    inside a ``record_function`` range named by its part."""
    stack = ExitStack()
    open_ranges: List[torch.profiler.record_function] = []

    def pre(label):
        def hook(module, args):
            rf = torch.profiler.record_function(label)
            rf.__enter__()
            open_ranges.append(rf)
        return hook

    def post(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    with stack:
        for label, names in parts.items():
            for name in names:
                module = getattr(model, name, None)
                if module is None:
                    continue
                stack.callback(module.register_forward_pre_hook(
                    pre(label)).remove)
                stack.callback(module.register_forward_hook(post).remove)
        yield


def _path(name: str, dev: torch.device
          ) -> Tuple[Callable, int, int, nn.Module]:
    """One run of a path as a callable, with its steps and batch and, for
    ``temporal``, the model whose parts get spans: a serving path's
    streaming loop over a slab, or one training step."""
    if name == "dfine":
        served = build_serving_model(device=dev, batch=128, seed=0)
        stream = make_streaming_forward(served.model)
        slab = make_uint8_slab(served.slab_shape(8), seed=1, device=dev)
        return lambda: stream(slab), 8, 128, None
    if name in ("yolo", "yolo9c"):
        config = "yolov8n-seg" if name == "yolo" else "yolov9c-seg"
        predictor = yolo_predict.build_yolo_predictor(
            device=dev, seed=0, cfg=yolo_predict.yolo_config(config))
        stream = yolo_predict.make_yolo_stream(predictor)
        slab = yolo_predict.make_frame_slab(4, 32, seed=1, device=dev)
        return lambda: stream(slab), 4, 32, None
    if name == "hf":
        predictor = dfine_predict.build_dfine_predictor(device=dev, seed=0)
        stream = dfine_predict.make_dfine_stream(predictor)
        slab = make_uint8_slab((4, 32, 640, 640, 3), seed=1, device=dev)
        return lambda: stream(slab), 4, 32, None
    if name == "temporal":
        model = temporal_predict.build_temporal_model(device=dev, seed=0)
        stream = temporal_predict.make_temporal_stream(model)
        slab = make_uint8_slab((4, temporal_predict.SEQ_LEN, 640, 640, 3),
                               seed=1, device=dev)
        return lambda: stream(slab), 4, temporal_predict.SEQ_LEN, model
    if name == "train":
        trainer = build_dfine_trainer(device=dev, seed=0)
        batch = make_train_batches(1, 16, seed=1)
        state = trainer.init(batch[0])
        return lambda: trainer.train_epoch(state, batch), 1, 16, None
    raise ValueError(f"device_profile: no path {name!r}; dfine, yolo, "
                     f"yolo9c, hf, temporal or train")


def main(path: str = "dfine") -> Dict:
    dev = resolve_device("cuda")
    # float32 stays float32, as in chip_smoke.py: no TF32 in cuDNN or GEMMs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, n_steps, batch, model = _path(path, dev)
    run()
    torch.cuda.synchronize()
    # the run's wall time without the profiler, whose own host cost
    # inflates the traced wall time: median of three runs
    untraced = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e6)
    untraced_us = statistics.median(untraced)
    # three runs back to back between CUDA events, no synchronize between
    # them, as serve.throughput.measure_fps times a stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        run()
    end.record()
    end.synchronize()
    chained_us = start.elapsed_time(end) * 1e3 / 3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    spans = (module_spans(model, TEMPORAL_PARTS) if model is not None
             else ExitStack())
    with spans, torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device events, less the device-side spans of annotations such as
    # the optimizer's step, which cover kernels and the gaps between them
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler saw no device activity; time with "
                           "CUDA events instead")
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = busy_us(intervals)
    by_kernel: Dict[str, List[float]] = {}
    for e in kernels:
        rec = by_kernel.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    kernel_us = sum(us for _, us in by_kernel.values())
    solves = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CPU
              and e.name == detr.SOLVE_SPAN]
    parts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in TEMPORAL_PARTS:
            rec = parts.setdefault(e.name, {"calls": 0, "device_ms": 0.0,
                                            "host_ms": 0.0})
            rec["calls"] += 1
            rec["device_ms"] += e.device_time_total / 1e3
            rec["host_ms"] += e.cpu_time_total / 1e3
    ops = [(a.key, a.count, a.self_device_time_total)
           for a in prof.key_averages()
           if a.device_type == DeviceType.CPU and a.self_device_time_total > 0]

    frames = n_steps * batch
    report = {
        "path": path, "card": torch.cuda.get_device_name(0),
        "batch": batch, "steps": n_steps,
        "wall_ms": wall_us / 1e3, "frames_per_s": frames / (wall_us / 1e6),
        "device_window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share_of_wall": 1 - busy / wall_us,
        "untraced_wall_ms": untraced_us / 1e3,
        "untraced_frames_per_s": frames / (untraced_us / 1e6),
        "idle_share_of_untraced_wall": 1 - busy / untraced_us,
        "chained_ms_per_run": chained_us / 1e3,
        "chained_frames_per_s": frames / (chained_us / 1e6),
        "kernel_launches": len(kernels),
        "host_solve_ms_per_run": sum(solves) / 1e3,
        "parts": parts,
        "ops": _table(ops, kernel_us),
        "kernels": _table([(k, n, us) for k, (n, us) in by_kernel.items()],
                          kernel_us),
    }
    print(f"{report['card']}: {path}, one run of {n_steps} x {batch} "
          f"frames under the profiler: wall {report['wall_ms']:.2f} ms "
          f"({report['frames_per_s']:.1f} frames/s), device busy "
          f"{report['device_busy_ms']:.2f} ms, idle share of wall "
          f"{report['idle_share_of_wall']:.3f}, {len(kernels)} kernels")
    print(f"without the profiler: wall {report['untraced_wall_ms']:.2f} ms "
          f"(median of 3 runs, {report['untraced_frames_per_s']:.1f} "
          f"frames/s), idle share of that wall at the traced busy time "
          f"{report['idle_share_of_untraced_wall']:.3f}; three runs back to "
          f"back between CUDA events {report['chained_ms_per_run']:.2f} ms "
          f"a run ({report['chained_frames_per_s']:.1f} frames/s); host "
          f"Hungarian "
          f"solve {report['host_solve_ms_per_run']:.2f} ms in the traced "
          f"run ({len(solves)} solves)")
    for label, rec in parts.items():
        print(f"  part   {rec['device_ms']:9.3f} ms device, "
              f"{rec['host_ms']:9.3f} ms host x{rec['calls']:<4d} {label}")
    for kind in ("ops", "kernels"):
        for r in report[kind]:
            print(f"  {kind[:-1]:6s} {r['device_us'] / 1e3:9.3f} ms "
                  f"{r['share']:6.1%} x{r['calls']:<5d} {r['name'][:110]}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main(*sys.argv[1:2])
