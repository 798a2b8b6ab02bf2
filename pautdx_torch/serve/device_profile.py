"""Where a serving path's device time goes, on one card.

    python -m pautdx_torch.serve.device_profile          # D-FINE serving
    python -m pautdx_torch.serve.device_profile yolo     # YOLOv8n-seg predict

Builds the serving model of ``throughput.build_serving_model`` (an
8 x 128-frame slab) or the predictor of
``yolo_predict.build_yolo_predictor`` (a 4 x 32-frame slab), runs one
warm slab, times three more, then traces one more with
``torch.profiler`` and prints, one line each: the traced slab's wall
time, the device's busy time (the union of kernel intervals) and idle
share of that wall, the same share of the three untraced slabs' median
wall time, the top 30
PyTorch operators by self device time and the top 30 kernels by device
time. The last line is one JSON object with the same numbers. TF32 is
off, as in ``chip_smoke.py``. Needs a card; nothing falls back to the
CPU.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType

from pautdx_torch.device import resolve_device
from pautdx_torch.serve import yolo_predict
from pautdx_torch.serve.throughput import (
    build_serving_model, make_streaming_forward, make_uint8_slab,
)

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


def _path(name: str, dev: torch.device) -> Tuple[Callable, torch.Tensor]:
    """The streaming loop of a serving path and the slab it runs over."""
    if name == "dfine":
        served = build_serving_model(device=dev, batch=128, seed=0)
        return (make_streaming_forward(served.model),
                make_uint8_slab(served.slab_shape(8), seed=1, device=dev))
    if name == "yolo":
        predictor = yolo_predict.build_yolo_predictor(device=dev, seed=0)
        return (yolo_predict.make_yolo_stream(predictor),
                yolo_predict.make_frame_slab(4, 32, seed=1, device=dev))
    raise ValueError(f"device_profile: no path {name!r}; dfine or yolo")


def main(path: str = "dfine") -> Dict:
    dev = resolve_device("cuda")
    # float32 stays float32, as in chip_smoke.py: no TF32 in cuDNN or GEMMs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stream, slab = _path(path, dev)
    n_steps, batch = slab.shape[:2]
    stream(slab)
    torch.cuda.synchronize()
    # the slab's wall time without the profiler, whose own host cost
    # inflates the traced wall time: median of three slabs
    untraced = []
    for _ in range(3):
        t0 = time.perf_counter()
        stream(slab)
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e6)
    untraced_us = statistics.median(untraced)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        stream(slab)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler saw no device activity; time with "
                           "CUDA events instead")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = busy_us(spans)
    by_kernel: Dict[str, List[float]] = {}
    for e in kernels:
        rec = by_kernel.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    kernel_us = sum(us for _, us in by_kernel.values())
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
        "kernel_launches": len(kernels),
        "ops": _table(ops, kernel_us),
        "kernels": _table([(k, n, us) for k, (n, us) in by_kernel.items()],
                          kernel_us),
    }
    print(f"{report['card']}: one slab of {n_steps} x {batch} "
          f"frames under the profiler: wall {report['wall_ms']:.2f} ms "
          f"({report['frames_per_s']:.1f} frames/s), device busy "
          f"{report['device_busy_ms']:.2f} ms, idle share of wall "
          f"{report['idle_share_of_wall']:.3f}, {len(kernels)} kernels")
    print(f"without the profiler: wall {report['untraced_wall_ms']:.2f} ms "
          f"(median of 3 slabs, {report['untraced_frames_per_s']:.1f} "
          f"frames/s), idle share of that wall at the traced busy time "
          f"{report['idle_share_of_untraced_wall']:.3f}")
    for kind in ("ops", "kernels"):
        for r in report[kind]:
            print(f"  {kind[:-1]:6s} {r['device_us'] / 1e3:9.3f} ms "
                  f"{r['share']:6.1%} x{r['calls']:<5d} {r['name'][:110]}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main(*sys.argv[1:2])
