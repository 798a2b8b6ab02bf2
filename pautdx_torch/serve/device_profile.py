"""Where a path's device time goes, on one card.

    python -m pautdx_torch.serve.device_profile          # D-FINE serving
    python -m pautdx_torch.serve.device_profile yolo     # YOLOv8n-seg predict
    python -m pautdx_torch.serve.device_profile yolo9c   # YOLOv9c-seg predict
    python -m pautdx_torch.serve.device_profile train    # D-FINE training
    python -m pautdx_torch.serve.device_profile hf       # HF D-FINE predict
    python -m pautdx_torch.serve.device_profile temporal # temporal D-FINE
    python -m pautdx_torch.serve.device_profile signal   # HybridBinary served
    python -m pautdx_torch.serve.device_profile signal_train  # ... trained

Builds the serving model of ``throughput.build_serving_model`` (run
eagerly through ``DFine.forward``, an 8 x 128-frame slab), the predictor of
``yolo_predict.build_yolo_predictor`` (a 4 x 32-frame slab; YOLOv8n-seg,
or ``yolo_config("yolov9c-seg")`` for ``yolo9c``), the f32
predictor of ``dfine_predict.build_dfine_predictor`` (the HF-architecture
D-FINE, a 4 x 32-frame slab), the temporal D-FINE v3 of
``temporal_predict.build_temporal_model`` (bf16, a 4 x 50-frame 640px
uint8 slab, 50 frames a chunk), HybridBinary at its published widths
through ``endpoints.SignalEndpoint`` (one f32 request of (16, 50, 320)
host signals, the copies to and from the card included; a "frame" of
this path is one A-scan, 800 a request), HybridBinary's training step
under the ``detection`` recipe (one (8, 50, 320) f32 batch of seeded
host signals through ``Trainer.train_epoch``, dropout on) or the trainer of
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
and for ``signal`` of each part of HybridBinary (the conv stack, the
shared MLP, the position encoding, and over the encoder's layers the
attention, LocalAttention's depthwise convs, the LayerNorms and the FFN),
from spans (``utils.profiling``) that forward hooks open
around those modules in the traced run only; ``signal_train`` adds the
whole forward, the criterion and the optimizer's step as parts, and the
adaptive pool's operators (forward and backward) as ``signal.pool``; the
backward is the step less those. The last line is one JSON
object with the same numbers. TF32 is off, as in
``chip_smoke.py``. Needs a card; nothing falls back to the CPU.
"""

from __future__ import annotations

import functools
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
from pautdx_torch.models.signal import build_signal_model
from pautdx_torch.models.vision.dfine import DFine
from pautdx_torch.serve import dfine_predict, temporal_predict, yolo_predict
from pautdx_torch.serve.endpoints import SignalEndpoint
from pautdx_torch.serve.throughput import (
    build_serving_model, make_streaming_forward, make_uint8_slab,
)
from pautdx_torch.train.detector import build_dfine_trainer, make_train_batches
from pautdx_torch.train.recipes import RECIPES
from pautdx_torch.train.signal import recipe_optimizer
from pautdx_torch.train.trainer import Trainer
from pautdx_torch.utils.profiling import TRACER, span

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


# the served signal request: HybridBinary over (batch, signals, samples)
SIGNAL_SHAPE = (16, 50, 320)


# HybridBinary's training step: the detection recipe's (batch, seq_len,
# signal_length)
SIGNAL_TRAIN_SHAPE = (8, 50, 320)
CRITERION_SPAN = "signal.criterion"
OPTIMIZER_SPAN = "signal.optimizer"


def signal_train_step(dev: torch.device, seed: int = 0):
    """HybridBinary at published widths in a ``Trainer`` under the
    ``detection`` recipe, its criterion and optimizer step inside
    spans, and one seeded (8, 50, 320) host batch:
    (trainer, state, [batch])."""
    recipe = RECIPES["detection"]
    objective = recipe.make_objective()

    def criterion(out, batch):
        with span(CRITERION_SPAN):
            return objective(out, batch)

    model = build_signal_model("HybridBinary", device=dev, seed=seed)
    trainer = Trainer(model, criterion, recipe_optimizer(recipe, 1),
                      seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    b, n, s = SIGNAL_TRAIN_SHAPE
    batch = {"signals": torch.randn(SIGNAL_TRAIN_SHAPE, generator=gen)
             .numpy(),
             "labels": (torch.rand((b, n), generator=gen) < 0.3).float()
             .numpy(),
             "sample_mask": torch.ones(b).numpy()}
    state = trainer.init(batch)
    step = state.optimizer.step

    def optimizer_step(*args, **kwargs):
        with span(OPTIMIZER_SPAN):
            return step(*args, **kwargs)

    state.optimizer.step = optimizer_step
    return trainer, state, [batch]


def signal_parts(num_layers: int) -> Dict[str, Tuple[str, ...]]:
    """The parts of HybridBinary, each a span of the traced run."""
    layers = [f"encoder.layer_{i}" for i in range(num_layers)]
    return {
        "signal.conv": ("conv",),
        "signal.mlp": ("shared1", "shared2"),
        "signal.pos_enc": ("pos_enc",),
        "signal.attention": tuple(f"{l}.self_attn" for l in layers),
        "signal.local_attention": tuple(f"{l}.local_attn" for l in layers),
        "signal.layer_norm": tuple(f"{l}.norm{j}" for l in layers
                                   for j in (1, 2, 3)),
        "signal.ffn": tuple(f"{l}.Dense_{j}" for l in layers
                            for j in (0, 1)),
        "signal.classifier": ("classifier",),
    }


@contextmanager
def module_spans(model: nn.Module, parts: Dict[str, Tuple[str, ...]]):
    """For a while, each call of the submodules named in ``parts`` (dotted
    paths; absent ones skipped) runs inside a span named by its part (a
    ``record_function`` range while the profiler runs)."""
    stack = ExitStack()
    open_spans = []

    def pre(label):
        def hook(module, args):
            open_spans.append(TRACER.begin(label))
        return hook

    def post(module, args, out):
        TRACER.end(open_spans.pop())

    with stack:
        for label, names in parts.items():
            for name in names:
                try:
                    module = model.get_submodule(name)
                except AttributeError:
                    continue
                stack.callback(module.register_forward_pre_hook(
                    pre(label)).remove)
                stack.callback(module.register_forward_hook(post).remove)
        yield


def _path(name: str, dev: torch.device
          ) -> Tuple[Callable, int, int, nn.Module, Dict]:
    """One run of a path as a callable, with its steps and batch and, for
    ``temporal`` and ``signal``, the model and the parts of it that get
    spans: a serving path's streaming loop over a slab, one signal
    request, or one training step."""
    if name == "dfine":
        # eager: the operator table needs the forward's own launches
        served = build_serving_model(device=dev, batch=128, seed=0)
        stream = make_streaming_forward(
            functools.partial(DFine.forward, served.model))
        slab = make_uint8_slab(served.slab_shape(8), seed=1, device=dev)
        return lambda: stream(slab), 8, 128, None, {}
    if name in ("yolo", "yolo9c"):
        config = "yolov8n-seg" if name == "yolo" else "yolov9c-seg"
        predictor = yolo_predict.build_yolo_predictor(
            device=dev, seed=0, cfg=yolo_predict.yolo_config(config))
        stream = yolo_predict.make_yolo_stream(predictor)
        slab = yolo_predict.make_frame_slab(4, 32, seed=1, device=dev)
        return lambda: stream(slab), 4, 32, None, {}
    if name == "hf":
        predictor = dfine_predict.build_dfine_predictor(device=dev, seed=0)
        stream = dfine_predict.make_dfine_stream(predictor)
        slab = make_uint8_slab((4, 32, 640, 640, 3), seed=1, device=dev)
        return lambda: stream(slab), 4, 32, None, {}
    if name == "temporal":
        model = temporal_predict.build_temporal_model(device=dev, seed=0)
        stream = temporal_predict.make_temporal_stream(model)
        slab = make_uint8_slab((4, temporal_predict.SEQ_LEN, 640, 640, 3),
                               seed=1, device=dev)
        return (lambda: stream(slab), 4, temporal_predict.SEQ_LEN, model,
                TEMPORAL_PARTS)
    if name == "signal":
        model = build_signal_model("HybridBinary", device=dev, seed=0)
        ep = SignalEndpoint(model, device=dev)
        signals = torch.randn(SIGNAL_SHAPE, generator=torch.Generator()
                              .manual_seed(1)).numpy()
        b, n, _ = SIGNAL_SHAPE
        return (lambda: ep.predict(signals), 1, b * n, model,
                signal_parts(model.encoder.num_layers))
    if name == "signal_train":
        trainer, state, batch = signal_train_step(dev)
        parts = dict(signal_parts(trainer.model.encoder.num_layers))
        parts["signal.forward"] = ("",)
        b, n, _ = SIGNAL_TRAIN_SHAPE
        return (lambda: trainer.train_epoch(state, batch), 1, b * n,
                trainer.model, parts)
    if name == "train":
        trainer = build_dfine_trainer(device=dev, seed=0)
        batch = make_train_batches(1, 16, seed=1)
        state = trainer.init(batch[0])
        return lambda: trainer.train_epoch(state, batch), 1, 16, None, {}
    raise ValueError(f"device_profile: no path {name!r}; dfine, yolo, "
                     f"yolo9c, hf, temporal, signal, signal_train or train")


def main(path: str = "dfine") -> Dict:
    dev = resolve_device("cuda")
    # float32 stays float32, as in chip_smoke.py: no TF32 in cuDNN or GEMMs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, n_steps, batch, model, part_names = _path(path, dev)
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
    spans = (module_spans(model, part_names) if model is not None
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
    span_names = set(part_names) | {CRITERION_SPAN, OPTIMIZER_SPAN}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in span_names:
            rec = parts.setdefault(e.name, {"calls": 0, "device_ms": 0.0,
                                            "host_ms": 0.0})
            rec["calls"] += 1
            rec["device_ms"] += e.device_time_total / 1e3
            rec["host_ms"] += e.cpu_time_total / 1e3
    ops = [(a.key, a.count, a.self_device_time_total)
           for a in prof.key_averages()
           if a.device_type == DeviceType.CPU and a.self_device_time_total > 0]
    if path == "signal_train":
        pool = [(n, us) for n, _, us in ops if "adaptive_avg_pool" in n]
        parts["signal.pool"] = {"calls": len(pool), "host_ms": 0.0,
                                "device_ms": sum(us for _, us in pool) / 1e3}

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
