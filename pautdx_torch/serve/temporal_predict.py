"""Temporal D-FINE serving: 50-frame sequences in, per-frame detections out.

The port's counterpart of the serving configuration of
``tools/bench_accuracy.py::measure_temporal_serving_fps``:
``TemporalDFine(variant="v3", num_temporal_labels=3)`` (4 temporal
layers, 8 heads, FFN 4·d) over the trunk ``dfine_nano(num_labels=2)``
with the discrete decoder (the ``onehot_gather`` kernel) and the einsum
AIFI attention, 150 queries, 640px frames, seeded weights with the
trunk's heads copied in (``init_heads_from_trunk``), every float32
weight and statistic cast to bf16. Frames travel as uint8 and are
dequantized on the card to ``bf16 · (1/255)``; detections are
``post_process(logits[..., :2], boxes, (H, W), threshold=0.3,
max_det=16)``.

- :func:`build_temporal_model` builds it;
- :func:`make_temporal_stream` runs it over the (T, ...) chunks of an
  (n, T, H, W, 3) uint8 slab on the card, which
  ``serve.throughput.measure_fps`` times;
- :func:`make_chunk_predictor` gives the per-chunk predictor, frames in,
  ``[{box, label, score}]`` per frame out;
- :func:`predict_sequence` runs it over a stack of any length through
  ``serve.endpoints.chunked_sequence_runner`` in windows of 50; it is
  what ``serve.bridge.serve_frames`` takes.

All of it is eager PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from pautdx_torch.device import resolve_device
from pautdx_torch.models.vision.dfine import DFineConfig, dfine_nano, post_process
from pautdx_torch.models.vision.temporal_dfine import (
    TemporalDFine, init_heads_from_trunk,
)
from pautdx_torch.serve.endpoints import chunked_sequence_runner, frame_results
from pautdx_torch.serve.throughput import (
    cast_params_bf16, make_streaming_forward,
)

__all__ = ["SEQ_LEN", "build_temporal_model", "make_chunk_predictor",
           "make_temporal_stream", "predict_sequence",
           "temporal_serving_config"]

SEQ_LEN = 50            # frames a window (bench_accuracy.py's SEQ_LEN)
NUM_LABELS = 2          # the trunk's labels; the temporal head adds one


def temporal_serving_config() -> DFineConfig:
    """The trunk of ``bench_accuracy.py:764-771``: ``dfine_nano`` with two
    labels and the discrete decoder; its AIFI stays unfused."""
    return dataclasses.replace(dfine_nano(num_labels=NUM_LABELS),
                               decoder_method="discrete")


def build_temporal_model(variant: str = "v3",
                         device: Optional[Union[str, torch.device]] = None,
                         seed: int = 0, dtype: torch.dtype = torch.bfloat16
                         ) -> TemporalDFine:
    """The serving model on ``device`` (default ``"cuda"``): seeded init of
    ``TemporalDFine(temporal_serving_config(), variant,
    num_temporal_labels=3)``, then ``init_heads_from_trunk``;
    ``dtype=torch.bfloat16`` casts every float32 weight and statistic, as
    ``cast_params_bf16`` does."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"build_temporal_model: dtype float32 or bfloat16, "
                         f"got {dtype}")
    model = TemporalDFine(temporal_serving_config(), variant=variant,
                          num_temporal_labels=NUM_LABELS + 1,
                          device=resolve_device(device), seed=seed)
    init_heads_from_trunk(model)
    if dtype == torch.bfloat16:
        cast_params_bf16(model)
    return model


def _frames_in(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 frames -> ``dtype`` times 1/255 rounded to ``dtype`` (the
    reference's ``astype(bf16) * bf16(1/255)``); float frames as given,
    cast to ``dtype``."""
    if x.dtype == torch.uint8:
        scale = float(torch.tensor(1.0 / 255.0, dtype=dtype))
        return x.to(dtype) * scale
    return x.to(dtype)


def make_temporal_stream(model: TemporalDFine) -> Callable:
    """``stream(slab)``: ``serve.throughput.make_streaming_forward`` over
    the (T, H, W, 3) chunks of an (n, T, H, W, 3) uint8 slab, each
    dequantized on the card; returns the last chunk's logits and boxes and
    a device flag that every chunk's outputs were finite."""
    dtype = next(model.parameters()).dtype
    return make_streaming_forward(lambda u8: model(_frames_in(u8, dtype)))


def make_chunk_predictor(model: TemporalDFine, threshold: float = 0.3,
                         max_det: int = 16) -> Callable:
    """``predict(frames)``: (T, H, W, 3) frames, numpy or torch, uint8
    (dequantized on the card) or float (as given) -> per-frame
    [{box, label, score}, ...] in pixels, from
    ``post_process(logits[..., :2], pred_boxes, (H, W))``."""
    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype

    def predict(frames) -> list:
        x = _frames_in(torch.as_tensor(frames).to(dev), dtype)
        with torch.inference_mode():
            out = model(x)
            det = post_process(out["logits"][..., :NUM_LABELS],
                               out["pred_boxes"], tuple(x.shape[1:3]),
                               threshold=threshold, max_det=max_det)
        return frame_results(det, threshold)

    return predict


def predict_sequence(model: TemporalDFine, frames: np.ndarray,
                     threshold: float = 0.3, max_det: int = 16) -> list:
    """Per-frame detections of a (T, H, W, 3) stack of any length T:
    ``chunked_sequence_runner`` over :func:`make_chunk_predictor` in
    windows of :data:`SEQ_LEN` frames."""
    return chunked_sequence_runner(
        make_chunk_predictor(model, threshold, max_det), np.asarray(frames),
        SEQ_LEN)
