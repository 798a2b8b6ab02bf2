"""Inference endpoints around the detectors.

Counterpart of ``pautdx/serve/endpoints.py``. Ported: ``DetectorEndpoint``,
with the reference bridge's output schema, and
``chunked_sequence_runner``, which runs a temporal model over a frame
stack of any length in fixed windows. ``SignalEndpoint`` waits for the
signal slice (ROADMAP.md, queue 1, item 11).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from pautdx_torch.data.windowing import chunked_windows, padded_window
from pautdx_torch.device import resolve_device


def frame_results(det: Dict[str, torch.Tensor], threshold: float) -> list:
    """Post-processed detections {"boxes", "scores", "classes", "valid"}
    of T frames -> per-frame [{box, label, score}, ...] (the reference
    bridge's output schema), the valid slots scored at ``threshold`` or
    more."""
    scores = det["scores"].float().cpu().numpy()
    classes = det["classes"].cpu().numpy()
    boxes = det["boxes"].float().cpu().numpy()
    valid = det["valid"].cpu().numpy() & (scores >= threshold)
    return [[{"box": [float(v) for v in boxes[t, i]],
              "label": int(classes[t, i]),
              "score": float(scores[t, i])}
             for i in np.nonzero(valid[t])[0]]
            for t in range(scores.shape[0])]


class DetectorEndpoint:
    """B-scan image detector endpoint over a batched ``forward`` that maps
    (T, H, W, 3) float images in [0, 1] to {"boxes", "scores", "classes",
    "valid"} (e.g. ``YoloPredictor.forward``)."""

    def __init__(self, forward: Callable, *, threshold: float = 0.3,
                 device: Optional[Union[str, torch.device]] = None):
        self.forward = forward
        self.threshold = threshold
        self.device = resolve_device(device)

    @torch.no_grad()
    def predict(self, images) -> list:
        """images (T, H, W, 3), numpy or torch -> per-frame
        [{box, label, score}, ...]. uint8 frames (the PNG pipeline's wire
        format) are rescaled to [0, 1], the training-time contract."""
        x = torch.as_tensor(images, device=self.device)
        x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 \
            else x.to(torch.float32)
        return frame_results(self.forward(x), self.threshold)


def chunked_sequence_runner(predict_fn: Callable, frames,
                            seq_len: int = 50) -> list:
    """Run a temporal model's ``predict_fn`` ((seq_len, ...) frames ->
    one result per frame) over a stack of any length T: windows of
    ``seq_len`` with the tail re-anchored (``data.windowing``), each
    frame keeping the result of the first window that holds it; a stack
    shorter than ``seq_len`` is zero-padded up to it. Every frame gets
    exactly one result."""
    T = frames.shape[0]
    results: list = [None] * T
    if T < seq_len:
        _, _, pad = padded_window(T, seq_len)
        padded = np.concatenate(
            [frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)])
        return list(predict_fn(padded)[:T])
    for (a, b) in chunked_windows(T, seq_len):
        out = predict_fn(frames[a:b])
        for i in range(a, b):
            if results[i] is None:
                results[i] = out[i - a]
    return results
