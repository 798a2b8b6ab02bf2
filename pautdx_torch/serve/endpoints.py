"""Inference endpoints around the detectors.

Counterpart of ``pautdx/serve/endpoints.py``: ``SignalEndpoint``, the
per-signal detectors' endpoint; ``DetectorEndpoint``, with the reference
bridge's output schema; and ``chunked_sequence_runner``, which runs a
temporal model over a frame stack of any length in fixed windows.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.data.windowing import chunked_windows, padded_window
from pautdx_torch.device import resolve_device

OVERFLOW_FACTOR = 8


class SignalEndpoint:
    """Per-signal detector endpoint over (B, N, S) signals, the contract
    of the reference's ONNX export with dynamic (batch, num_signals) axes.

    ``predict`` answers every request at its own (B, N): the reference's
    endpoint pads N up to a signal bucket with silent signals, which every
    model that mixes the signals (HybridBinary's sequence mean, every
    attention layer) then sees, so its answer for N = 37 is that for 37
    signals beside 13 zero ones. Eager PyTorch compiles nothing per
    shape, so padding would buy nothing. The buckets keep the reference's
    two limits: a batch above the largest batch bucket runs in chunks of
    that bucket, and N above ``8 x`` the largest configured signal bucket
    raises ``ValueError`` (the axis is the request's to choose).

    ``model`` holds its weights, or takes the reference's ``variables``
    through the strict ``load_jax_variables``; it runs in eval mode under
    ``torch.inference_mode()`` on ``device`` (default ``"cuda"``)."""

    def __init__(self, model: nn.Module,
                 variables: Optional[Mapping] = None, *,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8, 16),
                 signal_buckets: Sequence[int] = (8, 16, 32, 50, 64, 128),
                 threshold: float = 0.5,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if variables is not None:
            model = load_jax_variables(model, variables, self.device)
        self.model = model.to(self.device).eval()
        self.batch_buckets = sorted(batch_buckets)
        self.signal_buckets = sorted(signal_buckets)
        self.threshold = threshold

    def predict(self, signals) -> Dict[str, np.ndarray]:
        """(B, N, S) or (N, S) signals, numpy or torch -> {"prob", "pred"
        (prob >= threshold, float32), and "positions" where the model
        gives them}, numpy on the host."""
        x = torch.as_tensor(signals, dtype=torch.float32, device=self.device)
        if x.dim() == 2:
            x = x[None]
        n = x.shape[1]
        cap = self.signal_buckets[-1] * OVERFLOW_FACTOR
        if n > cap:
            raise ValueError(
                f"request size {n} exceeds the overflow cap "
                f"({self.signal_buckets[-1]} * {OVERFLOW_FACTOR}); raise the "
                f"configured buckets for workloads of this size")
        max_b = self.batch_buckets[-1]
        with torch.inference_mode():
            outs = [self.model(x[i:i + max_b])
                    for i in range(0, x.shape[0], max_b)]
        if isinstance(outs[0], dict):
            prob = torch.cat([o["prob"] for o in outs])
            pos = (torch.cat([o["positions"] for o in outs])
                   if "positions" in outs[0] else None)
        else:
            prob, pos = torch.cat(outs), None
        prob = prob.float().cpu().numpy()
        result = {"prob": prob,
                  "pred": (prob >= self.threshold).astype(np.float32)}
        if pos is not None:
            result["positions"] = pos.float().cpu().numpy()
        return result


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
