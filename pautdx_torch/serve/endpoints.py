"""Inference endpoints around the detectors.

Counterpart of ``pautdx/serve/endpoints.py``. Ported: ``DetectorEndpoint``,
with the reference bridge's output schema. ``SignalEndpoint`` and
``chunked_sequence_runner`` wait for the signal and temporal slices.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from pautdx_torch.device import resolve_device


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
        out = self.forward(x)
        scores = out["scores"].cpu().numpy()
        classes = out["classes"].cpu().numpy()
        boxes = out["boxes"].cpu().numpy()
        valid = out["valid"].cpu().numpy() & (scores >= self.threshold)
        results = []
        for t in range(scores.shape[0]):
            results.append([{"box": [float(v) for v in boxes[t, i]],
                             "label": int(classes[t, i]),
                             "score": float(scores[t, i])}
                            for i in np.nonzero(valid[t])[0]])
        return results
