"""HF-architecture D-FINE 640px predict path: frames in, detections out.

The port's counterpart of the D-FINE branch of
``pautdx/cli.py::_build_detector_forward``, the chain of ``predict-bscan
--detector dfine --fused-attn``: ``DFine`` with the fused AIFI attention
(the ``aifi_attention`` kernel, head dim 32 at ``DFineConfig()``'s d_model
256 and 8 heads), then ``post_process(logits, pred_boxes, (size, size),
threshold=0.3, max_det=16)``. The default configuration is
``DFineConfig(num_labels=2, encoder_fused_attn=True)``: the HGNetV2
``Embeddings`` stem, 3 feature levels (8,400 anchors at 640px), 300
queries, 6 decoder layers with per-head bilinear sampling points.

:func:`build_dfine_predictor` gives a :class:`DFinePredictor`, called on
(B, H, W, 3) float images in [0, 1], the ``forward`` that
``serve.endpoints.DetectorEndpoint`` wraps. :func:`make_dfine_stream`
runs it over the micro-batches of a (n_steps, B, H, W, 3) uint8 slab, and
:func:`~pautdx_torch.serve.throughput.measure_fps` times that loop with
CUDA events. All of it is eager PyTorch.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Callable, Dict, Optional, Union

import torch

from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.device import resolve_device
from pautdx_torch.models.vision.dfine import DFine, DFineConfig, post_process
from pautdx_torch.serve.throughput import cast_params_bf16
from pautdx_torch.serve.yolo_predict import full_f32

__all__ = ["DFinePredictor", "build_dfine_predictor", "dfine_predict_config",
           "make_dfine_stream"]


def dfine_predict_config() -> DFineConfig:
    """``DFineConfig()``'s HF architecture with two labels and the fused
    AIFI attention, as ``predict-bscan --fused-attn`` sets it
    (``pautdx/cli.py:317-320``)."""
    return DFineConfig(num_labels=2, encoder_fused_attn=True)


@dataclasses.dataclass
class DFinePredictor:
    model: DFine
    size: int
    threshold: float
    max_det: int

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, size, size, 3) float images in [0, 1] -> {boxes (B, max_det,
        4) xyxy in pixels, scores, classes, valid}. The images are cast to
        the weights' dtype; TF32 is off inside the call, the CLI's f32."""
        if images.dim() != 4 or tuple(images.shape[1:3]) != (self.size,
                                                            self.size):
            raise ValueError(f"predict: want (B, {self.size}, {self.size}, "
                             f"3) images, got {tuple(images.shape)}")
        dtype = next(self.model.parameters()).dtype
        with torch.inference_mode(), full_f32():
            out = self.model(images.to(dtype))
            return post_process(out["logits"], out["pred_boxes"],
                                (self.size, self.size),
                                threshold=self.threshold,
                                max_det=self.max_det)


def build_dfine_predictor(cfg: Optional[DFineConfig] = None, *,
                          size: int = 640, threshold: float = 0.3,
                          max_det: int = 16,
                          dtype: torch.dtype = torch.float32,
                          device: Optional[Union[str, torch.device]] = None,
                          seed: int = 0,
                          variables: Optional[Mapping] = None
                          ) -> DFinePredictor:
    """D-FINE on ``device`` (default ``"cuda"``): ``cfg`` (default
    :func:`dfine_predict_config`), the JAX package's ``variables`` loaded
    strictly when given, else a seeded init; ``dtype=torch.bfloat16``
    casts every float32 weight and statistic, as
    ``serve.throughput.cast_params_bf16`` does."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"build_dfine_predictor: dtype float32 or bfloat16, "
                         f"got {dtype}")
    dev = resolve_device(device)
    model = DFine(cfg or dfine_predict_config(), device=dev, seed=seed)
    if variables is not None:
        load_jax_variables(model, variables, device=dev)
    if dtype == torch.bfloat16:
        cast_params_bf16(model)
    return DFinePredictor(model=model, size=size, threshold=threshold,
                          max_det=max_det)


def make_dfine_stream(predict: Callable) -> Callable:
    """``stream(slab)`` runs ``predict`` over each (B, H, W, 3) micro-batch
    of a (n_steps, B, H, W, 3) uint8 slab, rescaled by 1/255, and returns
    the last step's outputs and a device flag that every step's boxes and
    scores were finite."""

    def stream(slab: torch.Tensor):
        finite = torch.ones((), dtype=torch.bool, device=slab.device)
        out = None
        for step in range(slab.shape[0]):
            out = predict(slab[step].to(torch.float32) / 255.0)
            finite &= (torch.isfinite(out["boxes"]).all()
                       & torch.isfinite(out["scores"]).all())
        return out, finite

    return stream
