"""YOLOv8n-seg 640px predict path: frames in, detections and masks out.

The chain the JAX package runs for YOLO-seg predict (``pautdx/cli.py``'s
YOLO head, ``tests/test_seg_eval.py``'s mask glue): ``YOLO`` ->
``decode_boxes`` -> ``dense_to_detections`` (top-k, class-offset IoU, the
greedy sweep on the ``nms_suppress`` kernel) -> the mask coefficients of
the kept anchors -> ``assemble_masks`` (the mask kernel). The
configuration is Ultralytics ``yolov8n-seg.yaml`` at its published width
and depth with one class, as the reference's ``data-seg.yaml`` trains it:
640x640 frames, 8,400 anchors, (B, 160, 160, 32) prototypes, NMS over the
top 300 candidates down to 100 detections.

:func:`build_yolo_predictor` gives a :class:`YoloPredictor`, called on
(B, H, W, 3) uint8 frames on its device. :func:`make_yolo_stream` runs it
over the micro-batches of a (n_steps, B, H, W, 3) slab, and
:func:`~pautdx_torch.serve.throughput.measure_fps` times that loop with
CUDA events. All of it is eager PyTorch; CUDA graphs are later work.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.device import resolve_device
from pautdx_torch.models.vision.yolo import YOLO, YoloConfig, decode_boxes
from pautdx_torch.ops import masks as mask_ops
from pautdx_torch.ops.nms import dense_to_detections
from pautdx_torch.serve.throughput import make_uint8_slab, measure_fps

__all__ = ["IMG", "YoloPredictor", "build_yolo_predictor", "full_f32",
           "make_frame_slab", "make_yolo_stream", "measure_fps",
           "postprocess", "yolo_serving_config"]

# frame side of the predict path: Ultralytics' default imgsz
IMG = 640


def yolo_serving_config() -> YoloConfig:
    """YOLOv8n-seg, one class."""
    return YoloConfig(num_classes=1, scale="n", flavour="v8", seg=True)


def postprocess(out: Dict, img_size: Tuple[int, int], cfg: YoloConfig
                ) -> Dict[str, torch.Tensor]:
    """The model's raw outputs -> {boxes, scores, classes, valid, indices,
    masks}: dense decode, batched NMS at ``nms()``'s defaults and, with
    ``cfg.seg``, the kept anchors' masks at proto resolution,
    (B, 100, H/4, W/4)."""
    d = decode_boxes(out, img_size, cfg)
    det = dense_to_detections(d)
    if cfg.seg:
        coeffs = torch.take_along_dim(d["coeffs"], det["indices"][..., None],
                                      dim=1)
        # the mask kernel reads dense NHWC protos; they come out dense only
        # when the convolutions ran channels_last, which depends on how the
        # caller laid out the images (a no-op when they are)
        det["masks"] = mask_ops.assemble_masks(out["protos"].contiguous(),
                                               coeffs, det["boxes"], img_size)
    return det


@contextmanager
def full_f32():
    """float32 convolutions and GEMMs without TF32, the precision the path
    is gated and measured at; the caller's settings come back after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@dataclasses.dataclass
class YoloPredictor:
    model: YOLO
    cfg: YoloConfig

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) float images in [0, 1], any strides -> detections
        and masks, in full f32 whatever the global TF32 settings."""
        with full_f32():
            return postprocess(self.model(images), tuple(images.shape[1:3]),
                               self.cfg)

    def __call__(self, frames_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) uint8 frames on the model's device, rescaled by
        1/255 -> detections and masks."""
        if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4:
            raise TypeError(f"predict: want (B, H, W, 3) uint8 frames, got "
                            f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
        return self.forward(frames_u8.to(torch.float32) / 255.0)


def build_yolo_predictor(variables: Optional[Mapping] = None,
                         device: Optional[Union[str, torch.device]] = None,
                         seed: int = 0) -> YoloPredictor:
    """YOLOv8n-seg in f32 on ``device`` (default ``"cuda"``), TF32 off in
    every call (:func:`full_f32`): the JAX package's ``variables`` loaded
    strictly when given, else a seeded init."""
    dev = resolve_device(device)
    cfg = yolo_serving_config()
    model = YOLO(cfg, device=dev, seed=seed)
    if variables is not None:
        load_jax_variables(model, variables, device=dev)
    return YoloPredictor(model=model, cfg=cfg)


def make_frame_slab(n_steps: int, batch: int, seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> torch.Tensor:
    """Random (n_steps, batch, IMG, IMG, 3) uint8 frames made on the
    device from a seeded generator."""
    return make_uint8_slab((n_steps, batch, IMG, IMG, 3), seed=seed,
                           device=device)


def make_yolo_stream(predict: Callable) -> Callable:
    """``stream(slab)`` runs ``predict`` over each (B, H, W, 3) micro-batch
    of a (n_steps, B, H, W, 3) slab and returns the last step's outputs
    and a device flag that every step's boxes, scores and masks were
    finite. The masks, the largest output, are checked through their sum
    in one read: masks lie in [0, 1], so the sum is finite exactly when
    every mask value is."""

    def stream(slab: torch.Tensor):
        finite = torch.ones((), dtype=torch.bool, device=slab.device)
        out = None
        for step in range(slab.shape[0]):
            out = predict(slab[step])
            finite &= (torch.isfinite(out["boxes"]).all()
                       & torch.isfinite(out["scores"]).all()
                       & torch.isfinite(out["masks"].sum()))
        return out, finite

    return stream
