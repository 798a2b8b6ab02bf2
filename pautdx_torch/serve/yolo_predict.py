"""YOLO 640px predict paths: frames in, detections (and masks) out.

The chain the JAX package runs for YOLO predict (``pautdx/cli.py``'s YOLO
head, ``tests/test_seg_eval.py``'s mask glue): ``YOLO`` -> ``decode_boxes``
-> ``dense_to_detections`` (top-k, class-offset IoU, the greedy sweep on
the ``nms_suppress`` kernel) -> with ``seg``, the mask coefficients of the
kept anchors -> ``assemble_masks`` (the mask kernel). Four configurations
(:func:`yolo_config`), each at its published width and depth with one
class, as the reference's ``data.yaml``/``data-seg.yaml`` train them, on
640x640 frames (8,400 anchors):

- ``yolov8n-seg`` (the default, :func:`yolo_serving_config`) and
  ``yolov9c-seg``: (B, 160, 160, 32) prototypes, NMS over the top 300
  candidates down to 100 detections, a mask each;
- ``yolo11n`` and ``yolov5su``: boxes only, NMS at the CLI head's
  settings (scores from 0.3, top 64, 16 detections).

:func:`postprocess` picks the NMS settings from ``cfg.seg``, so a
configuration is always served with its own.

:func:`build_yolo_predictor` gives a :class:`YoloPredictor`, called on
(B, H, W, 3) uint8 frames on its device; with ``int8_calib`` its
``ConvBnSiLU`` sites serve int8 activations (``serve.quantize``),
calibrated on the first batch it predicts, as the reference's
``predict-bscan --quant int8`` does, or on frames given at build time. :func:`make_yolo_stream` runs it
over the micro-batches of a (n_steps, B, H, W, 3) slab, and
:func:`~pautdx_torch.serve.throughput.measure_fps` times that loop with
CUDA events. All of it is eager PyTorch; CUDA graphs are later work.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.device import resolve_device
from pautdx_torch.models.vision.yolo import YOLO, YoloConfig, decode_boxes
from pautdx_torch.ops import masks as mask_ops
from pautdx_torch.ops.nms import dense_to_detections
from pautdx_torch.ops.qconv import set_int8_scales
from pautdx_torch.serve.quantize import Quant, calibrate_int8
from pautdx_torch.serve.throughput import make_uint8_slab, measure_fps
from pautdx_torch.utils.profiling import TRACER, span

__all__ = ["CONFIGS", "IMG", "YoloPredictor", "build_yolo_predictor",
           "full_f32", "make_frame_slab", "make_yolo_stream", "measure_fps",
           "postprocess", "yolo_config",
           "yolo_serving_config"]

# frame side of the predict path: Ultralytics' default imgsz
IMG = 640


CONFIGS = {
    # yolo8_seg_predict.py:3-9, the seg predictor
    "yolov8n-seg": YoloConfig(num_classes=1, scale="n", flavour="v8",
                              seg=True),
    # yolo_seg_train.py:5-19, yolov9c-seg.pt
    "yolov9c-seg": YoloConfig(num_classes=1, flavour="v9c", seg=True),
    # yolo/yolo_bbox_retrain.py:6-18, yolo11n.pt
    "yolo11n": YoloConfig(num_classes=1, scale="n", flavour="v11"),
    # yolo5s_retrain.py:4-17, yolov5su.pt
    "yolov5su": YoloConfig(num_classes=1, scale="s", flavour="v5"),
}

# the CLI's YOLO head (pautdx/cli.py, _build_detector_forward): its score
# threshold, 64 candidates, 16 detections; the seg chains keep nms()'s
# defaults (top 300, 100 detections)
_CLI_NMS = {"score_threshold": 0.3, "top_k": 64, "max_det": 16}


def yolo_config(name: str) -> YoloConfig:
    """The :class:`YoloConfig` of one of ``CONFIGS``' names."""
    if name not in CONFIGS:
        raise ValueError(f"no YOLO configuration {name!r}; known: "
                         f"{', '.join(CONFIGS)}")
    return CONFIGS[name]


def _served_nms(cfg: YoloConfig) -> Dict[str, Any]:
    """The ``dense_to_detections`` keywords ``cfg`` is served with:
    ``{}`` (nms()'s defaults) for the seg chains, the CLI head's for the
    detectors."""
    return {} if cfg.seg else dict(_CLI_NMS)


def yolo_serving_config() -> YoloConfig:
    """YOLOv8n-seg, one class."""
    return CONFIGS["yolov8n-seg"]


def postprocess(out: Dict, img_size: Tuple[int, int], cfg: YoloConfig,
                **nms_kw) -> Dict[str, torch.Tensor]:
    """The model's raw outputs -> {boxes, scores, classes, valid, indices}
    and, with ``cfg.seg``, {masks}: dense decode, batched NMS at ``cfg``'s
    served settings with ``nms_kw`` (``dense_to_detections``' keywords)
    over them, and the kept anchors' masks at proto resolution,
    (B, max_det, H/4, W/4)."""
    with span("yolo.decode"):
        d = decode_boxes(out, img_size, cfg)
    with span("yolo.nms"):
        det = dense_to_detections(d, **{**_served_nms(cfg), **nms_kw})
    if cfg.seg:
        with span("yolo.masks"):
            coeffs = torch.take_along_dim(d["coeffs"],
                                          det["indices"][..., None], dim=1)
            # the mask kernel reads dense NHWC protos; they come out dense
            # only when the convolutions ran channels_last, which depends on
            # how the caller laid out the images (a no-op when they are)
            det["masks"] = mask_ops.assemble_masks(
                out["protos"].contiguous(), coeffs, det["boxes"], img_size)
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
    nms_kw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # int8 activations: the sites' scales, and whether the first batch
    # predicted calibrates them
    quant: Quant = dataclasses.field(default_factory=dict)
    int8_on_first_batch: bool = False

    @torch.no_grad()
    def calibrate_int8(self, frames_u8) -> Quant:
        """Calibrate the int8 sites on (B, H, W, 3) uint8 frames (or a
        sequence of such batches) in the predict path's own input transform
        and precision, and serve int8 from then on."""
        batches = [frames_u8] if isinstance(frames_u8, torch.Tensor) \
            else list(frames_u8)
        with full_f32():
            self.quant = calibrate_int8(
                self.model, [_check_frames(b).to(torch.float32) / 255.0
                             for b in batches])
        set_int8_scales(self.model, self.quant)
        self.int8_on_first_batch = False
        return self.quant

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) float images in [0, 1], any strides -> detections
        (and masks), in full f32 whatever the global TF32 settings."""
        with full_f32():
            with span("yolo.forward"):
                out = self.model(images)
            return postprocess(out, tuple(images.shape[1:3]), self.cfg,
                               **self.nms_kw)

    def __call__(self, frames_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) uint8 frames on the model's device, rescaled by
        1/255 -> detections (and masks); the first call calibrates the int8
        sites when the predictor was built with ``int8_calib="first"``."""
        _check_frames(frames_u8)
        if self.int8_on_first_batch:
            self.calibrate_int8(frames_u8)
        with span("yolo.predict"):
            return self.forward(frames_u8.to(torch.float32) / 255.0)


def _check_frames(frames_u8: torch.Tensor) -> torch.Tensor:
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4:
        raise TypeError(f"predict: want (B, H, W, 3) uint8 frames, got "
                        f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
    return frames_u8


def build_yolo_predictor(variables: Optional[Mapping] = None,
                         device: Optional[Union[str, torch.device]] = None,
                         seed: int = 0, cfg: Optional[YoloConfig] = None,
                         int8_calib=None, **nms_kw) -> YoloPredictor:
    """``cfg`` (default YOLOv8n-seg) in f32 on ``device`` (default
    ``"cuda"``), TF32 off in every call (:func:`full_f32`), NMS at
    ``cfg``'s served settings with ``nms_kw`` over them (see
    :func:`postprocess`): the JAX package's ``variables`` loaded strictly when
    given, else a seeded init. An Ultralytics state dict loads afterwards
    through ``compat.yolo_import.load_ultralytics_state_dict``.

    ``int8_calib``: ``"first"`` serves int8 activations calibrated on the
    first batch predicted (the reference's ``predict-bscan --quant
    int8``); uint8 frames (a (B, H, W, 3) batch or a sequence of them)
    calibrate now; a ``"quant"`` collection in ``variables`` sets the
    reference's own scales. On a card it readies the tracer's side stream
    (``utils.profiling.Tracer.prepare``)."""
    dev = resolve_device(device)
    cfg = yolo_serving_config() if cfg is None else cfg
    model = YOLO(cfg, device=dev, seed=seed)
    if variables is not None:
        load_jax_variables(model, variables, device=dev)
    TRACER.prepare(dev)
    pred = YoloPredictor(model=model, cfg=cfg, nms_kw=nms_kw)
    if isinstance(int8_calib, str):
        if int8_calib != "first":
            raise ValueError(f"int8_calib: {int8_calib!r}; want 'first' or "
                             f"uint8 frames")
        pred.int8_on_first_batch = True
    elif int8_calib is not None:
        pred.calibrate_int8(int8_calib)
    return pred


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
    and a device flag that every step's boxes, scores and, where the model
    makes them, masks were finite. The masks, the largest output, are
    checked through their sum in one read: masks lie in [0, 1], so the sum
    is finite exactly when every mask value is."""

    def stream(slab: torch.Tensor):
        finite = torch.ones((), dtype=torch.bool, device=slab.device)
        out = None
        for step in range(slab.shape[0]):
            out = predict(slab[step])
            finite &= (torch.isfinite(out["boxes"]).all()
                       & torch.isfinite(out["scores"]).all())
            if "masks" in out:
                finite &= torch.isfinite(out["masks"].sum())
        return out, finite

    return stream
