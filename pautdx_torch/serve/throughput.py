"""High-throughput streaming inference of the D-FINE-nano serving path.

Counterpart of ``pautdx/serve/throughput.py``. The serving configuration
is the reference ``bench.py``'s: ``dfine_nano(num_labels=2)`` with the
discrete deformable decoder, the fused AIFI attention, bf16 weights and a
stride-8 space-to-depth stem that takes host-prepatchified raw uint8
frames, (B, 80, 80, 192) at 640px, with 1/255 folded into its weight.

The streaming loop runs the model over the micro-batches of a
(n_steps, B, ...) uint8 slab on the card; :func:`measure_fps` times it
with CUDA events after a warm-up. CUDA graphs are later work.

``build_serving_model(int8_calib=...)`` serves int8 activations: the 69
conv sites of the HGNet stages and the hybrid encoder calibrated
(``serve.quantize.calibrate_int8``) on uint8 wire batches shaped like the
serving inputs, after the bf16 cast and the stem fold, as the reference's
accuracy harness calibrates its ``uint8_raw`` graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from pautdx_torch.device import resolve_device
from pautdx_torch.models.vision.dfine import DFine, DFineConfig, dfine_nano
from pautdx_torch.ops.qconv import set_int8_scales
from pautdx_torch.serve.quantize import Quant, calibrate_int8


@torch.no_grad()
def fold_uint8_stem(model: DFine, scale: float = 1.0 / 255.0) -> DFine:
    """Fold the input dequantization scale into the space-to-depth stem's
    weight, in place: ``(u8 / 255) @ K == u8 @ (K / 255)``. The product is
    taken in float32 and cast back to the weight's dtype, as the reference
    does. Raises if the stem is not a space-to-depth patchify stem."""
    stem = getattr(model.model.backbone.model, "patch_embedder", None)
    if stem is None or not getattr(stem, "s2d", False):
        raise KeyError("fold_uint8_stem: raw-uint8 serving requires the "
                       "space-to-depth patchify stem (HGNetConfig.stem_s2d)")
    w = stem.proj.weight
    w.copy_((w.float() * scale).to(w.dtype))
    return model


@torch.no_grad()
def cast_params_bf16(module: nn.Module) -> nn.Module:
    """Cast every float32 parameter and buffer (BN statistics included) to
    bfloat16, in place; other dtypes pass through."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.dtype == torch.float32:
            t.data = t.data.to(torch.bfloat16)
    return module


def prepatchify_uint8(frames, patch: int) -> np.ndarray:
    """Host-side space-to-depth on the uint8 wire bytes:
    (..., H, W, C) -> (..., H/p, W/p, p*p*C), flattened in (ki, kj, c)
    order, which a ``stem_pre_patchified`` model consumes with the same
    weights. Leading axes (steps, batch) pass through."""
    x = np.asarray(frames)
    *lead, H, W, C = x.shape
    if H % patch or W % patch:
        raise ValueError(f"H/W must be divisible by patch={patch}, "
                         f"got {H}x{W}")
    x = x.reshape(*lead, H // patch, patch, W // patch, patch, C)
    nd = x.ndim
    # (..., Hp, ki, Wp, kj, c) -> (..., Hp, Wp, ki, kj, c)
    x = x.transpose(*range(nd - 5), nd - 5, nd - 3, nd - 4, nd - 2, nd - 1)
    return np.ascontiguousarray(x).reshape(
        *lead, H // patch, W // patch, patch * patch * C)


def make_uint8_slab(shape: Tuple[int, ...], seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> torch.Tensor:
    """Random uint8 slab made on the device from a seeded generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, generator=gen, device=dev,
                         dtype=torch.uint8)


def serving_config() -> DFineConfig:
    """The reference ``bench.py`` configuration (``bench.py:79-83``)."""
    cfg = dataclasses.replace(dfine_nano(num_labels=2),
                              decoder_method="discrete",
                              encoder_fused_attn=True)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, stem_pre_patchified=True))


# frame side of the reference ``bench.py`` serving run (``bench.py:61``)
IMG = 640


@dataclasses.dataclass
class ServingModel:
    model: DFine
    cfg: DFineConfig
    batch: int
    # the int8 sites' input scales, empty when serving dense
    quant: Quant = dataclasses.field(default_factory=dict)

    def slab_shape(self, n_steps: int) -> Tuple[int, ...]:
        """A slab of ``n_steps`` micro-batches of prepatchified uint8
        frames: (n_steps, batch, IMG/p, IMG/p, p*p*C)."""
        p = self.cfg.backbone.stem_patch
        c = self.cfg.backbone.stem_channels[0]
        return (n_steps, self.batch, IMG // p, IMG // p, p * p * c)


def build_serving_model(device: Optional[Union[str, torch.device]] = None,
                        batch: int = 128, seed: int = 0,
                        state_dict: Optional[dict] = None,
                        int8_calib=None) -> ServingModel:
    """The serving model of ``bench.py:79-100``: seeded init, or the float32
    weights and BN statistics of a trained ``dfine_nano(num_labels=2)`` in
    ``state_dict`` (the serving options take the same tensors), every
    float32 weight and statistic cast to bf16, then the uint8 stem fold.
    With ``int8_calib`` (uint8 wire batches on ``device``, a slab or a
    sequence of (B, 80, 80, 192) batches), the int8 sites are calibrated
    on them and serve s8 x s8 -> s32 from then on."""
    dev = resolve_device(device)
    cfg = serving_config()
    model = DFine(cfg, device=dev, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    fold_uint8_stem(cast_params_bf16(model))
    model.eval()
    quant: Quant = {}
    if int8_calib is not None:
        if isinstance(int8_calib, torch.Tensor):
            int8_calib = (list(int8_calib) if int8_calib.dim() == 5
                          else [int8_calib])
        with torch.inference_mode():
            quant = calibrate_int8(model, int8_calib)
        set_int8_scales(model, quant)
    return ServingModel(model=model, cfg=cfg, batch=batch, quant=quant)


def make_streaming_forward(model: Callable) -> Callable:
    """``stream(slab)`` runs ``model`` (a ``DFine``, or any callable that
    returns its ``logits`` and ``pred_boxes``) over each (B, ...)
    micro-batch of a (n_steps, B, ...) slab under
    ``torch.inference_mode()`` and returns the last step's logits and
    boxes and a device flag that every step's outputs were finite."""

    def stream(slab: torch.Tensor):
        with torch.inference_mode():
            finite = torch.ones((), dtype=torch.bool, device=slab.device)
            logits = boxes = None
            for step in range(slab.shape[0]):
                out = model(slab[step])
                logits, boxes = out["logits"], out["pred_boxes"]
                finite &= (torch.isfinite(logits).all()
                           & torch.isfinite(boxes).all())
            return logits, boxes, finite

    return stream


def measure_fps(stream_fn: Callable, slab: torch.Tensor) -> float:
    """Frames per second of ``stream_fn`` over ``slab`` on the card: three
    calls timed with CUDA events after one warm-up call and a synchronize."""
    if slab.device.type != "cuda":
        raise RuntimeError("measure_fps times the card; the slab is on "
                           f"{slab.device}")
    n_steps, batch = slab.shape[0], slab.shape[1]
    stream_fn(slab)
    torch.cuda.synchronize(slab.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        stream_fn(slab)
    end.record()
    torch.cuda.synchronize(slab.device)
    return n_steps * batch * 3 / (start.elapsed_time(end) / 1e3)
