"""Vision-side datasets: B-scan detection frames for the detectors.

Counterpart of ``pautdx/data/vision.py``: rendered B-scans (rendered on the
card by ``data.bscan``) plus padded (boxes, classes, mask) targets of a
static M, host-side batching, the letterbox transform and the temporal
models' sequence chunks (``data.windowing``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pautdx_torch.data.bscan import bbox_xyxy_from_schema, render_volume_dataset
from pautdx_torch.data.volume import ParsedVolume
from pautdx_torch.data.windowing import chunked_windows


@dataclasses.dataclass
class DetectionFrames:
    """Frames (T, H, W, C) + static-shape padded targets."""

    images: np.ndarray           # (T, H, W, 1 or 3) float32
    boxes: np.ndarray            # (T, M, 4) pixel xyxy, zero-padded
    classes: np.ndarray          # (T, M) int32, zero-padded
    mask: np.ndarray             # (T, M) float32

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def image_size(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

    def normalized_cxcywh(self) -> np.ndarray:
        """(T, M, 4) cxcywh normalized: the DETR box parameterization."""
        H, W = self.image_size
        b = self.boxes
        cx = (b[..., 0] + b[..., 2]) / 2 / W
        cy = (b[..., 1] + b[..., 3]) / 2 / H
        w = (b[..., 2] - b[..., 0]) / W
        h = (b[..., 3] - b[..., 1]) / H
        return np.stack([cx, cy, w, h], -1).astype(np.float32)


def detection_frames_from_volume(
        vol: ParsedVolume, out_size: int = 320, max_boxes: int = 8,
        class_map: Optional[Dict[str, int]] = None, rgb: bool = True,
        device: Optional[Union[str, torch.device]] = None
) -> DetectionFrames:
    """Frames rendered on ``device`` (default ``"cuda"``) + padded
    pixel-box targets for one volume. Boxes narrower or lower than one
    pixel are dropped, as the reference's invalid-box filter does; past
    ``max_boxes`` a frame's boxes are cut."""
    imgs, ann = render_volume_dataset(vol, out_size, out_size, device=device)
    T = imgs.shape[0]
    boxes = np.zeros((T, max_boxes, 4), np.float32)
    classes = np.zeros((T, max_boxes), np.int32)
    mask = np.zeros((T, max_boxes), np.float32)
    for t in range(T):
        j = 0
        for d in ann.get(f"{t}.png", []):
            if j >= max_boxes:
                break
            x1, y1, x2, y2 = bbox_xyxy_from_schema(d["bbox"])
            if x2 - x1 < 1 or y2 - y1 < 1:
                continue
            boxes[t, j] = [x1, y1, x2, y2]
            classes[t, j] = 0 if class_map is None else class_map.get(
                d["label"], 0)
            mask[t, j] = 1.0
            j += 1
    images = imgs[..., None].astype(np.float32)
    if rgb:
        images = np.repeat(images, 3, axis=-1)
    return DetectionFrames(images, boxes, classes, mask)


def sequence_chunks(frames: DetectionFrames, seq_len: int = 50,
                    require_gt: bool = True) -> List[DetectionFrames]:
    """Chunk a frame stack into tail-re-anchored windows; keep only chunks
    with ground truth when ``require_gt``."""
    out = []
    for (a, b) in chunked_windows(len(frames), seq_len):
        chunk = DetectionFrames(frames.images[a:b], frames.boxes[a:b],
                                frames.classes[a:b], frames.mask[a:b])
        if require_gt and chunk.mask.sum() < 1:
            continue
        out.append(chunk)
    return out


def letterbox(images: np.ndarray, out_size: int,
              pad_value: float = 114.0 / 255.0
              ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Aspect-preserving resize + center pad to (out_size, out_size).

    Returns (images, scale, (pad_x, pad_y)) so boxes can be transformed:
    ``box_out = box_in * scale + pad``.
    """
    T, H, W = images.shape[:3]
    C = images.shape[3] if images.ndim == 4 else 1
    imgs = images.reshape(T, H, W, C)
    scale = min(out_size / H, out_size / W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    ys = np.clip((np.arange(nh) + 0.5) / scale - 0.5, 0, H - 1)
    xs = np.clip((np.arange(nw) + 0.5) / scale - 0.5, 0, W - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    top = imgs[:, y0][:, :, x0] * (1 - wx) + imgs[:, y0][:, :, x1] * wx
    bot = imgs[:, y1][:, :, x0] * (1 - wx) + imgs[:, y1][:, :, x1] * wx
    resized = top * (1 - wy) + bot * wy
    out = np.full((T, out_size, out_size, C), pad_value, imgs.dtype)
    py = (out_size - nh) // 2
    px = (out_size - nw) // 2
    out[:, py:py + nh, px:px + nw] = resized
    return out, scale, (px, py)


def batch_frames(frames_list: List[DetectionFrames],
                 indices: np.ndarray) -> Dict[str, np.ndarray]:
    """Gather a batch dict from a flat list of single frames."""
    return {
        "images": np.stack([frames_list[i].images for i in indices]),
        "boxes": np.stack([frames_list[i].boxes for i in indices]),
        "classes": np.stack([frames_list[i].classes for i in indices]),
        "mask": np.stack([frames_list[i].mask for i in indices]),
    }


def split_frames(frames: DetectionFrames) -> List[DetectionFrames]:
    """Per-frame singletons (for image-level batching)."""
    return [
        DetectionFrames(frames.images[i], frames.boxes[i],
                        frames.classes[i], frames.mask[i])
        for i in range(len(frames))
    ]
