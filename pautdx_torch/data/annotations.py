"""Annotation schema + YOLO-format converters + mask rasterization.

Counterpart of ``pautdx/data/annotations.py``, host numpy, the port's own
copy. Schema parity with the reference: ``annotations.json`` maps
``{sequence: {"<scan>.png": [{"bbox": [x1, x2, y1, y2], "label": str}]}}``
(`BscanBased/DS_preprocessing.py:17-29`). Converters re-implement:

- detect labels  — `BscanBased/yolo_ds_preprocess.py:7-159`
  (YOLO ``class cx cy w h`` normalized, train/val split, empty-image keep ratio)
- seg masks      — `BscanBased/yolo_ds_segmentation.py:9-109`
  (bboxes rasterized as filled rectangles, keep fraction of empty images)

Rasterization is a vectorized numpy op, not a per-pixel host loop.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pautdx_torch.data.bscan import bbox_xyxy_from_schema


@dataclasses.dataclass
class YoloExample:
    """One image with its YOLO-normalized boxes (class, cx, cy, w, h)."""

    image_key: str
    boxes: np.ndarray        # (n, 5) float32
    split: str               # "train" | "val"


def load_annotations(path: str) -> Dict[str, Dict[str, list]]:
    with open(path) as f:
        return json.load(f)


def save_annotations(path: str, ann: Dict[str, Dict[str, list]]) -> None:
    with open(path, "w") as f:
        json.dump(ann, f)


def to_yolo_labels(defects: List[dict], img_size: Tuple[int, int],
                   class_map: Optional[Dict[str, int]] = None) -> np.ndarray:
    """Schema bboxes -> (n, 5) ``class cx cy w h`` normalized rows."""
    W, H = img_size
    rows = []
    for d in defects:
        x1, y1, x2, y2 = bbox_xyxy_from_schema(d["bbox"])
        cls = 0 if class_map is None else class_map.get(d["label"], 0)
        cx = (x1 + x2) / 2.0 / W
        cy = (y1 + y2) / 2.0 / H
        w = (x2 - x1) / W
        h = (y2 - y1) / H
        if w <= 0 or h <= 0:
            continue
        rows.append([cls, cx, cy, w, h])
    return np.asarray(rows, np.float32).reshape(-1, 5)


def prepare_yolo_split(ann: Dict[str, Dict[str, list]],
                       img_size: Tuple[int, int] = (320, 320),
                       val_fraction: float = 0.15,
                       keep_empty_fraction: float = 0.1,
                       seed: int = 42,
                       class_map: Optional[Dict[str, int]] = None
                       ) -> List[YoloExample]:
    """Flatten annotations into YOLO examples with a seeded split.

    Matches `yolo_ds_preprocess.py` behaviour: 15% val split; images with no
    boxes are kept only at ``keep_empty_fraction``.
    """
    rng = np.random.default_rng(seed)
    out: List[YoloExample] = []
    for seq, images in ann.items():
        for img_key, defects in images.items():
            boxes = to_yolo_labels(defects, img_size, class_map)
            if boxes.shape[0] == 0 and rng.random() > keep_empty_fraction:
                continue
            split = "val" if rng.random() < val_fraction else "train"
            out.append(YoloExample(f"{seq}/{img_key}", boxes, split))
    return out


def write_yolo_dataset(examples: Sequence[YoloExample], images: Dict[str, np.ndarray],
                       root: str, class_names: Sequence[str] = ("defect",)) -> str:
    """Write images/{train,val} + labels/{train,val} + data.yaml; returns yaml path."""
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, "images", split), exist_ok=True)
        os.makedirs(os.path.join(root, "labels", split), exist_ok=True)
    for ex in examples:
        stem = ex.image_key.replace("/", "__").rsplit(".", 1)[0]
        img = images.get(ex.image_key)
        if img is not None:
            np.save(os.path.join(root, "images", ex.split, stem + ".npy"),
                    img.astype(np.float32))
        with open(os.path.join(root, "labels", ex.split, stem + ".txt"), "w") as f:
            for row in ex.boxes:
                f.write(f"{int(row[0])} " + " ".join(f"{v:.6f}" for v in row[1:]) + "\n")
    yaml_path = os.path.join(root, "data.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"path: {root}\ntrain: images/train\nval: images/val\n")
        f.write(f"nc: {len(class_names)}\n")
        f.write("names: [" + ", ".join(class_names) + "]\n")
    return yaml_path


def rasterize_boxes(boxes_xyxy: np.ndarray, img_size: Tuple[int, int],
                    value: float = 255.0) -> np.ndarray:
    """Filled-rectangle mask from (n, 4) pixel boxes — vectorized analogue of
    `yolo_ds_segmentation.py:9-109` (single-channel mask, 255 inside boxes)."""
    W, H = img_size
    mask = np.zeros((H, W), np.float32)
    ys = np.arange(H)[:, None]
    xs = np.arange(W)[None, :]
    for (x1, y1, x2, y2) in np.asarray(boxes_xyxy, np.float32).reshape(-1, 4):
        mask = np.maximum(
            mask,
            value * ((xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)).astype(np.float32),
        )
    return mask


def yolo_to_xyxy(boxes: np.ndarray, img_size: Tuple[int, int]) -> np.ndarray:
    """(n, 5) class cx cy w h normalized -> (n, 4) pixel xyxy."""
    W, H = img_size
    b = np.asarray(boxes, np.float32).reshape(-1, 5)
    cx, cy, w, h = b[:, 1] * W, b[:, 2] * H, b[:, 3] * W, b[:, 4] * H
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)
