"""Vision train-time augmentation: mosaic, flips, amplitude jitter.

The port's own copy of ``pautdx/data/augment_vision.py``: host-side numpy
with the caller's ``np.random.Generator``, so the same generator state
gives the same batch.

The capability the reference gets from Ultralytics' train pipeline
(SURVEY.md §2.1 dependency note: "mosaic aug"). B-scan amplitude images
are single-channel physical quantities, so the HSV color jitter becomes
gain/bias/gamma amplitude jitter; geometric augs (mosaic 2x2 paste,
horizontal/vertical flips) carry boxes along. All host-side numpy, runs in
the input pipeline ahead of prefetch.

Boxes are (M, 4) pixel xyxy + (M,) classes + (M,) mask, padded static.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def flip_horizontal(image: np.ndarray, boxes: np.ndarray,
                    mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    W = image.shape[1]
    out = image[:, ::-1].copy()
    b = boxes.copy()
    b[:, [0, 2]] = W - boxes[:, [2, 0]]
    b[mask == 0] = 0
    return out, b


def flip_vertical(image: np.ndarray, boxes: np.ndarray,
                  mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    H = image.shape[0]
    out = image[::-1].copy()
    b = boxes.copy()
    b[:, [1, 3]] = H - boxes[:, [3, 1]]
    b[mask == 0] = 0
    return out, b


def amplitude_jitter(image: np.ndarray, rng: np.random.Generator,
                     gain: Tuple[float, float] = (0.7, 1.3),
                     bias: Tuple[float, float] = (-0.05, 0.05),
                     gamma: Tuple[float, float] = (0.7, 1.4)) -> np.ndarray:
    """Gain/bias/gamma jitter — the amplitude-image analogue of HSV aug."""
    g = rng.uniform(*gain)
    b = rng.uniform(*bias)
    gm = rng.uniform(*gamma)
    out = np.clip(np.abs(image) ** gm * g + b, 0.0, None)
    return out.astype(image.dtype)


def mosaic(images: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
           masks: np.ndarray, rng: np.random.Generator,
           max_boxes: int) -> Dict[str, np.ndarray]:
    """Combine 4 same-size images into one 2x2 mosaic at the same output
    size (each quadrant is a downscaled-by-2 image), merging targets.

    images (4, H, W, C); boxes (4, M, 4); classes (4, M); masks (4, M).
    """
    H, W = images.shape[1:3]
    canvas = np.zeros_like(images[0])
    all_boxes, all_classes = [], []
    # cheap 2x downscale by striding (amplitude images tolerate it; exact
    # bilinear available via data.vision.letterbox when quality matters)
    for q, (oy, ox) in enumerate([(0, 0), (0, W // 2),
                                  (H // 2, 0), (H // 2, W // 2)]):
        small = images[q][::2, ::2]
        canvas[oy:oy + H // 2, ox:ox + W // 2] = small[:H // 2, :W // 2]
        for m in range(boxes.shape[1]):
            if masks[q, m] <= 0:
                continue
            x1, y1, x2, y2 = boxes[q, m] / 2.0
            all_boxes.append([x1 + ox, y1 + oy, x2 + ox, y2 + oy])
            all_classes.append(classes[q, m])
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_classes = np.zeros((max_boxes,), np.int32)
    out_mask = np.zeros((max_boxes,), np.float32)
    order = rng.permutation(len(all_boxes))[:max_boxes]
    for j, idx in enumerate(order):
        out_boxes[j] = all_boxes[idx]
        out_classes[j] = all_classes[idx]
        out_mask[j] = 1.0
    return {"image": canvas, "boxes": out_boxes, "classes": out_classes,
            "mask": out_mask}


def augment_detection_batch(batch: Dict[str, np.ndarray],
                            rng: np.random.Generator,
                            mosaic_prob: float = 0.5,
                            flip_prob: float = 0.5,
                            jitter_prob: float = 0.5) -> Dict[str, np.ndarray]:
    """Batch-level augmentation for {"images", "boxes", "classes", "mask"}."""
    images = batch["images"].copy()
    boxes = batch["boxes"].copy()
    classes = batch["classes"].copy()
    mask = batch["mask"].copy()
    B = images.shape[0]
    M = boxes.shape[1]
    for i in range(B):
        if B >= 4 and rng.random() < mosaic_prob:
            picks = rng.choice(B, 4, replace=False)
            m = mosaic(images[picks], boxes[picks], classes[picks],
                       mask[picks], rng, M)
            images[i], boxes[i] = m["image"], m["boxes"]
            classes[i], mask[i] = m["classes"], m["mask"]
        if rng.random() < flip_prob:
            images[i], boxes[i] = flip_horizontal(images[i], boxes[i], mask[i])
        if rng.random() < jitter_prob:
            images[i] = amplitude_jitter(images[i], rng)
    return {**batch, "images": images, "boxes": boxes, "classes": classes,
            "mask": mask}
