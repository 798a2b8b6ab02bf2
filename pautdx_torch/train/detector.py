"""The D-FINE training entry point.

Counterpart of the D-FINE branch of ``pautdx/cli.py:205-247``
(``train-detector --detector dfine``) without its volume loading (the
volume-to-frames pipeline and the CLI are ROADMAP queue 1, items 12 and
15): the objective, the trainer and the checkpoint metadata, over batches
in the ``data/vision.py::batch_frames`` schema:

- ``images``: (B, S, S, 3) float32 frames in [0, 1];
- ``boxes``: (B, M, 4) xyxy in pixels;
- ``classes``: (B, M) int32;
- ``mask``: (B, M) float32, 1 for a real box.

:func:`make_train_batches` makes such batches from a seed, for smoke runs
and measurements.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from pautdx_torch.losses.detr import dfine_criterion
from pautdx_torch.models.vision.dfine import (DFine, DFineConfig,
                                              config_to_dict, dfine_nano)
from pautdx_torch.train.optim import make_optimizer
from pautdx_torch.train.trainer import Trainer


def dfine_objective(size: int, cfg: DFineConfig) -> Callable:
    """``cli.py:212-221``: pixel xyxy boxes -> normalized cxcywh, then the
    D-FINE criterion."""

    def objective(out, batch):
        boxes = batch["boxes"] / size
        cx = (boxes[..., 0] + boxes[..., 2]) / 2
        cy = (boxes[..., 1] + boxes[..., 3]) / 2
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        cxcywh = torch.stack([cx, cy, w, h], -1)
        return dfine_criterion(out, cxcywh, batch["classes"], batch["mask"],
                               cfg.num_labels, cfg.max_num_bins)

    return objective


# the CLI's defaults: --num-classes, --lr, --max-boxes
NUM_CLASSES = 2
LR = 1e-3
MAX_BOXES = 8


def dfine_metadata(cfg: DFineConfig, size: int) -> Dict:
    """The checkpoint metadata of ``cli.py:239-244`` for a D-FINE run (with
    the CLI's ``--scale``/``--flavour`` defaults, which D-FINE ignores)."""
    return {"detector": "dfine", "num_classes": cfg.num_labels,
            "size": size, "scale": "n", "flavour": "v8",
            "dfine_config": config_to_dict(cfg)}


def build_dfine_trainer(size: int = 640,
                        checkpoint_dir: Optional[str] = None,
                        device: Optional[Union[str, torch.device]] = None,
                        seed: int = 0) -> Trainer:
    """``Trainer(DFine(dfine_nano(NUM_CLASSES)), objective,
    make_optimizer(LR), checkpoint_dir=..., input_key="images")`` with
    seeded weights on ``device`` (default ``"cuda"``), f32."""
    cfg = dfine_nano(num_labels=NUM_CLASSES)
    model = DFine(cfg, device=device, seed=seed)
    return Trainer(model, dfine_objective(size, cfg), make_optimizer(LR),
                   checkpoint_dir=checkpoint_dir, input_key="images")


def make_train_batches(n: int, batch: int, size: int = 640, seed: int = 0
                       ) -> List[Dict[str, np.ndarray]]:
    """``n`` seeded batches in the ``batch_frames`` schema: frames in
    [0, 1], noise in [0, 0.5) with each box's window raised by 0.5 (so the
    boxes mark something), clipped at 1; 1 to ``MAX_BOXES`` valid boxes per
    frame with sides of 5-40 % of the frame, one of two classes, padding
    rows zero."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.uniform(0.0, 0.5, (batch, size, size, 3)).astype(
            np.float32)
        boxes = np.zeros((batch, MAX_BOXES, 4), np.float32)
        classes = np.zeros((batch, MAX_BOXES), np.int32)
        mask = np.zeros((batch, MAX_BOXES), np.float32)
        for b in range(batch):
            k = int(rng.integers(1, MAX_BOXES + 1))
            wh = rng.uniform(0.05, 0.4, (k, 2)) * size
            xy = rng.uniform(0.0, 1.0, (k, 2)) * (size - wh)
            boxes[b, :k] = np.concatenate([xy, xy + wh], -1)
            classes[b, :k] = rng.integers(0, 2, k)
            mask[b, :k] = 1.0
            for x0, y0, x1, y1 in boxes[b, :k].astype(int):
                images[b, y0:y1, x0:x1] += 0.5
        np.minimum(images, 1.0, out=images)
        out.append({"images": images, "boxes": boxes, "classes": classes,
                    "mask": mask})
    return out
