"""The B-scan detector training entry points, D-FINE and YOLO.

Counterpart of ``pautdx/cli.py:168-247`` (``train-bscan``, both
``--detector`` branches): :func:`train_bscan_detector` reads a directory of
PAUT volumes (``.json`` files and txt-tree folders), renders them to B-scan
frames on the card, batches them on a host thread and trains D-FINE-nano
or a YOLO (``YoloConfig(num_classes, scale, flavour)``, the CLI's) through
the ``Trainer`` with per-epoch checkpoints; ``python -m pautdx_torch.cli
train-bscan`` runs it. Batches follow
the ``data/vision.py::batch_frames`` schema:

- ``images``: (B, S, S, 3) float32 frames in [0, 1];
- ``boxes``: (B, M, 4) xyxy in pixels;
- ``classes``: (B, M) int32;
- ``mask``: (B, M) float32, 1 for a real box;
- ``gt_masks`` (YOLO-seg only): (B, M, S/4, S/4) float32, each box filled
  at proto resolution by ``data/annotations.rasterize_boxes``
  (:func:`add_box_masks`).

:func:`make_train_batches` makes such batches from a seed, for smoke runs
and measurements.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pautdx_torch.data.annotations import rasterize_boxes
from pautdx_torch.data.augment_vision import augment_detection_batch
from pautdx_torch.data.prefetch import ThreadedHostLoader
from pautdx_torch.data.vision import (batch_frames,
                                      detection_frames_from_volume,
                                      split_frames)
from pautdx_torch.data.volume import parse_json_volume, parse_txt_tree
from pautdx_torch.device import resolve_device
from pautdx_torch.losses.denoising import (denoising_loss,
                                           make_denoising_queries)
from pautdx_torch.losses.detr import dfine_criterion
from pautdx_torch.losses.yolo import yolo_loss
from pautdx_torch.models.vision.dfine import (DFine, DFineConfig,
                                              config_to_dict, dfine_nano)
from pautdx_torch.models.vision.yolo import YOLO, YoloConfig
from pautdx_torch.train.optim import make_optimizer
from pautdx_torch.train.trainer import Trainer, TrainState


def normalized_boxes(boxes: torch.Tensor, size: int) -> torch.Tensor:
    """Pixel xyxy boxes of a ``size`` frame -> normalized cxcywh."""
    boxes = boxes / size
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([cx, cy, w, h], -1)


def dfine_objective(size: int, cfg: DFineConfig) -> Callable:
    """``cli.py:212-221``: pixel xyxy boxes -> normalized cxcywh, then the
    D-FINE criterion; with a denoising group in the output (see
    :func:`denoising_forward`), plus ``denoising_loss`` of every head's
    denoising slots (aux ``dn``)."""

    def objective(out, batch):
        cxcywh = normalized_boxes(batch["boxes"], size)
        loss, aux = dfine_criterion(out, cxcywh, batch["classes"],
                                    batch["mask"], cfg.num_labels,
                                    cfg.max_num_bins)
        if "dn_logits" in out:
            dn = sum(denoising_loss(lg, bx, out["denoising"], cxcywh,
                                    batch["classes"])[0]
                     for lg, bx in zip(out["dn_logits"], out["dn_boxes"]))
            loss = loss + dn
            aux = {**aux, "dn": dn, "total": loss}
        return loss, aux

    return objective


def denoising_forward(size: int, cfg: DFineConfig, num_denoising: int,
                      gen: torch.Generator) -> Callable:
    """The ``Trainer``'s training forward with a contrastive denoising
    group: ``forward(model, batch)`` draws the group from ``gen`` and the
    batch's boxes, runs the model with it and returns the output with the
    group under ``"denoising"``, which :func:`dfine_objective` reads."""

    # the decoder's matching queries: the top num_queries of the anchors,
    # or every anchor where a small frame has fewer
    queries = min(cfg.num_queries,
                  sum((size // s) ** 2 for s in cfg.feat_strides))

    def forward(model, batch):
        dn = make_denoising_queries(
            gen, normalized_boxes(batch["boxes"], size), batch["classes"],
            batch["mask"], cfg.num_labels, queries, num_denoising)
        out = model(batch["images"], train=True, denoising=dn)
        return {**out, "denoising": dn}

    return forward


def yolo_objective(size: int, cfg: YoloConfig) -> Callable:
    """``cli.py:199-201``: ``yolo_loss`` on the pixel boxes of a ``size``
    frame; with ``cfg.seg``, plus the mask BCE against the batch's
    ``gt_masks``. The aux adds the loss as ``total``."""

    def objective(out, batch):
        loss, aux = yolo_loss(
            out, batch["boxes"], batch["classes"], batch["mask"], cfg,
            (size, size),
            gt_masks=batch.get("gt_masks") if cfg.seg else None)
        return loss, {**aux, "total": loss}

    return objective


PROTO_STRIDE = 4      # YOLO-seg's protos lie at a quarter of the frame


def add_box_masks(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``batch`` with ``gt_masks`` (B, M, S/4, S/4): each valid box filled
    with 1 at proto resolution by ``rasterize_boxes``, padding rows 0."""
    B, M = batch["mask"].shape
    side = batch["images"].shape[1] // PROTO_STRIDE
    masks = np.zeros((B, M, side, side), np.float32)
    for b, m in zip(*np.nonzero(batch["mask"] > 0)):
        masks[b, m] = rasterize_boxes(batch["boxes"][b, m] / PROTO_STRIDE,
                                      (side, side), value=1.0)
    return {**batch, "gt_masks": masks}


# the CLI's defaults: --num-classes, --lr, --max-boxes, --scale, --flavour
NUM_CLASSES = 2
LR = 1e-3
MAX_BOXES = 8
SCALE = "n"
FLAVOUR = "v8"


def dfine_metadata(cfg: DFineConfig, size: int, scale: str = SCALE,
                   flavour: str = FLAVOUR) -> Dict:
    """The checkpoint metadata of ``cli.py:239-244`` for a D-FINE run (with
    the CLI's ``--scale``/``--flavour``, which D-FINE ignores)."""
    return {"detector": "dfine", "num_classes": cfg.num_labels,
            "size": size, "scale": scale, "flavour": flavour,
            "dfine_config": config_to_dict(cfg)}


def yolo_metadata(cfg: YoloConfig, size: int) -> Dict:
    """The checkpoint metadata of ``cli.py:239-241`` for a YOLO run, and
    ``"seg": True`` for a seg model, which the CLI does not train."""
    meta = {"detector": "yolo", "num_classes": cfg.num_classes,
            "size": size, "scale": cfg.scale, "flavour": cfg.flavour}
    if cfg.seg:
        meta["seg"] = True
    return meta


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


def train_bscan_detector(data_dir: str, size: int = 640,
                         batch_size: int = 16, epochs: int = 1,
                         lr: float = LR, max_boxes: int = MAX_BOXES,
                         augment: bool = False, out: Optional[str] = None,
                         detector: str = "dfine", scale: str = SCALE,
                         flavour: str = FLAVOUR, seg: bool = False,
                         num_classes: int = NUM_CLASSES,
                         ema_decay: Optional[float] = None,
                         num_denoising: int = 0,
                         device: Optional[Union[str, torch.device]] = None,
                         log: Callable[[str], None] = print
                         ) -> Tuple[Trainer, TrainState]:
    """``train-bscan`` (``cli.py:168-247``) on ``device`` (default
    ``"cuda"``): the volumes of ``data_dir`` rendered to frames, split,
    shuffled by ``default_rng(0)`` each epoch and cut into full batches on
    a host thread (augmented where ``augment``), then trained at ``lr``
    with seeded weights; with ``out``, a checkpoint with the run's metadata
    after every epoch. ``ema_decay`` keeps the EMA of the parameters.

    ``detector="dfine"``: ``DFine(dfine_nano(num_classes))``;
    ``num_denoising`` > 0 adds contrastive denoising groups of that many
    queries (rounded to whole groups of 2 * ``max_boxes``), drawn from a
    generator seeded with 0. ``detector="yolo"``:
    ``YOLO(YoloConfig(num_classes, scale, flavour))`` under ``yolo_loss``;
    ``seg`` trains the seg model on box masks (:func:`add_box_masks`), a
    run the CLI has no flag for. Returns the trainer and its state."""
    if detector not in ("dfine", "yolo"):
        raise ValueError(f"train_bscan_detector: detector {detector!r}, "
                         f"want 'dfine' or 'yolo'")
    if detector == "yolo" and num_denoising > 0:
        raise ValueError("train_bscan_detector: denoising groups are "
                         "D-FINE's; YOLO trains without them")
    if seg and detector != "yolo":
        raise ValueError("train_bscan_detector: seg is a YOLO option")
    dev = resolve_device(device)
    frames_list = []
    for entry in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, entry)
        if entry.endswith(".json"):
            vol = parse_json_volume(path)
        elif os.path.isdir(path):
            vol = parse_txt_tree(data_dir, entry)
        else:
            continue
        frames_list.extend(split_frames(detection_frames_from_volume(
            vol, out_size=size, max_boxes=max_boxes, device=dev)))
    log(f"{len(frames_list)} frames")
    if len(frames_list) < batch_size:
        raise ValueError(f"{len(frames_list)} frames in {data_dir}: fewer "
                         f"than one batch of {batch_size}")
    rng = np.random.default_rng(0)

    def batches():
        order = rng.permutation(len(frames_list))
        for i in range(len(frames_list) // batch_size):
            batch = batch_frames(
                frames_list, order[i * batch_size:(i + 1) * batch_size])
            if augment:
                batch = augment_detection_batch(batch, rng)
            yield add_box_masks(batch) if seg else batch

    forward = None
    if detector == "yolo":
        cfg = YoloConfig(num_classes=num_classes, scale=scale,
                         flavour=flavour, seg=seg)
        model, objective = YOLO(cfg, device=dev), yolo_objective(size, cfg)
        metadata = yolo_metadata(cfg, size)
    else:
        cfg = dfine_nano(num_labels=num_classes)
        model, objective = DFine(cfg, device=dev), dfine_objective(size, cfg)
        metadata = dfine_metadata(cfg, size, scale, flavour)
        if num_denoising > 0:
            gen = torch.Generator(device=dev).manual_seed(0)
            forward = denoising_forward(size, cfg, num_denoising, gen)
    trainer = Trainer(model, objective, make_optimizer(lr),
                      checkpoint_dir=out, ema_decay=ema_decay,
                      input_key="images", forward=forward)
    # the reference draws its init batch from the epoch stream: one
    # permutation of the generator, kept so that the epochs' orders match
    state = trainer.init(next(iter(batches())))
    for epoch in range(epochs):
        state, metrics = trainer.train_epoch(
            state, ThreadedHostLoader(batches()))
        log(f"[epoch {epoch}] " + " ".join(
            f"{k}={v:.4f}" for k, v in metrics.items()))
        if trainer.ckpt is not None:
            trainer.ckpt.save(epoch, state.state_dict(), metadata=metadata,
                              history={k: [v] for k, v in metrics.items()},
                              is_best=True)
    return trainer, state
