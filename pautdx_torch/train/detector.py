"""The D-FINE training entry points.

Counterpart of the D-FINE branch of ``pautdx/cli.py:168-247``
(``train-detector --detector dfine``): :func:`train_bscan_detector` reads a
directory of PAUT volumes (``.json`` files and txt-tree folders), renders
them to B-scan frames on the card, batches them on a host thread and
trains D-FINE-nano through the ``Trainer`` with per-epoch checkpoints.
The ``train-detector`` subcommand itself waits for the CLI (ROADMAP.md,
queue 1, item 15). Batches follow the ``data/vision.py::batch_frames``
schema:

- ``images``: (B, S, S, 3) float32 frames in [0, 1];
- ``boxes``: (B, M, 4) xyxy in pixels;
- ``classes``: (B, M) int32;
- ``mask``: (B, M) float32, 1 for a real box.

:func:`make_train_batches` makes such batches from a seed, for smoke runs
and measurements.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

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
from pautdx_torch.models.vision.dfine import (DFine, DFineConfig,
                                              config_to_dict, dfine_nano)
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


def train_bscan_detector(data_dir: str, size: int = 640,
                         batch_size: int = 16, epochs: int = 1,
                         lr: float = LR, max_boxes: int = MAX_BOXES,
                         augment: bool = False, out: Optional[str] = None,
                         detector: str = "dfine",
                         ema_decay: Optional[float] = None,
                         num_denoising: int = 0,
                         device: Optional[Union[str, torch.device]] = None,
                         log: Callable[[str], None] = print
                         ) -> Tuple[Trainer, TrainState]:
    """``train-detector --detector dfine`` (``cli.py:168-247``) on
    ``device`` (default ``"cuda"``): the volumes of ``data_dir`` rendered
    to frames, split, shuffled by ``default_rng(0)`` each epoch and cut
    into full batches on a host thread (augmented where ``augment``), then
    ``DFine(dfine_nano(NUM_CLASSES))`` trained at ``lr`` with seeded
    weights; with ``out``, a checkpoint with ``dfine_metadata`` after every
    epoch. ``ema_decay`` keeps the EMA of the parameters; ``num_denoising``
    > 0 adds contrastive denoising groups of that many queries (rounded to
    whole groups of 2 * ``max_boxes``), drawn from a generator seeded with
    0. Returns the trainer and its state."""
    if detector != "dfine":
        raise NotImplementedError(
            f"train_bscan_detector(detector={detector!r}): only 'dfine' is "
            f"ported; the YOLO loss (losses/yolo.py) waits for ROADMAP.md, "
            f"queue 1, item 10")
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
            yield batch

    cfg = dfine_nano(num_labels=NUM_CLASSES)
    forward = None
    if num_denoising > 0:
        gen = torch.Generator(device=dev).manual_seed(0)
        forward = denoising_forward(size, cfg, num_denoising, gen)
    trainer = Trainer(DFine(cfg, device=dev),
                      dfine_objective(size, cfg), make_optimizer(lr),
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
            trainer.ckpt.save(epoch, state.state_dict(),
                              metadata=dfine_metadata(cfg, size),
                              history={k: [v] for k, v in metrics.items()},
                              is_best=True)
    return trainer, state
