"""The reference's training recipes as data.

Counterpart of ``pautdx/train/recipes.py``: :class:`Recipe` (lr, decay,
clip, epochs, batch, ``seq_len``, plateau or cosine schedule, early stop,
threshold, parameter groups and objective), ``OBJECTIVES``, the five
``RECIPES``, :class:`SNRCurriculum` (a high-SNR pretraining stage, then
the target tier, each ``Trainer.fit`` with a fresh plateau controller)
and :class:`HybridPhases` (HybridModel's three phases as lr masks, 0
freezing a group).

A masked group trains at lr 0: ``train.optim.ClippedAdamW`` scales the
decay by the group's lr as optax does, so a frozen group's parameters
stay bit-equal. Parameter groups match glob patterns over the port's
dotted names, which mirror the reference's paths.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

from pautdx_torch.losses import (
    detection_loss, detection_position_loss, enhanced_position_loss,
    seq_detector_loss, two_stage_loss,
)


@dataclasses.dataclass(frozen=True)
class Recipe:
    """A named training configuration."""

    name: str
    learning_rate: float = 6e-4
    weight_decay: float = 0.015
    clip_norm: float = 1.0
    epochs: int = 20
    batch_size: int = 8
    seq_len: int = 50
    scheduler: str = "plateau"             # plateau | cosine
    plateau_patience: int = 3
    early_stop_patience: int = 5
    threshold: float = 0.5
    group_lr_mults: Optional[Dict[str, float]] = None
    group_patterns: Optional[Dict[str, Sequence[str]]] = None
    objective: str = "detection"

    def make_objective(self) -> Callable:
        return OBJECTIVES[self.objective]


def _obj_detection(out, batch):
    prob = out["prob"] if isinstance(out, dict) else out
    return detection_loss(prob, batch["labels"], batch.get("sample_mask"))


def _obj_detection_position(out, batch):
    return detection_position_loss(out, batch["labels"], batch["positions"],
                                   batch.get("sample_mask"))


def _obj_two_stage(out, batch):
    return two_stage_loss(out, batch["labels"], batch["positions"],
                          batch.get("sample_mask"))


def _obj_position_only(out, batch):
    return enhanced_position_loss(out["positions"], batch["positions"],
                                  batch["labels"])


def _obj_seq_detector(out, batch):
    return seq_detector_loss(out, batch["labels"].long(), batch["positions"],
                             batch.get("sample_mask"))


OBJECTIVES: Dict[str, Callable] = {
    "detection": _obj_detection,
    "detection_position": _obj_detection_position,
    "two_stage": _obj_two_stage,
    "enhanced_position": _obj_position_only,
    "seq_detector": _obj_seq_detector,
}


RECIPES: Dict[str, Recipe] = {
    # AdamW 6e-4 / wd 0.015, BCE only, 20 epochs
    "detection": Recipe("detection", objective="detection"),
    # BCE + 0.5 masked SmoothL1, the three-output models
    "detection_position": Recipe("detection_position", learning_rate=1e-3,
                                 weight_decay=0.01,
                                 objective="detection_position"),
    # focal L1 + IoU + length + consistency
    "enhanced_position": Recipe("enhanced_position", learning_rate=5e-4,
                                objective="enhanced_position"),
    "two_stage": Recipe("two_stage", learning_rate=1e-3, weight_decay=0.01,
                        objective="two_stage",
                        group_lr_mults={"encoder": 1.0, "default": 3.0},
                        group_patterns={"encoder": ["ms_encoder*"]}),
    # three parameter groups, cosine decay
    "seq_detector": Recipe("seq_detector", learning_rate=5e-4,
                           scheduler="cosine", objective="seq_detector",
                           group_lr_mults={"encoder": 1.0,
                                           "transformer": 2.0,
                                           "default": 3.0},
                           group_patterns={"encoder": ["encoder*"],
                                           "transformer": ["transformer*"]}),
}


@dataclasses.dataclass(frozen=True)
class SNRCurriculum:
    """Pretrain ``pretrain_epochs`` on a high-SNR tier, then train
    ``epochs`` on the target tier, both over one state. ``pretrain`` and
    ``target`` are ``(train_batches_fn, val_batches_fn)`` pairs as
    ``Trainer.fit`` takes them; ``plateau_factory`` builds a fresh
    controller for each stage (a controller carried over would keep the
    easy tier's best loss and cut the lr at once on the hard one)."""

    pretrain_epochs: int = 4
    epochs: int = 20

    def run(self, trainer, state, pretrain, target, *,
            plateau_factory: Optional[Callable] = None,
            log: Callable[[str], None] = print, **fit_kwargs):
        pre_tr, pre_va = pretrain
        tgt_tr, tgt_va = target
        if self.pretrain_epochs > 0:
            log(f"curriculum: {self.pretrain_epochs} high-SNR pretrain "
                f"epochs")
            state = trainer.fit(
                state, pre_tr, pre_va, epochs=self.pretrain_epochs,
                plateau=plateau_factory() if plateau_factory else None,
                log=log, **fit_kwargs)
        return trainer.fit(
            state, tgt_tr, tgt_va, epochs=self.epochs,
            plateau=plateau_factory() if plateau_factory else None,
            log=log, **fit_kwargs)


@dataclasses.dataclass(frozen=True)
class HybridPhases:
    """HybridModel's three phases: detection alone, then the position path
    with detection frozen, then both; each a set of group lr masks (0 =
    frozen) for ``make_optimizer(group_lr_mults=...,
    group_patterns=HybridPhases.group_patterns())``."""

    detection_epochs: int = 8
    position_epochs: int = 8
    joint_epochs: int = 4

    def phase_masks(self) -> Tuple[Dict[str, float], ...]:
        det = {"detection": 1.0, "position": 0.0, "default": 0.0}
        pos = {"detection": 0.0, "position": 1.0, "default": 0.0}
        joint = {"detection": 1.0, "position": 1.0, "default": 1.0}
        return det, pos, joint

    @staticmethod
    def group_patterns() -> Dict[str, Sequence[str]]:
        return {"detection": ["detection*"],
                "position": ["position*"]}
