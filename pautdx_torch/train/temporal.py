"""Temporal D-FINE training: the per-variant recipe over 50-frame sequences.

Counterpart of the temporal arm's training in ``tools/bench_accuracy.py``
(``make_temporal_dataset`` and ``train_temporal``, ``:467-676``), with the
trunk restored as ``train-temporal --trunk`` restores it
(``pautdx/cli.py:562-736``): from a D-FINE checkpoint whose metadata holds
its config (``train/checkpoint.restore_dfine``).

- Data: :func:`make_temporal_dataset`, the harness's volumes with
  flickering defect echoes, rendered on the card and cut into sequences.
- Trainable sets: ``models/vision/temporal_dfine.trainable_mask``; the
  frozen parameters take ``requires_grad_(False)`` and stay out of the
  optimizer, so they take no weight decay (``optax.set_to_zero`` gives
  them none; ``torch.optim.AdamW`` would decay them at zero gradient) and
  no part of the clip norm (the reference zeroes their gradients before
  the clip for that reason). v1 and v2 freeze the whole trunk, whose
  forward then builds no graph; v3 trains the trunk's encoder and decoder,
  so its step runs the bilinear decoder's weighted gather backward at
  batch T.
- Optimizer (:func:`temporal_optimizer`): AdamW, weight decay 0.01, clip
  1.0, one peak per group (:data:`PEAKS`) on one warmup-cosine schedule.
- Objective (:func:`temporal_objective`): the D-FINE criterion on the
  final logits and boxes alone, plus 0.1 x the anomaly consistency for v3.
- :func:`train_temporal`: one sequence a step, drawn by
  ``default_rng(3)``, through the ``Trainer``'s guarded step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pautdx_torch.data import synthetic
from pautdx_torch.data.synthetic import CLASS_MAP
from pautdx_torch.data.vision import (DetectionFrames,
                                      detection_frames_from_volume,
                                      sequence_chunks)
from pautdx_torch.data.volume import parse_json_volume
from pautdx_torch.device import resolve_device
from pautdx_torch.losses.detr import dfine_criterion
from pautdx_torch.models.vision.temporal_dfine import (
    TemporalDFine, init_heads_from_trunk, temporal_consistency_loss,
    trainable_mask,
)
from pautdx_torch.train.checkpoint import restore_dfine
from pautdx_torch.train.detector import MAX_BOXES, normalized_boxes
from pautdx_torch.train.optim import (ClippedAdamW, cosine_schedule,
                                      make_optimizer)
from pautdx_torch.train.trainer import Trainer, TrainState

SEQ_LEN = 50
CONSISTENCY_WEIGHT = 0.1

# each variant's peak learning rate per group: v3 the reference's three
# groups (``temp_dfine_over_improved.py:389-410``), v2 a fast group for its
# fresh classifier, v1 one group over its trainable set
PEAKS = {"v1": {"temporal": 2e-4},
         "v2": {"temporal": 5e-4, "classifier": 1e-3},
         "v3": {"trunk": 1e-5, "temporal": 5e-4, "classifier": 1e-4}}


def make_temporal_dataset(seeds: Sequence[int], n_scans: int = 60,
                          rng_seed: int = 0, flicker: float = 0.65,
                          size: int = 640, seq_len: int = SEQ_LEN,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> List[DetectionFrames]:
    """Per-volume ``seq_len``-frame sequences with defect-echo flicker, the
    harness's draws from ``default_rng(rng_seed)``: 6-8 beams, noise in
    [0.04, 0.10), 1-3 defects persisting over 15-40 scans with amplitudes
    in [0.35, 0.8), each echo faded per frame by ``flicker``; frames
    rendered on ``device`` (default ``"cuda"``) at ``size`` px with up to
    8 boxes, cut into tail-re-anchored windows that hold a box."""
    rng = np.random.default_rng(rng_seed)
    chunks: List[DetectionFrames] = []
    for s in seeds:
        n_beams = int(rng.integers(6, 9))
        spec = synthetic.VolumeSpec(
            n_beams=n_beams, n_scans=n_scans, n_samples=320,
            noise=float(rng.uniform(0.04, 0.10)),
            amplitude_flicker=flicker, seed=int(s))
        defects = []
        for _ in range(int(rng.integers(1, 4))):
            b0 = int(rng.integers(0, n_beams - 2))
            b1 = int(rng.integers(b0 + 1, n_beams))
            s0 = int(rng.integers(0, max(1, n_scans - 20)))
            s1 = int(rng.integers(min(s0 + 15, n_scans - 1),
                                  min(s0 + 40, n_scans)))
            d0 = float(rng.uniform(0.15, 0.6))
            d1 = float(d0 + rng.uniform(0.08, 0.25))
            label = "Delamination" if rng.random() < 0.5 else "FO"
            defects.append(synthetic.SyntheticDefect(
                b0, b1, s0, s1, d0, min(d1, 0.85), label=label,
                amplitude=float(rng.uniform(0.35, 0.8))))
        vol_arr, _ = synthetic.generate_volume(spec, defects)
        vol = parse_json_volume(synthetic.volume_to_json_dict(vol_arr,
                                                              defects))
        frames = detection_frames_from_volume(
            vol, out_size=size, max_boxes=MAX_BOXES, class_map=CLASS_MAP,
            device=device)
        chunks.extend(sequence_chunks(frames, seq_len=seq_len))
    return chunks


def stack_chunks(chunks: Sequence[DetectionFrames],
                 device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """Sequences on ``device``: {"images" (S, T, H, W, 3) f32, "boxes"
    (S, T, M, 4) normalized cxcywh, "classes" (S, T, M), "mask"
    (S, T, M)}."""
    size = chunks[0].images.shape[2]
    out = {k: torch.from_numpy(np.stack([getattr(c, k) for c in chunks]))
           .to(device) for k in ("images", "boxes", "classes", "mask")}
    out["boxes"] = normalized_boxes(out["boxes"], size)
    return out


def temporal_labels(model: TemporalDFine, variant: str) -> Dict[str, str]:
    """Each parameter's optimizer group by name (``bench_accuracy.py:
    580-597``): ``frozen`` outside ``trainable_mask``, else ``trunk``,
    ``classifier`` (the class head) or ``temporal``."""
    mask = trainable_mask(variant, model)

    def group(name: str) -> str:
        if not mask[name]:
            return "frozen"
        top = name.split(".", 1)[0]
        if top == "trunk":
            return "trunk"
        if top == "class_head":
            return "classifier"
        return "temporal"

    return {name: group(name) for name in mask}


def temporal_optimizer(model: TemporalDFine, variant: str,
                       steps: int) -> ClippedAdamW:
    """Freeze ``model``'s frozen parameters (``requires_grad_(False)``) and
    build AdamW over the rest: weight decay 0.01, clip 1.0, each group at
    its peak of :data:`PEAKS` times one ``cosine_schedule(1.0, steps,
    max(5, steps // 10), 1 / 50)`` (optax's ``warmup_cosine_decay_schedule(
    0, peak, ..., peak / 50)``, scaled)."""
    labels = temporal_labels(model, variant)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    peaks = PEAKS[variant]
    spec = make_optimizer(
        1.0, weight_decay=0.01, clip_norm=1.0,
        schedule=cosine_schedule(1.0, steps, max(5, steps // 10), 1 / 50),
        group_lr_mults=peaks,
        group_patterns={g: [n for n, lab in labels.items() if lab == g]
                        for g in peaks})
    return spec.init(model)


def temporal_objective(model: TemporalDFine, variant: str) -> Callable:
    """``objective(out, batch)``: the D-FINE criterion on the final
    ``logits`` and ``pred_boxes`` alone (no auxiliary heads, no corners)
    against the sequence's normalized cxcywh boxes, plus
    ``CONSISTENCY_WEIGHT`` x :func:`temporal_consistency_loss` for v3."""

    def objective(out, batch):
        head_out = {"intermediate_logits": [out["logits"]],
                    "intermediate_boxes": [out["pred_boxes"]],
                    "intermediate_corners": [], "initial_references": []}
        loss, aux = dfine_criterion(head_out, batch["boxes"],
                                    batch["classes"], batch["mask"],
                                    model.head_labels,
                                    model.cfg.max_num_bins)
        if variant == "v3":
            consistency = temporal_consistency_loss(out["anomaly"])
            loss = loss + CONSISTENCY_WEIGHT * consistency
            aux = {**aux, "consistency": consistency, "total": loss}
        return loss, aux

    return objective


def build_temporal_trainer(variant: str, trunk: str, steps: int,
                           device: Optional[Union[str, torch.device]] = None,
                           seed: int = 0) -> Tuple[Trainer, TrainState]:
    """The temporal model of ``variant`` over the D-FINE checkpoint in
    directory ``trunk`` (its config from the checkpoint's metadata, its
    weights loaded into ``model.trunk``), seeded heads, then
    ``init_heads_from_trunk``; in train mode, with the recipe's optimizer
    and objective in a ``Trainer`` and its fresh state."""
    dev = resolve_device(device)
    restored, _, _ = restore_dfine(trunk, device=dev)
    cfg = restored.cfg
    model = TemporalDFine(cfg, variant=variant,
                          num_temporal_labels=(None if variant == "v1"
                                               else cfg.num_labels + 1),
                          device=dev, seed=seed)
    model.trunk.load_state_dict(restored.state_dict())
    init_heads_from_trunk(model)
    model.train()
    optimizer = temporal_optimizer(model, variant, steps)
    trainer = Trainer(model, temporal_objective(model, variant),
                      optimizer.spec, input_key="images",
                      forward=lambda m, batch: m(batch["images"]))
    state = TrainState(step=0, model=model, optimizer=optimizer)
    return trainer, state


def train_temporal(variant: str, trunk: str,
                   chunks: Sequence[DetectionFrames], steps: int,
                   device: Optional[Union[str, torch.device]] = None,
                   log_every: int = 50, log: Callable[[str], None] = print
                   ) -> Tuple[Trainer, TrainState, List[Dict[str, float]]]:
    """``steps`` steps of ``variant`` over the trunk checkpoint in directory
    ``trunk`` (:func:`build_temporal_trainer`), on ``device`` (default
    ``"cuda"``), one of ``chunks`` a step, drawn by ``default_rng(3)`` from
    the sequences held on the device. Returns the trainer, its state and
    each step's row (the objective's aux, ``grad_norm``,
    ``update_was_finite``)."""
    dev = resolve_device(device)
    trainer, state = build_temporal_trainer(variant, trunk, steps, dev)
    data = stack_chunks(chunks, dev)
    rng = np.random.default_rng(3)
    rows = []
    for i in range(steps):
        si = int(rng.integers(0, len(chunks)))
        row = trainer.train_step(state, {k: v[si] for k, v in data.items()})
        rows.append(row)
        if i % log_every == 0 or i == steps - 1:
            log(f"    [{variant}] step {i:4d} loss {row['total']:8.3f}")
    return trainer, state, rows
