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

``train-temporal`` (``pautdx/cli.py:560-736``) trains with its own recipe,
kept here beside the harness's: :func:`cli_temporal_model` builds its model
(the trunk's checkpoint config, the ``--tiny`` config or D-FINE-nano),
:func:`cli_temporal_optimizer` its groups and constant rates, and
:func:`train_temporal_epochs` walks every sequence once an epoch, in order.
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
from pautdx_torch.models.vision.dfine import (DFineConfig, config_from_dict,
                                              dfine_nano)
from pautdx_torch.models.vision.hgnet import HGNetConfig
from pautdx_torch.models.vision.temporal_dfine import (
    TemporalDFine, init_heads_from_trunk, temporal_consistency_loss,
    trainable_mask,
)
from pautdx_torch.train.checkpoint import (CheckpointManager,
                                           load_model_state, restore_dfine)
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

# ``train-temporal``'s groups (``pautdx/cli.py:655-671``): these modules
# train as ``temporal``, the class head as ``classifier``, every other
# trainable parameter (the box head among them) as ``trunk``
CLI_TEMPORAL_TOPS = ("temporal_encoder", "temporal_attention",
                     "anomaly_detector", "context_aggregator",
                     "context_projector")
# its constant rates for v3's AdamW (decay 0.01); v1 and v2 train every
# group with Adam at ``--lr`` (``pautdx/cli.py:673-684``)
CLI_V3_LRS = {"trunk": 1e-5, "temporal": 5e-4, "classifier": 1e-4}


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


def temporal_labels(model: TemporalDFine, variant: str,
                    temporal_tops: Optional[Sequence[str]] = None
                    ) -> Dict[str, str]:
    """Each parameter's optimizer group by name: ``frozen`` outside
    ``trainable_mask``, ``classifier`` the class head, else the harness's
    split (``bench_accuracy.py:580-597``: ``trunk`` under the trunk,
    ``temporal`` the rest) or, given ``temporal_tops``, ``temporal`` under
    those modules and ``trunk`` the rest (:data:`CLI_TEMPORAL_TOPS`)."""
    mask = trainable_mask(variant, model)

    def group(name: str) -> str:
        if not mask[name]:
            return "frozen"
        top = name.split(".", 1)[0]
        if top == "class_head":
            return "classifier"
        if temporal_tops is None:
            return "trunk" if top == "trunk" else "temporal"
        return "temporal" if top in temporal_tops else "trunk"

    return {name: group(name) for name in mask}


def _freeze(model: TemporalDFine, labels: Dict[str, str]) -> List[str]:
    """``requires_grad_(False)`` on the frozen parameters; the other
    groups, in name order."""
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    return sorted({g for g in labels.values() if g != "frozen"})


def _patterns(labels: Dict[str, str], groups: Sequence[str]
              ) -> Dict[str, List[str]]:
    return {g: [n for n, lab in labels.items() if lab == g] for g in groups}


def temporal_optimizer(model: TemporalDFine, variant: str,
                       steps: int) -> ClippedAdamW:
    """Freeze ``model``'s frozen parameters (``requires_grad_(False)``) and
    build AdamW over the rest: weight decay 0.01, clip 1.0, each group at
    its peak of :data:`PEAKS` times one ``cosine_schedule(1.0, steps,
    max(5, steps // 10), 1 / 50)`` (optax's ``warmup_cosine_decay_schedule(
    0, peak, ..., peak / 50)``, scaled)."""
    labels = temporal_labels(model, variant)
    _freeze(model, labels)
    peaks = PEAKS[variant]
    spec = make_optimizer(
        1.0, weight_decay=0.01, clip_norm=1.0,
        schedule=cosine_schedule(1.0, steps, max(5, steps // 10), 1 / 50),
        group_lr_mults=peaks, group_patterns=_patterns(labels, peaks))
    return spec.init(model)


def cli_temporal_optimizer(model: TemporalDFine, variant: str,
                           lr: float) -> ClippedAdamW:
    """``train-temporal``'s optimizer: the groups of
    :data:`CLI_TEMPORAL_TOPS`, the frozen ones out of the optimizer and the
    clip (1.0); v3 AdamW at :data:`CLI_V3_LRS` with decay 0.01, v1 and v2
    Adam at ``lr``; constant rates."""
    labels = temporal_labels(model, variant, CLI_TEMPORAL_TOPS)
    groups = _freeze(model, labels)
    lrs = CLI_V3_LRS if variant == "v3" else dict.fromkeys(groups, lr)
    spec = make_optimizer(
        1.0, weight_decay=0.01 if variant == "v3" else 0.0, clip_norm=1.0,
        group_lr_mults={g: lrs[g] for g in groups},
        group_patterns=_patterns(labels, groups))
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


def temporal_trainer(model: TemporalDFine, variant: str,
                     optimizer: ClippedAdamW) -> Tuple[Trainer, TrainState]:
    """``model`` in train mode, the recipe's objective and ``optimizer``
    in a ``Trainer``, and its fresh state."""
    model.train()
    trainer = Trainer(model, temporal_objective(model, variant),
                      optimizer.spec, input_key="images",
                      forward=lambda m, batch: m(batch["images"]))
    return trainer, TrainState(step=0, model=model, optimizer=optimizer)


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
    return temporal_trainer(model, variant,
                            temporal_optimizer(model, variant, steps))


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


def tiny_temporal_config(num_classes: int) -> DFineConfig:
    """``train-temporal --tiny``'s D-FINE (tests and smoke runs)."""
    return DFineConfig(
        num_labels=num_classes, d_model=64, encoder_hidden_dim=64,
        decoder_layers=2, decoder_attention_heads=4,
        encoder_attention_heads=4, decoder_ffn_dim=128,
        encoder_ffn_dim=128, num_queries=20, max_num_bins=16,
        hidden_expansion=0.5,
        backbone=HGNetConfig(
            stem_channels=(3, 8, 8), stage_in_channels=(8, 16, 32, 64),
            stage_mid_channels=(8, 8, 16, 32),
            stage_out_channels=(16, 32, 64, 128),
            stage_num_blocks=(1, 1, 1, 1), stage_num_layers=(1, 1, 2, 2)))


def cli_temporal_model(variant: str, num_classes: int, defect_classes: int,
                       temporal_layers: int, trunk: Optional[str] = None,
                       tiny: bool = False,
                       device: Optional[Union[str, torch.device]] = None,
                       log: Callable[[str], None] = print) -> TemporalDFine:
    """``train-temporal``'s model: the trunk's config from the checkpoint in
    directory ``trunk`` where its metadata has one, else
    :func:`tiny_temporal_config` with ``tiny``, else D-FINE-nano; v2/v3
    re-classify into ``defect_classes`` + 1 no-object column, v1 keeps the
    trunk's labels. The trunk's weights are loaded (without ``trunk`` it
    stays at its seeded init, with a warning), then
    ``init_heads_from_trunk``."""
    dev = resolve_device(device)
    trunk_state, trunk_meta = None, {}
    if trunk:
        trunk_state, trunk_meta = CheckpointManager(trunk).restore("latest")
    if trunk_meta.get("dfine_config"):
        cfg = config_from_dict(trunk_meta["dfine_config"])
    elif tiny:
        cfg = tiny_temporal_config(num_classes)
    else:
        cfg = dfine_nano(num_labels=num_classes)
    model = TemporalDFine(
        cfg, variant=variant,
        num_temporal_labels=None if variant == "v1" else defect_classes + 1,
        num_temporal_layers=temporal_layers,
        temporal_heads=4 if tiny else 8, device=dev)
    if trunk_state is not None:
        load_model_state(model.trunk, trunk_state)
    else:
        log("warning: no --trunk checkpoint given — the frozen trunk "
            "stays randomly initialized; the temporal encoder would "
            "train on noise features (smoke runs only)")
    init_heads_from_trunk(model)
    return model


def train_temporal_epochs(model: TemporalDFine, variant: str,
                          chunks: Sequence[DetectionFrames], epochs: int,
                          lr: float,
                          on_epoch: Callable[[int, TrainState, List[float]],
                                             None],
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Tuple[Trainer, TrainState]:
    """``train-temporal``'s loop: :func:`cli_temporal_optimizer`, the
    sequences held on ``device`` (:func:`stack_chunks`), each trained on
    once an epoch in order; ``on_epoch(epoch, state, losses)`` after each
    epoch with its steps' total losses."""
    dev = resolve_device(device)
    trainer, state = temporal_trainer(
        model, variant, cli_temporal_optimizer(model, variant, lr))
    data = stack_chunks(chunks, dev)
    for epoch in range(epochs):
        losses = [trainer.train_step(state, {k: v[i]
                                             for k, v in data.items()})
                  ["total"] for i in range(len(chunks))]
        on_epoch(epoch, state, losses)
    return trainer, state
