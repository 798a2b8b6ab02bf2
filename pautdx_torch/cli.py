"""pautdx_torch command-line interface: ``python -m pautdx_torch.cli``.

Counterpart of ``pautdx/cli.py``: the same eleven subcommands with the
same flags and defaults, over the port's own modules, plus ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain PyTorch
versions). On ``cuda`` without a card every subcommand but ``explain``
raises; a kernel that fails to build or launch fails the command.

- ``build-dataset``   raw txt-tree / JSON volumes -> rendered B-scans +
                      annotations.json (+ optional YOLO export)
- ``train-signal``    train a signal-zoo model with a named recipe
- ``eval-signal``     checkpoint -> metrics artifacts
- ``predict-signal``  JSON volumes -> predictions.json + optional heatmaps
- ``train-bscan``     train a B-scan detector (D-FINE or YOLO)
- ``predict-bscan``   B-scan detections of every volume, detections.json
- ``inspect``         self-contained HTML inspector (B-scans or signals)
- ``explain``         animated HTML explainers of the pipeline
- ``export``          a trained signal model as a ``torch.export`` ``.pt2``
- ``train-temporal``  train a temporal D-FINE over B-scan sequences
- ``bridge``          stdin/stdout JSON serving of a signal model

Where the port differs from the reference on purpose:

- ``predict-bscan --prepatch`` takes the patch size from the stem's
  config (``HGNetConfig.stem_patch``), and rearranges the frames on the
  card, where they were rendered; the reference hardcodes the size and
  sends every batch through host numpy.
- ``train-signal`` trains with the recipe's parameter groups and cosine
  decay (``train.signal.recipe_optimizer``); the reference's drops both.
- ``bridge`` loads its checkpoint once and answers every request on stdin
  (one JSON line an answer); the reference reloads the checkpoint for its
  one request.
- ``train-temporal`` draws dropout from the trainer's generator, seeded
  per step; the reference uses one dropout key at every step.
- ``export --polymorphic`` traces at a batch of at least 2: a trace at 1
  would fix the batch to 1 (``serve/export.py``).
- Without ``--checkpoint`` the detectors start from the port's seeded
  init, not the reference's ``PRNGKey(0)`` values.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from pautdx_torch.device import resolve_device

FLAVOURS = ("v8", "v5", "v9c", "v11")


def _iter_volumes(data_dir: str) -> Iterator[Tuple[str, object]]:
    """(sequence name, ParsedVolume) of every JSON volume and txt tree
    under ``data_dir``, in name order."""
    from pautdx_torch.data.volume import parse_json_volume, parse_txt_tree

    for entry in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, entry)
        if entry.endswith(".json"):
            yield entry[:-5], parse_json_volume(path)
        elif os.path.isdir(path):
            yield entry, parse_txt_tree(data_dir, entry)


# ------------------------------------------------------------ build-dataset


def _cmd_build_dataset(args) -> None:
    from pautdx_torch.data.annotations import (
        prepare_yolo_split, save_annotations, write_yolo_dataset,
    )
    from pautdx_torch.data.bscan import render_volume_dataset

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    annotations, images = {}, {}
    for seq, vol in _iter_volumes(args.data):
        imgs, ann = render_volume_dataset(vol, args.size, args.size,
                                          device=dev)
        annotations[seq] = ann
        seq_dir = os.path.join(args.out, seq)
        os.makedirs(seq_dir, exist_ok=True)
        for t in range(imgs.shape[0]):
            np.save(os.path.join(seq_dir, f"{t}.npy"), imgs[t])
            images[f"{seq}/{t}.png"] = imgs[t]
    save_annotations(os.path.join(args.out, "annotations.json"), annotations)
    print(f"wrote {len(annotations)} sequences to {args.out}")
    if args.yolo:
        examples = prepare_yolo_split(annotations, (args.size, args.size),
                                      keep_empty_fraction=args.keep_empty)
        yaml = write_yolo_dataset(examples, images,
                                  os.path.join(args.out, "yolo"))
        print(f"YOLO dataset: {yaml}")


# ------------------------------------------------------------ signals


def _cmd_train_signal(args) -> None:
    from pautdx_torch.train.signal import train_signal
    from pautdx_torch.viz import plot_training_history

    trainer, _ = train_signal(
        args.data, args.out, model=args.model, recipe=args.recipe,
        epochs=args.epochs, batch_size=args.batch_size,
        seq_len=args.seq_len, defect_focused=args.defect_focused,
        signal_length=None, dp=args.dp, device=args.device)
    plot_training_history(trainer.history,
                          os.path.join(args.out, "history.png"))
    print(f"checkpoints + history in {args.out}")


def _signal_endpoint(ckpt_dir: str, device, threshold: float = 0.5):
    """(endpoint, metadata) of a ``train-signal`` checkpoint: its best
    epoch, else its latest, loaded once on ``device``."""
    from pautdx_torch.serve.endpoints import SignalEndpoint
    from pautdx_torch.train.signal import restore_signal_model

    model, meta = restore_signal_model(ckpt_dir, device=device)
    return SignalEndpoint(model, threshold=threshold, device=device), meta


def _cmd_eval_signal(args) -> None:
    from pautdx_torch.data.datasets import load_json_dir
    from pautdx_torch.eval.report import SignalEvaluator

    endpoint, meta = _signal_endpoint(args.checkpoint, args.device)
    ds = load_json_dir(args.data, seq_len=meta.get("seq_len", 50))
    report = SignalEvaluator(endpoint.predict, threshold=args.threshold).run(
        ds, out_dir=args.out)
    print(json.dumps(report, indent=1))


def _cmd_predict_signal(args) -> None:
    from pautdx_torch.data.volume import parse_json_volume
    from pautdx_torch.eval.report import prediction_map

    endpoint, meta = _signal_endpoint(args.checkpoint, args.device)
    os.makedirs(args.out, exist_ok=True)
    results = {}
    for fn in sorted(os.listdir(args.data)):
        if not fn.endswith(".json"):
            continue
        vol = parse_json_volume(os.path.join(args.data, fn))
        heat = prediction_map(endpoint.predict, vol, meta.get("seq_len", 50))
        results[fn] = {"beams": vol.beam_keys,
                       "probabilities": np.nan_to_num(heat).tolist()}
        if args.heatmaps:
            from pautdx_torch.viz import plot_prediction_heatmap
            plot_prediction_heatmap(
                heat, os.path.join(args.out, fn.replace(".json", ".png")))
    with open(os.path.join(args.out, "predictions.json"), "w") as f:
        json.dump(results, f)
    print(f"predictions for {len(results)} volumes in {args.out}")


def _cmd_export(args) -> None:
    from pautdx_torch.serve.export import export_signal_model
    from pautdx_torch.train.signal import restore_signal_model

    model, _ = restore_signal_model(args.checkpoint, device=args.device)
    batch = max(args.batch, 2) if args.polymorphic else args.batch
    export_signal_model(model, (batch, args.num_signals, args.signal_length),
                        args.out, polymorphic_batch=args.polymorphic,
                        device=args.device)
    print(f"torch.export artifact: {args.out}")


def _cmd_bridge(args) -> None:
    from pautdx_torch.serve.bridge import serve_signals

    endpoint, meta = _signal_endpoint(args.checkpoint, args.device,
                                      args.threshold)
    print(f"bridge: loaded {args.checkpoint} (step {meta['step']}) once",
          file=sys.stderr, flush=True)
    serve_signals(endpoint)


# ------------------------------------------------------------ B-scans


def _detector_model(detector: str, num_classes: int, scale: str,
                    flavour: str, meta: Dict, fused_attn: bool,
                    prepatch: bool, dev: torch.device):
    """The detector of ``predict-bscan`` / ``inspect`` and its config: a
    checkpoint's metadata defines the architecture where it has one."""
    from pautdx_torch.models.vision.dfine import (
        DFine, config_from_dict, dfine_nano,
    )
    from pautdx_torch.models.vision.yolo import YOLO, YoloConfig

    if detector == "yolo":
        if prepatch:
            raise SystemExit("--prepatch is a D-FINE wire-format option")
        cfg = YoloConfig(num_classes=meta.get("num_classes", num_classes),
                         scale=meta.get("scale", scale),
                         flavour=meta.get("flavour", flavour))
        return YOLO(cfg, device=dev), cfg
    if meta.get("dfine_config"):
        cfg = config_from_dict(meta["dfine_config"])
    else:
        # a checkpoint without a config: the preset with the exact-erf
        # AIFI GELU that such checkpoints trained with
        cfg = dataclasses.replace(
            dfine_nano(num_labels=meta.get("num_classes", num_classes)),
            encoder_act_approx=False)
    if fused_attn:
        cfg = dataclasses.replace(cfg, encoder_fused_attn=True)
    if prepatch:
        if not cfg.backbone.stem_s2d:
            raise SystemExit(
                "--prepatch requires a space-to-depth stem (this "
                "checkpoint's config has stem_s2d=False)")
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, stem_pre_patchified=True))
    return DFine(cfg, device=dev), cfg


def build_detector_forward(detector: str, num_classes: int, scale: str,
                           size: int, checkpoint: Optional[str],
                           threshold: float, flavour: str = "v8",
                           quant: str = "none", fused_attn: bool = False,
                           prepatch: bool = False,
                           device=None) -> Callable:
    """``forward(frames)``: (T, H, W, 3) float frames in [0, 1] on the
    device -> fixed-size detections {boxes (T, 16, 4) pixel xyxy, scores,
    classes, valid}. Shared by ``predict-bscan`` and ``inspect``.

    The weights come from the ``"latest"`` step of ``checkpoint`` (the
    architecture from its metadata), else from the port's seeded init.
    D-FINE ends in ``post_process`` (16 detections); YOLO in the CLI
    head's NMS (scores from ``threshold``, top 64, 16 detections) on the
    ``nms_suppress`` kernel. ``quant="int8"`` serves int8 activations at
    every conv site, calibrated on the first call's frames. ``fused_attn``
    (D-FINE) runs the AIFI attention through its kernel; ``prepatch``
    (D-FINE, space-to-depth stems) feeds the stem space-to-depth frames
    rearranged on the card. Forwards run in full f32 (no TF32)."""
    from pautdx_torch.models.vision.dfine import post_process
    from pautdx_torch.ops.qconv import set_int8_scales
    from pautdx_torch.serve.quantize import calibrate_int8
    from pautdx_torch.serve.throughput import prepatchify_uint8
    from pautdx_torch.serve.yolo_predict import full_f32, postprocess
    from pautdx_torch.train.checkpoint import (
        CheckpointManager, load_model_state,
    )

    dev = resolve_device(device)
    state, meta = None, {}
    if checkpoint:
        state, meta = CheckpointManager(checkpoint).restore("latest")
        if meta.get("size") and int(meta["size"]) != int(size):
            print(f"warning: checkpoint was trained at --size {meta['size']} "
                  f"but inference runs at --size {size}; detections may "
                  f"degrade from the resolution mismatch")
    model, cfg = _detector_model(detector, num_classes, scale, flavour, meta,
                                 fused_attn, prepatch, dev)
    if state is not None:
        load_model_state(model, state)
    model.eval()

    def head(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = model(images)
        if detector == "yolo":
            det = postprocess(out, (size, size), cfg,
                              score_threshold=threshold)
            return {k: det[k] for k in ("boxes", "scores", "classes",
                                        "valid")}
        return post_process(out["logits"], out["pred_boxes"], (size, size),
                            threshold=threshold, max_det=16)

    calibrate = quant == "int8"

    def forward(frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        nonlocal calibrate
        images = (prepatchify_uint8(frames, cfg.backbone.stem_patch)
                  if prepatch else frames)
        with torch.inference_mode(), full_f32():
            if calibrate:
                set_int8_scales(model, calibrate_int8(model, [images]))
                calibrate = False
            return head(images)

    return forward


def _detections(det: Dict[str, torch.Tensor]) -> List[List[Dict]]:
    """Per frame, the valid detections as {box, label, score}."""
    boxes, classes, scores, valid = (det[k].cpu() for k in (
        "boxes", "classes", "scores", "valid"))
    out = []
    for t in range(valid.shape[0]):
        out.append([{"box": boxes[t, i].tolist(),
                     "label": int(classes[t, i]),
                     "score": float(scores[t, i])}
                    for i in torch.nonzero(valid[t]).flatten().tolist()])
    return out


def _frames(imgs: torch.Tensor) -> torch.Tensor:
    """(T, H, W) gray frames -> (T, H, W, 3) float32, as the detectors
    take them."""
    return imgs[..., None].expand(*imgs.shape, 3).to(
        torch.float32).contiguous()


def _cmd_predict_bscan(args) -> None:
    from pautdx_torch.data.bscan import render_volume

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    forward = build_detector_forward(
        args.detector, args.num_classes, args.scale, args.size,
        args.checkpoint, args.threshold, flavour=args.flavour,
        quant=args.quant, fused_attn=args.fused_attn,
        prepatch=args.prepatch, device=dev)
    results = {}
    for seq, vol in _iter_volumes(args.data):
        imgs, _ = render_volume(vol, args.size, args.size, dev)
        seq_out = _detections(forward(_frames(imgs)))
        results[seq] = seq_out
        if args.overlays:
            from pautdx_torch.viz import draw_boxes_on_image
            t_best = int(np.argmax([len(s) for s in seq_out]))
            draw_boxes_on_image(
                imgs[t_best].cpu().numpy(), [d["box"] for d in
                                             seq_out[t_best]],
                os.path.join(args.out, f"{seq}_{t_best}.png"),
                scores=[d["score"] for d in seq_out[t_best]])
    with open(os.path.join(args.out, "detections.json"), "w") as f:
        json.dump(results, f)
    print(f"detections for {len(results)} sequences in {args.out}")


def _cmd_train_bscan(args) -> None:
    from pautdx_torch.train.detector import train_bscan_detector

    train_bscan_detector(
        args.data, size=args.size, batch_size=args.batch_size,
        epochs=args.epochs, lr=args.lr, max_boxes=args.max_boxes,
        augment=args.augment, out=args.out, detector=args.detector,
        scale=args.scale, flavour=args.flavour,
        num_classes=args.num_classes, device=args.device)
    print(f"checkpoints in {args.out}")


# ------------------------------------------------------------ temporal


def _cmd_train_temporal(args) -> None:
    from pautdx_torch.data.vision import (
        detection_frames_from_volume, sequence_chunks,
    )
    from pautdx_torch.train.checkpoint import CheckpointManager
    from pautdx_torch.train.temporal import (
        cli_temporal_model, train_temporal_epochs,
    )

    dev = resolve_device(args.device)
    model = cli_temporal_model(
        args.variant, args.num_classes, args.defect_classes,
        args.temporal_layers, trunk=args.trunk, tiny=args.tiny, device=dev)
    chunks = []
    for _, vol in _iter_volumes(args.data):
        frames = detection_frames_from_volume(vol, out_size=args.size,
                                              max_boxes=args.max_boxes,
                                              device=dev)
        chunks.extend(sequence_chunks(frames, seq_len=args.seq_len))
    print(f"{len(chunks)} sequences of {args.seq_len} frames")
    if not chunks:
        raise SystemExit(f"train-temporal: no sequence of {args.seq_len} "
                         f"frames with a box in {args.data}")

    ckpt = CheckpointManager(args.out)
    metadata = {"variant": args.variant, "seq_len": args.seq_len,
                "num_classes": args.num_classes,
                "defect_classes": args.defect_classes,
                "num_temporal_labels": model.num_temporal_labels,
                "size": args.size}

    def on_epoch(epoch, state, losses):
        print(f"[epoch {epoch}] loss={float(np.mean(losses)):.4f}")
        ckpt.save(epoch, state.state_dict(), metadata=metadata,
                  history={"loss": losses}, is_best=True)

    train_temporal_epochs(model, args.variant, chunks, args.epochs, args.lr,
                          on_epoch, device=dev)
    print(f"checkpoints in {args.out}")


# ------------------------------------------------------------ host pages


def _cmd_explain(args) -> None:
    from pautdx_torch.viz.explain import build_explainers

    for p in build_explainers(args.out):
        print(p)


def _cmd_inspect(args) -> None:
    if args.mode == "bscan":
        from pautdx_torch.data.bscan import (
            bbox_xyxy_from_schema, render_volume,
        )
        from pautdx_torch.viz.inspect import build_bscan_inspector

        dev = resolve_device(args.device)
        forward = None
        if args.checkpoint:
            forward = build_detector_forward(
                args.detector, args.num_classes, args.scale, args.size,
                args.checkpoint, args.threshold, flavour=args.flavour,
                device=dev)
        sequences = []
        for seq, vol in _iter_volumes(args.data):
            imgs, ann = render_volume(vol, args.size, args.size, dev)
            gt = [[{"box": list(bbox_xyxy_from_schema(d["bbox"])),
                    "label": d["label"]} for d in ann.get(f"{t}.png", [])]
                  for t in range(imgs.shape[0])]
            pred = (_detections(forward(_frames(imgs)))
                    if forward is not None else None)
            sequences.append({"name": seq, "images": imgs.cpu().numpy(),
                              "gt": gt, "pred": pred})
        build_bscan_inspector(sequences, args.out)
    else:
        from pautdx_torch.eval.report import prediction_map
        from pautdx_torch.viz.inspect import build_signal_inspector

        endpoint = meta = None
        if args.checkpoint:
            endpoint, meta = _signal_endpoint(args.checkpoint, args.device)
        sequences = []
        for seq, vol in _iter_volumes(args.data):
            heat = None
            if endpoint is not None:
                heat = np.nan_to_num(prediction_map(
                    endpoint.predict, vol, meta.get("seq_len", 50)))
            for bi, bk in enumerate(vol.beam_keys):
                infos = vol.scan_infos[bk]
                sequences.append({
                    "name": f"{seq}/{bk}",
                    "signals": vol.signals[bk],
                    "labels": [i.binary_label for i in infos],
                    "positions": [list(i.position) for i in infos],
                    "label_names": [i.label for i in infos],
                    "probs": heat[bi][:len(infos)] if heat is not None
                    else None,
                })
        build_signal_inspector(sequences, args.out)
    print(f"inspector page: {args.out}")


# ------------------------------------------------------------ the parser


def _device_flag(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card, the default) or cpu (the "
                             "kernels' plain PyTorch versions)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("pautdx_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-dataset")
    b.add_argument("--data", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--size", type=int, default=320)
    b.add_argument("--yolo", action="store_true")
    b.add_argument("--keep-empty", type=float, default=0.1)
    _device_flag(b)
    b.set_defaults(fn=_cmd_build_dataset)

    t = sub.add_parser("train-signal")
    t.add_argument("--data", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--model", default="HybridBinary")
    t.add_argument("--recipe", default="detection")
    t.add_argument("--epochs", type=int)
    t.add_argument("--batch-size", type=int)
    t.add_argument("--seq-len", type=int)
    t.add_argument("--defect-focused", action="store_true")
    t.add_argument("--dp", action="store_true",
                   help="data-parallel over all local devices: one rank a "
                        "card over NCCL (--device cpu: one gloo rank; under "
                        "torchrun, its world)")
    _device_flag(t)
    t.set_defaults(fn=_cmd_train_signal)

    e = sub.add_parser("eval-signal")
    e.add_argument("--data", required=True)
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--out", default="eval_out")
    e.add_argument("--threshold", type=float, default=0.5)
    _device_flag(e)
    e.set_defaults(fn=_cmd_eval_signal)

    pr = sub.add_parser("predict-signal")
    pr.add_argument("--data", required=True)
    pr.add_argument("--checkpoint", required=True)
    pr.add_argument("--out", default="predictions")
    pr.add_argument("--heatmaps", action="store_true")
    _device_flag(pr)
    pr.set_defaults(fn=_cmd_predict_signal)

    tb = sub.add_parser("train-bscan")
    tb.add_argument("--data", required=True)
    tb.add_argument("--out", required=True)
    tb.add_argument("--detector", choices=("yolo", "dfine"), default="yolo")
    tb.add_argument("--size", type=int, default=320)
    tb.add_argument("--num-classes", type=int, default=1)
    tb.add_argument("--scale", default="n")
    tb.add_argument("--flavour", default="v8", choices=FLAVOURS)
    tb.add_argument("--max-boxes", type=int, default=8)
    tb.add_argument("--batch-size", type=int, default=8)
    tb.add_argument("--epochs", type=int, default=10)
    tb.add_argument("--lr", type=float, default=1e-3)
    tb.add_argument("--augment", action="store_true")
    _device_flag(tb)
    tb.set_defaults(fn=_cmd_train_bscan)

    pb = sub.add_parser("predict-bscan")
    pb.add_argument("--data", required=True)
    pb.add_argument("--out", default="bscan_predictions")
    pb.add_argument("--detector", choices=("yolo", "dfine"), default="dfine")
    pb.add_argument("--checkpoint")
    pb.add_argument("--size", type=int, default=320)
    pb.add_argument("--num-classes", type=int, default=2)
    pb.add_argument("--scale", default="n")
    pb.add_argument("--flavour", default="v8", choices=FLAVOURS)
    pb.add_argument("--threshold", type=float, default=0.3)
    pb.add_argument("--quant", choices=("none", "int8"), default="none",
                    help="int8: activation-int8 serving (s8xs8->s32 convs, "
                         "scales self-calibrated on the first request)")
    pb.add_argument("--fused-attn", action="store_true",
                    help="D-FINE: the AIFI attention through its fused "
                         "kernel (param-free, any checkpoint loads)")
    pb.add_argument("--prepatch", action="store_true",
                    help="D-FINE: space-to-depth wire format, the frames "
                         "rearranged before the stem (identical "
                         "detections)")
    pb.add_argument("--overlays", action="store_true")
    _device_flag(pb)
    pb.set_defaults(fn=_cmd_predict_bscan)

    ins = sub.add_parser("inspect")
    ins.add_argument("--data", required=True)
    ins.add_argument("--mode", choices=("bscan", "signal"), default="bscan")
    ins.add_argument("--out", default="inspector.html")
    ins.add_argument("--checkpoint")
    ins.add_argument("--detector", choices=("yolo", "dfine"),
                     default="dfine")
    ins.add_argument("--size", type=int, default=320)
    ins.add_argument("--num-classes", type=int, default=2)
    ins.add_argument("--scale", default="n")
    ins.add_argument("--flavour", default="v8", choices=FLAVOURS)
    ins.add_argument("--threshold", type=float, default=0.3)
    _device_flag(ins)
    ins.set_defaults(fn=_cmd_inspect)

    xp = sub.add_parser("explain")
    xp.add_argument("--out", default="explainers",
                    help="output directory for the animated HTML scenes")
    xp.set_defaults(fn=_cmd_explain)

    ex = sub.add_parser("export")
    ex.add_argument("--checkpoint", required=True)
    ex.add_argument("--out", required=True)
    ex.add_argument("--batch", type=int, default=1)
    ex.add_argument("--num-signals", type=int, default=50)
    ex.add_argument("--signal-length", type=int, default=320)
    ex.add_argument("--polymorphic", action="store_true",
                    help="symbolic batch dimension")
    _device_flag(ex)
    ex.set_defaults(fn=_cmd_export)

    tt = sub.add_parser("train-temporal")
    tt.add_argument("--data", required=True)
    tt.add_argument("--out", required=True)
    tt.add_argument("--variant", choices=("v1", "v2", "v3"), default="v3")
    tt.add_argument("--size", type=int, default=320)
    tt.add_argument("--seq-len", type=int, default=50)
    tt.add_argument("--num-classes", type=int, default=2)
    tt.add_argument("--defect-classes", type=int, default=2,
                    help="v2/v3: defect classes (temporal head gets +1 "
                         "no-object column)")
    tt.add_argument("--max-boxes", type=int, default=8)
    tt.add_argument("--temporal-layers", type=int, default=4)
    tt.add_argument("--epochs", type=int, default=3)
    tt.add_argument("--lr", type=float, default=1e-5)
    tt.add_argument("--tiny", action="store_true",
                    help="tiny trunk (tests / smoke runs)")
    tt.add_argument("--trunk", default=None,
                    help="trained single-frame D-FINE checkpoint dir "
                         "(train-bscan --detector dfine output) to load "
                         "into the trunk; without it the frozen trunk is "
                         "random init (smoke runs only)")
    _device_flag(tt)
    tt.set_defaults(fn=_cmd_train_temporal)

    br = sub.add_parser("bridge")
    br.add_argument("--checkpoint", required=True)
    br.add_argument("--threshold", type=float, default=0.5)
    _device_flag(br)
    br.set_defaults(fn=_cmd_bridge)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
