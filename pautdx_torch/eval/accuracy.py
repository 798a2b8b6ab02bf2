"""Accuracy run of D-FINE-nano on synthetic PAUT volumes: train on the
card, then mAP@0.5 on held-out volumes in five inference arms.

The nano arm of ``tools/bench_accuracy.py``, step for step:

- data (``make_dataset``): train volumes from seeds 100-124 with the
  volume draws of ``default_rng(1)``, validation volumes from seeds 500-503
  with ``default_rng(2)``, 60 scans each, rendered on the card to 640px
  frames with up to 8 boxes of two classes; the sets live on the device;
- training (``train``): ``dfine_nano(num_labels=2)``, f32, bilinear
  decoder, TF32 off, AdamW with clipping at 1.0, weight decay 1e-4, lr
  2.5e-4 on a warmup-cosine schedule to lr / 50, an EMA of the parameters
  at 0.999, each batch drawn by ``default_rng(0).choice(n, batch,
  replace=False)``;
- evaluation (``evaluate_arms``): the EMA parameters with the live BN
  statistics, ``post_process(threshold=0.05, max_det=16)``, mAP@0.5 of (a)
  the f32 bilinear model, (b) bf16 weights with the discrete decoder and
  (c) the serving configuration of ``serve/throughput.py`` (bf16, discrete
  decoder, fused attention, folded uint8 stem) over the frames as uint8
  wire slabs, prepatchified on the host; two more arms, f32 discrete and
  bf16 bilinear, split (b)'s difference from (a) into precision and
  sampling.

After training, one discrete-decoder step from the EMA weights runs through
the kernels and through their plain versions (``discrete_step_errors``),
and each gradient leaf's relative error is printed beside its 1e-3 limit.

    python -m pautdx_torch.eval.accuracy [--steps 3000] [--batch 16]
        [--quick] [--volumes N] [--device cuda|cpu] [--out FILE]
        [--temporal]

``--quick`` runs 128px frames and at most 60 steps; ``--volumes N`` takes
the first N seeds of each set. The last line of the output is one JSON
object with every arm's mAP@0.5, the step count, the frame counts, the
wall time, the median ms/step and the card's name and power limit as
``nvidia-smi`` reports them.

``--temporal`` runs the reference's temporal arm instead
(``bench_accuracy.run_temporal``, :func:`run_temporal`): 20 train and 8
validation volumes of seeds 200-219 and 700-707 whose defect echoes
flicker (``train.temporal.make_temporal_dataset``), cut into 50-frame
sequences at 320px (``--quick``: 2 and 1 volumes, 8-frame sequences at
96px, 8 temporal steps); the single-frame trunk trained for
min(``--steps``, 2000) steps as above and checkpointed with its EMA, then
v1, v2 and v3 trained over it for 400, 1000 and 400 steps
(``train.temporal.train_temporal``); each variant's per-frame mAP@0.5
beside the trunk's. The reference's ``parity_small`` and int8 arms are
not part of either run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pautdx_torch.data import synthetic
from pautdx_torch.data.synthetic import CLASS_MAP
from pautdx_torch.data.vision import detection_frames_from_volume
from pautdx_torch.data.volume import parse_json_volume
from pautdx_torch.device import resolve_device
from pautdx_torch.eval.map import evaluate_map
from pautdx_torch.models.vision.dfine import DFine, dfine_nano, post_process
from pautdx_torch.ops import gather
from pautdx_torch.serve.throughput import (build_serving_model,
                                           cast_params_bf16,
                                           prepatchify_uint8)
from pautdx_torch.train.checkpoint import CheckpointManager
from pautdx_torch.train.detector import dfine_metadata, dfine_objective
from pautdx_torch.train.optim import cosine_schedule, make_optimizer
from pautdx_torch.train.temporal import make_temporal_dataset, train_temporal
from pautdx_torch.train.trainer import Trainer, TrainState, ema_weights

IMG = 640
QUICK_IMG = 128
QUICK_STEPS = 60
NUM_LABELS = len(CLASS_MAP)
N_SCANS = 60
MAX_BOXES = 8
TRAIN_SEEDS = range(100, 125)
VAL_SEEDS = range(500, 504)
LR = 2.5e-4
EMA_DECAY = 0.999
LOG_EVERY = 100
EVAL_BATCH = 16
THRESHOLD = 0.05        # post_process's score threshold and its top-k
MAX_DET = 16
STEP_BATCH = 4          # frames of the discrete step from trained weights
GRAD_LIMIT = 1e-3       # per-leaf relative gradient error, kernels vs plain

Data = Dict[str, torch.Tensor]


def harness_volumes(seeds: Sequence[int], rng_seed: int,
                    n_scans: int = N_SCANS
                    ) -> List[Tuple[synthetic.VolumeSpec, list]]:
    """(spec, defects) of each seed, drawn as ``make_dataset`` draws them:
    6-8 beams, noise in [0.02, 0.06), 1-3 defects of random beams, scans,
    depths, class and amplitude."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for s in seeds:
        n_beams = int(rng.integers(6, 9))
        spec = synthetic.VolumeSpec(
            n_beams=n_beams, n_scans=n_scans, n_samples=320,
            noise=float(rng.uniform(0.02, 0.06)), seed=int(s))
        defects = []
        for _ in range(int(rng.integers(1, 4))):
            b0 = int(rng.integers(0, n_beams - 2))
            b1 = int(rng.integers(b0 + 1, n_beams))
            s0 = int(rng.integers(0, n_scans - 12))
            s1 = int(rng.integers(s0 + 6, min(s0 + 30, n_scans)))
            d0 = float(rng.uniform(0.15, 0.6))
            d1 = float(d0 + rng.uniform(0.08, 0.25))
            label = "Delamination" if rng.random() < 0.5 else "FO"
            defects.append(synthetic.SyntheticDefect(
                b0, b1, s0, s1, d0, min(d1, 0.85), label=label,
                amplitude=float(rng.uniform(0.5, 1.0))))
        out.append((spec, defects))
    return out


def make_dataset(seeds: Sequence[int], rng_seed: int, size: int = IMG,
                 device: Optional[Union[str, torch.device]] = None) -> Data:
    """The frames of the seeds' volumes (generated, encoded to the JSON
    schema and parsed back, as the reference harness does), rendered on
    ``device`` at ``size`` px: {"images" (N, S, S, 3) f32, "boxes"
    (N, 8, 4) pixel xyxy, "classes" (N, 8), "mask" (N, 8)} on ``device``."""
    dev = resolve_device(device)
    parts: Dict[str, list] = {"images": [], "boxes": [], "classes": [],
                              "mask": []}
    for spec, defects in harness_volumes(seeds, rng_seed):
        vol_arr, _ = synthetic.generate_volume(spec, defects)
        vol = parse_json_volume(synthetic.volume_to_json_dict(vol_arr,
                                                              defects))
        fr = detection_frames_from_volume(vol, out_size=size,
                                          max_boxes=MAX_BOXES,
                                          class_map=CLASS_MAP, device=dev)
        for k in parts:
            parts[k].append(torch.from_numpy(getattr(fr, k)).to(dev))
    return {k: torch.cat(v) for k, v in parts.items()}


def train(data: Data, steps: int, batch: int, size: int = IMG, log=print
          ) -> Tuple[Trainer, TrainState, List[float]]:
    """``steps`` steps of ``dfine_nano(num_labels=2)`` on the device-held
    ``data``; returns the trainer, its state and each step's ms (host
    clock, from one step's start to the next's)."""
    dev = data["images"].device
    cfg = dfine_nano(num_labels=NUM_LABELS)
    schedule = cosine_schedule(LR, steps, warmup_steps=min(100, steps // 10),
                               final_scale=1 / 50)
    trainer = Trainer(DFine(cfg, device=dev),
                      dfine_objective(size, cfg),
                      make_optimizer(LR, weight_decay=1e-4, clip_norm=1.0,
                                     schedule=schedule),
                      ema_decay=EMA_DECAY, input_key="images")
    state = trainer.init(data)
    n = data["images"].shape[0]
    rng = np.random.default_rng(0)
    starts = []
    t0 = time.perf_counter()
    for i in range(steps):
        starts.append(time.perf_counter())
        idx = torch.as_tensor(rng.choice(n, batch, replace=False),
                              device=dev)
        row = trainer.train_step(state, {k: v[idx] for k, v in data.items()})
        if i % LOG_EVERY == 0 or i == steps - 1:
            log(f"    step {i:5d} loss {row['total']:8.3f} "
                f"finite {row['update_was_finite']:.0f} "
                f"({time.perf_counter() - t0:.0f}s)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    starts.append(time.perf_counter())
    return trainer, state, [1e3 * (b - a) for a, b in zip(starts, starts[1:])]


def _map50(run, data: Data, size: int, batch: int = EVAL_BATCH) -> float:
    """mAP@0.5 of ``run(a, b)`` (the model's output on frames a:b) over
    the whole batches of ``batch`` frames of ``data``, as the reference's
    ``eval_jax``."""
    boxes = data["boxes"].cpu().numpy()
    classes = data["classes"].cpu().numpy()
    mask = data["mask"].cpu().numpy()
    n = boxes.shape[0]
    preds, gts = [], []
    for a in range(0, n - n % batch, batch):
        with torch.inference_mode():
            out = run(a, a + batch)
            pp = post_process(out["logits"], out["pred_boxes"], (size, size),
                              threshold=THRESHOLD, max_det=MAX_DET)
        pp = {k: v.float().cpu().numpy() if v.is_floating_point()
              else v.cpu().numpy() for k, v in pp.items()}
        for i in range(batch):
            t, v = a + i, pp["valid"][i]
            preds.append({"boxes": pp["boxes"][i][v],
                          "scores": pp["scores"][i][v],
                          "classes": pp["classes"][i][v]})
            gm = mask[t] > 0
            gts.append({"boxes": boxes[t][gm], "classes": classes[t][gm]})
    return evaluate_map(preds, gts, num_classes=NUM_LABELS)["mAP@0.5"]


# the model arms: (weights' dtype, decoder_method); (a) and (b) are the
# reference harness's, the other two split (b)'s difference from (a) into
# precision and sampling
MODEL_ARMS = {"f32_bilinear": (torch.float32, "default"),
              "f32_discrete": (torch.float32, "discrete"),
              "bf16_bilinear": (torch.bfloat16, "default"),
              "bf16_discrete": (torch.bfloat16, "discrete")}


def evaluate_arms(state: TrainState, data: Data, size: int = IMG
                  ) -> Dict[str, float]:
    """mAP@0.5 of the state's EMA parameters with the live BN statistics:
    each of ``MODEL_ARMS`` (``f32_bilinear`` is arm a, ``bf16_discrete``
    arm b; the bf16 arms feed bf16 frames) and ``serving`` (arm c)."""
    images = data["images"]
    dev = images.device
    with ema_weights(state) as model:
        weights = {k: v.detach().clone()
                   for k, v in model.state_dict().items()}
    out = {}
    for name, (dtype, method) in MODEL_ARMS.items():
        arm = DFine(dataclasses.replace(model.cfg, decoder_method=method),
                    device=dev)
        arm.load_state_dict(weights, strict=True)
        if dtype == torch.bfloat16:
            cast_params_bf16(arm)
        out[name] = _map50(lambda a, b: arm(images[a:b].to(dtype)), data,
                           size)
    serving = build_serving_model(dev, batch=EVAL_BATCH, state_dict=weights)
    u8 = np.clip(images.cpu().numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
    wire = torch.from_numpy(prepatchify_uint8(
        u8, serving.cfg.backbone.stem_patch)).to(dev)
    out["serving"] = _map50(lambda a, b: serving.model(wire[a:b]), data,
                            size)
    return out


@contextlib.contextmanager
def plain_gathers():
    """Route the decoder's gathers to their plain PyTorch versions for a
    while (the call sites look the wrappers up in ``ops.gather``)."""
    names = ("onehot_gather", "weighted_gather")
    saved = {n: getattr(gather, n) for n in names}
    for n in names:
        setattr(gather, n, getattr(gather, f"{n}_reference"))
    try:
        yield
    finally:
        for n in names:
            setattr(gather, n, saved[n])


def discrete_step_errors(state: TrainState, data: Data, size: int = IMG
                         ) -> Dict:
    """One training step of the discrete decoder from the state's EMA
    weights (live BN statistics) on ``STEP_BATCH`` frames of ``data``
    drawn by ``default_rng(1)``, through the kernels and through the plain
    versions: both losses, the gradient's relative error as a whole, and
    each leaf's relative error for the leaves above 1e-6 of the global
    norm (the rest is float noise, as in ``chip_smoke.py`` phase 12)."""
    dev = data["images"].device
    with ema_weights(state) as model:
        start = {k: v.detach().clone()
                 for k, v in model.state_dict().items()}
        cfg = dataclasses.replace(model.cfg, decoder_method="discrete")
    model = DFine(cfg, device=dev)
    objective = dfine_objective(size, cfg)
    pick = np.random.default_rng(1).choice(data["images"].shape[0],
                                           STEP_BATCH, replace=False)
    idx = torch.as_tensor(pick, device=dev)
    b = {k: v[idx] for k, v in data.items()}

    def step(plain: bool):
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        with plain_gathers() if plain else contextlib.nullcontext():
            loss, _ = objective(model(b["images"], train=True), b)
            loss.backward()
        return loss.item(), {n: (p.grad.clone() if p.grad is not None
                                 else torch.zeros_like(p))
                             for n, p in model.named_parameters()}

    loss_k, got = step(False)
    loss_p, want = step(True)
    sq = {n: float(w.double().pow(2).sum()) for n, w in want.items()}
    norm = sum(sq.values()) ** 0.5
    floor = 1e-6 * norm
    leaves = {n: (got[n] - w).norm().item() / w.norm().item()
              for n, w in want.items() if sq[n] ** 0.5 >= floor}
    whole = sum(float((got[n] - w).double().pow(2).sum())
                for n, w in want.items()) ** 0.5 / max(norm, 1e-30)
    worst = max(leaves, key=leaves.get)
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "whole": whole,
            "worst_leaf": worst, "worst": leaves[worst], "limit": GRAD_LIMIT,
            "leaves_over_limit": sum(e > GRAD_LIMIT for e in leaves.values()),
            "leaves": leaves}


# the temporal arm (``bench_accuracy.run_temporal``): frame side, sequence
# length, scans a volume, temporal steps (v2 takes V2_STEP_SCALE of them),
# train and validation volumes; the quick run's values beside them
TEMPORAL_IMG, QUICK_TEMPORAL_IMG = 320, 96
TEMPORAL_SEQ, QUICK_TEMPORAL_SEQ = 50, 8
TEMPORAL_SCANS, QUICK_TEMPORAL_SCANS = 60, 10
TEMPORAL_STEPS, QUICK_TEMPORAL_STEPS = 400, 8
TEMPORAL_VOLUMES, QUICK_TEMPORAL_VOLUMES = (20, 8), (2, 1)
TRUNK_STEPS = 2000          # at most, of --steps
V2_STEP_SCALE = 2.5


def chunk_data(chunks, device: Union[str, torch.device]) -> Data:
    """The sequences' frames, flattened in order, on ``device``: images
    rounded to bf16 and computed in f32 (the reference stores them in
    bf16), pixel boxes, classes and masks."""
    parts = {k: torch.from_numpy(np.concatenate([getattr(c, k)
                                                 for c in chunks])).to(device)
             for k in ("images", "boxes", "classes", "mask")}
    parts["images"] = parts["images"].to(torch.bfloat16).float()
    return parts


def eval_trunk_on_chunks(trunk: DFine, data: Data, size: int,
                         seq_len: int) -> float:
    """Single-frame mAP@0.5 of the trunk on the frames the temporal
    models see, ``seq_len`` frames a call (``bench_accuracy.py:715``)."""
    trunk.eval()
    return _map50(lambda a, b: trunk(data["images"][a:b]), data, size,
                  batch=seq_len)


def eval_temporal(model, data: Data, size: int, seq_len: int) -> float:
    """Per-frame mAP@0.5 of a temporal model, one sequence a call, on the
    defect columns of its logits (``bench_accuracy.py:678``)."""
    model.eval()

    def run(a, b):
        out = model(data["images"][a:b])
        return {"logits": out["logits"][..., :NUM_LABELS],
                "pred_boxes": out["pred_boxes"]}

    return _map50(run, data, size, batch=seq_len)


def run_temporal(args, dev: torch.device) -> Dict:
    """The temporal arm: the single-frame trunk trained on the flattened
    train sequences (``train``, EMA kept) and checkpointed, then v1, v2
    (``V2_STEP_SCALE`` x the steps) and v3 trained over it by
    ``train.temporal.train_temporal``; each variant's per-frame mAP@0.5
    on the validation sequences beside the trunk's."""
    q = args.quick
    size = QUICK_TEMPORAL_IMG if q else TEMPORAL_IMG
    seq = QUICK_TEMPORAL_SEQ if q else TEMPORAL_SEQ
    n_scans = QUICK_TEMPORAL_SCANS if q else TEMPORAL_SCANS
    n_train, n_val = QUICK_TEMPORAL_VOLUMES if q else TEMPORAL_VOLUMES
    seq_steps = QUICK_TEMPORAL_STEPS if q else TEMPORAL_STEPS
    trunk_steps = min(args.steps, TRUNK_STEPS)
    t0 = time.perf_counter()
    train_chunks, val_chunks = (
        make_temporal_dataset(range(first, first + n), n_scans=n_scans,
                              rng_seed=rng_seed, size=size, seq_len=seq,
                              device=dev)
        for first, n, rng_seed in ((200, n_train, 4), (700, n_val, 5)))
    train_data, val_data = (chunk_data(c, dev)
                            for c in (train_chunks, val_chunks))
    print(f"temporal: {len(train_chunks)} train and {len(val_chunks)} "
          f"validation sequences of {seq} frames at {size}px "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    out: Dict = {"img_size": size, "seq_len": seq, "flicker": 0.65,
                 "trunk_steps": trunk_steps, "temporal_steps": seq_steps}
    with tempfile.TemporaryDirectory() as ckpt:
        print(f"trunk: {trunk_steps} steps at batch {args.batch}", flush=True)
        trainer, state, step_ms = train(train_data, trunk_steps, args.batch,
                                        size,
                                        log=lambda m: print(m, flush=True))
        out["trunk_median_ms_per_step"] = statistics.median(step_ms)
        with ema_weights(state) as model:
            CheckpointManager(ckpt).save(0, {
                "params": {k: v.detach().cpu() for k, v in
                           model.named_parameters()},
                "batch_stats": {k: v.cpu() for k, v in
                                model.named_buffers()}},
                metadata=dfine_metadata(model.cfg, size))
            out["single_frame_map50"] = eval_trunk_on_chunks(
                model, val_data, size, seq)
        print(f"  trunk single-frame mAP@0.5 = "
              f"{out['single_frame_map50']:.4f}", flush=True)
        del trainer, state
        for variant in ("v1", "v2", "v3"):
            steps = (int(seq_steps * V2_STEP_SCALE) if variant == "v2"
                     else seq_steps)
            t0 = time.perf_counter()
            _, vstate, rows = train_temporal(
                variant, ckpt, train_chunks, steps, device=dev,
                log=lambda m: print(m, flush=True))
            train_s = time.perf_counter() - t0
            m = eval_temporal(vstate.model, val_data, size, seq)
            out[f"{variant}_map50"] = m
            out[f"{variant}_steps"] = steps
            out[f"{variant}_delta_vs_single"] = m - out["single_frame_map50"]
            out[f"{variant}_ms_per_step"] = 1e3 * train_s / steps
            out[f"{variant}_final_loss"] = rows[-1]["total"]
            print(f"  {variant} mAP@0.5 = {m:.4f} (delta "
                  f"{m - out['single_frame_map50']:+.4f})", flush=True)
            del vstate
    return out


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_record(dev: torch.device) -> Dict:
    return {"type": dev.type,
            "name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "nvidia_smi": card_line() if dev.type == "cuda" else None}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="python -m pautdx_torch.eval.accuracy",
        description="Train D-FINE-nano on synthetic PAUT volumes and report "
                    "mAP@0.5 in five inference arms.")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--quick", action="store_true",
                    help=f"{QUICK_IMG}px frames, at most {QUICK_STEPS} steps")
    ap.add_argument("--volumes", type=int, default=None,
                    help="the first N seeds of the train and the "
                         "validation set")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the result, "
                    "each gradient leaf's error included, to this file")
    ap.add_argument("--temporal", action="store_true",
                    help="the temporal arm instead: the trunk, then v1, v2 "
                         "and v3 over it on flickering sequences")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    dev = resolve_device(args.device)
    size = QUICK_IMG if args.quick else IMG
    steps = min(args.steps, QUICK_STEPS) if args.quick else args.steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.temporal:
        result = {"temporal": run_temporal(args, dev),
                  "wall_s": time.perf_counter() - t_start,
                  "device": device_record(dev)}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        print(json.dumps(result), flush=True)
        return result

    train_seeds, val_seeds = list(TRAIN_SEEDS), list(VAL_SEEDS)
    if args.volumes is not None:
        train_seeds, val_seeds = (train_seeds[:args.volumes],
                                  val_seeds[:args.volumes])
    print("dataset: synthesizing and rendering volumes ...", flush=True)
    t0 = time.perf_counter()
    train_data = make_dataset(train_seeds, 1, size, dev)
    val_data = make_dataset(val_seeds, 2, size, dev)
    data_s = time.perf_counter() - t0
    n_train, n_val = (int(d["images"].shape[0]) for d in (train_data,
                                                          val_data))
    print(f"  train frames {n_train}, val {n_val} at {size}px "
          f"({data_s:.1f} s)", flush=True)

    print(f"training: {steps} steps at batch {args.batch}", flush=True)
    t0 = time.perf_counter()
    trainer, state, step_ms = train(train_data, steps, args.batch, size,
                                    log=lambda s: print(s, flush=True))
    train_s = time.perf_counter() - t0
    del train_data
    maps = evaluate_arms(state, val_data, size)
    print("mAP@0.5: " + ", ".join(f"{k} {v:.4f}" for k, v in maps.items()),
          flush=True)
    grads = discrete_step_errors(state, val_data, size)
    for name, err in grads["leaves"].items():
        print(f"  discrete step, leaf {name}: relative gradient error "
              f"{err:.3g} (limit {GRAD_LIMIT:g})")
    print(f"discrete step from the trained EMA weights, kernels vs plain: "
          f"loss {grads['loss_kernels']:.6f} / {grads['loss_plain']:.6f}, "
          f"gradient as a whole {grads['whole']:.3g}, worst leaf "
          f"{grads['worst']:.3g} ({grads['worst_leaf']}), "
          f"{grads['leaves_over_limit']} of {len(grads['leaves'])} leaves "
          f"over {GRAD_LIMIT:g}", flush=True)
    result = {
        "img_size": size, "steps": steps, "batch": args.batch,
        "train_frames": n_train, "val_frames": n_val,
        "map50": maps,
        "median_ms_per_step": statistics.median(step_ms) if step_ms else None,
        "train_s": train_s, "data_s": data_s,
        "wall_s": time.perf_counter() - t_start,
        "discrete_step": {k: v for k, v in grads.items() if k != "leaves"},
        "device": device_record(dev),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "discrete_step_leaves": grads["leaves"]}, f,
                      indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
