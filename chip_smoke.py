"""Smoke run of pautdx_torch on one NVIDIA card: builds the CUDA kernels,
holds each against its plain PyTorch version, then drives the D-FINE-nano
640px serving path (the configuration of the root ``bench.py``), the
YOLOv8n-seg 640px predict path, the D-FINE-nano 640px training step, the
HF-architecture D-FINE 640px predict path, D-FINE-nano training from
PAUT volumes, the temporal D-FINE serving path (50-frame sequences
through the chunked runner and the frames bridge), the YOLOv9c-seg,
YOLO11n and YOLOv5su 640px predict paths, YOLO training and temporal
D-FINE training through their entry points, and the signal domain: the
21-model zoo and HybridBinary served through ``SignalEndpoint``, then
trained through ``train.signal.train_signal``, and int8 activations in
serving (D-FINE-nano and YOLOv8n-seg through the s8 x s8 -> s32
convolution kernel), the HF D-FINE bridge and the C++ volume reader, the
command line, ``python -m pautdx_torch.cli``, every subcommand, and last
multi-device training (NCCL in a world of 1, and four gloo ranks sharing
the card on a (dp, tp) mesh).

    python3 chip_smoke.py
    python3 chip_smoke.py --signal-train    # phases 29-31 alone
    python3 chip_smoke.py --int8            # phases 32-35 alone
    python3 chip_smoke.py --cli             # phase 36 alone
    python3 chip_smoke.py --multi           # phase 37 alone

Phases, one line each, in order; any failure exits non-zero:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: ``nvcc`` of every ``pautdx_torch/csrc/*.cu``, all at once, and
   each kernel's registers, static shared memory and spills from the
   ``-Xptxas -v`` log;
3. attention kernel vs plain at (128, 8, 400, 16), f32 (3xTF32 on the
   tensor cores) and bf16 (tensor cores), and at a ragged N=37;
4. gather kernel vs plain at (128, 2000, 128) x 1200 taps, bf16 and f32,
   indices out of range included: bit for bit; then the one-hot forward's
   tile plan where it stretches (a b4 denoising step, a ragged last tile,
   a pile-up), and the weighted forward at b16, b4 and a 20,000-row table,
   and on the path's bilinear corners at b4 and b50 with the plan each
   took (within 1e-5);
5. the full model in f32 at batch 4, once through the kernels and once
   through the plain versions, detection sets matched by assignment; each
   forward must launch the attention kernel once and the gather thrice;
6. the serving run: bf16 weights, folded uint8 stem, a (8, 128, 80, 80,
   192) uint8 slab, through the eager forward; counts every kernel's
   launches over that run, checks the outputs are finite, then serves the
   slab through the served model's own calls, which replay a CUDA graph:
   each step's outputs equal the eager run's bit for bit, one capture, one
   replay a step, the per-op counters as eager; times frames/s (through
   the kernels and, in turns with it, through the plain versions, eager;
   then the replay), each kernel at the
   inputs that run gave it, its plain version and one library call that
   computes the same function (device times per call from
   ``torch.profiler``, the event-timed call through the wrapper beside
   them; attention's bound counts its exponentials on the SFUs at the
   card's ``clocks.max.sm``), and the attention kernel in f32 on the same
   inputs, the f32 model's kernel;
7. NMS sweep kernel vs plain at (32, 300) candidates, ties at the
   threshold and invalid slots included: bit for bit;
8. mask decode kernel vs plain at (32, 160, 160, 32) protos, K=100, boxes
   off the image and of zero area included: max |err| <= 1e-5;
9. YOLOv8n-seg in f32 at batch 4: the network once, its outputs
   post-processed once through the kernels and once through the plain
   versions: identical detections, masks within 1e-5; one ``predict``
   launches each of the two kernels once and, with TF32 switched on for
   the process, gives the same detections and masks (the predictor runs
   in full f32 whatever the caller set); images laid out NCHW in memory
   go through too;
10. the predict run: ``build_yolo_predictor`` over a (4, 32, 640, 640, 3)
    uint8 slab made on the card, TF32 on for the process; counts every kernel's launches over that
    run, checks the outputs are finite, times frames/s (through the kernels
    and, in turns with it, through the plain versions) and each of the two
    kernels at the inputs that run gave it, beside its plain version
    (device times, as in phase 6; no single PyTorch call computes either
    function, and the record says so);
11. weighted gather kernel vs plain at (16, 2000, 128) f32 x (1200, 4)
    taps, corners of weight 0 and rows past either end of the table
    included: forward within 1e-5 of the output's largest magnitude, the
    backward's d_flat and d_w within 1e-5 of theirs against autograd of the
    plain version (a row of d_flat sums its taps in an order that varies
    from run to run), also at a ragged T=37, at L=20000 (the backward's
    rows split into ranges) and with every corner of a frame piled on one
    row; the one-hot gather's backward
    kernel against the plain clipped scatter-add, through autograd and
    alone, at (16, 2000, 128) x 1200, a ragged (3, 50, 128) x 37 with
    indices past both ends, and a pile-up, within 1e-5;
12. the training config ``dfine_nano(num_labels=2)`` at 640px, batch 4,
    f32, and the same with ``decoder_method="discrete"``: for each, one
    forward, loss and backward through the kernels and one through the
    plain versions from the same weights and batch: losses within 1e-4,
    every gradient within 1e-3 in norm (the discrete step: the gradient
    as a whole, and each leaf within the larger of 1e-3 and twice what it
    moves in a plain step whose one-hot sums run in another order), BN
    running statistics within 1e-5; the bilinear step launches the
    weighted gather 3 times forward and 3 times backward, the discrete one
    the one-hot gather 3 and 3 times; a checkpoint save and restore gives
    identical tensors;
13. the training run: ``train.detector.build_dfine_trainer`` at 640px,
    batch 16, f32, lr 1e-3, on seeded numpy batches; counts every kernel's
    launches over one step, times steps through the kernels and, in turns
    with them, through the plain versions (six 5-step turns per arm, the
    median turn reported beside all of them), reads the peak device memory,
    checks the loss is finite at every step and falls over 20 steps on one
    batch; one step of the discrete config on the same batches, its
    launches counted; and times both weighted gather kernels and the
    one-hot backward at the inputs the steps gave them, beside their plain
    versions and ``embedding_bag`` (``F.embedding``'s backward for the
    one-hot): device time per call from ``torch.profiler``, every kernel
    and memset of the call summed (the wrappers' host time exceeds these
    kernels' device time, so CUDA events around one call measure the
    host), and the event-timed call beside it;
14. attention kernel vs plain at every head dim of ``HEAD_DIMS`` (1 to
    256), f32 and bf16, at (32, 8, 400, dh) and a ragged N=37, directly
    and through the (B, N, D) strides, at phase 3's gates;
15. the widened envelopes vs their plain versions: the weighted gather
    forward and backward with a bf16 table at (16, 2000, 128) x (1200, 4)
    (w f32 and bf16, rows past both ends, a pile-up) and the one-hot
    backward with a bf16 gradient, within one bf16 ulp at the largest
    magnitude plus 1e-5 of it (each output is rounded to bf16 once, after
    f32 sums that run in another order); masks at (4, 160, 160, 32) x
    K=400 and at P=16 and P=37, within 1e-5; NMS with a bf16 IoU at
    (32, 300), bit for bit;
16. ``DFineConfig(num_labels=2, encoder_fused_attn=True)`` (HGNet stem, d_model
    256, 8 heads of 32, 3 levels, per-head points, 6 decoder layers) in
    f32 at batch 4, 640px: through the kernels, through the plain versions
    and with ``encoder_fused_attn=False``, detection sets matched by
    assignment; one forward launches the attention kernel once and no
    gather;
17. the predict runs: ``serve.dfine_predict.build_dfine_predictor`` over a
    (4, 32, 640, 640, 3) uint8 slab made on the card, f32 (TF32 off) and
    bf16 weights; counts the launches, checks the outputs are finite, times
    frames/s through the kernels and, in turns with it, through the plain
    versions, and records the attention kernel at the inputs each run gave
    it (head dim 32), with SDPA at the same shape as its library call;
18. NMS sweep kernel vs plain past the shared-memory bitmask, at K = 1025,
    1500, 2048 and 4096 candidates (B = 4), ties at the threshold and
    invalid slots included: bit for bit;
19. training from PAUT volumes: the accuracy harness's volumes of seeds
    100-103, two written as JSON and two as txt trees, parsed, rendered
    to 640px frames on the card and through the same function on the CPU
    (images within 1e-5, boxes, classes and masks equal), frames rendered
    per second; ``train.detector.train_bscan_detector`` over them for one
    epoch at b16 with an EMA of 0.999: every loss finite, the weighted
    gather launched 3 times forward and 3 times backward a step, the EMA
    within 1e-6 of d*ema + (1-d)*params after the last step, the
    checkpoint restores it, median ms/step; then the EMA's mAP@0.5 on 64
    of the frames in the accuracy harness's arms (f32 and bf16, bilinear
    and discrete, and the serving configuration over uint8 wire slabs),
    each in [0, 1];
20. phase 12's step (b4, 640px, f32, both decoders) with a contrastive
    denoising group of M = 8 and 100 denoising queries (D = 192, so 342
    decoder queries and 2,736 taps a frame), criterion plus
    ``denoising_loss``, through the kernels and through the plain versions
    from the same weights, batch and draws, at phase 12's gates, the
    bilinear step too at the discrete step's (one backbone leaf's f32
    gradient is at the noise floor there: reversing the plain step's tap
    order moves it by more than 1e-3); the
    records of the weighted gather, its backward, the one-hot gather and
    its backward at the inputs these steps gave them, each with its bound
    and library call, as phase 13's;
21. ``TemporalDFine`` v1, v2 and v3 over the nano discrete trunk
    (``serve.temporal_predict.build_temporal_model``: seeded weights,
    then ``init_heads_from_trunk``) in f32, TF32 off, T = 8 frames of
    640px, once through the kernels and once through the plain versions:
    per-frame detection sets matched by assignment, v3's anomaly scores
    within 1e-4; one forward launches the one-hot gather 3 times and
    nothing else (the trunk's AIFI stays unfused);
22. the temporal serving run: ``build_temporal_model("v3")`` in bf16 over
    a (4, 50, 640, 640, 3) uint8 slab made on the card, dequantized there;
    counts the launches (12 one-hot gathers), checks the outputs are
    finite, times frames/s through the kernels and, in turns with it,
    through the plain versions, and records the one-hot gather at a
    50-frame chunk's inputs, (50, 2000, 128) bf16 x 1200 taps; then
    ``predict_sequence`` end to end over 170 host uint8 frames (windows
    (0, 50), (50, 100), (100, 150) and the re-anchored (120, 170), one
    result per frame, 12 launches), frames/s with the host-to-card copies;
    a 7-frame stack padded to 50; and a [2][640][640] JSON through
    ``serve.bridge.serve_frames``, answered in the {box, label, score}
    schema;
23. YOLOv9c-seg, YOLO11n and YOLOv5su (``serve.yolo_predict.yolo_config``,
    one class, published widths and depths; served NMS: top 300 and 100
    detections for v9c-seg, scores from 0.3, top 64 and 16 detections for
    the other two) in f32 at batch 4, 640px: the network once, its
    outputs post-processed once through the kernels and once through the
    plain versions: identical detections, v9c-seg's masks within 1e-5;
    one ``predict`` launches one NMS sweep and, for v9c-seg only, one mask
    decode;
24. the predict runs: v9c-seg over a (4, 32, 640, 640, 3) uint8 slab made
    on the card, v11n and v5su over (2, 32, 640, 640, 3); counts the
    launches, checks the outputs are finite, times frames/s through the
    kernels and, in turns with it, through the plain versions, and records
    the NMS sweep at the inputs each run gave it (K = 300 for v9c-seg,
    K = 64 for v11n and v5su) and the mask decode at v9c-seg's, as phase
    10 does;
25. YOLO training: one train-mode ``ConvBnSiLU`` on the card moves its
    running mean by 0.03 of the batch mean (momentum 0.97); one b2 128px
    f32 step of each of YOLOv8n-seg, YOLOv9c-seg, YOLO11n and YOLOv5su
    (two classes, seeded weights, box masks for the seg models) on the
    card under deterministic algorithms, TF32 off, and the same step on
    the CPU in f32 and in float64: the card's task-aligned assignment
    equals the CPU's, and its loss, gradient and BN statistics lie within
    1e-4 (relative), 1e-3 (relative, in norm) and 1e-5 of the float64
    step's, each limit raised to twice the CPU f32 step's own error where
    that is larger (the deep unscaled v9c-seg rounds to 1e-5 in its BN
    statistics); no kernel launches; the timed YOLOv8n-seg run at 640px
    b16 f32 with ``rasterize_boxes`` masks (the loss falls over 20 steps
    on one batch; median ms/step of six turns; peak memory); one epoch of
    ``train_bscan_detector(detector="yolo", seg=True)`` over phase 19's
    volumes, then ``YoloPredictor`` on 64 of their frames: box and mask
    mAP@0.5 in [0, 1], one NMS sweep and one mask decode a predict;
26. temporal D-FINE training over a seeded ``dfine_nano`` trunk
    checkpoint, on the sequences of the harness's first two temporal
    volumes at 640px (``train.temporal.make_temporal_dataset``): one v3
    step at T = 50 through the kernels and through the plain versions
    (the same dropout masks), at phase 20's rule: the loss within 1e-4,
    the gradient within 1e-3 as a whole and each leaf within the larger
    of 1e-3 and twice what reordering the plain gather's taps moves it;
    then 20 steps of each of v1, v2 and v3 (``build_temporal_trainer``,
    the recipe's groups and schedule), kernels and plain versions in
    turns: every loss finite, the frozen parameters and the trunk's BN
    statistics unchanged bit for bit, launches a step (3 weighted
    gathers, and 3 backwards for v3 only), ms/step and peak memory; the
    records of the weighted gather and its backward at the v3 step's
    inputs, (50, 2000, 128) x (1200, 4);
27. the signal zoo: every ``MODEL_ZOO`` name at its published default
    widths (``models.signal.build_signal_model``, seeded weights), f32,
    TF32 off, at (B, N, S) = (16, 50, 320), the largest batch bucket at
    the recipe's ``seq_len`` 50 and ``signal_length`` 320, on the card
    and, with the same weights, on the CPU: every output (each key of a
    dict) within ``SIGNAL_TOL``; one line per model with its max |err|;
    the zoo launches no kernel (the signal path reaches no Pallas kernel
    in the reference);
28. HybridBinary served: ``serve.endpoints.SignalEndpoint`` at (16, 50,
    320) and at a ragged (3, 37, 320), answered at the request's own shape
    and held to the CPU model at that shape within ``SIGNAL_TOL``; a
    ``serve.bridge.serve_signals`` round trip through in-memory streams;
    ``eval.report.prediction_map`` over phase 19's first volume, card
    against CPU; then A-scans per second through the endpoint from host
    numpy, host copies included (``SIGNAL_TURNS`` turns of
    ``SIGNAL_CALLS`` calls, the median turn beside all turns), and the
    device ms of one forward and of one ``predict`` by CUDA events;
29. signal steps, card against CPU: HybridBinary/``detection``,
    ``SignalSequenceDetector`` and its Enhanced variant/``seq_detector``,
    ``Hybrid1DDetLoc``/``detloc_criterion``, MSC3Out/
    ``detection_position``, EnhancedPosition/``enhanced_position``,
    TwoStage/``two_stage`` and Hybrid/``detection_position`` under
    ``HybridPhases``' joint groups, each at its published widths, one
    ``Trainer.train_step`` at (2, 50, 320) f32, TF32 off, dropout 0, from
    the same weights on the card, on the CPU in f32 and on the CPU in
    float64: the card's loss within 1e-4 (relative), each gradient leaf
    within 1e-3 in norm (a leaf under ``grad_floor`` within the floor)
    and the BN statistics within 1e-5 of the float64 step's, each limit
    raised to twice the CPU f32 step's own error; each pair's worst leaf
    printed; no kernel launches;
30. HybridBinary trained: ``train_signal`` over the harness's volumes of
    ``VOLUME_SEEDS`` as JSON, two epochs at batch 8 of (50, 320) with the
    recipe's plateau and dropout 0.15 from the trainer's seeded
    generator; ``restore_signal_model``, ``SignalEndpoint`` on it within
    1e-6 of its forward (and of the trained model when the best epoch is
    the last), ``SignalEvaluator``'s report, a ``prediction_map``; the
    loss falling over 20 steps on one batch, ms/step (six turns, the
    median beside all turns) and peak memory at (8, 50, 320); then 20
    steps of ``RECIPES["seq_detector"]`` with ``SignalSequenceDetector``
    at published width, ms/step;
31. ``HybridPhases``' phase 1 on Hybrid (the frozen groups bit-equal),
    ``SNRCurriculum`` with two 1-epoch stages (a fresh controller each,
    each from lr scale 1.0), ``train_autoencoder`` with
    ``anomaly_threshold`` and ``detect_anomalies``, ``find_gates`` and
    ``gate_mask`` against the numpy mask, and
    ``export_signal_model(HybridBinary)`` saved as ``.pt2``, loaded and
    run on the card within 1e-5 of eager at batches 2 and 5; no kernel
    launches;
32. the int8 convolution kernel against its plain version at every
    distinct site shape of the two int8 paths: the 69 sites of a b128
    D-FINE-nano serving forward (``build_serving_model(int8_calib=...)``,
    calibrated on a seeded 2 x 128 slab; 25 shapes, bf16) and the 66 of a
    b32 YOLOv8n-seg predict (``build_yolo_predictor(int8_calib="first")``;
    40 shapes, f32): the route each shape takes (every site but YOLO's
    3-channel stem on a TMA route, asserted; one launch a call on it), the
    int32 accumulators and the dequantized output bit for bit (the plain
    version convolves the integer values in float64, exact); each shape's
    device ms (L2 flushed), the plain version's, cuDNN's bf16 convolution
    at the same shape (a yardstick, not the same function), at 1x1 sites
    ``torch._int_mm`` over the input already quantized (the same product)
    and that quantization apart, and the bound (input read once, output
    written once, int8 weights, at the HBM rate; int8 operations at 1,979
    TOP/s); the host cost of a TMA map encode; and the first captured
    site of each route (wgmma, dp4a, generic) with NaN and +-inf written
    into a copy of its input, kernel against plain version bit for bit
    (NaN quantizes to 0, +-inf to +-127);
33. int8 D-FINE-nano serving: the (8, 128, 80, 80, 192) slab of phase 6
    through the int8 model: launches (552 int8 convolutions, 8
    attentions, 24 one-hot gathers), finite outputs, detections through
    the kernel against the plain int8 arm's (the int8 convolutions through
    their plain version, the other kernels as served) by assignment on
    one 128-frame step, frames/s in turns with the bf16 serving model of
    phase 6 (and phase 6's median beside), the plain int8 arm over one
    step;
34. int8 YOLOv8n-seg predict at b32 f32: the first b4 predict calibrates;
    kernels against plain versions on a b4 predict at phase 9's gate
    (identical detections, masks within 1e-5); the (4, 32, 640, 640, 3)
    slab's launches (264 int8 convolutions, 4 NMS sweeps, 4 mask
    decodes), finite outputs, frames/s in turns with the f32 predictor;
35. host-side modules: the HF-architecture D-FINE of
    ``serve.dfine_predict`` exported to an HF state dict
    (``compat.dfine_import``) and converted back into a fresh model, every
    entry bit-equal, detections matched by assignment; phase 19's volumes
    written again and parsed by the C++ reader (``native``, asserted
    built and taken), bit-equal to the numpy path;
36. the command line on the card (``pautdx_torch.cli.main`` in this
    process with ``--device cuda``, over phase 19's four volumes and the
    signal volumes of phases 29-31): (a) ``predict-bscan`` at 640px
    (four 60-frame forwards) for D-FINE-nano (default, ``--fused-attn``,
    ``--prepatch``, ``--quant int8``) and YOLO ``--flavour`` v8, v5, v9c
    and v11, each in f32 and ``--quant int8``, each through the kernels
    (four volumes) and through the plain versions (the first volume, which
    is also the int8 calibration request): launches gated per forward (3
    weighted gathers a D-FINE forward, the attention once with
    ``--fused-attn``, the int8 convolution at every calibrated site, one
    NMS sweep a YOLO forward; the int8 calibration forward adds 3
    gathers; none through the plain versions), every arm with
    detections, D-FINE's by :func:`same_detections`' rule on the first
    volume, YOLO's equal there, ``--prepatch`` equal to the default run;
    in every int8 arm each site's captured input through the int8 kernel
    and its plain version, accumulators and output bit for bit; the YOLO
    flavours' int8 site shapes that YOLOv8n-seg lacks written to
    ``chiprun_out/cli_int8_sites.json``; (c) ``train-bscan`` for both
    detectors (1 epoch, 320px, b4), ``predict-bscan`` and ``inspect`` from
    the D-FINE checkpoint, ``train-temporal --tiny``: losses finite,
    checkpoints restored; (d) ``train-signal`` (HybridBinary, 1 epoch),
    ``eval-signal``, ``predict-signal --heatmaps``, ``export
    --polymorphic`` (the artifact within 1e-5 of the model on the card);
    (b) two processes side by side: ``python -m pautdx_torch.cli
    predict-bscan``, its detections against (a)'s default run, and
    ``bridge`` with two requests (both answered at their own shapes, the
    checkpoint loaded once); (e) ``build-dataset --yolo``, ``explain``,
    ``inspect --mode signal``; each subcommand's wall seconds;
37. multi-device: (a) NCCL in a world of 1 in this process: one
    b16 640px dfine_nano step of ``Trainer(mesh=make_mesh())`` against the
    same step without a mesh (loss within 1e-6, every gradient leaf
    within phase 20's per-leaf rule), and ``python -m pautdx_torch.cli
    train-signal --dp`` (HybridBinary, 1 epoch over phase 29's volumes) in
    a process of its own; (b) ``mesh.dryrun.dryrun_multichip`` on four
    gloo ranks sharing the card, (dp, tp) = (2, 2), dfine_nano at 640px,
    global batch 16, the kernels built before the spawn: its step against
    one process's over the whole batch (loss within 1e-4; each gradient
    leaf within 1e-3 of its norm plus the floor of 1e-6 of the global
    norm, or four times the one-process step's own noise, the larger move
    of its rows reversed and rolled by half), its tp eval forward
    (encoder attention through the fused kernel, 4 of 8 heads a rank)
    against the unsharded forward by assignment, and every rank's
    launches of the attention and of both weighted-gather kernels, each
    above 0; the phase's wall seconds.

The line before last is ``nvidia-smi``'s; before it, one JSON object with
a record per kernel, and before that the script's wall time. The last line
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a card, or without the package beside it, the script exits
non-zero and prints no result. Every device time of a kernel record is
taken with L2 flushed before each call (``FLUSH_BYTES``), so the bytes of
its bound come from HBM in the timed call too.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM rate, dense bf16 and TF32 tensor-core rates,
# the f32 rate of the CUDA cores and the dense int8 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1979e12     # dense int8 tensor cores
# exponentials per clock per SM from the special-function units (the CUDA
# programming guide's throughput table, compute capability 9.0)
SFU_EXP_PER_CLK_PER_SM = 16

BATCH = 128
N_STEPS = 8
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SERVING_ATTN_ULPS = 4
YOLO_BATCH = 32
YOLO_STEPS = 4
MASK_TOL = 1e-5
DETECTION_KEYS = ("boxes", "scores", "classes", "valid", "indices")
TRAIN_BATCH = 16
TRAIN_WARMUP = 6          # the first steps pin and cache host buffers
TRAIN_TURN = 5            # timed steps per turn; six turns per arm
GATHER_TOL = 1e-5         # of the largest magnitude; sums reordered
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
HF_BATCH = 32             # the HF-architecture predict run's micro-batch
HF_STEPS = 4
# bytes written before each timed call of a kernel record, twice the 50 MB
# L2, so that every call finds its inputs in HBM, as the bounds count them
# (0: no flush)
FLUSH_BYTES = 128 * 2**20
# traces of one device_ms call before it gives up on seeing device events
PROFILER_ATTEMPTS = 10
# head dims of phase 14: every instantiation of the attention kernel (16,
# 32, 64, 128, 256), short ones padded (1, 8, 24, 37, 48), column blocks
# (80, 100, 200), and off 16-byte alignment (1, 37, 100 in bf16)
HEAD_DIMS = (1, 8, 16, 24, 32, 37, 48, 64, 80, 100, 128, 200, 256)
WIDE_NMS_K = (1025, 1500, 2048, 4096)
VOLUME_SEEDS = range(100, 104)  # phase 19: the accuracy harness's first four
TEMPORAL_T = 8            # phase 21's sequence
TEMPORAL_IMG = 640
TEMPORAL_ANOMALY_TOL = 1e-4
TEMPORAL_STEPS = 4        # phase 22: 50-frame chunks in the slab
TEMPORAL_RUNNER_FRAMES = 170
# phases 23-24: the other YOLO configurations, each predict run's
# (n_steps, batch) and the (kernels, plain, plain, kernels) turns per run
YOLO_FLAVOURS = ("yolov9c-seg", "yolo11n", "yolov5su")
YOLO_FLAVOUR_SLABS = {"yolov9c-seg": (4, 32), "yolo11n": (2, 32),
                      "yolov5su": (2, 32)}
FLAVOUR_TURNS = 2
# phase 25: the configurations of the card-vs-CPU step, its frame side, and
# the steps on one batch whose loss must fall
YOLO_TRAIN_NAMES = ("yolov8n-seg", "yolov9c-seg", "yolo11n", "yolov5su")
YOLO_CHECK_IMG = 128
YOLO_TRAIN_LOSS_STEPS = 20
# phase 26: the harness's first two temporal train volumes, the steps of
# each variant and the steps of a timed turn
TEMPORAL_TRAIN_SEEDS = range(200, 202)
TEMPORAL_TRAIN_STEPS = 20
TEMPORAL_TURN = 4
# phases 27-28: the served signal request (the largest batch bucket, the
# recipe's seq_len and signal_length), the ragged one, the card-vs-CPU
# limit on every output, and the endpoint's timed turns
SIGNAL_SHAPE = (16, 50, 320)
SIGNAL_RAGGED = (3, 37, 320)
SIGNAL_TOL = 1e-4
SIGNAL_TURNS = 6
SIGNAL_CALLS = 20
# phases 29-31: the signal domain trained
SIGNAL_CHECK_SHAPE = (2, 50, 320)   # phase 29's card-against-CPU steps
SIGNAL_TRAIN_SHAPE = (8, 50, 320)   # the detection recipe's batch
SIGNAL_LOSS_STEPS = 20
SIGNAL_TRAIN_TURN = 10
# phases 32-34: the int8 sites of the D-FINE-nano serving configuration
# (HGNet stages 2-3 and the hybrid encoder) and of YOLOv8n-seg
INT8_DFINE_SITES = 69
INT8_YOLO_SITES = 66


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def short_name(sym: str) -> str:
    """A mangled kernel name's last component, with its raw template
    arguments: ``_ZN12_GLOBAL__N_111attn_kernelILi16ELi16ELb1EEEv..`` ->
    ``attn_kernel<Li16,Li16,Lb1>``."""
    i, name = (3 if sym.startswith("_ZN") else 2), sym
    while i < len(sym) and sym[i].isdigit():
        n = re.match(r"\d+", sym[i:]).group()
        i += len(n)
        name, i = sym[i:i + int(n)], i + int(n)
    if sym[i:i + 1] == "I":
        name += "<" + sym[i + 1:sym.find("EE", i)].replace("E", ",") + ">"
    return name


def ptxas_summary(log: str) -> list:
    """"kernel: registers, static shared bytes, spill bytes" of each entry
    function in an ``nvcc -Xptxas -v`` log."""
    rows, name, spill = [], "", 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = short_name(entry.group(1))
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if stores:
            spill = int(stores.group(1)) + int(stores.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append(f"{name}: {used.group(1)} registers, "
                        f"{smem.group(1) if smem else 0} B shared, "
                        f"{spill} B spilled")
            name, spill = "", 0
    return rows

def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median time of one call between a CUDA event pair recorded around
    it: the card's time, or the host's where the card waits for the
    call's Python wrapper."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flush_l2(buf) -> None:
    """Overwrite ``buf`` (FLUSH_BYTES on the card) in place, which evicts
    whatever the 50 MB L2 held: a ``bitwise_not`` kernel, a name no kernel
    record's own work launches, so :func:`device_ms` can leave it out."""
    import torch

    torch.bitwise_not(buf, out=buf)


def device_ms(fn, reps: int = 20, parts: dict = None) -> float:
    """Device time of one call: the kernels, memsets and copies that
    ``reps`` calls put on the card, as ``torch.profiler`` traces them, each
    name's mean duration times its launches a call. Unlike :func:`time_ms`
    it leaves out the gaps in which the card waits for the host. Before
    each call L2 is flushed (:func:`flush_l2`, left out of the sum), so
    each call reads its inputs from HBM, as the first call of a step
    finds them. Fills ``parts``, if given, with the ms per call of each
    kernel name."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    buf = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    flush = flush_l2 if FLUSH_BYTES else (lambda _: None)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # a trace now and then comes back without its device events (seen
    # once in some hundred traces of this script on the card, and two
    # traces in a row twice in 200 back-to-back traces; three in a row
    # failed a run once): trace again
    for _ in range(PROFILER_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                flush(buf)
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and "bitwise_not" not in e.name]
        if events:
            break
    check(bool(events), "the profiler saw no device activity")
    # a trace also misses some of its device events now and then (one or
    # two of a kernel's 20 in several traces of this script on the card,
    # and once 18 of 20): every call puts the same kernels on the card, so
    # a name's time a call is its mean duration times its launches a
    # call, its count over reps rounded, at least one
    durations = {}
    for e in events:
        durations.setdefault(e.name, []).append(
            (e.time_range.end - e.time_range.start) / 1e3)
    per_call = {name: sum(d) / len(d) * max(1, round(len(d) / reps))
                for name, d in durations.items()}
    for full, ms in per_call.items() if parts is not None else ():
        name = re.split(r"[<(]", full.replace("(anonymous namespace)::",
                                              ""))[0]
        name = (name.split("::")[-1].split() or ["?"])[-1]
        parts[name] = parts.get(name, 0.0) + ms
    return sum(per_call.values())


def kernel_times(fn, plain, library=None) -> dict:
    """A kernel record's times: the device time per call of the kernel
    (``ms``), of its plain version and of the library call, and one call
    through the wrapper between CUDA events (``call_ms``), which includes
    the host time of the wrapper where the card waits for it; ``parts``:
    the kernel's device time by the name of each launch."""
    parts = {}
    return dict(ms=device_ms(fn, parts=parts), parts=parts,
                plain_ms=device_ms(plain),
                library_ms=None if library is None else device_ms(library),
                call_ms=time_ms(fn))


def print_record(phase: str, r: dict, per: str) -> None:
    library = (f"library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None
               else f"no library call ({r['library_note']})")
    parts = ", ".join(f"{k} {v:.4f}" for k, v in r["parts"].items())
    print(f"[{phase} {r['name']}] {r['shape']}: device time per call "
          f"(profiler) kernel {r['ms']:.4f} ms ({parts}), plain "
          f"{r['plain_ms']:.4f} "
          f"ms, {library}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
          f"one call through the wrapper, CUDA events, {r['call_ms']:.4f} "
          f"ms; {r['launches']} launches {per}, max |err| "
          f"{r['max_abs_err']:.3g}", flush=True)


def attention_record(torch, name: str, q, k, v, heads: int, launches: int,
                     err: float, note: str) -> dict:
    """The kernel record of the AIFI attention at the (B, N, D) inputs a
    run gave it: device times of the kernel, its plain version and SDPA at
    the same (B, heads, N, dh), and the bound, the largest of the bytes
    (q, k, v read, o written), the products and the B*H*N^2 exponentials
    on the SFUs (16 a clock on each SM at the card's clocks.max.sm). bf16
    products count at the bf16 tensor-core peak; f32-accurate products at
    the faster of the CUDA cores' f32 peak and three TF32 products each
    (3xTF32) at the TF32 tensor-core peak, whatever design ships."""
    from pautdx_torch.ops import attention

    B, N, D = q.shape
    dh = D // heads
    qh, kh, vh = (t.reshape(B, N, heads, dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    F = torch.nn.functional
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4 * B * heads * N * N * dh
    exps = B * heads * N * N
    f_sm = max_sm_clock_hz()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S,
             "exp": exps / (SFU_EXP_PER_CLK_PER_SM * n_sm * f_sm)}
    if q.dtype == torch.bfloat16:
        terms["operations"] = flops / PEAK_BF16_FLOP_PER_S
        rates = f"{flops} FLOP at {PEAK_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s"
    else:
        terms["f32 CUDA cores"] = flops / PEAK_F32_FLOP_PER_S
        terms["3xTF32"] = 3 * flops / PEAK_TF32_FLOP_PER_S
        terms["operations"] = min(terms["f32 CUDA cores"], terms["3xTF32"])
        rates = (f"{flops} FLOP at {PEAK_F32_FLOP_PER_S / 1e12:.0f} "
                 f"TFLOP/s on the CUDA cores or 3 x that at "
                 f"{PEAK_TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s TF32")
    bound = max(terms["bytes"], terms["exp"], terms["operations"])
    return dict(
        name=name, route="cuda", source="pautdx_torch/csrc/aifi_attention.cu",
        replaces="pautdx/ops/pallas_attention.py:35", launches=launches,
        max_abs_err=err,
        **kernel_times(
            lambda: attention.aifi_attention(q, k, v, heads),
            lambda: attention.aifi_attention_reference(q, k, v, heads),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)),
        bound_ms=1e3 * bound,
        # the exponentials are operations too, on the SFUs
        bound_by="bytes" if terms["bytes"] >= bound else "operations",
        shape=f"q/k/v {tuple(q.shape)} {str(q.dtype).split('.')[1]}, "
              f"{heads} heads of {dh}, {note}; bound terms (ms) " + ", ".join(
                  f"{k} {1e3 * t:.4f}" for k, t in terms.items())
              + f" ({nbytes} bytes, {rates}, {exps} exponentials over {n_sm} "
              f"SMs x {SFU_EXP_PER_CLK_PER_SM} x {f_sm / 1e6:.0f} MHz "
              f"clocks.max.sm)")


def onehot_record(torch, dev, flat, idx, launches: int, name: str) -> dict:
    """The record of the one-hot gather at inputs a run gave it, after
    checking it against its plain version bit for bit; the bound is the
    bytes of the output, the indices and the distinct rows read, the
    library call ``flat[b_idx, idx]``."""
    from pautdx_torch.ops import gather

    got = gather.onehot_gather(flat, idx)
    want = gather.onehot_gather_reference(flat, idx)
    check(torch.equal(got, want), f"{name}: the one-hot gather differs from "
          f"its plain version")
    Bf, Lf, C = flat.shape
    rows = torch.unique(idx.long().clamp(0, Lf - 1)
                        + Lf * torch.arange(Bf, device=dev)[:, None]).numel()
    nbytes = (got.numel() * got.element_size() + idx.numel() * 4
              + rows * C * flat.element_size())
    b_idx = torch.arange(Bf, device=dev)[:, None].expand_as(idx)
    idx_long = idx.long()
    return dict(
        name=name, route="cuda",
        source="pautdx_torch/csrc/onehot_gather.cu",
        replaces="pautdx/ops/pallas_gather.py:36",
        launches=launches, max_abs_err=max_abs_err(got, want),
        **kernel_times(lambda: gather.onehot_gather(flat, idx),
                       lambda: gather.onehot_gather_reference(flat, idx),
                       lambda: flat[b_idx, idx_long]),
        bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes",
        shape=f"flat {tuple(flat.shape)} {str(flat.dtype).split('.')[1]}, "
              f"idx {tuple(idx.shape)}, {rows} distinct rows, {nbytes} "
              f"bytes")


def nms_record(torch, captured: dict, launches: int, name: str) -> dict:
    """The NMS sweep kernel's record at the inputs a predict run gave it:
    checked bit for bit against its plain version, timed beside it, its
    bound the bytes this run's data needs."""
    from pautdx_torch.ops import suppress

    iou, valid, thr = captured["nms_suppress"]
    got = suppress.nms_suppress(iou, valid, thr)
    want = suppress.nms_suppress_reference(iou, valid, thr)
    check(torch.equal(got, want), f"{name}: predict nms differs from plain")
    Bn, Kn = valid.shape
    # bytes this run's data needs: the part j > i of each row i that is
    # still alive at its step (its final keep), valid read and keep written
    alive = (want > 0).nonzero()[:, 1]
    nbytes = 4 * int((Kn - 1 - alive).sum()) + 2 * 4 * Bn * Kn
    return dict(
        name=name, route="cuda", source="pautdx_torch/csrc/nms_suppress.cu",
        replaces="pautdx/ops/pallas_nms.py:30",
        launches=launches, max_abs_err=max_abs_err(got, want),
        **kernel_times(
            lambda: suppress.nms_suppress(iou, valid, thr),
            lambda: suppress.nms_suppress_reference(iou, valid, thr)),
        bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes",
        library_note="no single PyTorch call computes the greedy sweep "
                     "over a precomputed IoU matrix (torchvision's nms "
                     "takes boxes and is not part of PyTorch)",
        shape=f"iou {tuple(iou.shape)} f32, {int(valid.sum())} valid, "
              f"{int(want.sum())} kept, {nbytes} bytes needed of "
              f"{iou.numel() * 4} ({Kn} candidates an image)")


def masks_record(torch, dev, captured: dict, launches: int,
                 name: str) -> dict:
    """The mask decode kernel's record at the inputs a predict run gave
    it: within ``MASK_TOL`` of its plain version, timed beside it, its
    bound the larger of its bytes and the dot products inside the boxes."""
    from pautdx_torch.ops import masks

    protos, coeffs, mboxes, img_size = captured["assemble_masks"]
    got = masks.assemble_masks(protos, coeffs, mboxes, img_size)
    want = masks.assemble_masks_reference(protos, coeffs, mboxes, img_size)
    err = max_abs_err(got, want)
    check(err <= MASK_TOL, f"{name}: predict masks max |err| {err:.3g}")
    Bm, Hp, Wp, P = protos.shape
    nbytes = 4 * (protos.numel() + coeffs.numel() + mboxes.numel()
                  + got.numel())
    # the dot products this run's boxes need: one per pixel inside a box
    sx, sy = Wp / img_size[1], Hp / img_size[0]
    pb = mboxes * torch.tensor([sx, sy, sx, sy], device=dev)
    cols = torch.arange(Wp, device=dev, dtype=torch.float32)
    rows = torch.arange(Hp, device=dev, dtype=torch.float32)
    in_x = ((cols >= pb[..., 0:1]) & (cols < pb[..., 2:3])).sum(-1)
    in_y = ((rows >= pb[..., 1:2]) & (rows < pb[..., 3:4])).sum(-1)
    flops = 2 * P * int((in_x * in_y).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return dict(
        name=name, route="cuda", source="pautdx_torch/csrc/assemble_masks.cu",
        replaces="pautdx/ops/pallas_mask.py:33",
        launches=launches, max_abs_err=err,
        **kernel_times(
            lambda: masks.assemble_masks(protos, coeffs, mboxes, img_size),
            lambda: masks.assemble_masks_reference(protos, coeffs, mboxes,
                                                   img_size)),
        bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_note="no single PyTorch call computes sigmoid(coeffs . "
                     "protos) cropped to each box; a batched matmul leaves "
                     "out the sigmoid and the crop",
        shape=f"protos {tuple(protos.shape)}, coeffs {tuple(coeffs.shape)} "
              f"f32 (protos contiguous: {protos.is_contiguous()}), {nbytes} "
              f"bytes, {flops} FLOP inside the boxes")


def max_abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def within(got, want) -> float:
    """max |got - want| over the largest |want|; checked <= 1e-5."""
    return max_abs_err(got, want) / want.abs().max().item()


def matched_costs(cost: np.ndarray) -> np.ndarray:
    """Costs of the minimum-cost perfect matching of a square cost matrix,
    one per row (the Hungarian method with potentials)."""
    n = cost.shape[0]
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    row_of = np.zeros(n + 1, dtype=int)      # column j -> its row (1-based)
    way = np.zeros(n + 1, dtype=int)
    for i in range(1, n + 1):
        row_of[0] = i
        j0 = 0
        minv = np.full(n + 1, np.inf)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = row_of[j0]
            free = ~used[1:]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            cand = np.where(free, minv[1:], np.inf)
            j1 = int(np.argmin(cand)) + 1
            delta = cand[j1 - 1]
            u[row_of[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if row_of[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            row_of[j0] = row_of[j1]
            j0 = j1
    rows = row_of[1:] - 1
    return cost[rows, np.arange(n)]


def same_detections(logits_a, boxes_a, logits_b, boxes_b) -> str:
    """The criterion of tests/test_dfine_parity.py: a bijection between the
    two query sets in which all but at most 4 pairs of (box, sigmoid score)
    lie within 2e-3 and the median pair within 1e-3. Returns "" or why
    not."""
    for b in range(logits_a.shape[0]):
        fa = np.concatenate([boxes_a[b], 1 / (1 + np.exp(-logits_a[b]))], -1)
        fb = np.concatenate([boxes_b[b], 1 / (1 + np.exp(-logits_b[b]))], -1)
        cost = np.linalg.norm(fa[:, None, :] - fb[None, :, :], axis=-1)
        m = matched_costs(cost)
        if (m < 2e-3).sum() < m.shape[0] - 4 or np.median(m) >= 1e-3:
            return (f"frame {b}: worst matched costs {np.sort(m)[-6:]}, "
                    f"median {np.median(m):.3g}")
    return ""


@contextmanager
def swapped(wrappers: dict, make):
    """Replace each kernel wrapper ``module.<name>`` by ``make(name,
    module, wrapper)`` for a while; the call sites look the wrapper up in
    its module at every call."""
    saved = {name: getattr(mod, name) for name, mod in wrappers.items()}
    for name, mod in wrappers.items():
        setattr(mod, name, make(name, mod, saved[name]))
    try:
        yield
    finally:
        for name, mod in wrappers.items():
            setattr(mod, name, saved[name])


def plain_kernels(wrappers: dict):
    """Route the kernel calls to the plain versions for a while."""
    return swapped(wrappers, lambda name, mod, fn: getattr(
        mod, f"{name}_reference"))


def first_inputs(wrappers: dict, captured: dict):
    """Keep the arguments of the first call of each kernel wrapper."""
    def make(name, mod, fn):
        def wrapper(*args):
            captured.setdefault(name, args)
            return fn(*args)
        return wrapper
    return swapped(wrappers, make)


@contextmanager
def deterministic():
    """cuDNN's and PyTorch's deterministic algorithms for a while, so
    that a plain training step gives the same gradients bit for bit at
    every run (the kernels' shared-memory atomics still add in an order
    that varies). cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` from its first
    call on, which :func:`main` sets."""
    import torch

    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1])


def onehot_reordered(gather) -> dict:
    """The discrete step's reordering: the plain one-hot gather over the
    taps in reverse order, so its backward's sums run reversed."""
    return {"the one-hot taps reversed": {
        "onehot_gather": lambda flat, idx: gather.onehot_gather_reference(
            flat, idx.flip(1)).flip(1)}}


def weighted_reorderings(gather) -> dict:
    """The bilinear step's reorderings: the plain weighted gather with
    its taps, its four corners, or both in reverse order."""
    ref = gather.weighted_gather_reference
    return {
        "the taps reversed": {"weighted_gather": lambda flat, idx, w: ref(
            flat, idx.flip(1), w.flip(1)).flip(1)},
        "the corners reversed": {"weighted_gather": lambda flat, idx, w: ref(
            flat, idx.flip(2), w.flip(2))},
        "both reversed": {"weighted_gather": lambda flat, idx, w: ref(
            flat, idx.flip(1, 2), w.flip(1, 2)).flip(1)}}


def set_tf32(on: bool) -> None:
    """The process-wide TF32 switches of cuDNN convolutions and of GEMMs."""
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def reset_counts(counters: dict) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def launch_counts(counters: dict) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def grad_floor(want: dict) -> float:
    """1e-6 of the gradient's global norm: leaves below it are zero up to
    float noise (a bias in front of a train-mode BatchNorm, a key bias
    under the softmax)."""
    return 1e-6 * sum(float(w.double().pow(2).sum())
                      for w in want.values()) ** 0.5


def leaf_errors(got: dict, want: dict) -> dict:
    """Per leaf ||got - want|| / ||want|| over the leaves above the floor."""
    floor = grad_floor(want)
    return {name: (got[name] - w).norm().item() / w.norm().item()
            for name, w in want.items() if w.norm().item() >= floor}


def relative_grad_errors(got: dict, want: dict) -> tuple:
    """The worst of :func:`leaf_errors` and its leaf, and the worst
    absolute error of the leaves below the floor, which are held to it.
    Returns (worst relative, its leaf, worst noise error, the floor)."""
    floor = grad_floor(want)
    errs = leaf_errors(got, want)
    leaf = max(errs, key=errs.get, default="")
    noise = max(((got[n] - w).norm().item() for n, w in want.items()
                 if n not in errs), default=0.0)
    return errs.get(leaf, 0.0), leaf, noise, floor


def global_grad_error(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over all leaves together."""
    num = sum(float((got[n] - w).double().pow(2).sum())
              for n, w in want.items())
    den = sum(float(w.double().pow(2).sum()) for w in want.values())
    return (num / den) ** 0.5


def step_check(torch, dev, counters: dict, wrappers: dict, none: dict,
               batch: dict, size: int):
    """Phase 12's check of one training step, for phases 12, 20 and 26:
    ``kernels_vs_plain(cfg, want_counts, reorderings=None,
    denoising=None, captured=None, phase="12", model=None, objective=None,
    forward=None, what=None)`` runs one step of ``cfg`` on ``batch``
    through the kernels and one through the plain versions from the same
    weights (and the same denoising group, if given), under
    :func:`deterministic`, applies phase 12's gates, prints them and
    returns the model; ``captured`` keeps the kernel step's first inputs
    of each wrapper. ``model``, ``objective`` and ``forward(model)`` stand
    in for ``DFine(cfg)``, ``dfine_objective`` and its training forward
    (phase 26's temporal model), ``what`` names the step."""
    from pautdx_torch.models.vision.dfine import DFine
    from pautdx_torch.ops import gather
    from pautdx_torch.train.detector import dfine_objective

    def model_step(model, objective, start, denoising=None,
                   forward=None) -> tuple:
        """The loss and the gradients of one step from ``start``, through
        whatever the wrappers are now."""
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        if forward is not None:
            out = forward(model)
        elif denoising is None:
            out = model(batch["images"], train=True)
        else:
            out = model(batch["images"], train=True, denoising=denoising)
            out = {**out, "denoising": denoising}
        loss, _ = objective(out, batch)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {
            n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}

    def one_step(model, objective, start, plain: bool, denoising,
                 captured, forward=None):
        reset_counts(counters)
        with (plain_kernels(wrappers) if plain
              else first_inputs(wrappers, captured) if captured is not None
              else nullcontext()):
            loss, grads = model_step(model, objective, start, denoising,
                                     forward)
        return (loss, grads,
                {k: v.clone() for k, v in model.named_buffers()},
                launch_counts(counters))

    def kernels_vs_plain(cfg, want_counts: dict, reorderings=None,
                         denoising=None, captured=None, phase="12",
                         model=None, objective=None, forward=None,
                         what=None):
        """One step of ``cfg`` through the kernels and one through the
        plain versions: the checks of phase 12 and what they read. With
        ``reorderings`` ({what: wrappers to the plain versions summing in
        another order}), one more plain step for each measures how far
        the plain step's own gradients move when only the order of a sum
        changes, leaf by leaf; a leaf may then differ by twice the most
        of these moves, the 1e-3 holding for the gradient as a whole and
        as the floor of every leaf; one more kernel step prints how far
        the kernels' own order moves them from run to run."""
        model = DFine(cfg, device=dev, seed=0) if model is None else model
        objective = objective or dfine_objective(size, cfg)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        if what is None:
            what = f"decoder_method={cfg.decoder_method!r}"
            if denoising is not None:
                what += (f" with {denoising['class_ids'].shape[1]} "
                         f"denoising queries")
        with deterministic():
            return checked_step(model, objective, start, want_counts,
                                reorderings, denoising, captured, phase,
                                forward, what)

    def checked_step(model, objective, start, want_counts, reorderings,
                     denoising, captured, phase, forward, what):
        loss_k, grads_k, bufs_k, counts_k = one_step(
            model, objective, start, False, denoising, captured, forward)
        loss_p, grads_p, bufs_p, counts_p = one_step(
            model, objective, start, True, denoising, None, forward)
        check(counts_k == dict(none, **want_counts),
              f"{what}: one training step launched {counts_k}, want "
              f"{want_counts}")
        check(counts_p == none, f"{what}: the plain step launched {counts_p}")
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        check(loss_err <= TRAIN_LOSS_TOL, f"{what}: train loss kernels "
              f"{loss_k} vs plain {loss_p}")
        grad_err, grad_leaf, noise, floor = relative_grad_errors(grads_k,
                                                                 grads_p)
        check(noise <= floor, f"{what}: noise leaves {noise:.3g} (floor "
              f"{floor:.3g})")
        if reorderings is None:
            check(grad_err <= TRAIN_GRAD_TOL, f"{what}: gradients: worst "
                  f"relative {grad_err:.3g} at {grad_leaf}")
            grads_note = (f"worst gradient relative error {grad_err:.3g} "
                          f"({grad_leaf}) <= {TRAIN_GRAD_TOL}")
        else:
            spread = {}
            for reordered in reorderings.values():
                with plain_kernels(wrappers), swapped(
                        dict.fromkeys(reordered, gather),
                        lambda name, mod, fn: reordered[name]):
                    moved = leaf_errors(model_step(model, objective, start,
                                                   denoising, forward)[1],
                                        grads_p)
                spread = {n: max(e, spread.get(n, 0.0))
                          for n, e in moved.items()}
            # the kernel step once more: how far its own sums' order moves
            # it from run to run (printed, not gated)
            rerun = leaf_errors(one_step(model, objective, start, False,
                                         denoising, None, forward)[1],
                                grads_k)
            errs = leaf_errors(grads_k, grads_p)
            limit = {n: max(TRAIN_GRAD_TOL, 2 * spread[n]) for n in errs}
            over = {n: (e, limit[n]) for n, e in errs.items()
                    if e > limit[n]}
            whole = global_grad_error(grads_k, grads_p)
            check(not over and whole <= TRAIN_GRAD_TOL,
                  f"{what}: gradients beyond their limits {over}, as a "
                  f"whole {whole:.3g}")
            top = max(spread, key=spread.get)
            grads_note = (f"gradient relative error as a whole "
                          f"{whole:.3g} <= {TRAIN_GRAD_TOL}; worst leaf "
                          f"{grad_err:.3g} ({grad_leaf}, norm "
                          f"{grads_p[grad_leaf].norm().item():.3g}), the "
                          f"plain step itself moving up to "
                          f"{spread[top]:.3g} ({top}) "
                          f"with {' / '.join(reorderings)}; every leaf "
                          f"within max({TRAIN_GRAD_TOL}, 2x that); the "
                          f"kernel step run again moving up to "
                          f"{max(rerun.values()):.3g} "
                          f"({max(rerun, key=rerun.get)})")
        bn_err = max(max_abs_err(bufs_k[k], bufs_p[k]) for k in bufs_p)
        check(bn_err <= 1e-5, f"{what}: BN running statistics differ by "
              f"{bn_err:.3g}")
        print(f"[{phase} train model] {what}, 640px f32 batch "
              f"{batch['images'].shape[0]}, TF32 off: "
              f"loss through the kernels {loss_k:.6f}, plain {loss_p:.6f} "
              f"(relative {loss_err:.3g} <= {TRAIN_LOSS_TOL}); "
              f"{grads_note}; noise-level leaves within {noise:.3g} "
              f"(floor {floor:.3g}); BN statistics max |err| {bn_err:.3g}; "
              f"launches per step {counts_k}", flush=True)
        return model

    return kernels_vs_plain


def gather_records(torch, dev, captured: dict, dcaptured, counts: dict,
                   dcounts, suffix: str = "") -> list:
    """The records of the weighted gather, its backward and the one-hot
    gather's backward at the inputs that training steps gave them
    (``captured`` from a bilinear step, ``dcaptured`` from a discrete one,
    each with its launch counts; without a discrete step, ``dcaptured``
    None, no one-hot record), each beside its plain version and its
    library call; the names carry ``suffix``. Checks the kernels against
    the plain versions at those inputs (relative to the largest
    magnitude, ``GATHER_TOL``)."""
    import torch.nn.functional as F

    from pautdx_torch.ops import gather

    flat, idx, w = (t.detach() for t in captured["weighted_gather"])
    _, _, _, g = (t.detach() for t in captured["weighted_gather_backward"])
    B, L, C = flat.shape
    T, K = idx.shape[1:]
    with torch.no_grad():
        got = gather.weighted_gather(flat, idx, w)
        want = gather.weighted_gather_reference(flat, idx, w)
        d_got = gather.weighted_gather_backward(flat, idx, w, g)
        d_want = gather.weighted_gather_backward_reference(flat, idx, w, g)
    rel = [within(got, want), within(d_got[0], d_want[0]),
           within(d_got[1], d_want[1])]
    if dcaptured is not None:
        og, oidx, oL = dcaptured["onehot_gather_backward"]
        og, oidx = og.detach(), oidx.detach()
        with torch.no_grad():
            o_got = gather.onehot_gather_backward(og, oidx, oL)
            o_want = gather.onehot_gather_backward_reference(og, oidx, oL)
        rel.append(within(o_got, o_want))
    check(max(rel) <= GATHER_TOL, f"training-step gather{suffix} relative "
          f"errors (out, d_flat, d_w[, one-hot d_flat]) {rel}")
    fwd_err = max_abs_err(got, want)
    bwd_err = max(max_abs_err(d_got[0], d_want[0]),
                  max_abs_err(d_got[1], d_want[1]))
    plan = gather.weighted_plan(B, T, K, C * flat.element_size(),
                                torch.cuda.get_device_properties(
                                    dev).multi_processor_count)
    rows = torch.unique(idx.long().clamp(0, L - 1)
                        + L * torch.arange(B, device=dev)[:, None, None])
    table_bytes = rows.numel() * C * 4          # the rows the taps touch
    tap_bytes = 2 * idx.numel() * 4             # idx and w
    out_bytes = B * T * C * 4
    # embedding_bag over fixed bags of K rows: the same function
    table = flat.reshape(B * L, C)
    bag_idx = (idx.long().clamp(0, L - 1) + L * torch.arange(
        B, device=dev)[:, None, None]).reshape(B * T, K)
    bag_w = w.reshape(B * T, K)

    def bag(tab, wts):
        return F.embedding_bag(bag_idx, tab, mode="sum",
                               per_sample_weights=wts)

    tab_r = table.clone().requires_grad_()
    w_r = bag_w.clone().requires_grad_()
    bag_out = bag(tab_r, w_r)
    bag_g = g.reshape(B * T, C)
    kernels = [
        ("weighted_gather", 134, fwd_err,
         table_bytes + tap_bytes + out_bytes, 2 * K * C * B * T,
         lambda: gather.weighted_gather(flat, idx, w),
         lambda: gather.weighted_gather_reference(flat, idx, w),
         lambda: bag(table, bag_w),
         f"flat {tuple(flat.shape)}, idx/w {tuple(idx.shape)} f32, "
         f"{rows.numel()} distinct rows of {B * L}; plan {plan.group} taps "
         f"a group, {plan.blocks} blocks of {plan.warps} warps; library: "
         f"embedding_bag over bags of {K}"),
        ("weighted_gather_backward", 196, bwd_err,
         out_bytes + table_bytes + tap_bytes + B * L * C * 4
         + idx.numel() * 4, 4 * K * C * B * T,
         lambda: gather.weighted_gather_backward(flat, idx, w, g),
         lambda: gather.weighted_gather_backward_reference(
             flat, idx, w, g),
         lambda: torch.autograd.grad(bag_out, (tab_r, w_r), bag_g,
                                     retain_graph=True),
         f"flat {tuple(flat.shape)}, idx/w {tuple(idx.shape)} f32, "
         f"{rows.numel()} distinct rows of {B * L}; library: "
         f"embedding_bag's backward to both inputs")]
    if dcaptured is not None:
        # F.embedding over the clipped rows of all frames: its backward is
        # the one-hot gather's
        Bo, To, Co = og.shape
        o_rows = (oidx.long().clamp(0, oL - 1)
                  + oL * torch.arange(Bo, device=dev)[:, None])
        emb_table = torch.zeros((Bo * oL, Co), device=dev,
                                requires_grad=True)
        emb_out = F.embedding(o_rows, emb_table)
        kernels.append((
            "onehot_gather_backward", 107, max_abs_err(o_got, o_want),
            og.numel() * 4 + Bo * oL * Co * 4 + oidx.numel() * 4,
            Bo * To * Co,
            lambda: gather.onehot_gather_backward(og, oidx, oL),
            lambda: gather.onehot_gather_backward_reference(og, oidx, oL),
            lambda: torch.autograd.grad(emb_out, emb_table, og,
                                        retain_graph=True),
            f"g {tuple(og.shape)} f32, idx {tuple(oidx.shape)}, L {oL}, "
            f"{torch.unique(o_rows).numel()} distinct rows of {Bo * oL}; "
            f"library: F.embedding's backward"))
    records = []
    for name, line, err, nbytes, flops, fn, plain, library, shape in kernels:
        parts = {}
        with torch.no_grad() if name == "weighted_gather" else nullcontext():
            t_ms = device_ms(fn, parts=parts)
            p_ms, l_ms = device_ms(plain), device_ms(library)
            call_ms = time_ms(fn)
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = flops / PEAK_F32_FLOP_PER_S
        records.append(dict(
            name=name + suffix, route="cuda",
            source="pautdx_torch/csrc/weighted_gather.cu",
            replaces=f"pautdx/ops/pallas_gather.py:{line}",
            launches=(dcounts if name.startswith("onehot")
                      else counts)[name],
            max_abs_err=err, ms=t_ms, parts=parts, plain_ms=p_ms,
            call_ms=call_ms, bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=l_ms,
            shape=f"{shape}; {nbytes} bytes, {flops} FLOP"))
    return records


def train_phases(torch, dev, gen, counters: dict, wrappers: dict,
                 none: dict) -> list:
    """Phases 11-13, the D-FINE-nano training step; returns the records of
    the two weighted gather kernels."""
    from pautdx_torch.models.vision.dfine import DFine, dfine_nano
    from pautdx_torch.ops import gather
    from pautdx_torch.train.checkpoint import restore_dfine
    from pautdx_torch.train.detector import (
        build_dfine_trainer, dfine_metadata, dfine_objective,
        make_train_batches,
    )
    from pautdx_torch.train.optim import make_optimizer
    from pautdx_torch.train.trainer import Trainer

    set_tf32(False)

    # 11. weighted gather kernel vs plain, forward and backward
    def weighted_inputs(B, L, C, T):
        flat = torch.randn((B, L, C), generator=gen, device=dev)
        idx = torch.randint(-3, L + 3, (B, T, 4), generator=gen, device=dev,
                            dtype=torch.int32)
        w = torch.rand((B, T, 4), generator=gen, device=dev)
        w[:, ::7, 2] = 0.0               # a corner off the grid
        g = torch.randn((B, T, C), generator=gen, device=dev)
        return flat, idx, w, g

    worst = {}
    for B, L, C, T, pile_up in ((16, 2000, 128, 1200, False),
                                (3, 50, 128, 37, False),
                                (2, 20000, 128, 500, False),
                                (4, 2000, 128, 1200, True)):
        flat, idx, w, g = weighted_inputs(B, L, C, T)
        if pile_up:
            idx.fill_(L // 2)
        fk, wk = flat.clone().requires_grad_(), w.clone().requires_grad_()
        got = gather.weighted_gather(fk, idx, wk)
        got.backward(g)
        torch.cuda.synchronize()
        fp, wp = flat.clone().requires_grad_(), w.clone().requires_grad_()
        want = gather.weighted_gather_reference(fp, idx, wp)
        want.backward(g)
        errs = (within(got, want), within(fk.grad, fp.grad),
                within(wk.grad, wp.grad))
        case = f"({B}, {L}, {C}) x ({T}, 4)" + (" pile-up" if pile_up else "")
        check(max(errs) <= GATHER_TOL, f"weighted gather {case}: relative "
              f"max |err| (out, d_flat, d_w) {errs} beyond {GATHER_TOL}")
        worst[case] = errs
    print(f"[11 weighted gather] kernel vs plain, f32, rows -3..L+2 "
          f"clamped, corners of weight 0, L=20000 in row ranges, a pile-up "
          f"of every corner of a frame on one row: max |err| / max |value| "
          f"of (out, d_flat, d_w) " + "; ".join(
              f"{k}: " + ", ".join(f"{e:.3g}" for e in v)
              for k, v in worst.items())
          + f" <= {GATHER_TOL} (a row of d_flat sums its taps in an order "
          f"that varies from run to run)", flush=True)
    worst = {}
    for B, L, C, T, pile_up in ((16, 2000, 128, 1200, False),
                                (3, 50, 128, 37, False),
                                (4, 2000, 128, 1200, True)):
        flat = torch.randn((B, L, C), generator=gen, device=dev)
        idx = torch.randint(-3, L + 3, (B, T), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[:, :2] = torch.tensor([-3, L + 2], dtype=torch.int32, device=dev)
        if pile_up:
            idx.fill_(L // 2)
        g = torch.randn((B, T, C), generator=gen, device=dev)
        fk = flat.clone().requires_grad_()
        gather.onehot_gather(fk, idx).backward(g)
        alone = gather.onehot_gather_backward(g, idx, L)
        torch.cuda.synchronize()
        want = gather.onehot_gather_backward_reference(g, idx, L)
        errs = (within(fk.grad, want), within(alone, want))
        case = f"({B}, {L}, {C}) x {T}" + (" pile-up" if pile_up else "")
        check(max(errs) <= GATHER_TOL, f"one-hot backward {case}: relative "
              f"max |err| (autograd, kernel alone) {errs} beyond "
              f"{GATHER_TOL}")
        worst[case] = errs
    print(f"[11 one-hot backward] kernel vs plain clipped scatter-add, f32, "
          f"indices -3 and L+2 clamped, a pile-up of every tap of a frame on "
          f"one row: max |err| / max |value| of (through autograd, the "
          f"kernel alone) " + "; ".join(
              f"{k}: " + ", ".join(f"{e:.3g}" for e in v)
              for k, v in worst.items())
          + f" <= {GATHER_TOL} (sums in an order that varies)", flush=True)

    # 12. the training model: one step through the kernels vs the plain
    # versions, from the same weights and batch, for the bilinear decoder
    # (the training config) and the discrete one
    size = 640
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in make_train_batches(1, 4, size, seed=5)[0].items()}
    kernels_vs_plain = step_check(torch, dev, counters, wrappers, none,
                                  batch, size)
    cfg = dfine_nano(num_labels=2)
    model = kernels_vs_plain(cfg, dict(weighted_gather=3,
                                       weighted_gather_backward=3))
    kernels_vs_plain(dataclasses.replace(cfg, decoder_method="discrete"),
                     dict(onehot_gather=3, onehot_gather_backward=3),
                     reorderings=onehot_reordered(gather))
    objective = dfine_objective(size, cfg)
    # checkpoint round trip through the trainer's state
    ckpt_dir = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    trainer = Trainer(model, objective, make_optimizer(1e-3),
                      checkpoint_dir=ckpt_dir, input_key="images")
    state = trainer.init(batch)
    trainer.train_step(state, batch)
    saved = state.state_dict()
    trainer.ckpt.save(0, saved, metadata=dfine_metadata(cfg, size),
                      is_best=True)
    restored, loaded, meta = restore_dfine(ckpt_dir, "best", device=dev)

    def tensors(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from tensors(v, f"{prefix}{k}.")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from tensors(v, f"{prefix}{i}.")
        elif isinstance(tree, torch.Tensor):
            yield prefix, tree

    pairs = dict(tensors(loaded))
    same = (dict(tensors(saved)).keys() == pairs.keys()
            and all(torch.equal(v, pairs[k])
                    for k, v in tensors(saved))
            and all(torch.equal(v.cpu(), saved["params"].get(k, saved[
                "batch_stats"].get(k)))
                    for k, v in restored.state_dict().items()))
    check(same and meta["dfine_config"]["decoder_method"] == "default",
          "checkpoint round trip changed a tensor")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"[12 checkpoint] dfine_nano(num_labels=2): round trip of "
          f"{len(pairs)} tensors through the trainer's state identical",
          flush=True)
    del model, trainer, state, restored, saved, loaded

    # 13. the training run
    trainer = build_dfine_trainer(size=size, device=dev, seed=0)
    batches = make_train_batches(4, TRAIN_BATCH, size, seed=6)
    state = trainer.init(batches[0])
    finite = []

    def steps(n: int, first: int = 0) -> float:
        """ms per step over ``n`` steps, CUDA events around them."""
        startev = torch.cuda.Event(enable_timing=True)
        endev = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        startev.record()
        for i in range(n):
            _, m = trainer.train_epoch(state, [batches[(first + i) % 4]])
            finite.append(m["loss_was_finite"] * m["update_was_finite"])
        endev.record()
        endev.synchronize()
        return startev.elapsed_time(endev) / n

    steps(TRAIN_WARMUP)
    captured = {}
    torch.cuda.reset_peak_memory_stats()
    with first_inputs(wrappers, captured):
        reset_counts(counters)
        steps(1, TRAIN_WARMUP)
        run_counts = launch_counts(counters)
    check(run_counts == dict(none, weighted_gather=3,
                             weighted_gather_backward=3),
          f"one training step launched {run_counts}")
    # in turns (kernels, plain, plain, kernels) three times, as phases 6
    # and 10: the host-bound step spreads with the host from turn to turn
    ms = {"kernels": [], "plain": []}
    for arm in ("kernels", "plain", "plain", "kernels") * 3:
        with plain_kernels(wrappers) if arm == "plain" else nullcontext():
            ms[arm].append(steps(TRAIN_TURN, len(finite)))
    peak = torch.cuda.max_memory_allocated()
    check(all(f == 1.0 for f in finite), f"non-finite steps: {finite}")
    ms_k = statistics.median(ms["kernels"])
    ms_p = statistics.median(ms["plain"])
    # 20 steps on one fixed batch from fresh weights: the loss must fall
    fresh = build_dfine_trainer(size=size, device=dev, seed=1)
    fstate = fresh.init(batches[0])
    fixed = [fresh.train_epoch(fstate, batches[:1])[1]["total"]
             for _ in range(20)]
    check(all(np.isfinite(fixed)) and fixed[-1] < fixed[0],
          f"loss over 20 steps on one batch: {fixed}")
    print(f"[13 training run] dfine_nano(num_labels=2) 640px f32 batch "
          f"{TRAIN_BATCH}, lr 1e-3, TF32 off, numpy batches through the "
          f"Trainer's pinned-memory pipeline: median {ms_k:.2f} ms/step "
          f"({TRAIN_BATCH * 1e3 / ms_k:.1f} frames/s) through the kernels, "
          f"turns {[round(m, 2) for m in ms['kernels']]}; median "
          f"{ms_p:.2f} ms/step ({TRAIN_BATCH * 1e3 / ms_p:.1f} frames/s) "
          f"through the plain versions, turns "
          f"{[round(m, 2) for m in ms['plain']]} ({len(ms['plain'])} turns "
          f"of {TRAIN_TURN} steps per arm, CUDA events, after "
          f"{TRAIN_WARMUP} warm-up steps); peak memory "
          f"{peak / 2**30:.3f} GiB; launches per step {run_counts}; "
          f"{len(finite)} steps all finite; loss on "
          f"one batch over 20 steps {fixed[0]:.4f} -> {fixed[-1]:.4f} "
          f"(min {min(fixed):.4f})", flush=True)
    del fresh, fstate

    # the discrete decoder's step on the same batches: the inputs and
    # launches of the one-hot gather's kernels
    dcfg = dataclasses.replace(dfine_nano(num_labels=2),
                               decoder_method="discrete")
    dtrainer = Trainer(DFine(dcfg, device=dev, seed=0),
                       dfine_objective(size, dcfg), make_optimizer(1e-3),
                       input_key="images")
    dstate = dtrainer.init(batches[0])
    dtrainer.train_epoch(dstate, batches[:1])
    dcaptured = {}
    with first_inputs(wrappers, dcaptured):
        reset_counts(counters)
        _, m = dtrainer.train_epoch(dstate, batches[1:2])
        torch.cuda.synchronize()
        dcounts = launch_counts(counters)
    check(dcounts == dict(none, onehot_gather=3, onehot_gather_backward=3),
          f"one discrete training step launched {dcounts}")
    check(m["loss_was_finite"] * m["update_was_finite"] == 1.0,
          "the discrete training step is not finite")
    print(f"[13 discrete step] dfine_nano(num_labels=2, "
          f"decoder_method='discrete') 640px f32 batch {TRAIN_BATCH}: loss "
          f"{float(m['total']):.4f}, finite; launches per step {dcounts}",
          flush=True)
    del dtrainer, dstate

    # the gather kernels at the inputs the training steps gave them
    records = gather_records(torch, dev, captured, dcaptured, run_counts,
                             dcounts)
    for r in records:
        print_record("13", r, "per step")
    return records


def bf16_ulps(want) -> float:
    """One bf16 ulp at the largest magnitude of ``want`` (0 for a float32
    tensor): the rounding an output gets once, which a reordered f32 sum
    can tip to the neighbouring value."""
    import torch

    if want.dtype != torch.bfloat16:
        return 0.0
    return 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)


def hf_phases(torch, dev, gen, counters: dict, wrappers: dict,
              none: dict) -> list:
    """Phases 14-17: the kernels at the inputs the HF-architecture D-FINE
    and the widened envelopes give them, and that model's predict path;
    returns the attention records of the predict runs."""
    from pautdx_torch.models.vision.dfine import DFine
    from pautdx_torch.ops import attention, gather, masks, suppress
    from pautdx_torch.ops.nms import box_iou_matrix
    from pautdx_torch.serve.dfine_predict import (
        build_dfine_predictor, dfine_predict_config, make_dfine_stream,
    )
    from pautdx_torch.serve.throughput import make_uint8_slab, measure_fps

    set_tf32(False)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # 14. attention kernel vs plain at every head dim it pads to, pads, or
    # splits into column blocks
    worst = {}
    for dh in HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            tol = ATTN_TOL[name]
            for n in (400, 37):
                q, k, v = (randn(HF_BATCH, 8, n, dh, dtype=dtype)
                           for _ in range(3))
                q = q * dh ** -0.5
                x = [t.transpose(1, 2).reshape(HF_BATCH, n, 8 * dh)
                     .contiguous() for t in (q, k, v)]
                pairs = ((attention.fused_attention(q, k, v),
                          attention.fused_attention_reference(q, k, v)),
                         (attention.aifi_attention(*x, 8),
                          attention.aifi_attention_reference(*x, 8)))
                torch.cuda.synchronize()
                for got, want in pairs:
                    err = max_abs_err(got, want)
                    check(got.dtype == dtype and got.shape == want.shape,
                          f"attention dh={dh} {name} N={n}: got {got.dtype} "
                          f"{tuple(got.shape)}")
                    check(torch.allclose(got.float(), want.float(), atol=tol,
                                         rtol=tol),
                          f"attention dh={dh} {name} N={n}: max |err| "
                          f"{err:.3g} beyond {tol}")
                    key = f"dh={dh} {name} N={n}"
                    worst[key] = max(worst.get(key, 0.0), err)
    print(f"[14 attention head dims] kernel vs plain at ({HF_BATCH}, 8, N, "
          f"dh), and through the (B, N, D) strides, max |err| "
          + ", ".join(f"{k}: {v:.3g}" for k, v in worst.items())
          + "; phase 3's gates: atol=rtol 1e-5 in f32, 2e-2 in bf16",
          flush=True)
    worst_f32 = max(v for k, v in worst.items() if "float32" in k)
    print(f"[14 attention f32] largest max |err| over every head dim and N: "
          f"{worst_f32:.3g} (3xTF32), gate 1e-5", flush=True)

    # 15. the widened envelopes against their plain versions
    def gate(got, want) -> float:
        """max |got - want| over one bf16 ulp at |want| max (0 in f32) plus
        GATHER_TOL of it; checked <= 1."""
        peak = want.float().abs().max().item()
        return max_abs_err(got, want) / (bf16_ulps(want) + GATHER_TOL * peak)

    B, L, C, T = 16, 2000, 128, 1200
    worst = {}
    for pile_up in (False, True):
        for wdt in (torch.float32, torch.bfloat16):
            flat = randn(B, L, C, dtype=torch.bfloat16)
            idx = torch.randint(-3, L + 3, (B, T, 4), generator=gen,
                                device=dev, dtype=torch.int32)
            if pile_up:
                idx.fill_(L // 2)
            w = torch.rand((B, T, 4), generator=gen, device=dev)
            w[:, ::7, 2] = 0.0
            w = w.to(wdt)
            g = randn(B, T, C, dtype=torch.bfloat16)
            fk, wk = flat.clone().requires_grad_(), w.clone().requires_grad_()
            got = gather.weighted_gather(fk, idx, wk)
            got.backward(g)
            alone = gather.weighted_gather_backward(flat, idx, w, g)
            torch.cuda.synchronize()
            want = gather.weighted_gather_reference(flat, idx, w)
            r_flat, r_w = gather.weighted_gather_backward_reference(
                flat, idx, w, g)
            check(got.dtype == torch.bfloat16 and wk.grad.dtype == wdt
                  and alone[1].dtype == wdt, "weighted gather bf16: dtypes")
            errs = (gate(got, want), gate(fk.grad, r_flat),
                    gate(wk.grad, r_w), gate(alone[0], r_flat),
                    gate(alone[1], r_w))
            case = (f"w {str(wdt).split('.')[1]}"
                    + (" pile-up" if pile_up else ""))
            check(max(errs) <= 1.0, f"weighted gather bf16 {case}: (out, "
                  f"d_flat, d_w, kernel alone) {errs} beyond the gate")
            worst[case] = errs
    flat = randn(B, L, C, dtype=torch.bfloat16)
    for pile_up in (False, True):
        idx = torch.randint(-3, L + 3, (B, T), generator=gen, device=dev,
                            dtype=torch.int32)
        if pile_up:
            idx.fill_(L // 2)
        g = randn(B, T, C, dtype=torch.bfloat16)
        fk = flat.clone().requires_grad_()
        gather.onehot_gather(fk, idx).backward(g)
        alone = gather.onehot_gather_backward(g, idx, L)
        torch.cuda.synchronize()
        want = gather.onehot_gather_backward_reference(g, idx, L)
        errs = (gate(fk.grad, want), gate(alone, want))
        case = "one-hot" + (" pile-up" if pile_up else "")
        check(max(errs) <= 1.0 and alone.dtype == torch.bfloat16,
              f"one-hot backward bf16 {case}: {errs} beyond the gate")
        worst[case] = errs
    print(f"[15 gathers bf16] kernels vs plain at ({B}, {L}, {C}) bf16 x "
          f"({T}, 4) (one-hot: {T}), rows -3..L+2 clamped, corners of "
          f"weight 0, w f32 and bf16, pile-ups: max |err| over (one bf16 "
          f"ulp at |want| max + {GATHER_TOL} of it) for (out, d_flat, d_w, "
          f"d_flat alone, d_w alone) / (through autograd, alone): "
          + "; ".join(f"{k}: " + ", ".join(f"{e:.3g}" for e in v)
                      for k, v in worst.items()) + " <= 1", flush=True)
    worst = {}
    for mb, P, K in ((4, 32, 400), (4, 16, 100), (4, 37, 100)):
        protos = randn(mb, 160, 160, P)
        coeffs = randn(mb, K, P)
        xy = torch.rand((mb, K, 2), generator=gen, device=dev) * 700 - 60
        wh = torch.rand((mb, K, 2), generator=gen, device=dev) * 320
        mboxes = torch.cat([xy, xy + wh], -1)
        got = masks.assemble_masks(protos, coeffs, mboxes, (640, 640))
        torch.cuda.synchronize()
        want = masks.assemble_masks_reference(protos, coeffs, mboxes,
                                              (640, 640))
        err = max_abs_err(got, want)
        check(got.shape == want.shape and err <= MASK_TOL,
              f"masks P={P} K={K}: max |err| {err:.3g} beyond {MASK_TOL}")
        worst[f"({mb}, 160, 160, {P}) x K={K}"] = err
    nb, nk = YOLO_BATCH, 300
    xy = torch.rand((nb, nk, 2), generator=gen, device=dev) * 560
    wh = 10 + torch.rand((nb, nk, 2), generator=gen, device=dev) * 150
    iou = box_iou_matrix(torch.cat([xy, xy + wh], -1)).bfloat16()
    valid = torch.rand((nb, nk), generator=gen, device=dev) > 0.2
    got = suppress.nms_suppress(iou, valid, 0.45)
    torch.cuda.synchronize()
    want = suppress.nms_suppress_reference(iou, valid, 0.45)
    check(torch.equal(got, want), "nms with a bf16 IoU differs from plain")
    print("[15 masks, nms] mask kernel vs plain, f32, boxes off the image "
          "included: max |err| " + ", ".join(
              f"{k}: {v:.3g}" for k, v in worst.items())
          + f" <= {MASK_TOL}; NMS with a bf16 IoU at ({nb}, {nk}) == plain "
          f"bit for bit ({int(want.sum())} kept)", flush=True)

    # 16. the HF-architecture model, f32, kernels vs plain versions
    cfg = dfine_predict_config()
    model = DFine(cfg, device=dev, seed=0)
    frames = make_uint8_slab((4, 640, 640, 3), seed=7,
                             device=dev).float() / 255.0
    outs = {}
    for arm in ("kernels", "plain", "unfused"):
        if arm == "unfused":
            model = DFine(dataclasses.replace(cfg, encoder_fused_attn=False),
                          device=dev, seed=0)
        reset_counts(counters)
        with (plain_kernels(wrappers) if arm == "plain" else nullcontext()), \
                torch.inference_mode():
            out = model(frames)
        torch.cuda.synchronize()
        counts = launch_counts(counters)
        want = dict(none, aifi_attention=1) if arm == "kernels" else none
        check(counts == want, f"HF model {arm} forward launched {counts}, "
              f"want {want}")
        outs[arm] = [out[k].float().cpu().numpy()
                     for k in ("logits", "pred_boxes")]
    for arm in ("plain", "unfused"):
        why = same_detections(*outs["kernels"], *outs[arm])
        check(not why, f"HF model f32, kernels vs {arm}: {why}")
    diffs = {arm: float(np.abs(outs["kernels"][0] - outs[arm][0]).max())
             for arm in ("plain", "unfused")}
    print(f"[16 HF model] DFineConfig(num_labels=2, encoder_fused_attn="
          f"True) 640px f32 batch 4, TF32 off (d_model 256, 8 heads of 32, "
          f"3 levels, 8,400 anchors, 300 queries, 6 decoder layers, per-head "
          f"points): detections through the kernels match the plain "
          f"versions' and the unfused encoder's by assignment (max |logit "
          f"diff| slot by slot {diffs}); one forward launches "
          f"{dict(none, aifi_attention=1)}", flush=True)
    del model, frames, outs

    # 17. the predict runs, f32 (the CLI's precision) and bf16 weights
    records = []
    slab = make_uint8_slab((HF_STEPS, HF_BATCH, 640, 640, 3), seed=8,
                           device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        predictor = build_dfine_predictor(device=dev, seed=0, dtype=dtype)
        stream = make_dfine_stream(predictor)
        stream(slab[:1])                   # warm-up: cuDNN plans, caches
        torch.cuda.synchronize()
        captured = {}
        with first_inputs(wrappers, captured):
            reset_counts(counters)
            det, finite = stream(slab)
            torch.cuda.synchronize()
            counts = launch_counts(counters)
        check(counts == dict(none, aifi_attention=HF_STEPS),
              f"HF predict run {name} launched {counts}")
        check(bool(finite), f"HF predict {name} outputs are not all finite")
        check(tuple(det["boxes"].shape) == (HF_BATCH, 16, 4),
              f"HF predict {name} boxes {tuple(det['boxes'].shape)}")
        fps = {"kernels": [], "plain": []}
        for arm in ("kernels", "plain", "plain", "kernels") * 3:
            with plain_kernels(wrappers) if arm == "plain" else nullcontext():
                fps[arm].append(measure_fps(stream, slab))
        print(f"[17 HF predict {name}] DFineConfig(num_labels=2, "
              f"encoder_fused_attn=True) {name} weights, uint8 slab "
              f"{tuple(slab.shape)} -> post_process(threshold=0.3, "
              f"max_det=16), TF32 off: median "
              f"{statistics.median(fps['kernels']):.1f} frames/s through the "
              f"kernels {[round(f, 1) for f in fps['kernels']]}, median "
              f"{statistics.median(fps['plain']):.1f} through the plain "
              f"versions {[round(f, 1) for f in fps['plain']]} ({HF_STEPS} x "
              f"{HF_BATCH} frames x 3 calls each, CUDA events, eager); "
              f"launches over one slab: {counts}; outputs finite; "
              f"{det['valid'].sum(1).tolist()} valid per frame in the last "
              f"step", flush=True)
        q, k, v, heads = captured["aifi_attention"]
        got = attention.aifi_attention(q, k, v, heads)
        want = attention.aifi_attention_reference(q, k, v, heads)
        err = max_abs_err(got, want)
        if dtype == torch.bfloat16:
            # as phase 6: SERVING_ATTN_ULPS bf16 ulps at |out| max
            tol = SERVING_ATTN_ULPS * bf16_ulps(want)
            ok, limit = err <= tol, f"{SERVING_ATTN_ULPS} bf16 ulps {tol:.3g}"
        else:
            tol = ATTN_TOL[name]
            ok = torch.allclose(got, want, atol=tol, rtol=tol)
            limit = f"atol=rtol {tol}"
        check(ok, f"HF predict attention {name}: max |err| {err:.3g} beyond "
              f"{limit}")
        records.append(attention_record(
            torch, f"aifi_attention_dh32_{name}", q, k, v, heads,
            counts["aifi_attention"], err, f"limit {limit}"))
        print_record("17", records[-1], "over the slab")
        del predictor, stream, captured, det
    return records


def write_volumes(data_dir: str) -> list:
    """The accuracy harness's volumes of ``VOLUME_SEEDS``, the first two
    written into ``data_dir`` as JSON, the other two as txt trees, and
    each parsed back."""
    from pautdx_torch.data import synthetic
    from pautdx_torch.data.volume import parse_json_volume, parse_txt_tree
    from pautdx_torch.eval import accuracy

    os.makedirs(data_dir)
    vols = []
    for i, (spec, defects) in enumerate(accuracy.harness_volumes(
            VOLUME_SEEDS, 1)):
        if i < 2:
            path = os.path.join(data_dir, f"vol{i}.json")
            synthetic.write_json_volume(path, spec, defects)
            vols.append(parse_json_volume(path))
        else:
            synthetic.write_txt_tree(data_dir, spec, defects,
                                     file_folder=f"vol{i}")
            vols.append(parse_txt_tree(data_dir, f"vol{i}"))
    return vols


def volume_phase(torch, dev, counters: dict, none: dict) -> None:
    """Phase 19: four harness volumes written as JSON and as txt trees,
    parsed, rendered on the card and on the CPU, trained on for one epoch
    through ``train_bscan_detector`` with the EMA, and the EMA evaluated
    in the accuracy harness's arms."""
    from pautdx_torch.data.bscan import render_bscans
    from pautdx_torch.data.vision import detection_frames_from_volume
    from pautdx_torch.eval import accuracy
    from pautdx_torch.train.checkpoint import CheckpointManager
    from pautdx_torch.train.detector import train_bscan_detector
    from pautdx_torch.train.trainer import Trainer

    root = os.path.join(HERE, "build", "chip_smoke_volumes")
    data_dir, ckpt_dir = (os.path.join(root, d) for d in ("data", "ckpt"))
    shutil.rmtree(root, ignore_errors=True)
    vols = write_volumes(data_dir)
    img_err, frames = 0.0, []
    for vol in vols:
        card, host = (detection_frames_from_volume(
            vol, 640, 8, class_map=accuracy.CLASS_MAP, device=d)
            for d in (dev, "cpu"))
        img_err = max(img_err, float(np.abs(card.images
                                            - host.images).max()))
        check(all(np.array_equal(getattr(card, k), getattr(host, k))
                  for k in ("boxes", "classes", "mask")),
              "volume frames: the card's boxes, classes or masks differ "
              "from the CPU's")
        frames.append(card)
    check(img_err <= 1e-5, f"volume frames: the card's render differs from "
          f"the CPU's by {img_err:.3g}")
    scans = [np.ascontiguousarray(np.swapaxes(v.beam_array(), 0, 1))
             for v in vols]
    n_frames = sum(x.shape[0] for x in scans)

    def render_all():
        for x in scans:
            render_bscans(x, 640, 640, device=dev)
        torch.cuda.synchronize()

    render_all()
    t0 = time.perf_counter()
    for _ in range(3):
        render_all()
    render_fps = 3 * n_frames / (time.perf_counter() - t0)

    # one epoch, each step's EMA before it and parameters after it kept
    decay, last, step_ms, rows = 0.999, {}, [], []
    train_step = Trainer.train_step

    def spy(self, state, batch, lr_scale=1.0):
        last["ema"] = {k: v.clone() for k, v in state.ema.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = train_step(self, state, batch, lr_scale)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        last["params"] = {k: p.detach().clone()
                          for k, p in self.model.named_parameters()}
        rows.append(row)
        return row

    reset_counts(counters)
    Trainer.train_step = spy
    try:
        trainer, state = train_bscan_detector(
            data_dir, size=640, batch_size=TRAIN_BATCH, epochs=1,
            out=ckpt_dir, ema_decay=decay, device=dev, log=lambda s: None)
    finally:
        Trainer.train_step = train_step
    counts = launch_counts(counters)
    n = len(rows)
    check(n == n_frames // TRAIN_BATCH, f"{n} steps over {n_frames} frames")
    check(counts == dict(none, weighted_gather=3 * n,
                         weighted_gather_backward=3 * n),
          f"{n} steps from volumes launched {counts}")
    check(all(r["loss_was_finite"] * r["update_was_finite"] == 1.0
              and np.isfinite(r["total"]) for r in rows),
          f"non-finite steps from volumes: {[r['total'] for r in rows]}")
    ema_err = max(max_abs_err(state.ema[k], decay * last["ema"][k]
                              + (1 - decay) * p)
                  for k, p in last["params"].items())
    check(ema_err <= 1e-6, f"the EMA after the last step is off its "
          f"closed form by {ema_err:.3g}")
    saved, _ = CheckpointManager(ckpt_dir).restore("latest")
    check(saved["ema_params"].keys() == state.ema.keys()
          and all(torch.equal(v, state.ema[k].cpu())
                  for k, v in saved["ema_params"].items()),
          "the checkpoint does not restore the EMA")

    # the EMA in the harness's arms, on the first 64 frames
    data = {k: torch.from_numpy(np.concatenate(
        [getattr(f, k) for f in frames])[:64]).to(dev)
        for k in ("images", "boxes", "classes", "mask")}
    reset_counts(counters)
    maps = accuracy.evaluate_arms(state, data, 640)
    eval_counts = {k: v for k, v in launch_counts(counters).items() if v}
    check(all(0.0 <= m <= 1.0 for m in maps.values()),
          f"mAP@0.5 out of [0, 1]: {maps}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[19 volumes] seeds {list(VOLUME_SEEDS)} as the accuracy harness "
          f"draws them, 2 JSON + 2 txt trees, {n_frames} frames at 640px: "
          f"rendered on the card and on the CPU, max |err| {img_err:.3g} <= "
          f"1e-5, boxes, classes and masks equal; {render_fps:.1f} frames "
          f"rendered/s on the card (host clock, raw scans copied up, frames "
          f"left on the card, 3 passes after one); train_bscan_detector one "
          f"epoch b{TRAIN_BATCH} 640px f32 EMA {decay}: {n} steps, median "
          f"{statistics.median(step_ms):.2f} ms/step (host clock, synchronized "
          f"around each step; steps {[round(m, 1) for m in step_ms]}), loss "
          f"{rows[0]['total']:.4f} -> {rows[-1]['total']:.4f}, all finite; "
          f"launches {counts}; EMA after the last step within {ema_err:.3g} "
          f"of d*ema + (1-d)*params; the checkpoint restores the EMA; "
          f"mAP@0.5 of the EMA on 64 of these frames after {n} steps: "
          + ", ".join(f"{k} {v:.4f}" for k, v in maps.items())
          + f"; launches over the arms {eval_counts}", flush=True)
    del trainer, state, data


def denoising_phase(torch, dev, counters: dict, wrappers: dict,
                    none: dict) -> list:
    """Phase 20: phase 12's step with a contrastive denoising group of
    M = 8 and 100 denoising queries (12 groups, D = 192), for both
    decoders, at phase 12's gates, each leaf of both held to the discrete
    step's rule; returns the records of the gathers at the inputs these
    steps gave them."""
    from pautdx_torch.losses.denoising import make_denoising_queries
    from pautdx_torch.models.vision.dfine import dfine_nano
    from pautdx_torch.ops import gather
    from pautdx_torch.train.detector import (make_train_batches,
                                             normalized_boxes)

    size = 640
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in make_train_batches(1, 4, size, seed=5)[0].items()}
    cfg = dfine_nano(num_labels=2)
    gen = torch.Generator(device=dev).manual_seed(20)
    dn = make_denoising_queries(gen, normalized_boxes(batch["boxes"], size),
                                batch["classes"], batch["mask"],
                                cfg.num_labels, cfg.num_queries)
    check(dn["class_ids"].shape == (4, 192), f"denoising queries "
          f"{tuple(dn['class_ids'].shape)}, want (4, 192)")
    kernels_vs_plain = step_check(torch, dev, counters, wrappers, none,
                                  batch, size)
    captured, dcaptured = {}, {}
    # with the group, one backbone leaf's f32 gradient stands barely above
    # the noise floor and moves by more than 1e-3 when only the order of
    # the plain step's sums changes (the line of phase 20 prints by how
    # much), so the bilinear step takes the discrete step's per-leaf rule
    kernels_vs_plain(cfg, dict(weighted_gather=3, weighted_gather_backward=3),
                     reorderings=weighted_reorderings(gather),
                     denoising=dn, captured=captured, phase="20")
    kernels_vs_plain(dataclasses.replace(cfg, decoder_method="discrete"),
                     dict(onehot_gather=3, onehot_gather_backward=3),
                     reorderings=onehot_reordered(gather),
                     denoising=dn, captured=dcaptured, phase="20")
    check(captured["weighted_gather"][1].shape[1] == 8 * (150 + 192),
          f"weighted gather taps {tuple(captured['weighted_gather'][1].shape)}"
          f", want {8 * (150 + 192)}")
    per_step = dict(none, weighted_gather=3, weighted_gather_backward=3,
                    onehot_gather=3, onehot_gather_backward=3)
    records = gather_records(torch, dev, captured, dcaptured, per_step,
                             per_step, suffix="_denoising")
    flat, idx = (t.detach() for t in dcaptured["onehot_gather"])
    records.append(onehot_record(torch, dev, flat, idx, 3,
                                 "onehot_gather_denoising"))
    for r in records:
        print_record("20", r, "per step")
    return records


def temporal_phases(torch, dev, counters: dict, wrappers: dict,
                    none: dict) -> list:
    """Phases 21-22, the temporal D-FINE over the nano discrete trunk;
    returns the one-hot gather's record at a 50-frame chunk's inputs."""
    import io

    from pautdx_torch.data.windowing import chunked_windows
    from pautdx_torch.models.vision.temporal_dfine import VARIANTS
    from pautdx_torch.serve.bridge import serve_frames
    from pautdx_torch.serve.temporal_predict import (
        SEQ_LEN, build_temporal_model, make_temporal_stream, predict_sequence,
    )
    from pautdx_torch.serve.throughput import make_uint8_slab, measure_fps

    # 21. v1/v2/v3 in f32, through the kernels and through the plain versions
    side = TEMPORAL_IMG
    frames = make_uint8_slab((TEMPORAL_T, side, side, 3), seed=9,
                             device=dev).to(torch.float32) / 255.0
    found = []
    for variant in VARIANTS:
        model = build_temporal_model(variant, device=dev, seed=0,
                                     dtype=torch.float32)
        reset_counts(counters)
        with torch.inference_mode():
            out_k = model(frames)
        torch.cuda.synchronize()
        counts = launch_counts(counters)
        check(counts == dict(none, onehot_gather=3),
              f"temporal {variant} forward launched {counts}, want the "
              f"one-hot gather 3 times and nothing else")
        with plain_kernels(wrappers), torch.inference_mode():
            out_p = model(frames)
        check(launch_counts(counters) == counts,
              f"the plain temporal {variant} forward launched a kernel")
        la, ba, lb, bb = (t.float().cpu().numpy() for t in (
            out_k["logits"], out_k["pred_boxes"], out_p["logits"],
            out_p["pred_boxes"]))
        why = same_detections(la, ba, lb, bb)
        check(not why, f"temporal {variant} f32, kernels vs plain: {why}")
        note = f"max |logit diff| {np.abs(la - lb).max():.3g}"
        if variant == "v3":
            err = max_abs_err(out_k["anomaly"], out_p["anomaly"])
            check(err <= TEMPORAL_ANOMALY_TOL, f"temporal v3 anomaly: max "
                  f"|err| {err:.3g} beyond {TEMPORAL_ANOMALY_TOL}")
            note += f", anomaly max |err| {err:.3g}"
        found.append(f"{variant} ({tuple(out_k['logits'].shape)} logits, "
                     f"{note})")
        del model, out_k, out_p
    print(f"[21 temporal model] TemporalDFine v1/v2/v3 over dfine_nano "
          f"discrete, {side}px f32, T={TEMPORAL_T}, TF32 off, seeded weights "
          f"then init_heads_from_trunk: per-frame detections through the "
          f"kernels match the plain versions' by assignment: "
          + "; ".join(found) + f"; one forward launches "
          f"{dict(none, onehot_gather=3)}", flush=True)
    del frames

    # 22. the serving run: v3, bf16, a (4, 50, 640, 640, 3) uint8 slab
    model = build_temporal_model("v3", device=dev, seed=0)
    stream = make_temporal_stream(model)
    slab = make_uint8_slab((TEMPORAL_STEPS, SEQ_LEN, side, side, 3),
                           seed=10, device=dev)
    stream(slab[:1])                       # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()
    captured = {}
    with first_inputs(wrappers, captured):
        reset_counts(counters)
        logits, boxes, finite = stream(slab)
        torch.cuda.synchronize()
        counts = launch_counts(counters)
    check(counts == dict(none, onehot_gather=3 * TEMPORAL_STEPS),
          f"temporal serving run launches {counts}, want the one-hot gather "
          f"{3 * TEMPORAL_STEPS} times")
    check(bool(finite), "temporal serving outputs are not all finite")
    queries = min(150, (side // 16) ** 2 + (side // 32) ** 2)
    check(tuple(logits.shape) == (SEQ_LEN, queries, 3)
          and tuple(boxes.shape) == (SEQ_LEN, queries, 4),
          f"temporal serving outputs {tuple(logits.shape)} "
          f"{tuple(boxes.shape)}")
    fps = {"kernels": [], "plain": []}
    for arm in ("kernels", "plain", "plain", "kernels") * 3:
        with plain_kernels(wrappers) if arm == "plain" else nullcontext():
            fps[arm].append(measure_fps(stream, slab))
    print(f"[22 temporal serving] TemporalDFine v3, bf16 weights, uint8 slab "
          f"{tuple(slab.shape)} dequantized on the card (logits "
          f"{str(logits.dtype).split('.')[1]}, the GRU's f32 carry): median "
          f"{statistics.median(fps['kernels']):.1f} frames/s through the "
          f"kernels {[round(f, 1) for f in fps['kernels']]}, median "
          f"{statistics.median(fps['plain']):.1f} through the plain versions "
          f"{[round(f, 1) for f in fps['plain']]} ({TEMPORAL_STEPS} chunks "
          f"of {SEQ_LEN} frames x 3 calls each, CUDA events, eager); "
          f"launches over one slab: {counts}; outputs finite", flush=True)
    flat, idx = captured["onehot_gather"]
    record = onehot_record(torch, dev, flat, idx, counts["onehot_gather"],
                           "onehot_gather_temporal")
    print_record("22", record, "over the slab")
    del stream, slab, captured, logits, boxes, flat, idx

    # the chunked runner end to end on host frames, copies included
    n = TEMPORAL_RUNNER_FRAMES
    host = make_uint8_slab((n, side, side, 3), seed=11,
                           device=dev).cpu().numpy()
    windows = chunked_windows(n, SEQ_LEN)
    check(windows == [(0, 50), (50, 100), (100, 150), (120, 170)],
          f"windows of {n} frames: {windows}")
    predict_sequence(model, host)          # warm-up
    torch.cuda.synchronize()
    reset_counts(counters)
    t0 = time.perf_counter()
    results = predict_sequence(model, host)
    runner_s = time.perf_counter() - t0
    counts = launch_counts(counters)
    check(len(results) == n and all(isinstance(r, list) for r in results),
          f"the runner gave {len(results)} results for {n} frames")
    check(counts == dict(none, onehot_gather=3 * len(windows)),
          f"the runner over {n} frames launched {counts}")
    dets = [d for frame in results for d in frame]
    check(all(set(d) == {"box", "label", "score"} and d["score"] >= 0.3
              for d in dets), "the runner's detections break the schema")
    short = predict_sequence(model, host[:7])
    check(len(short) == 7, f"a 7-frame stack gave {len(short)} results")
    wire = json.dumps(np.round(host[:2, :, :, 0] / 255.0, 4).tolist())
    stdout = io.StringIO()
    t0 = time.perf_counter()
    serve_frames(lambda f: predict_sequence(model, f),
                 stdin=io.StringIO(wire), stdout=stdout)
    bridge_s = time.perf_counter() - t0
    bridged = json.loads(stdout.getvalue())
    check(len(bridged) == 2 and all(
        set(d) == {"box", "label", "score"} for f in bridged for d in f),
        f"the bridge returned {len(bridged)} frames")
    print(f"[22 temporal runner] predict_sequence over {n} host uint8 frames "
          f"(windows {windows}): {n / runner_s:.1f} frames/s ({runner_s:.3f} "
          f"s, host-to-card copies, post_process and the per-frame schema "
          f"included, after one warm-up run); {len(dets)} detections, every "
          f"frame one result; launches {counts}; a 7-frame stack padded to "
          f"{SEQ_LEN}: 7 results; serve_frames over a [2][{side}][{side}] JSON "
          f"({len(wire)} bytes): 2 frames, {sum(map(len, bridged))} "
          f"detections, {bridge_s:.3f} s", flush=True)
    del model, host
    return [record]


def yolo_flavour_phases(torch, dev, counters: dict, wrappers: dict,
                        none: dict) -> list:
    """Phases 23-24: YOLOv9c-seg, YOLO11n and YOLOv5su at their published
    widths and depths, one class, f32 (TF32 off) at 640px, each with its
    served NMS settings; returns each run's NMS record and v9c-seg's
    mask record."""
    from pautdx_torch.serve.yolo_predict import (
        IMG, build_yolo_predictor, make_frame_slab, make_yolo_stream,
        measure_fps, postprocess, yolo_config,
    )

    # 23. each configuration, post-processed through kernels vs plain
    predictors = {}
    for name in YOLO_FLAVOURS:
        cfg = yolo_config(name)
        predictor = build_yolo_predictor(device=dev, seed=0, cfg=cfg)
        predictors[name] = predictor
        frames = make_frame_slab(1, 4, seed=23, device=dev)[0]
        with torch.no_grad():
            out = predictor.model(frames.to(torch.float32) / 255.0)
        reset_counts(counters)
        det_k = postprocess(out, (IMG, IMG), cfg)
        torch.cuda.synchronize()
        post_counts = launch_counts(counters)
        with plain_kernels(wrappers):
            det_p = postprocess(out, (IMG, IMG), cfg)
        check(launch_counts(counters) == post_counts,
              f"{name}: the plain post-process launched a kernel")
        differ = [k for k in DETECTION_KEYS
                  if not torch.equal(det_k[k], det_p[k])]
        check(not differ, f"{name}: detections through the kernels differ "
              f"from the plain versions' in {differ}")
        # the served max_det: nms()'s 100 for seg, the CLI head's 16 else
        max_det = 100 if cfg.seg else 16
        check(tuple(det_k["boxes"].shape) == (4, max_det, 4)
              and ("masks" in det_k) == cfg.seg,
              f"{name}: outputs {sorted(det_k)}, boxes "
              f"{tuple(det_k['boxes'].shape)}")
        err = 0.0
        if cfg.seg:
            check(tuple(det_k["masks"].shape)
                  == (4, max_det, IMG // 4, IMG // 4),
                  f"{name}: masks {tuple(det_k['masks'].shape)}")
            err = max_abs_err(det_k["masks"], det_p["masks"])
            check(err <= MASK_TOL, f"{name}: masks differ by {err:.3g}")
        reset_counts(counters)
        det = predictor(frames)
        torch.cuda.synchronize()
        per_predict = launch_counts(counters)
        want = dict(none, nms_suppress=1, assemble_masks=int(cfg.seg))
        check(per_predict == want and post_counts == want,
              f"{name}: one predict launched {per_predict}, want {want}")
        check(all(torch.equal(det[k], det_k[k]) for k in det_k),
              f"{name}: predict() differs from the model plus postprocess()")
        n_params = sum(p.numel() for p in predictor.model.parameters())
        print(f"[23 yolo {name}] {n_params} parameters, {IMG}px f32 "
              f"batch 4, NMS "
              f"{'top 300, 100' if cfg.seg else 'score 0.3, top 64, 16'} "
              f"detections: kernels vs plain "
              f"detections identical ({det['valid'].sum(1).tolist()} valid "
              f"per frame)" + (f", masks max |err| {err:.3g}" if cfg.seg
                               else ", no masks")
              + f"; launches per predict: {per_predict}", flush=True)
        del out, det_k, det_p, det

    # 24. the predict runs
    kernels = []
    for name in YOLO_FLAVOURS:
        predictor = predictors.pop(name)
        seg = predictor.cfg.seg
        steps, batch = YOLO_FLAVOUR_SLABS[name]
        slab = make_frame_slab(steps, batch, seed=24, device=dev)
        stream = make_yolo_stream(predictor)
        stream(slab[:1])                   # warm-up: cuDNN plans, caches
        torch.cuda.synchronize()
        captured = {}
        with first_inputs(wrappers, captured):
            reset_counts(counters)
            det, finite = stream(slab)
            torch.cuda.synchronize()
            counts = launch_counts(counters)
        want = dict(none, nms_suppress=steps,
                    assemble_masks=steps if seg else 0)
        check(counts == want, f"{name} predict run launches {counts}, "
              f"want {want}")
        check(bool(finite), f"{name} predict outputs are not all finite")
        fps = {"kernels": [], "plain": []}
        for arm in ("kernels", "plain", "plain", "kernels") * FLAVOUR_TURNS:
            if arm == "plain":
                with plain_kernels(wrappers):
                    fps[arm].append(measure_fps(stream, slab))
            else:
                fps[arm].append(measure_fps(stream, slab))
        print(f"[24 yolo serving {name}] f32, uint8 slab "
              f"{tuple(slab.shape)}: median "
              f"{statistics.median(fps['kernels']):.1f} frames/s through "
              f"the kernels {[round(f, 1) for f in fps['kernels']]}, median "
              f"{statistics.median(fps['plain']):.1f} through the plain "
              f"versions {[round(f, 1) for f in fps['plain']]} ({steps} x "
              f"{batch} frames x 3 calls each, CUDA events, eager); "
              f"launches over one slab: {counts}; outputs finite; "
              f"{det['valid'].sum(1).tolist()} valid per frame in the last "
              f"step", flush=True)
        tag = name.replace("-", "_")
        records = [nms_record(torch, captured, counts["nms_suppress"],
                              f"nms_suppress_{tag}")]
        if seg:
            records.append(masks_record(torch, dev, captured,
                                        counts["assemble_masks"],
                                        f"assemble_masks_{tag}"))
        for r in records:
            print_record("24", r, "over the slab")
        kernels += records
        del predictor, slab, stream, captured, det
    return kernels


def yolo_train_phase(torch, dev, counters: dict, none: dict) -> None:
    """Phase 25: YOLO training on the card: the BatchNorm momentum, one
    step of each configuration on the card against the same step on the
    CPU, the timed YOLOv8n-seg b16 run, and one epoch of
    ``train_bscan_detector(detector="yolo")`` over phase 19's volumes with
    the trained model's box and mask mAP@0.5."""
    import copy

    from pautdx_torch.data.vision import detection_frames_from_volume
    from pautdx_torch.eval.map import evaluate_map
    from pautdx_torch.eval.seg import evaluate_mask_map
    from pautdx_torch.losses.yolo import task_aligned_assign
    from pautdx_torch.models.vision.yolo import (YOLO, ConvBnSiLU,
                                                 decode_boxes)
    from pautdx_torch.serve.yolo_predict import YoloPredictor, yolo_config
    from pautdx_torch.train.detector import (
        LR, NUM_CLASSES, add_box_masks, make_train_batches,
        train_bscan_detector, yolo_objective,
    )
    from pautdx_torch.train.optim import make_optimizer
    from pautdx_torch.train.trainer import Trainer

    # (a) the BatchNorm's running mean moves by 0.03 of the batch's
    conv = ConvBnSiLU(3, 5, 3).to(dev).train()
    x = torch.randn((4, 3, 8, 8), device=dev) * 2.0 + 1.0
    with torch.no_grad():
        batch_mean = conv.conv(x).mean((0, 2, 3))
        conv(x)
    bn_err = max_abs_err(conv.bn.running_mean, 0.03 * batch_mean)
    check(bn_err <= 1e-6, f"YOLO BatchNorm: running mean off 0.03 x the "
          f"batch mean by {bn_err:.3g}")
    print(f"[25 yolo bn] ConvBnSiLU(3, 5, 3) in train mode on the card: the "
          f"running mean moved by 0.03 of the batch mean (max |err| "
          f"{bn_err:.3g}, batch mean up to "
          f"{batch_mean.abs().max().item():.3g})", flush=True)

    # (b) one step of each configuration, card against CPU
    size = YOLO_CHECK_IMG
    batch = make_train_batches(1, 2, size, seed=25)[0]
    found = []
    for name in YOLO_TRAIN_NAMES:
        cfg = dataclasses.replace(yolo_config(name), num_classes=NUM_CLASSES)
        host = {k: torch.from_numpy(v) for k, v in (
            add_box_masks(batch) if cfg.seg else batch).items()}
        objective = yolo_objective(size, cfg)
        cpu_model = YOLO(cfg, device="cpu", seed=0)
        start = copy.deepcopy(cpu_model.state_dict())

        def step(model, b):
            """Loss, gradients, BN statistics and the assignment (fg,
            gt index) of one train-mode step from ``start``."""
            model.load_state_dict(start)
            model.zero_grad(set_to_none=True)
            out = model(b["images"], train=True)
            loss, _ = objective(out, b)
            loss.backward()
            d = decode_boxes(out, (size, size), cfg)
            a = task_aligned_assign(d["scores"].detach(),
                                    d["boxes"].detach(), b["boxes"],
                                    b["classes"], b["mask"],
                                    d["anchor_points"])
            return (loss.item(),
                    {n: p.grad.detach().cpu() for n, p in
                     model.named_parameters() if p.grad is not None},
                    {n: t.detach().cpu() for n, t in model.named_buffers()},
                    (a["fg"].cpu(), a["target_gt_idx"].cpu()))

        loss_c, grads_c, bufs_c, assign_c = step(cpu_model, host)
        # the same step in float64 on the CPU: the exact answer, which the
        # card's and the CPU's f32 steps each miss by their own rounding
        loss_x, grads_x, bufs_x, _ = step(copy.deepcopy(cpu_model).double(), {
            k: v.double() if v.is_floating_point() else v
            for k, v in host.items()})
        card_model = copy.deepcopy(cpu_model).to(dev)
        reset_counts(counters)
        with deterministic():
            loss_g, grads_g, bufs_g, assign_g = step(
                card_model, {k: v.to(dev) for k, v in host.items()})
        counts = launch_counts(counters)
        check(counts == none, f"yolo {name} train step launched {counts}")
        check(torch.equal(assign_g[0], assign_c[0])
              and torch.equal(assign_g[1][assign_c[0] > 0],
                              assign_c[1][assign_c[0] > 0]),
              f"yolo {name}: the card's task-aligned assignment differs "
              f"from the CPU's")

        def errors(loss, grads, bufs) -> tuple:
            """Loss (relative), gradient (relative in norm) and BN (max
            abs) against the float64 step."""
            return (abs(loss - loss_x) / abs(loss_x),
                    global_grad_error({n: g.double() for n, g in
                                       grads.items()}, grads_x),
                    max(max_abs_err(bufs[k].double(), bufs_x[k])
                        for k in bufs_x))

        own = errors(loss_c, grads_c, bufs_c)
        limit = tuple(max(tol, 2 * e) for tol, e in zip(
            (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, 1e-5), own))
        err = errors(loss_g, grads_g, bufs_g)
        check(all(e <= lim for e, lim in zip(err, limit)),
              f"yolo {name} train step, card f32 vs CPU f64: loss, gradient "
              f"and BN errors {err} beyond {limit}")
        vs_cpu = (abs(loss_g - loss_c) / abs(loss_c),
                  global_grad_error(grads_g, grads_c),
                  max(max_abs_err(bufs_g[k], bufs_c[k]) for k in bufs_c))
        found.append(
            f"{name}: loss {loss_g:.4f}, float64 {loss_x:.4f}; against "
            f"the float64 step the card's loss, gradient and BN err "
            f"{err[0]:.3g} / {err[1]:.3g} / {err[2]:.3g} (limits "
            f"{limit[0]:.3g} / {limit[1]:.3g} / {limit[2]:.3g}), the CPU's "
            f"f32 {own[0]:.3g} / {own[1]:.3g} / {own[2]:.3g}; card against "
            f"the CPU's f32 {vs_cpu[0]:.3g} / {vs_cpu[1]:.3g} / "
            f"{vs_cpu[2]:.3g}; {int(assign_c[0].sum())} foreground anchors, "
            f"the same on both")
        del cpu_model, card_model, grads_c, grads_x, grads_g
    print(f"[25 yolo step] one train-mode step at {size}px b2 f32, TF32 off, "
          f"NUM_CLASSES {NUM_CLASSES}, seeded weights, the card under "
          f"deterministic algorithms, against the same step on the CPU in "
          f"float64: " + "; ".join(found) + f"; no kernel launched; limits: "
          f"loss {TRAIN_LOSS_TOL}, gradient {TRAIN_GRAD_TOL} in norm, BN "
          f"1e-5, each raised to twice the CPU f32 step's own error", flush=True)

    # (c) the timed run: YOLOv8n-seg, 640px b16 f32 with box masks
    cfg = dataclasses.replace(yolo_config("yolov8n-seg"),
                              num_classes=NUM_CLASSES)
    one = {k: torch.as_tensor(v).to(dev) for k, v in add_box_masks(
        make_train_batches(1, TRAIN_BATCH, 640, seed=26)[0]).items()}
    trainer = Trainer(YOLO(cfg, device=dev, seed=0), yolo_objective(640, cfg),
                      make_optimizer(LR), input_key="images")
    state = trainer.init(one)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    rows = [trainer.train_step(state, one)]
    counts = launch_counts(counters)
    check(counts == none, f"yolo b16 step launched {counts}")
    rows += [trainer.train_step(state, one)
             for _ in range(YOLO_TRAIN_LOSS_STEPS - 1)]
    losses = [r["total"] for r in rows]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0]
          and all(r["update_was_finite"] == 1.0 for r in rows),
          f"yolo b16: the loss over {len(losses)} steps on one batch: "
          f"{losses}")
    turns = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_TURN):
            trainer.train_step(state, one)
        torch.cuda.synchronize()
        turns.append(1e3 * (time.perf_counter() - t0) / TRAIN_TURN)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[25 yolo train] yolov8n-seg ({NUM_CLASSES} classes) 640px b"
          f"{TRAIN_BATCH} f32, TF32 off, seg loss on rasterize_boxes masks, "
          f"AdamW lr {LR}: median {statistics.median(turns):.2f} ms/step "
          f"(six turns of {TRAIN_TURN} steps, host clock, synchronized: "
          f"{[round(t, 2) for t in turns]}), peak memory {peak:.2f} GiB; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps on one batch (box {rows[-1]['box']:.3f}, "
          f"cls {rows[-1]['cls']:.3f}, dfl {rows[-1]['dfl']:.3f}, seg "
          f"{rows[-1]['seg']:.3f}); launches per step {counts}", flush=True)
    del trainer, state, one

    # (d) one epoch of train_bscan_detector(detector="yolo"), then predict
    root = os.path.join(HERE, "build", "chip_smoke_yolo")
    data_dir = os.path.join(root, "data")
    shutil.rmtree(root, ignore_errors=True)
    vols = write_volumes(data_dir)
    reset_counts(counters)
    t0 = time.perf_counter()
    trainer, state = train_bscan_detector(
        data_dir, size=640, batch_size=TRAIN_BATCH, epochs=1,
        detector="yolo", seg=True, out=os.path.join(root, "ckpt"),
        device=dev, log=lambda m: None)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    check(launch_counts(counters) == none,
          f"yolo epoch launched {launch_counts(counters)}")
    history = trainer.ckpt.load_history()
    check(all(np.isfinite(v[0]) for v in history.values())
          and history["update_was_finite"] == [1.0],
          f"yolo epoch: {history}")
    frames = [detection_frames_from_volume(v, 640, 8, device=dev)
              for v in vols]
    data = {k: np.concatenate([getattr(f, k) for f in frames])[:64]
            for k in ("images", "boxes", "classes", "mask")}
    gt_masks = add_box_masks(data)["gt_masks"]
    predictor = YoloPredictor(model=state.model.eval(), cfg=state.model.cfg)
    preds, gts, mpreds, mgts = [], [], [], []
    reset_counts(counters)
    for a in range(0, 64, TRAIN_BATCH):
        det = predictor.forward(torch.from_numpy(
            data["images"][a:a + TRAIN_BATCH]).to(dev))
        det = {k: v.cpu().numpy() for k, v in det.items()}
        for i in range(det["boxes"].shape[0]):
            t, v = a + i, det["valid"][i]
            gm = data["mask"][t] > 0
            preds.append({"boxes": det["boxes"][i][v],
                          "scores": det["scores"][i][v],
                          "classes": det["classes"][i][v]})
            gts.append({"boxes": data["boxes"][t][gm],
                        "classes": data["classes"][t][gm]})
            mpreds.append({"masks": det["masks"][i][v],
                           "scores": det["scores"][i][v],
                           "classes": det["classes"][i][v]})
            mgts.append({"masks": gt_masks[t][gm],
                         "classes": data["classes"][t][gm]})
    counts = launch_counts(counters)
    n_predict = 64 // TRAIN_BATCH
    check(counts == dict(none, nms_suppress=n_predict,
                         assemble_masks=n_predict),
          f"yolo predict after training launched {counts}")
    box_map = evaluate_map(preds, gts, num_classes=NUM_CLASSES)["mAP@0.5"]
    mask_map = evaluate_mask_map(mpreds, mgts, num_classes=NUM_CLASSES)[
        "mask_mAP@0.5"]
    check(0.0 <= box_map <= 1.0 and 0.0 <= mask_map <= 1.0,
          f"yolo mAP@0.5 out of [0, 1]: box {box_map}, mask {mask_map}")
    meta = json.load(open(os.path.join(root, "ckpt", "metadata.json")))
    shutil.rmtree(root, ignore_errors=True)
    print(f"[25 yolo volumes] train_bscan_detector(detector='yolo', "
          f"seg=True) one epoch b{TRAIN_BATCH} 640px over seeds "
          f"{list(VOLUME_SEEDS)} ({state.step} steps, {epoch_s:.2f} s with "
          f"rendering): loss {history['total'][0]:.4f} (box "
          f"{history['box'][0]:.4f}, cls {history['cls'][0]:.4f}, dfl "
          f"{history['dfl'][0]:.4f}, seg {history['seg'][0]:.4f}), "
          f"metadata {meta}; YoloPredictor on 64 of the frames: box mAP@0.5 "
          f"{box_map:.4f}, mask mAP@0.5 {mask_map:.4f} (masks at 160x160 "
          f"against rasterize_boxes' at proto resolution); launches over "
          f"the predicts {counts}", flush=True)
    del trainer, state, predictor


def seeded_forward(model, frames):
    """The temporal model's training forward with the generator seeded
    first, so that the encoder's dropout draws the same masks in every
    step of a check (cuDNN's GRU has no backward in eval mode)."""
    import torch

    torch.manual_seed(26)
    return model(frames)


def temporal_train_phase(torch, dev, counters: dict, wrappers: dict,
                         none: dict) -> list:
    """Phase 26: temporal D-FINE trained on the card over a seeded nano
    trunk checkpoint: the v3 step at T = 50 through the kernels and the
    plain versions (phase 20's rule), 20 steps of each variant, and the
    weighted gather's two records at the v3 step's inputs."""
    from pautdx_torch.models.vision.dfine import DFine, dfine_nano
    from pautdx_torch.ops import gather
    from pautdx_torch.train.checkpoint import CheckpointManager
    from pautdx_torch.train.detector import dfine_metadata
    from pautdx_torch.train.temporal import (build_temporal_trainer,
                                             make_temporal_dataset,
                                             stack_chunks)

    root = os.path.join(HERE, "build", "chip_smoke_temporal")
    shutil.rmtree(root, ignore_errors=True)
    trunk = DFine(dfine_nano(num_labels=2), device=dev, seed=0)
    CheckpointManager(root).save(0, {
        "params": {k: v.detach().cpu() for k, v in trunk.named_parameters()},
        "batch_stats": {k: v.cpu() for k, v in trunk.named_buffers()}},
        metadata=dfine_metadata(trunk.cfg, TEMPORAL_IMG))
    del trunk
    t0 = time.perf_counter()
    chunks = make_temporal_dataset(TEMPORAL_TRAIN_SEEDS, rng_seed=4,
                                   size=TEMPORAL_IMG, device=dev)
    data = stack_chunks(chunks, dev)
    data_s = time.perf_counter() - t0
    seq = tuple(data["images"].shape[1:])

    # (a) the v3 step at T = 50 through the kernels and the plain versions
    batch = {k: v[0] for k, v in data.items()}
    trainer, state = build_temporal_trainer("v3", root, TEMPORAL_TRAIN_STEPS,
                                            device=dev)
    kernels_vs_plain = step_check(torch, dev, counters, wrappers, none,
                                  batch, TEMPORAL_IMG)
    captured = {}
    per_step = dict(weighted_gather=3, weighted_gather_backward=3)
    kernels_vs_plain(state.model.cfg, per_step,
                     reorderings=weighted_reorderings(gather),
                     captured=captured, phase="26", model=state.model,
                     objective=trainer.objective,
                     forward=lambda m: seeded_forward(m, batch["images"]),
                     what=f"temporal v3 over dfine_nano, T={seq[0]}, the "
                          f"same dropout masks in every step")
    check(tuple(captured["weighted_gather"][1].shape) == (seq[0], 1200, 4),
          f"temporal weighted gather taps "
          f"{tuple(captured['weighted_gather'][1].shape)}")
    del trainer, state

    # (b) 20 steps of each variant, kernels and plain in turns
    found = []
    for variant in ("v1", "v2", "v3"):
        trainer, state = build_temporal_trainer(
            variant, root, TEMPORAL_TRAIN_STEPS, device=dev)
        model = state.model
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if not p.requires_grad}
        bufs = {n: b.clone() for n, b in model.named_buffers()}
        rng = np.random.default_rng(3)
        rows = []

        def run(n: int) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                si = int(rng.integers(0, len(chunks)))
                rows.append(trainer.train_step(
                    state, {k: v[si] for k, v in data.items()}))
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / n

        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        run(1)
        counts = launch_counts(counters)
        want = dict(none, weighted_gather=3,
                    weighted_gather_backward=3 if variant == "v3" else 0)
        check(counts == want, f"temporal {variant} step launched {counts}, "
              f"want {want}")
        run(3)
        ms = {"kernels": [], "plain": []}
        for arm in ("kernels", "plain", "plain", "kernels"):
            with plain_kernels(wrappers) if arm == "plain" else nullcontext():
                ms[arm].append(run(TEMPORAL_TURN))
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(len(rows) == TEMPORAL_TRAIN_STEPS, f"{len(rows)} steps")
        check(all(np.isfinite(r["total"]) and r["update_was_finite"] == 1.0
                  for r in rows),
              f"temporal {variant}: losses {[r['total'] for r in rows]}")
        params = dict(model.named_parameters())
        check(all(torch.equal(params[n], p) for n, p in frozen.items()),
              f"temporal {variant}: a frozen parameter moved")
        check(all(torch.equal(b, bufs[n])
                  for n, b in model.named_buffers()),
              f"temporal {variant}: a BN statistic moved")
        found.append(
            f"{variant}: {len(frozen)} of {len(params)} parameters frozen, "
            f"unchanged bit for bit, BN statistics too; loss "
            f"{rows[0]['total']:.3f} -> {rows[-1]['total']:.3f}; "
            f"ms/step through the kernels {[round(m, 2) for m in ms['kernels']]}"
            f", plain {[round(m, 2) for m in ms['plain']]}; peak memory "
            f"{peak:.2f} GiB; launches a step {counts}")
        del trainer, state, model, frozen, params
    shutil.rmtree(root, ignore_errors=True)
    print(f"[26 temporal train] {len(chunks)} sequences {seq} of seeds "
          f"{list(TEMPORAL_TRAIN_SEEDS)} (flicker 0.65) rendered on the card "
          f"in {data_s:.2f} s; {TEMPORAL_TRAIN_STEPS} steps each over a seeded "
          f"dfine_nano trunk checkpoint, one sequence a step, the recipe's "
          f"AdamW groups, f32, TF32 off (host clock, synchronized, turns of "
          f"{TEMPORAL_TURN} steps after 4): " + "; ".join(found), flush=True)

    # (c) the weighted gather and its backward at the v3 step's inputs
    records = gather_records(torch, dev, captured, None,
                             dict(none, **per_step), None,
                             suffix="_temporal_train")
    for r in records:
        print_record("26", r, "per v3 step")
    return records


def signal_phases(torch, dev, counters: dict, none: dict) -> None:
    """Phases 27-28: the signal zoo on the card against the CPU, and
    HybridBinary served through the endpoint, the bridge and the
    prediction map."""
    import copy
    import io

    from pautdx_torch.data import synthetic
    from pautdx_torch.data.volume import parse_json_volume
    from pautdx_torch.eval import accuracy
    from pautdx_torch.eval.report import prediction_map
    from pautdx_torch.models.signal import MODEL_ZOO, build_signal_model
    from pautdx_torch.serve.bridge import serve_signals
    from pautdx_torch.serve.endpoints import SignalEndpoint

    set_tf32(False)
    rng = np.random.default_rng(27)
    host = rng.normal(size=SIGNAL_SHAPE).astype(np.float32)
    x_cpu = torch.from_numpy(host)
    x_dev = x_cpu.to(dev)

    def outputs(out) -> dict:
        return out if isinstance(out, dict) else {"prob": out}

    # 27. every zoo model, card against CPU, the same weights
    t0 = time.perf_counter()
    reset_counts(counters)
    worst = 0.0
    for i, name in enumerate(MODEL_ZOO):
        cpu_model = build_signal_model(name, device="cpu", seed=i)
        card_model = copy.deepcopy(cpu_model).to(dev)
        with torch.inference_mode():
            want = outputs(cpu_model(x_cpu))
            got = outputs(card_model(x_dev))
        torch.cuda.synchronize()
        check(set(got) == set(want), f"zoo {name}: keys {sorted(got)}")
        errs = {}
        for k in want:
            g = got[k].float().cpu()
            check(g.shape == want[k].shape and bool(torch.isfinite(g).all()),
                  f"zoo {name}: {k} of shape {tuple(g.shape)} or not finite")
            errs[k] = max_abs_err(g, want[k])
        err = max(errs.values())
        check(err <= SIGNAL_TOL, f"zoo {name}: card differs from the CPU by "
              f"{err:.3g} > {SIGNAL_TOL} ({errs})")
        worst = max(worst, err)
        n_params = sum(p.numel() for p in card_model.parameters())
        print(f"[27 zoo {name}] {n_params} parameters, outputs "
              + ", ".join(f"{k} {tuple(v.shape)} max |err| {errs[k]:.3g}"
                          for k, v in want.items()), flush=True)
        del cpu_model, card_model
    zoo_counts = launch_counts(counters)
    check(zoo_counts == none, f"the signal zoo launched {zoo_counts}")
    print(f"[27 zoo] {len(MODEL_ZOO)} models at {SIGNAL_SHAPE} f32, TF32 "
          f"off, card vs CPU with the same weights: worst max |err| "
          f"{worst:.3g} (limit {SIGNAL_TOL}); launches {zoo_counts} (the "
          f"signal path has no kernel); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 28. HybridBinary served
    t0 = time.perf_counter()
    cpu_model = build_signal_model("HybridBinary", device="cpu", seed=28)
    ep = SignalEndpoint(build_signal_model("HybridBinary", device=dev,
                                           seed=28), device=dev)
    cpu_ep = SignalEndpoint(cpu_model, device="cpu")
    reset_counts(counters)
    served = {}
    for shape in (SIGNAL_SHAPE, SIGNAL_RAGGED):
        req = rng.normal(size=shape).astype(np.float32)
        got, want = ep.predict(req), cpu_ep.predict(req)
        check(got["prob"].shape == shape[:2]
              and bool(np.isfinite(got["prob"]).all()),
              f"endpoint {shape}: prob {got['prob'].shape}")
        err = float(np.abs(got["prob"] - want["prob"]).max())
        check(err <= SIGNAL_TOL, f"endpoint {shape}: card differs from the "
              f"CPU by {err:.3g}")
        agree = float((got["pred"] == want["pred"]).mean())
        served[shape] = (err, agree)
    request = rng.normal(size=SIGNAL_SHAPE[1:]).astype(np.float32)
    stdout = io.StringIO()
    serve_signals(ep, stdin=io.StringIO(json.dumps(
        {"signals": request.tolist()})), stdout=stdout)
    payload = json.loads(stdout.getvalue())
    bridge_err = float(np.abs(np.asarray(payload["prob"])
                              - cpu_ep.predict(request)["prob"]).max())
    check(set(payload) == {"prob", "pred"}
          and np.asarray(payload["prob"]).shape == (1, SIGNAL_SHAPE[1])
          and bridge_err <= SIGNAL_TOL,
          f"bridge: keys {sorted(payload)}, error {bridge_err:.3g}")
    spec, defects = accuracy.harness_volumes([VOLUME_SEEDS[0]], 1)[0]
    path = os.path.join(HERE, "build", "chip_smoke_signal", "vol0.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    synthetic.write_json_volume(path, spec, defects)
    vol = parse_json_volume(path)
    heat = prediction_map(ep.predict, vol)
    heat_err = float(np.abs(heat - prediction_map(cpu_ep.predict,
                                                  vol)).max())
    check(bool(np.isfinite(heat).all()) and heat_err <= SIGNAL_TOL,
          f"prediction map {heat.shape}: error {heat_err:.3g}")
    served_counts = launch_counts(counters)
    check(served_counts == none, f"the served path launched {served_counts}")
    print(f"[28 signal served] HybridBinary, published widths, f32: endpoint "
          + "; ".join(f"{s} max |err| {e:.3g}, pred agrees on {a:.4f}"
                      for s, (e, a) in served.items())
          + f" (each answered at its own shape); bridge {tuple(request.shape)}"
          f" request answered {list(payload)}, max |err| {bridge_err:.3g}; "
          f"prediction map {heat.shape} of volume seed {VOLUME_SEEDS[0]} "
          f"max |err| {heat_err:.3g}; launches {served_counts}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the endpoint's throughput, host numpy in and out
    ascans = SIGNAL_SHAPE[0] * SIGNAL_SHAPE[1]
    for _ in range(3):
        ep.predict(host)
    turns = []
    for _ in range(SIGNAL_TURNS):
        t1 = time.perf_counter()
        for _ in range(SIGNAL_CALLS):
            ep.predict(host)
        turns.append(ascans * SIGNAL_CALLS / (time.perf_counter() - t1))
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: ep.model(x_dev))
    predict_ms = time_ms(lambda: ep.predict(host))
    print(f"[28 signal throughput] SignalEndpoint.predict at "
          f"{SIGNAL_SHAPE} f32 from host numpy: median "
          f"{statistics.median(turns):.1f} A-scans/s "
          f"{[round(t, 1) for t in turns]} ({SIGNAL_TURNS} turns of "
          f"{SIGNAL_CALLS} calls, host clock, copies included); one forward "
          f"on card tensors {fwd_ms:.4f} ms, one predict {predict_ms:.4f} "
          f"ms (CUDA events, median of 30)", flush=True)


def _dropout_off(model):
    """Every ``nn.blocks.Dropout`` of ``model`` at rate 0: the card's and
    the CPU's masks come from different generators."""
    from pautdx_torch.nn.blocks import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def _seeded(build, seed: int):
    """``build()`` with torch's global generator seeded, restored after."""
    import torch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def signal_batch(rng, shape) -> dict:
    """A host batch of the signal schema: normal signals, labels of rate
    0.3, sorted (start, end) on the defects, a full sample mask."""
    b, n, _ = shape
    labels = (rng.random((b, n)) < 0.3).astype(np.float32)
    pos = np.sort(rng.uniform(0.1, 0.9, (b, n, 2)), -1).astype(np.float32)
    return {"signals": rng.normal(size=shape).astype(np.float32),
            "labels": labels, "positions": pos * labels[..., None],
            "sample_mask": np.ones(b, np.float32)}


def trainer_step(model, objective, spec, batch: dict) -> tuple:
    """One ``Trainer.train_step`` of ``model`` (on its device) over the
    host ``batch``: (loss, the clipped gradients the optimizer applied,
    the float buffers after the step), all on the CPU in float64."""
    import torch

    from pautdx_torch.train.trainer import Trainer

    seen = {}

    def captured(out, b):
        loss, aux = objective(out, b)
        seen["loss"] = loss.detach()
        return loss, aux

    trainer = Trainer(model, captured, spec)
    state = trainer.init(batch)
    _, row = trainer.train_epoch(state, [batch])
    check(row["update_was_finite"] == 1.0, "signal step: update refused")
    return (float(seen["loss"]),
            {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters()},
            {n: b.detach().double().cpu() for n, b in model.named_buffers()
             if b.is_floating_point()})


def signal_step_check(torch, dev, name: str, build, objective, spec,
                      batch: dict) -> str:
    """Phase 29's rule for one model and objective: one step on the card,
    on the CPU in f32 and on the CPU in float64 from the same weights,
    dropout 0; the card's loss within 1e-4 (relative), each gradient leaf
    within 1e-3 in norm (relative; a leaf under the floor of
    ``grad_floor`` within that floor, absolute) and the BN statistics
    within 1e-5 of the float64 step's, each limit raised to twice the CPU
    f32 step's own error. Returns the report line."""
    import copy

    cpu_model = _dropout_off(build())
    f64_batch = {k: v.astype(np.float64) for k, v in batch.items()}
    ref = trainer_step(copy.deepcopy(cpu_model).double(), objective, spec,
                       f64_batch)
    card = trainer_step(copy.deepcopy(cpu_model).to(dev), objective, spec,
                        batch)
    cpu = trainer_step(cpu_model, objective, spec, batch)

    def errors(got) -> tuple:
        leaves = leaf_errors(got[1], ref[1])
        noise = {n: (got[1][n] - w).norm().item()
                 for n, w in ref[1].items() if n not in leaves}
        bn = max((max_abs_err(got[2][k], ref[2][k]) for k in ref[2]),
                 default=0.0)
        return abs(got[0] - ref[0]) / abs(ref[0]), leaves, noise, bn

    c_loss, c_leaves, c_noise, c_bn = errors(card)
    o_loss, o_leaves, o_noise, o_bn = errors(cpu)
    floor = grad_floor(ref[1])
    loss_lim = max(TRAIN_LOSS_TOL, 2 * o_loss)
    bn_lim = max(1e-5, 2 * o_bn)
    check(c_loss <= loss_lim, f"{name} step: card loss error {c_loss:.3g} "
          f"> {loss_lim:.3g}")
    check(c_bn <= bn_lim, f"{name} step: card BN error {c_bn:.3g} > "
          f"{bn_lim:.3g}")
    worst = ("", 0.0, TRAIN_GRAD_TOL)
    for n, e in c_leaves.items():
        lim = max(TRAIN_GRAD_TOL, 2 * o_leaves[n])
        check(e <= lim, f"{name} step: gradient of {n} off by {e:.3g} in "
              f"norm > {lim:.3g}")
        if e / lim > worst[1] / worst[2]:
            worst = (n, e, lim)
    for n, e in c_noise.items():
        lim = max(floor, 2 * o_noise[n])
        check(e <= lim, f"{name} step: gradient of {n} (under the floor "
              f"{floor:.3g}) off by {e:.3g} > {lim:.3g}")
    return (f"{name}: loss {card[0]:.5f} (float64 {ref[0]:.5f}, err "
            f"{c_loss:.3g}, CPU f32 {o_loss:.3g}), worst leaf {worst[0]} "
            f"{worst[1]:.3g} (limit {worst[2]:.3g}; {len(c_leaves)} leaves, "
            f"{len(c_noise)} under the floor), BN {c_bn:.3g} (CPU f32 "
            f"{o_bn:.3g})")


def signal_train_phases(torch, dev, counters: dict, none: dict) -> None:
    """Phases 29-31: the signal domain trained on the card (no kernel)."""
    import copy

    from pautdx_torch.data.datasets import (
        BatchIterator, load_json_dir, train_val_split,
    )
    from pautdx_torch.data.volume import parse_json_volume
    from pautdx_torch.eval.report import SignalEvaluator, prediction_map
    from pautdx_torch.losses.heatmap import detloc_criterion
    from pautdx_torch.models.signal import (
        EnhancedSignalSequenceDetector, Hybrid1DDetLoc, HybridModel,
        SignalSequenceDetector, build_signal_model,
    )
    from pautdx_torch.serve.endpoints import SignalEndpoint
    from pautdx_torch.serve.export import export_signal_model, load_exported
    from pautdx_torch.train import anomaly
    from pautdx_torch.train.checkpoint import CheckpointManager
    from pautdx_torch.train.optim import ReduceLROnPlateau, make_optimizer
    from pautdx_torch.train.recipes import (
        RECIPES, HybridPhases, SNRCurriculum,
    )
    from pautdx_torch.train.signal import (
        recipe_optimizer, restore_signal_model, train_signal,
    )
    from pautdx_torch.train.trainer import Trainer
    from pautdx_torch.utils.autogates import find_gates, gate_mask

    set_tf32(False)
    rng = np.random.default_rng(29)
    s_len = SIGNAL_TRAIN_SHAPE[2]

    # 29. each model against its objective, card against CPU
    t0 = time.perf_counter()
    reset_counts(counters)
    step_batch = signal_batch(rng, SIGNAL_CHECK_SHAPE)
    det = RECIPES["detection_position"]

    def detloc(out, batch):
        return detloc_criterion(out, batch["labels"], batch["positions"],
                                s_len)

    joint = HybridPhases().phase_masks()[2]
    pairs = [
        ("HybridBinary/detection",
         lambda: build_signal_model("HybridBinary", device="cpu", seed=29),
         RECIPES["detection"]),
        ("SignalSequenceDetector/seq_detector",
         lambda: _seeded(lambda: SignalSequenceDetector(device="cpu"), 29),
         RECIPES["seq_detector"]),
        ("EnhancedSignalSequenceDetector/seq_detector",
         lambda: _seeded(lambda: EnhancedSignalSequenceDetector(
             device="cpu"), 29), RECIPES["seq_detector"]),
        ("Hybrid1DDetLoc/detloc_criterion",
         lambda: _seeded(lambda: Hybrid1DDetLoc(device="cpu"), 29),
         (detloc, make_optimizer())),
        ("MSC3Out/detection_position",
         lambda: build_signal_model("MSC3Out", device="cpu", seed=29), det),
        ("EnhancedPosition/enhanced_position",
         lambda: build_signal_model("EnhancedPosition", device="cpu",
                                    seed=29), RECIPES["enhanced_position"]),
        ("TwoStage/two_stage",
         lambda: build_signal_model("TwoStage", device="cpu", seed=29),
         RECIPES["two_stage"]),
        ("Hybrid/detection_position, HybridPhases' joint groups",
         lambda: build_signal_model("Hybrid", device="cpu", seed=29),
         (det.make_objective(), make_optimizer(
             det.learning_rate, det.weight_decay, det.clip_norm,
             group_lr_mults=joint,
             group_patterns=HybridPhases.group_patterns()))),
    ]
    found = []
    for name, build, how in pairs:
        objective, spec = (how if isinstance(how, tuple) else
                           (how.make_objective(), recipe_optimizer(how, 10)))
        found.append(signal_step_check(torch, dev, name, build, objective,
                                       spec, step_batch))
        print(f"[29 signal step] {found[-1]}", flush=True)
    counts = launch_counts(counters)
    check(counts == none, f"the signal steps launched {counts}")
    print(f"[29 signal steps] {len(pairs)} models at published widths, one "
          f"Trainer.train_step each at {SIGNAL_CHECK_SHAPE} f32, TF32 off, "
          f"dropout 0, card against the same step on the CPU in f32 and "
          f"float64 from the same weights: all within phase 25's rule "
          f"(loss {TRAIN_LOSS_TOL}, each gradient leaf {TRAIN_GRAD_TOL} in "
          f"norm, BN 1e-5, or twice the CPU f32 step's own error); launches "
          f"{counts}; {time.perf_counter() - t0:.1f} s", flush=True)

    # 30. HybridBinary trained through train_signal
    t0 = time.perf_counter()
    root = os.path.join(HERE, "build", "chip_smoke_signal_train")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = os.path.join(root, "volumes")
    write_signal_volumes(data_dir)
    ds = load_json_dir(data_dir, seq_len=SIGNAL_TRAIN_SHAPE[1])
    reset_counts(counters)
    ck = os.path.join(root, "ckpt")
    trainer, state = train_signal(
        data_dir, ck, epochs=2, batch_size=SIGNAL_TRAIN_SHAPE[0],
        seq_len=SIGNAL_TRAIN_SHAPE[1], signal_length=s_len, seed=30,
        device=dev, log=lambda m: print(f"    {m}", flush=True))
    counts = launch_counts(counters)
    check(counts == none, f"train_signal launched {counts}")
    hist = trainer.history
    check(all(np.isfinite(hist["train_bce"])) and hist["epoch"] == [0, 1],
          f"train_signal history {hist}")
    fit_s = time.perf_counter() - t0
    model, meta = restore_signal_model(ck, device=dev)
    saved, _ = CheckpointManager(ck).restore(meta["step"])
    check(all(torch.equal(v.cpu(), {**saved["params"],
                                    **saved["batch_stats"]}[k])
              for k, v in model.state_dict().items()),
          "restore_signal_model: weights differ from the checkpoint")
    ep = SignalEndpoint(model, device=dev)
    probe = rng.normal(size=SIGNAL_TRAIN_SHAPE).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(probe).to(dev)).cpu().numpy()
        trained = state.model.eval()(torch.from_numpy(probe).to(dev)).cpu()
    got = ep.predict(probe)["prob"]
    ep_err = float(np.abs(got - want).max())
    check(ep_err <= 1e-6, f"SignalEndpoint on the restored model: {ep_err}")
    last = meta["step"] == hist["epoch"][-1]
    trained_err = float(np.abs(got - trained.numpy()).max())
    if last:
        check(trained_err <= 1e-6, f"the restored best epoch is the last, "
              f"yet differs from the trained model by {trained_err}")
    report = SignalEvaluator(ep.predict, threshold=0.5).run(ds)
    vol = parse_json_volume(os.path.join(data_dir, "vol0.json"))
    heat = prediction_map(ep.predict, vol)
    check(bool(np.isfinite(heat).all()), "prediction map not finite")
    print(f"[30 train_signal] HybridBinary/detection over the harness's "
          f"volumes {list(VOLUME_SEEDS)} as JSON ({len(ds)} sequences of "
          f"{SIGNAL_TRAIN_SHAPE[1]} x {s_len}), 2 epochs at batch "
          f"{SIGNAL_TRAIN_SHAPE[0]}, dropout 0.15 from the trainer's seeded "
          f"generator: train bce {[round(v, 4) for v in hist['train_bce']]}, "
          f"val loss {[round(v, 4) for v in hist.get('val_loss', [])]}, "
          f"{fit_s:.1f} s; restore_signal_model took epoch {meta['step']} "
          f"(the best, else the latest; metadata {meta}); SignalEndpoint on it "
          f"within {ep_err:.3g} of its forward"
          + (f", {trained_err:.3g} of the trained model" if last else "")
          + f"; SignalEvaluator accuracy {report['accuracy']:.4f} f1 "
          f"{report['f1']:.4f} auc {report['auc']:.4f}; prediction map "
          f"{heat.shape}, mean {float(heat.mean()):.4f}; launches {counts}",
          flush=True)

    # the loss falling, the timed step and its memory
    batch = next(iter(BatchIterator(ds, SIGNAL_TRAIN_SHAPE[0], seed=2)))
    one = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    recipe = RECIPES["detection"]
    tr = Trainer(build_signal_model("HybridBinary", device=dev, seed=31),
                 recipe.make_objective(), recipe_optimizer(recipe, 1))
    st = tr.init(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    rows = [tr.train_step(st, one) for _ in range(SIGNAL_LOSS_STEPS)]
    losses = [r["bce"] for r in rows]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"HybridBinary: the loss over {len(losses)} steps: {losses}")
    turns = []
    for _ in range(6):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(SIGNAL_TRAIN_TURN):
            tr.train_step(st, one)
        torch.cuda.synchronize()
        turns.append(1e3 * (time.perf_counter() - t1) / SIGNAL_TRAIN_TURN)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = launch_counts(counters)
    check(counts == none, f"the HybridBinary steps launched {counts}")
    print(f"[30 signal train] HybridBinary/detection at "
          f"{SIGNAL_TRAIN_SHAPE} f32, TF32 off, dropout on: median "
          f"{statistics.median(turns):.3f} ms/step (six turns of "
          f"{SIGNAL_TRAIN_TURN} steps, host clock, synchronized: "
          f"{[round(t, 3) for t in turns]}), peak memory {peak:.3f} GiB; bce "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps on "
          f"one batch; launches {counts}", flush=True)
    del tr, st

    # 20 steps of the seq_detector recipe at published width
    rec = RECIPES["seq_detector"]
    tr = Trainer(_seeded(lambda: SignalSequenceDetector(device=dev), 30),
                 rec.make_objective(),
                 recipe_optimizer(rec, SIGNAL_LOSS_STEPS))
    st = tr.init(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, rows = [], []
    for _ in range(SIGNAL_LOSS_STEPS):
        t1 = time.perf_counter()
        rows.append(tr.train_step(st, one))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
    lrs = sorted({g["lr"] for g in st.optimizer.adamw.param_groups})
    check(all(np.isfinite(r["ce"]) for r in rows), "seq_detector: loss")
    print(f"[30 seq_detector] SignalSequenceDetector (d 128, 4 heads, 4 "
          f"layers) under RECIPES['seq_detector'] at {SIGNAL_TRAIN_SHAPE}: "
          f"median {statistics.median(times[5:]):.3f} ms/step over steps "
          f"5-{SIGNAL_LOSS_STEPS - 1} (host clock, synchronized; all "
          f"{[round(t, 2) for t in times]}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; total "
          f"{rows[0]['ce'] + rows[0]['position']:.4f} -> "
          f"{rows[-1]['ce'] + rows[-1]['position']:.4f} (ce + position); "
          f"last lr of the three groups {lrs} (cosine over "
          f"{SIGNAL_LOSS_STEPS} steps)", flush=True)
    del tr, st

    # 31. phases, curriculum, autoencoder, gates, export
    t0 = time.perf_counter()
    reset_counts(counters)
    hybrid = build_signal_model("Hybrid", device=dev, seed=31)
    det_mask = HybridPhases().phase_masks()[0]
    tr = Trainer(hybrid, det.make_objective(), make_optimizer(
        1e-2, group_lr_mults=det_mask,
        group_patterns=HybridPhases.group_patterns()))
    st = tr.init(batch)
    before = {k: p.detach().clone() for k, p in hybrid.named_parameters()}
    tr.train_step(st, one)
    frozen = [k for k in before if not k.startswith("detection.")]
    moved = [k for k in before if k.startswith("detection.")
             and not torch.equal(before[k], dict(
                 hybrid.named_parameters())[k])]
    check(frozen and all(torch.equal(before[k], dict(
        hybrid.named_parameters())[k]) for k in frozen) and moved,
        "HybridPhases: a frozen group moved or detection did not")
    del tr, st, hybrid

    plateaus = []

    def factory():
        plateaus.append(ReduceLROnPlateau(patience=0))
        return plateaus[-1]

    tr_ds, va_ds = train_val_split(ds)
    ctr = Trainer(build_signal_model("HybridBinary", device=dev, seed=32),
                  recipe.make_objective(), recipe_optimizer(recipe, 1))
    cst = ctr.init(batch)
    SNRCurriculum(pretrain_epochs=1, epochs=1).run(
        ctr, cst, (lambda: BatchIterator(tr_ds, 8, seed=1),
                   lambda: BatchIterator(va_ds, 8, shuffle=False,
                                         drop_remainder=False)),
        (lambda: BatchIterator(tr_ds, 8, seed=2),
         lambda: BatchIterator(va_ds, 8, shuffle=False,
                               drop_remainder=False)),
        plateau_factory=factory, log=lambda m: None)
    check(len(plateaus) == 2 and plateaus[0] is not plateaus[1]
          and ctr.history["lr_scale"] == [1.0, 1.0],
          f"SNRCurriculum: controllers {plateaus}, lr scales "
          f"{ctr.history['lr_scale']}")
    del ctr, cst

    healthy = ds.signals[ds.labels == 0]
    defective = ds.signals[ds.labels == 1]
    ae = anomaly.train_autoencoder(healthy, epochs=3, device=dev)
    thr = anomaly.anomaly_threshold(ae, healthy)
    flagged_h = anomaly.detect_anomalies(ae, healthy, thr)["is_anomaly"]
    flagged_d = anomaly.detect_anomalies(ae, defective, thr)["is_anomaly"]
    check(np.isfinite(thr) and flagged_h.shape == (len(healthy),),
          f"autoencoder threshold {thr}")

    dscan = vol.signals[vol.beam_keys[0]]
    gates = find_gates(dscan)
    a, b = gates[0]
    x = torch.from_numpy(probe).to(dev)
    gated = gate_mask(x, a, b).cpu().numpy()
    keep = (np.arange(s_len) >= a) & (np.arange(s_len) < b)
    check(np.array_equal(gated, probe * keep), "gate_mask differs from the "
          "numpy mask")

    path = os.path.join(root, "hybrid_binary.pt2")
    served = build_signal_model("HybridBinary", device=dev, seed=33)
    export_signal_model(served, (2,) + SIGNAL_TRAIN_SHAPE[1:], path,
                        polymorphic_batch=True, device=dev)
    run = load_exported(path)
    export_errs = []
    for bsz in (2, 5):
        xb = torch.from_numpy(rng.normal(size=(bsz,) + SIGNAL_TRAIN_SHAPE[
            1:]).astype(np.float32)).to(dev)
        with torch.no_grad():
            export_errs.append(max_abs_err(run(xb), served(xb)))
    check(max(export_errs) <= 1e-5, f"exported HybridBinary: {export_errs}")
    counts = launch_counts(counters)
    check(counts == none, f"phase 31 launched {counts}")
    print(f"[31 signal tools] HybridPhases phase 1 on Hybrid: "
          f"{len(moved)} detection tensors moved, {len(frozen)} frozen "
          f"bit-equal; SNRCurriculum(1, 1): two fresh controllers, each "
          f"stage from lr scale 1.0; train_autoencoder on "
          f"{len(healthy)} healthy signals: threshold {thr:.5f}, flags "
          f"{flagged_h.mean():.3f} of the healthy and {flagged_d.mean():.3f} "
          f"of {len(defective)} defect signals; find_gates {gates}, "
          f"gate_mask == numpy; export_signal_model(HybridBinary) .pt2 "
          f"loaded on the card, batches 2 and 5 within "
          f"{max(export_errs):.3g} of eager; launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def write_signal_volumes(data_dir: str) -> None:
    """The accuracy harness's volumes of ``VOLUME_SEEDS`` as JSON."""
    from pautdx_torch.data import synthetic
    from pautdx_torch.eval import accuracy

    os.makedirs(data_dir)
    for i, (spec, defects) in enumerate(accuracy.harness_volumes(
            VOLUME_SEEDS, 1)):
        synthetic.write_json_volume(os.path.join(data_dir, f"vol{i}.json"),
                                    spec, defects)


@contextmanager
def all_int8_inputs(captured: dict):
    """Keep the arguments of the first call of each distinct int8 site
    shape (input shape, dtype and strides, weight, stride, padding,
    groups) and the number of calls of each, for a while."""
    from pautdx_torch.ops import qconv

    saved = qconv.int8_conv

    def wrapper(x, weight, stride, padding, groups, in_scale, prepared):
        key = (tuple(x.shape), str(x.dtype).split(".")[1], x.stride(),
               tuple(weight.shape), stride, padding, groups)
        entry = captured.setdefault(key, [
            (x, weight, stride, padding, groups, in_scale, prepared), 0])
        entry[1] += 1
        return saved(x, weight, stride, padding, groups, in_scale, prepared)

    qconv.int8_conv = wrapper
    try:
        yield
    finally:
        qconv.int8_conv = saved


def int_mm_times(torch, x, prep, want_acc) -> tuple:
    """At a 1x1 stride-1 site: device ms of ``torch._int_mm`` over the input
    already quantized and flattened channels-last (the same s8 x s8 -> s32
    product, without the quantization and dequantization), the ms of that
    quantization in plain PyTorch, and whether the product equals the
    kernel's accumulators."""
    N, C, H, W = x.shape
    s = prep.in_scale.to(x.device)

    def quantize():
        return torch.clamp(torch.round(x.permute(0, 2, 3, 1).reshape(-1, C)
                                       .float() / s), -127, 127).to(torch.int8)

    xq = quantize().contiguous()
    wt = prep.q.reshape(prep.q.shape[0], C).t()
    try:
        got = torch._int_mm(xq, wt)
    except RuntimeError as e:   # a yardstick: its refusal fails nothing
        print(f"[32 int8 conv] torch._int_mm refuses {tuple(xq.shape)} x "
              f"{tuple(wt.shape)}: {e}", flush=True)
        return None, None, None
    same = torch.equal(got, want_acc.permute(0, 2, 3, 1).reshape(
        -1, got.shape[1]))
    return (device_ms(lambda: torch._int_mm(xq, wt), reps=5),
            device_ms(quantize, reps=5), same)


def int8_site_equal(torch, key, args) -> tuple:
    """The int8 kernel at one captured site against its plain version: the
    int32 accumulators and the dequantized output equal bit for bit, one
    launch each on the route the wrapper picks. Returns (route, output,
    the plain accumulators)."""
    from pautdx_torch.ops import qconv

    x, w, st, pad, g, _, prep = args
    w = w.detach()
    route = qconv.int8_route(x.shape, x.stride(), x.element_size(),
                             x.data_ptr(), prep.q.shape,
                             qconv._pair(st, "stride"), g)
    before = dict(qconv.LAUNCHES_BY_ROUTE)
    with torch.inference_mode():
        acc = qconv.int8_accumulators(x, prep, st, pad)
        want_acc = qconv.int8_accumulators_reference(x, prep, st, pad)
        out = qconv.int8_conv(x, w, st, pad, g, None, prep)
        want = qconv.int8_conv_reference(x, w, st, pad, g, None, prep)
    check(torch.equal(acc, want_acc), f"int8 conv {key}: the kernel's int32 "
          f"accumulators differ from the plain version's in "
          f"{int((acc != want_acc).sum())} places")
    check(out.dtype == want.dtype and torch.equal(out, want),
          f"int8 conv {key}: the kernel's output differs from the plain "
          f"version's by {max_abs_err(out, want):.3g}")
    check(qconv.LAUNCHES_BY_ROUTE == dict(before, **{route: before[route]
                                                     + 2}),
          f"int8 conv {key}: launches by route {qconv.LAUNCHES_BY_ROUTE}, "
          f"want two more on {route} than {before}")
    return route, out, want_acc


def int8_site_record(torch, key, args, calls: int) -> dict:
    """Phase 32's check and times of one int8 site shape: the route the
    wrapper picks, the kernel's int32 accumulators and dequantized output
    against the plain version's bit for bit (one launch each, on that
    route), then device times (L2 flushed) of the kernel, the plain
    version and two yardsticks: cuDNN's bf16 convolution at the same shape
    (not the same function) and, at 1x1 stride-1 sites, ``torch._int_mm``
    (the same product, see :func:`int_mm_times`); and the bound: the input
    read once, the output written once and the int8 weights at the HBM
    rate, against the int8 operations at the dense int8 peak."""
    from pautdx_torch.ops import qconv

    F = torch.nn.functional
    x, w, st, pad, g, _, prep = args
    w = w.detach()
    sp = qconv._pair(st, "stride")
    route, out, want_acc = int8_site_equal(torch, key, args)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    ms = device_ms(lambda: qconv.int8_conv(x, w, st, pad, g, None, prep),
                   reps=5)
    plain_ms = device_ms(lambda: qconv.int8_conv_reference(
        x, w, st, pad, g, None, prep), reps=3)
    library_ms = device_ms(lambda: F.conv2d(xb, wb, None, st, pad, 1, g),
                           reps=5)
    N, C, H, W = x.shape
    O, I, kh, kw = prep.q.shape
    int_mm = (int_mm_times(torch, x, prep, want_acc)
              if g == 1 and kh == 1 and sp == 1 else (None, None, None))
    nbytes = (x.numel() * x.element_size() + out.numel()
              * out.element_size() + prep.q.numel())
    ops = 2 * out.numel() * I * kh * kw
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS_PER_S
    return dict(calls=calls, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                int_mm_ms=int_mm[0], int_mm_quant_ms=int_mm[1],
                int_mm_equal=int_mm[2], route=route, input_channels=C,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                nbytes=nbytes, ops=ops, depthwise=g > 1,
                shape=f"x {tuple(x.shape)} {key[1]}"
                      f"{' channels-last' if x.stride(1) == 1 else ''}, "
                      f"w {tuple(prep.q.shape)}, stride {st}, pad {pad}, "
                      f"groups {g}")


def int8_nonfinite_check(torch, captured: list) -> str:
    """Phase 32's check of non-finite inputs: the first captured site of
    each route, its input copied with NaN (quantized to 0) and +inf and
    -inf (to +-127) written in, through the kernel and the plain version:
    the int32 accumulators and the output equal bit for bit, the output
    finite. Fails unless the wgmma, dp4a and generic routes are all
    covered."""
    from pautdx_torch.ops import qconv

    seen = {}
    for (x, w, st, pad, g, _, prep), _n in captured:
        route = qconv.int8_route(x.shape, x.stride(), x.element_size(),
                                 x.data_ptr(), prep.q.shape,
                                 qconv._pair(st, "stride"), g)
        if route in seen:
            continue
        with torch.inference_mode():
            x = x.clone()
            x[:, ::3, ::4, 1::5] = float("nan")
            x[:, 1::3, 2::4, ::7] = float("inf")
            x[:, 2::3, 1::5, 3::6] = -float("inf")
            acc = qconv.int8_accumulators(x, prep, st, pad)
            want_acc = qconv.int8_accumulators_reference(x, prep, st, pad)
            out = qconv.int8_conv(x, w.detach(), st, pad, g, None, prep)
            want = qconv.int8_conv_reference(x, w.detach(), st, pad, g,
                                             None, prep)
        torch.cuda.synchronize()
        shape = f"x {tuple(x.shape)} {x.dtype}, w {tuple(prep.q.shape)}"
        check(torch.equal(acc, want_acc),
              f"int8 conv, NaN/inf input {shape}: the accumulators differ "
              f"from the plain version's in {int((acc != want_acc).sum())} "
              f"places")
        check(torch.equal(out, want) and bool(torch.isfinite(out).all()),
              f"int8 conv, NaN/inf input {shape}: the output differs from "
              f"the plain version's or is not finite")
        seen[route] = shape
    check(set(seen) == {"wgmma", "dp4a", "generic"},
          f"int8 conv, NaN/inf inputs: routes covered {sorted(seen)}, want "
          f"wgmma, dp4a and generic")
    return "; ".join(f"{r}: {v}" for r, v in sorted(seen.items()))


def int8_forward_record(name: str, rows: list, launches: int,
                        what: str) -> dict:
    """The kernel line's record of the int8 convolution over one forward
    of a path: each site shape's times and bound times its calls, summed;
    beside them the dense and depthwise parts, the sites by route, and
    ``torch._int_mm`` summed over the 1x1 sites with the kernel's own
    time at those sites."""
    def total(k, sel=lambda r: True):
        return sum(r[k] * r["calls"] for r in rows if sel(r))

    tot = {k: total(k) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "nbytes", "ops")}
    t_bytes = tot["nbytes"] / PEAK_BYTES_PER_S
    t_ops = tot["ops"] / PEAK_INT8_OPS_PER_S
    one = lambda r: r["int_mm_ms"] is not None  # noqa: E731
    parts = {kind: {k: total(k, lambda r, d=dw: r["depthwise"] == d)
                    for k in ("ms", "library_ms", "bound_ms")}
             for kind, dw in (("dense", False), ("depthwise", True))}
    routes = {}
    for r in rows:
        routes[r["route"]] = routes.get(r["route"], 0) + r["calls"]
    return dict(
        name=name, route="cuda", source="pautdx_torch/csrc/int8_conv.cu",
        replaces="pautdx/ops/qconv.py:58 (XLA's s8 x s8 -> s32 "
                 "convolution; no Pallas kernel)",
        launches=launches, max_abs_err=0.0, ms=tot["ms"],
        plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=tot["library_ms"],
        library_note="cuDNN's bf16 convolution at the same shapes, a "
                     "yardstick: no PyTorch call computes the int8 "
                     "convolution; at the 1x1 sites torch._int_mm computes "
                     "its s8 x s8 -> s32 product (int_mm_ms, over input "
                     "already quantized; int_mm_quant_ms that quantization)",
        int_mm_ms=total("int_mm_ms", one),
        int_mm_quant_ms=total("int_mm_quant_ms", one),
        int_mm_kernel_ms=total("ms", one),
        int_mm_bound_ms=total("bound_ms", one),
        int_mm_sites=sum(r["calls"] for r in rows if one(r)),
        parts=parts, sites_by_route=routes,
        shape=f"{what}: {sum(r['calls'] for r in rows)} sites of "
              f"{len(rows)} shapes, {tot['nbytes']} bytes, {tot['ops']} "
              f"int8 operations")


def encode_us() -> float:
    """Host microseconds one TMA map encode takes (the C library's own
    timing over 2,000 encodes): each call on a TMA route encodes one."""
    import ctypes

    from pautdx_torch.ops import _build

    fn = _build.load("int8_conv").pautdx_int8_encode_us
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_double
    return fn(2000)


def int8_phases(torch, dev, counters: dict, wrappers: dict, none: dict,
                bf16_fps: list) -> list:
    """Phases 32-34: the int8 convolution kernel against its plain version
    at every site shape of the two int8 paths, then the int8 D-FINE-nano
    serving run and the int8 YOLOv8n-seg predict run; returns the
    kernel's records."""
    from pautdx_torch.models.vision.dfine import DFine
    from pautdx_torch.ops import masks, qconv, suppress
    from pautdx_torch.serve.throughput import (
        build_serving_model, make_streaming_forward, make_uint8_slab,
        measure_fps,
    )
    from pautdx_torch.serve.yolo_predict import (
        build_yolo_predictor, make_frame_slab, make_yolo_stream,
    )

    set_tf32(False)
    t0 = time.perf_counter()
    # the int8 serving model, calibrated on a seeded slab of two steps
    calib = make_uint8_slab((2, BATCH, 80, 80, 192), seed=5, device=dev)
    served = build_serving_model(device=dev, batch=BATCH, seed=0,
                                 int8_calib=calib)
    check(len(served.quant) == INT8_DFINE_SITES,
          f"int8 serving: {len(served.quant)} calibrated sites, want "
          f"{INT8_DFINE_SITES}")
    slab = make_uint8_slab(served.slab_shape(N_STEPS), seed=2, device=dev)
    dcap = {}
    with torch.inference_mode(), all_int8_inputs(dcap):
        served.model(slab[0])
    # YOLOv8n-seg, calibrated on the first batch it predicts
    ypred = build_yolo_predictor(device=dev, seed=0, int8_calib="first")
    frames = make_frame_slab(1, 4, seed=3, device=dev)[0]
    reset_counts(counters)
    det_k = ypred(frames)
    torch.cuda.synchronize()
    per_predict = launch_counts(counters)
    check(len(ypred.quant) == INT8_YOLO_SITES,
          f"int8 YOLO: {len(ypred.quant)} calibrated sites, want "
          f"{INT8_YOLO_SITES}")
    yslab = make_frame_slab(YOLO_STEPS, YOLO_BATCH, seed=4, device=dev)
    ycap = {}
    with all_int8_inputs(ycap):
        ypred(yslab[0])
    setup_s = time.perf_counter() - t0

    # 32. the kernel against its plain version at every site shape
    t0 = time.perf_counter()
    rows = {}
    for path, cap in (("dfine", dcap), ("yolo", ycap)):
        with torch.inference_mode():
            rows[path] = [int8_site_record(torch, key, args, n)
                          for key, (args, n) in cap.items()]
        for r in rows[path]:
            int_mm = ("" if r["int_mm_ms"] is None else
                      f", torch._int_mm {r['int_mm_ms']:.4f} (+ quantize "
                      f"{r['int_mm_quant_ms']:.4f}; == accumulators: "
                      f"{r['int_mm_equal']})")
            print(f"[32 int8 conv {path}] {r['shape']}, {r['calls']} "
                  f"site(s) a forward, route {r['route']}: accumulators "
                  f"and output == plain; device ms kernel {r['ms']:.4f}, "
                  f"plain {r['plain_ms']:.4f}, cuDNN bf16 "
                  f"{r['library_ms']:.4f}{int_mm}, bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}"
                  f"{', half reached' if r['ms'] <= 2 * r['bound_ms'] else ''}"
                  f")", flush=True)
        # every site on a TMA route but YOLO's 3-channel stem
        off = [r["shape"] for r in rows[path] if (r["route"] == "generic")
               != (r["input_channels"] == 3)]
        check(not off, f"int8 conv {path}: sites on the wrong route: {off}")
    nonfinite = int8_nonfinite_check(torch, list(dcap.values())
                                     + list(ycap.values()))
    del dcap, ycap
    enc = encode_us()
    tma_sites = sum(r["calls"] for path in rows for r in rows[path]
                    if r["route"] != "generic")
    print(f"[32 int8 conv] kernel == plain bit for bit (int32 "
          f"accumulators and the dequantized output) at "
          f"{len(rows['dfine'])} D-FINE-nano serving site shapes (b{BATCH} "
          f"bf16, {sum(r['calls'] for r in rows['dfine'])} sites) and "
          f"{len(rows['yolo'])} YOLOv8n-seg site shapes (b{YOLO_BATCH} f32,"
          f" {sum(r['calls'] for r in rows['yolo'])} sites); "
          f"{time.perf_counter() - t0:.1f} s (set-up "
          f"{setup_s:.1f} s); host cost of the TMA map encodes "
          f"{enc:.3f} us each, {tma_sites} of the {INT8_DFINE_SITES} + "
          f"{INT8_YOLO_SITES} sites a forward on a TMA route "
          f"({enc * tma_sites:.1f} us over both forwards); with NaN and "
          f"+-inf in the input, kernel == plain bit for bit on every route "
          f"({nonfinite})", flush=True)

    # 33. int8 D-FINE-nano serving
    t0 = time.perf_counter()
    stream = make_streaming_forward(served.model)
    stream(slab[:1])
    torch.cuda.synchronize()
    reset_counts(counters)
    logits, boxes, finite = stream(slab)
    torch.cuda.synchronize()
    counts = launch_counts(counters)
    want = dict(none, aifi_attention=N_STEPS, onehot_gather=3 * N_STEPS,
                int8_conv=INT8_DFINE_SITES * N_STEPS)
    check(counts == want, f"int8 serving run launches {counts}, want {want}")
    check(bool(finite), "int8 serving outputs are not all finite")
    check(tuple(logits.shape) == (BATCH, 150, 2)
          and tuple(boxes.shape) == (BATCH, 150, 4),
          f"int8 serving outputs {tuple(logits.shape)} "
          f"{tuple(boxes.shape)}")
    # the plain int8 arm: the int8 convolutions through their plain
    # version, every other kernel as served (in bf16 the plain attention
    # rounds P before P.V, which moves the top-k query selection of random
    # weights, so the whole plain path would not isolate this kernel)
    int8_plain = {"int8_conv": qconv}
    with torch.inference_mode():
        out_k = served.model(slab[0])
        with plain_kernels(int8_plain):
            out_p = served.model(slab[0])
    why = same_detections(*(t.float().cpu().numpy() for t in (
        out_k["logits"], out_k["pred_boxes"], out_p["logits"],
        out_p["pred_boxes"])))
    check(not why, f"int8 serving, kernels vs plain: {why}")
    exact = all(torch.equal(out_k[k], out_p[k])
                for k in ("logits", "pred_boxes"))
    dense = build_serving_model(device=dev, batch=BATCH, seed=0)
    dstream = make_streaming_forward(functools.partial(DFine.forward,
                                                       dense.model))
    dstream(slab[:1])
    fps = {"int8": [], "bf16": []}
    for arm in ("int8", "bf16", "bf16", "int8") * 2:
        fps[arm].append(measure_fps(stream if arm == "int8" else dstream,
                                    slab))
    with plain_kernels(int8_plain):
        plain_fps = measure_fps(stream, slab[:1])
    phase6 = (f"median {statistics.median(bf16_fps):.1f}" if bf16_fps
              else "not run")
    print(f"[33 int8 serving] bench config, int8 activations at "
          f"{INT8_DFINE_SITES} sites, bf16 elsewhere, uint8 slab "
          f"{tuple(slab.shape)}, {smi_line()}: median "
          f"{statistics.median(fps['int8']):.1f} frames/s through the kernels "
          f"{[round(f, 1) for f in fps['int8']]}, median "
          f"{statistics.median(fps['bf16']):.1f} for bf16 serving in turns "
          f"with it {[round(f, 1) for f in fps['bf16']]} (phase 6: "
          f"{phase6}), {plain_fps:.1f} with the int8 convolutions through "
          f"their plain version over one step; launches over one slab: "
          f"{counts}; detections through the kernel match that plain int8 "
          f"arm's by assignment on {BATCH} frames (logits and boxes "
          f"{'bit-equal' if exact else 'not bit-equal'}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    records = [int8_forward_record(
        "int8_conv", rows["dfine"], counts["int8_conv"],
        f"one b{BATCH} forward of the D-FINE-nano serving slab")]
    del served, dense, stream, dstream, slab, calib, out_k, out_p

    # 34. int8 YOLOv8n-seg predict at b32
    t0 = time.perf_counter()
    want = dict(none, nms_suppress=1, assemble_masks=1,
                int8_conv=INT8_YOLO_SITES)
    check(per_predict == want, f"one int8 predict (the calibrating one) "
          f"launched {per_predict}, want {want}")
    reset_counts(counters)
    det_k = ypred(frames)
    with plain_kernels(wrappers):
        det_p = ypred(frames)
    check(launch_counts(counters) == want, f"int8 predict launched "
          f"{launch_counts(counters)}, want {want}")
    differ = [k for k in DETECTION_KEYS if not torch.equal(det_k[k],
                                                           det_p[k])]
    check(not differ, f"int8 yolo: detections through the kernels differ "
          f"from the plain versions' in {differ}")
    err = max_abs_err(det_k["masks"], det_p["masks"])
    check(err <= MASK_TOL, f"int8 yolo: masks differ by {err:.3g}")
    ystream = make_yolo_stream(ypred)
    ystream(yslab[:1])
    torch.cuda.synchronize()
    reset_counts(counters)
    det, finite = ystream(yslab)
    torch.cuda.synchronize()
    ycounts = launch_counts(counters)
    want = dict(none, nms_suppress=YOLO_STEPS, assemble_masks=YOLO_STEPS,
                int8_conv=INT8_YOLO_SITES * YOLO_STEPS)
    check(ycounts == want, f"int8 predict run launches {ycounts}, want "
          f"{want}")
    check(bool(finite), "int8 predict outputs are not all finite")
    check(tuple(det["boxes"].shape) == (YOLO_BATCH, 100, 4)
          and tuple(det["masks"].shape) == (YOLO_BATCH, 100, 160, 160),
          f"int8 predict outputs {tuple(det['boxes'].shape)} "
          f"{tuple(det['masks'].shape)}")
    dense = build_yolo_predictor(device=dev, seed=0)
    dstream = make_yolo_stream(dense)
    dstream(yslab[:1])
    yfps = {"int8": [], "f32": []}
    for arm in ("int8", "f32", "f32", "int8") * 2:
        yfps[arm].append(measure_fps(ystream if arm == "int8" else dstream,
                                     yslab))
    print(f"[34 int8 yolo] yolov8n-seg, int8 activations at "
          f"{INT8_YOLO_SITES} sites (calibrated on the first batch), f32 "
          f"elsewhere, uint8 slab {tuple(yslab.shape)}: median "
          f"{statistics.median(yfps['int8']):.1f} frames/s "
          f"{[round(f, 1) for f in yfps['int8']]}, median "
          f"{statistics.median(yfps['f32']):.1f} for the f32 predictor in "
          f"turns with it {[round(f, 1) for f in yfps['f32']]}; b4 predict "
          f"through the kernels == plain (masks max |err| {err:.3g}); "
          f"launches per predict {per_predict}, over one slab {ycounts}; "
          f"outputs finite; {det['valid'].sum(1).tolist()[:8]}... valid per "
          f"frame; {time.perf_counter() - t0:.1f} s", flush=True)
    records.append(int8_forward_record(
        "int8_conv_yolov8n_seg", rows["yolo"], ycounts["int8_conv"],
        f"one b{YOLO_BATCH} f32 forward of YOLOv8n-seg"))
    for r in records:
        parts = "; ".join(f"{k} kernel {v['ms']:.4f}, cuDNN bf16 "
                          f"{v['library_ms']:.4f}, bound {v['bound_ms']:.4f}"
                          for k, v in r["parts"].items() if v["ms"])
        print(f"[34 int8 conv record {r['name']}] {r['shape']}: device ms a "
              f"forward kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, "
              f"cuDNN bf16 {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}); {parts}; at the {r['int_mm_sites']} 1x1 "
              f"sites kernel {r['int_mm_kernel_ms']:.4f}, torch._int_mm "
              f"{r['int_mm_ms']:.4f} + quantize {r['int_mm_quant_ms']:.4f}, "
              f"bound {r['int_mm_bound_ms']:.4f}; sites by route "
              f"{r['sites_by_route']}; {r['launches']} launches over the "
              f"slab", flush=True)
    return records


def host_phase(torch, dev) -> None:
    """Phase 35: the HF D-FINE bridge's round trip at the HF-architecture
    predict model, and phase 19's volumes through the C++ reader against
    the numpy path."""
    from pautdx_torch import native
    from pautdx_torch.compat import dfine_import
    from pautdx_torch.data.volume import parse_json_volume, parse_txt_tree
    from pautdx_torch.models.vision.dfine import DFine
    from pautdx_torch.serve.dfine_predict import build_dfine_predictor

    t0 = time.perf_counter()
    model = build_dfine_predictor(device=dev, seed=0).model
    exported = dfine_import.export_state_dict(model)
    back = DFine(model.cfg, device=dev, seed=1)
    unused = dfine_import.load_hf_state_dict(back, exported)
    check(all(k.startswith("model.decoder.") for k in unused),
          f"HF bridge: unexpected unused keys {unused[:6]}")
    differ = [k for k, v in model.state_dict().items()
              if not torch.equal(v, back.state_dict()[k])]
    check(not differ, f"HF bridge: the round trip changed {differ[:6]}")
    frames = torch.rand((2, 640, 640, 3), generator=torch.Generator(
        device=dev).manual_seed(9), device=dev)
    with torch.inference_mode():
        a, b = model(frames), back(frames)
    why = same_detections(*(t.float().cpu().numpy() for t in (
        a["logits"], a["pred_boxes"], b["logits"], b["pred_boxes"])))
    check(not why, f"HF bridge: the round-tripped model's detections: {why}")
    same = "bit-equal" if torch.equal(a["logits"], b["logits"]) else \
        "matched by assignment"
    bridge = (f"{len(exported)} HF entries exported, converted back "
              f"bit-equal ({len(unused)} tied aliases unused), outputs "
              f"{same}")
    del model, back, frames, a, b

    check(native.native_available(), f"the C++ reader does not build: "
          f"{native.native_error()}")
    root = os.path.join(HERE, "build", "chip_smoke_native")
    shutil.rmtree(root, ignore_errors=True)
    before = native.NATIVE_PARSES
    vols = write_volumes(root)
    check(native.NATIVE_PARSES == before + len(vols),
          f"the C++ reader answered {native.NATIVE_PARSES - before} of "
          f"{len(vols)} parses")
    for i, vol in enumerate(vols):
        ref = (parse_json_volume(os.path.join(root, f"vol{i}.json"),
                                 use_native=False) if i < 2 else
               parse_txt_tree(root, f"vol{i}", use_native=False))
        check(vol.beam_keys == ref.beam_keys
              and all(np.array_equal(vol.signals[k], ref.signals[k])
                      and vol.scan_infos[k] == ref.scan_infos[k]
                      for k in ref.beam_keys),
              f"volume {i}: the C++ reader differs from the numpy path")
    print(f"[35 host] HF D-FINE bridge at DFineConfig(num_labels=2, "
          f"encoder_fused_attn=True): {bridge}; phase 19's volumes (2 JSON, "
          f"2 txt trees) through the C++ reader ({native.lib_path().name}, "
          f"{len(vols)} native parses) == the numpy path bit for bit; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# phase 36: predict-bscan's arms: (tag, flags); each runs through the
# kernels and through the plain versions
CLI_DFINE_ARMS = (("dfine", ()), ("dfine fused-attn", ("--fused-attn",)),
                  ("dfine prepatch", ("--prepatch",)),
                  ("dfine int8", ("--quant", "int8")))
CLI_YOLO_FLAVOURS = ("v8", "v5", "v9c", "v11")
CLI_SIZE = 640
CLI_TRAIN_SIZE = 320


def detections_rule(got: dict, want: dict) -> str:
    """:func:`same_detections`' rule on two ``detections.json``: per frame,
    features [box / size, score], a bijection by assignment, all but at
    most 4 pairs within 2e-3 and the median within 1e-3, equal labels for
    the pairs within 2e-3. Returns "" or why not."""
    if got.keys() != want.keys():
        return f"sequences {sorted(got)} vs {sorted(want)}"
    for seq in want:
        if len(got[seq]) != len(want[seq]):
            return f"{seq}: {len(got[seq])} vs {len(want[seq])} frames"
        for t, (g, w) in enumerate(zip(got[seq], want[seq])):
            if len(g) != len(w):
                return f"{seq} frame {t}: {len(g)} vs {len(w)} detections"
            if not g:
                continue

            def feats(dets):
                return np.array([[*(np.array(d["box"]) / CLI_SIZE),
                                  d["score"]] for d in dets])

            cost = np.linalg.norm(feats(g)[:, None] - feats(w)[None], axis=-1)
            m = matched_costs(cost)
            if (m < 2e-3).sum() < len(m) - 4 or np.median(m) >= 1e-3:
                return (f"{seq} frame {t}: worst matched costs "
                        f"{np.sort(m)[-6:]}, median {np.median(m):.3g}")
            from scipy.optimize import linear_sum_assignment
            r, c = linear_sum_assignment(cost)
            if any(g[i]["label"] != w[j]["label"] for i, j in zip(r, c)
                   if cost[i, j] < 2e-3):
                return f"{seq} frame {t}: labels differ in matched pairs"
    return ""


@contextmanager
def cli_forwards(torch, counters: dict, log: list, sites: list):
    """For a while, every detector forward ``pautdx_torch.cli`` builds
    appends (frames, launches it made) to ``log``, and every int8
    calibration the number of sites it calibrated to ``sites``."""
    from pautdx_torch import cli
    from pautdx_torch.serve import quantize

    build, calibrate = cli.build_detector_forward, quantize.calibrate_int8

    def counted_build(*args, **kw):
        forward = build(*args, **kw)

        def counted(frames):
            before = launch_counts(counters)
            out = forward(frames)
            torch.cuda.synchronize()
            after = launch_counts(counters)
            log.append((frames.shape[0], {k: after[k] - before[k]
                                          for k in after}))
            return out

        return counted

    def counted_calibrate(model, batches):
        quant = calibrate(model, batches)
        sites.append(len(quant))
        return quant

    cli.build_detector_forward = counted_build
    quantize.calibrate_int8 = counted_calibrate
    try:
        yield
    finally:
        cli.build_detector_forward = build
        quantize.calibrate_int8 = calibrate


def cli_run(label: str, argv: list, timings: list) -> float:
    """``pautdx_torch.cli.main(argv + --device cuda)`` in this process;
    (``label``, its wall seconds) is appended to ``timings``."""
    import torch

    from pautdx_torch import cli

    t0 = time.perf_counter()
    cli.main(list(argv) + ["--device", "cuda"])
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    timings.append((label, s))
    return s


def cli_processes(jobs: dict, root: str, timeout: float) -> dict:
    """Start every job ``{name: (argv, stdin text)}`` at once as ``python
    -m pautdx_torch.cli argv`` (the checkout on ``PYTHONPATH``, its output
    in files under ``root``) and wait for all of them; returns ``{name:
    (exit code, stdout, stderr, wall seconds from the start)}``. A process
    still running at ``timeout`` seconds, or when this fails, is killed."""
    procs, files, res = {}, [], {}
    t0 = time.perf_counter()
    try:
        for name, (argv, stdin) in jobs.items():
            base = os.path.join(root, f"proc_{name}")
            with open(base + ".in", "w") as f:
                f.write(stdin)
            fds = [open(base + ".in"), open(base + ".out", "w"),
                   open(base + ".err", "w")]
            files += fds
            procs[name] = (base, subprocess.Popen(
                [sys.executable, "-m", "pautdx_torch.cli", *argv], cwd=HERE,
                stdin=fds[0], stdout=fds[1], stderr=fds[2],
                env=dict(os.environ, PYTHONPATH=HERE)))
        while len(res) < len(procs):
            check(time.perf_counter() - t0 < timeout,
                  f"cli processes {sorted(set(procs) - set(res))} still "
                  f"running after {timeout} s")
            for name, (base, p) in procs.items():
                if name not in res and p.poll() is not None:
                    res[name] = (p.returncode, read_text(base + ".out"),
                                 read_text(base + ".err"),
                                 time.perf_counter() - t0)
            time.sleep(0.05)
        return res
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()


def read_text(path: str) -> str:
    with open(path) as f:
        return f.read()


def kernel_ab_module():
    """``kernel_ab.py`` beside this script, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "kernel_ab", os.path.join(HERE, "kernel_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def cli_phase(torch, dev, counters: dict, wrappers: dict,
              none: dict) -> None:
    """Phase 36: the command line on the card, in this process through
    ``pautdx_torch.cli.main`` and once as ``python -m pautdx_torch.cli``
    (see the module docstring)."""
    from pautdx_torch import cli
    from pautdx_torch.ops import qconv
    from pautdx_torch.models.vision.temporal_dfine import TemporalDFine
    from pautdx_torch.models.vision.yolo import YOLO, YoloConfig
    from pautdx_torch.serve.export import load_exported
    from pautdx_torch.train.checkpoint import (
        CheckpointManager, load_model_state, restore_dfine,
    )
    from pautdx_torch.train.signal import restore_signal_model
    from pautdx_torch.train.temporal import tiny_temporal_config
    from pautdx_torch.viz import have_matplotlib

    set_tf32(False)
    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    data, sig = os.path.join(root, "data"), os.path.join(root, "signals")
    write_volumes(data)
    write_signal_volumes(sig)
    # the plain versions' runs go over the first volume alone, which is
    # also the int8 arms' calibration request
    data1 = os.path.join(root, "data1")
    os.makedirs(data1)
    shutil.copy(os.path.join(data, "vol0.json"), data1)
    out = lambda *p: os.path.join(root, *p)  # noqa: E731
    timings: list = []

    # (a) predict-bscan through the kernels and the plain versions
    runs, new_sites = {}, {}
    checks_s = {"plain arms": 0.0, "int8 site checks": 0.0}
    known = {(C, H, W, tuple(w), st, g) for C, H, W, _, _, w, st, g, _ in
             kernel_ab_module().INT8_SITES["yolo"]}
    arms = [(tag, ("--detector", "dfine") + flags)
            for tag, flags in CLI_DFINE_ARMS]
    arms += [(f"yolo {f}{' int8' if q else ''}",
              ("--detector", "yolo", "--flavour", f)
              + (("--quant", "int8") if q else ()))
             for f in CLI_YOLO_FLAVOURS for q in (False, True)]
    for tag, flags in arms:
        for arm in ("kernels", "plain"):
            log, sites, cap = [], [], {}
            name = f"pred {tag} {arm}".replace(" ", "_")
            argv = ["predict-bscan", "--data",
                    data1 if arm == "plain" else data, "--out", out(name),
                    "--size", str(CLI_SIZE), *flags]
            ctx = plain_kernels(wrappers) if arm == "plain" else nullcontext()
            grab = (all_int8_inputs(cap) if arm == "kernels"
                    and tag.endswith("int8") else nullcontext())
            with ctx, grab, cli_forwards(torch, counters, log, sites):
                s_run = cli_run(f"predict-bscan {tag}", argv,
                                timings if arm == "kernels" else [])
            if arm == "plain":
                checks_s["plain arms"] += s_run
            runs[tag, arm] = read_json(out(name, "detections.json"))
            n_vols = 1 if arm == "plain" else 4
            check(len(log) == n_vols and sum(n for n, _ in log)
                  == 60 * n_vols,
                  f"cli {tag} {arm}: forwards {[n for n, _ in log]}")
            n_dets = sum(len(f) for s in runs[tag, arm].values() for f in s)
            check(n_dets > 0, f"cli {tag} {arm}: no detections")
            if arm == "plain":
                check(all(c == none for _, c in log),
                      f"cli {tag}: the plain run launched {log}")
                continue
            klog = log
            per_forward = {k: v for k, v in log[-1][1].items() if v}
            if tag.startswith("dfine"):
                want = dict(none, weighted_gather=3)
                if "fused" in tag:
                    want["aifi_attention"] = 1
            else:
                want = dict(none, nms_suppress=1)
            if tag.endswith("int8"):
                check(len(sites) == 1, f"cli {tag}: {len(sites)} "
                      f"calibrations")
                want["int8_conv"] = sites[0]
                if tag.startswith("dfine"):
                    check(sites[0] == INT8_DFINE_SITES,
                          f"cli {tag}: {sites[0]} sites")
            for i, (_, got) in enumerate(log):
                expect = dict(want)
                if i == 0 and tag == "dfine int8":   # the calibration
                    expect["weighted_gather"] = 6    # forward's gathers
                check(got == expect, f"cli {tag}: forward {i} launched "
                      f"{got}, want {expect}")
            # every site of the arm against the plain version, bit for bit
            routes, t0 = {}, time.perf_counter()
            for key, (args, _) in cap.items():
                route = int8_site_equal(torch, key, args)[0]
                routes[route] = routes.get(route, 0) + 1
            checks_s["int8 site checks"] += time.perf_counter() - t0
            if tag.endswith("int8"):
                check(sum(routes.values()) > 0, f"cli {tag}: no int8 site "
                      f"captured")
                print(f"[36 cli int8 sites] {tag}: {len(cap)} site shapes "
                      f"({routes} by route), accumulators and output == "
                      f"plain", flush=True)
            for key, (args, n) in cap.items():
                if tag.startswith("dfine"):
                    continue
                x, w, st, pad, g = args[:5]
                if isinstance(st, (tuple, list)) and len(set(st)) == 1:
                    st = st[0]
                shape = (x.shape[1], x.shape[2], x.shape[3],
                         tuple(w.shape), st, g)
                if shape not in known:
                    new_sites.setdefault(tag.split()[1], []).append(
                        [x.shape[1], x.shape[2], x.shape[3],
                         list(x.stride()), x.storage_offset(),
                         list(w.shape), st, g, n // 4])
        want = runs[tag, "plain"]
        got = {seq: runs[tag, "kernels"][seq] for seq in want}
        if tag.startswith("dfine"):
            why = detections_rule(got, want)
        else:
            why = "" if got == want else "detections differ"
        check(not why, f"cli {tag}: kernels vs plain: {why}")
        n = sum(len(f) for s in runs[tag, "kernels"].values() for f in s)
        n1 = sum(len(f) for s in want.values() for f in s)
        print(f"[36 cli predict-bscan] {tag}: {len(klog)} forwards of "
              f"{[n_ for n_, _ in klog]} frames, launches a forward "
              f"{per_forward}, none through the plain versions; {n} "
              f"detections; on the first volume ({n1} detections) kernels "
              f"vs plain "
              f"{'equal' if got == want else 'by the D-FINE rule'}",
              flush=True)
    check(runs["dfine prepatch", "kernels"] == runs["dfine", "kernels"],
          "cli: --prepatch detections differ from the default run's")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "cli_int8_sites.json"),
              "w") as f:
        json.dump(new_sites, f)
    print(f"[36 cli int8 sites] the YOLO flavours' int8 site shapes that "
          f"YOLOv8n-seg serving has not: "
          + "; ".join(f"{k}: {len(v)}" for k, v in new_sites.items())
          + " (chiprun_out/cli_int8_sites.json)", flush=True)

    # (c) training
    for det in ("dfine", "yolo"):
        cli_run(f"train-bscan {det}", [
                 "train-bscan", "--data", data, "--out", out(f"tb_{det}"),
                 "--detector", det, "--epochs", "1", "--size",
                 str(CLI_TRAIN_SIZE), "--batch-size", "4"], timings)
        hist = read_json(out(f"tb_{det}", "history.json"))
        check(all(np.isfinite(v).all() for v in hist.values()),
              f"cli train-bscan {det}: history {hist}")
        state, meta = CheckpointManager(out(f"tb_{det}")).restore("latest")
        if det == "dfine":
            restore_dfine(out("tb_dfine"), device=dev)
        else:
            load_model_state(YOLO(YoloConfig(num_classes=1), device=dev),
                             state)
    log, sites = [], []
    with cli_forwards(torch, counters, log, sites):
        cli_run("predict-bscan trained dfine", [
                 "predict-bscan", "--data", data, "--out", out("tb_pred"),
                 "--checkpoint", out("tb_dfine"), "--size",
                 str(CLI_TRAIN_SIZE)], timings)
        cli_run("inspect bscan", [
                 "inspect", "--data", data, "--mode", "bscan", "--out",
                 out("inspect.html"), "--checkpoint", out("tb_dfine"),
                 "--size", str(CLI_TRAIN_SIZE)], timings)
    check(len(log) == 8 and all(c == dict(none, weighted_gather=3)
                                for _, c in log),
          f"cli predict/inspect from the trained checkpoint: {log}")
    check(os.path.getsize(out("inspect.html")) > 10000,
          "cli inspect: the page is empty")
    cli_run("train-temporal --tiny", [
             "train-temporal", "--data", data, "--out", out("tt"),
             "--tiny", "--seq-len", "4", "--epochs", "1"], timings)
    losses = read_json(out("tt", "history.json"))["loss"]
    check(len(losses) > 0 and np.isfinite(losses).all(),
          f"cli train-temporal: losses {losses[:5]}")
    state, meta = CheckpointManager(out("tt")).restore("latest")
    tmodel = TemporalDFine(tiny_temporal_config(2), variant="v3",
                           num_temporal_labels=3, temporal_heads=4,
                           device=dev)
    load_model_state(tmodel, state)
    print(f"[36 cli train] train-bscan dfine and yolo (1 epoch, "
          f"{CLI_TRAIN_SIZE}px, b4) finite and restored; predict-bscan and "
          f"inspect from the D-FINE checkpoint, 3 weighted gathers a "
          f"forward; train-temporal --tiny: {len(losses)} steps, losses "
          f"finite, restored", flush=True)

    # (d) signals
    cli_run("train-signal", [
             "train-signal", "--data", sig, "--out", out("ts"),
             "--epochs", "1"], timings)
    check(os.path.exists(out("ts", "history.png")) == have_matplotlib(),
          "cli train-signal: history.png")
    cli_run("eval-signal", [
             "eval-signal", "--data", sig, "--checkpoint", out("ts"),
             "--out", out("ev")], timings)
    report = read_json(out("ev", "metrics.json"))
    check(0.0 <= report["accuracy"] <= 1.0, f"cli eval-signal: {report}")
    cli_run("predict-signal --heatmaps", [
             "predict-signal", "--data", sig, "--checkpoint", out("ts"),
             "--out", out("ps"), "--heatmaps"], timings)
    probs = read_json(out("ps", "predictions.json"))
    check(len(probs) == len(VOLUME_SEEDS)
          and all(np.isfinite(v["probabilities"]).all()
                  for v in probs.values()), "cli predict-signal")
    cli_run("export --polymorphic", [
             "export", "--checkpoint", out("ts"), "--out",
             out("ex", "m.pt2"), "--batch", "4", "--polymorphic"], timings)
    model, meta = restore_signal_model(out("ts"), device=dev)
    run = load_exported(out("ex", "m.pt2"))
    x = torch.randn((3, 50, 320), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev)
    with torch.no_grad():
        want = model(x)
    got = run(x)
    err = max(max_abs_err(g, w) for g, w in zip(
        torch.utils._pytree.tree_leaves(got),
        torch.utils._pytree.tree_leaves(want)))
    check(err <= 1e-5, f"cli export: the artifact differs by {err:.3g}")
    # (b) the entry point and the bridge, as two processes side by side
    reqs = [np.random.default_rng(6).normal(size=s).astype(np.float32)
            for s in ((7, 320), (2, 13, 320))]
    procs = cli_processes({
        "entry": (["predict-bscan", "--data", data, "--out", out("entry"),
                   "--detector", "dfine", "--size", str(CLI_SIZE)], ""),
        "bridge": (["bridge", "--checkpoint", out("ts")],
                   "\n".join(json.dumps({"signals": r.tolist()})
                             for r in reqs))}, root, timeout=600)
    rc, _, stderr, secs = procs["entry"]
    timings.append(("python -m pautdx_torch.cli predict-bscan (process, "
                    "beside the bridge)", secs))
    check(rc == 0, f"python -m pautdx_torch.cli exited {rc}: "
          f"{stderr[-2000:]}")
    entry = read_json(out("entry", "detections.json"))
    same = entry == runs["dfine", "kernels"]
    why = "" if same else detections_rule(entry, runs["dfine", "kernels"])
    check(not why, f"cli entry point vs in-process: {why}")
    print(f"[36 cli entry] python -m pautdx_torch.cli predict-bscan exit 0; "
          f"detections {'equal to' if same else 'by the D-FINE rule against'}"
          f" the in-process default run", flush=True)
    rc, stdout, stderr, secs = procs["bridge"]
    timings.append(("bridge (process, 2 requests, beside the entry point)",
                    secs))
    check(rc == 0, f"cli bridge exited {rc}: {stderr[-2000:]}")
    answers = [json.loads(line) for line in stdout.splitlines()]
    check(len(answers) == 2 and stderr.count("bridge: loaded") == 1,
          f"cli bridge: {len(answers)} answers, stderr {stderr[-500:]}")
    for r, a in zip(reqs, answers):
        xr = torch.from_numpy(r[None] if r.ndim == 2 else r).to(dev)
        with torch.no_grad():
            p = model(xr)
        p = p["prob"] if isinstance(p, dict) else p
        e = max_abs_err(torch.tensor(a["prob"], device=dev), p)
        check(np.array(a["prob"]).shape == tuple(xr.shape[:2]) and e <= 1e-5,
              f"cli bridge: answer {np.array(a['prob']).shape} off by {e}")
    print(f"[36 cli signals] train-signal HybridBinary 1 epoch, eval-signal "
          f"accuracy {report['accuracy']:.4f}, predict-signal --heatmaps "
          f"({len(probs)} volumes), export .pt2 within {err:.3g} of the "
          f"model on the card; bridge: 2 requests answered at their own "
          f"shapes, the checkpoint loaded once", flush=True)

    # (e) host subcommands
    cli_run("build-dataset --yolo", ["build-dataset", "--data", data,
                                     "--out", out("ds"), "--yolo"], timings)
    check(os.path.exists(out("ds", "yolo", "data.yaml")), "build-dataset")
    t0 = time.perf_counter()
    cli.main(["explain", "--out", out("xp")])
    timings.append(("explain", time.perf_counter() - t0))
    check(len(os.listdir(out("xp"))) == 7, "cli explain: pages")
    cli_run("inspect signal", [
             "inspect", "--data", sig, "--mode", "signal", "--out",
             out("sig.html"), "--checkpoint", out("ts")], timings)
    for name, s in timings:
        print(f"[36 cli seconds] {name}: {s:.2f} s", flush=True)
    print(f"[36 cli] {len(timings)} subcommand runs on the card in "
          f"{time.perf_counter() - t_phase:.1f} s, of which "
          + ", ".join(f"{k} {v:.1f} s" for k, v in checks_s.items())
          + f"; {smi_line()}", flush=True)
    del model, run, tmodel


MULTI_RANKS = 4           # phase 37 (b): gloo ranks sharing the one card
MULTI_BATCH = 16          # the D-FINE-nano training batch, global
# the ranks' gradient leaf may move up to this many times the larger move
# of two reorderings of the one-process step's rows: a leaf's f32 spread
# is heavy-tailed (``multi_spread.py`` on an H100: the ranks' arrangement
# of this batch moved bbox_embed.0 2.9 times the largest of eight
# reorderings, three other arrangements within them), and a leaf-local
# fault moves a leaf by a sizeable share of its norm
MULTI_NOISE_FACTOR = 4


def _nano_step(torch, dev, batch: dict, mesh) -> tuple:
    """One ``Trainer`` step of ``dfine_nano(2)`` (seed 0) over the host
    ``batch``, deterministic, under ``mesh`` or none: (the step's row, its
    clipped gradients)."""
    from pautdx_torch.models.vision.dfine import DFine, dfine_nano
    from pautdx_torch.train.detector import dfine_objective
    from pautdx_torch.train.optim import make_optimizer
    from pautdx_torch.train.trainer import Trainer

    model = DFine(dfine_nano(num_labels=2), device=dev, seed=0)
    trainer = Trainer(model, dfine_objective(640, model.cfg),
                      make_optimizer(1e-4), input_key="images", mesh=mesh)
    state = trainer.init(batch)
    with deterministic():
        _, row = trainer.train_epoch(state, [batch])
        torch.cuda.synchronize()
    return row, {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}


def multi_phase(torch, dev) -> None:
    """Phase 37: (a) NCCL in a world of 1 (the ``Trainer`` under
    ``make_mesh()`` against the same step without a mesh, every gradient
    leaf within phase 20's per-leaf rule; ``train-signal --dp`` in a
    process of its own); (b) ``dryrun_multichip`` on four gloo ranks
    sharing the card, (dp, tp) = (2, 2), dfine_nano at 640px, global
    batch 16: the step against one process's over the whole batch, leaf
    by leaf, the tp eval forward (fused
    attention, 4 local heads) against the unsharded one by assignment,
    and every rank's launches of the attention and of both weighted-gather
    kernels."""
    from pautdx_torch.mesh import make_mesh
    from pautdx_torch.mesh.dryrun import (Spec, dryrun_multichip,
                                          one_process_step, rounding_noise)
    from pautdx_torch.mesh.launch import launch
    from pautdx_torch.models.vision.dfine import dfine_nano
    from pautdx_torch.train.detector import make_train_batches

    t_phase = time.perf_counter()
    set_tf32(False)
    torch.cuda.empty_cache()

    # (a) a world of 1 over NCCL, in this process
    batch = make_train_batches(1, MULTI_BATCH, 640, seed=37)[0]
    t0 = time.perf_counter()
    plain_row, plain = _nano_step(torch, dev, batch, None)
    row, meshed = launch(lambda: _nano_step(torch, dev, batch, make_mesh()),
                         1, "cuda")[0]
    worst, leaf, noise, floor = relative_grad_errors(meshed, plain)
    diff = max(max_abs_err(meshed[n], plain[n]) for n in plain)
    check(row["update_was_finite"] == 1.0 and
          abs(row["total"] - plain_row["total"])
          <= 1e-6 * abs(plain_row["total"]),
          f"multi (a): the meshed step's loss {row['total']} against "
          f"{plain_row['total']}")
    check(worst <= TRAIN_GRAD_TOL and noise <= floor,
          f"multi (a): gradient of {leaf} off by {worst:.3g} in norm "
          f"(under the floor: {noise:.3g} > {floor:.3g})")
    a_s = time.perf_counter() - t0
    del plain, meshed
    root = os.path.join(HERE, "build", "chip_smoke_multi")
    shutil.rmtree(root, ignore_errors=True)
    sig = os.path.join(root, "volumes")
    write_signal_volumes(sig)
    out = os.path.join(root, "ts_dp")
    res = cli_processes({"dp": (["train-signal", "--data", sig, "--out", out,
                                 "--epochs", "1", "--dp"], "")}, root, 600)
    rc, _, err, cli_s = res["dp"]
    check(rc == 0, f"train-signal --dp exited {rc}: {err[-2000:]}")
    hist = read_json(os.path.join(out, "history.json"))
    check(hist["epoch"] == [0] and all(np.isfinite(hist["train_bce"])),
          f"train-signal --dp history {hist}")
    print(f"[37 multi (a)] NCCL, a world of 1: Trainer(mesh=make_mesh()) "
          f"b{MULTI_BATCH} 640px dfine_nano step against the step without "
          f"a mesh: loss {row['total']:.6f} against {plain_row['total']:.6f}, "
          f"worst gradient leaf "
          f"{worst:.3g} ({leaf or 'none'}; limit {TRAIN_GRAD_TOL}), max "
          f"|diff| {diff:.3g}, {a_s:.1f} s; python -m pautdx_torch.cli "
          f"train-signal --dp (HybridBinary, 1 epoch, phase 29's volumes): "
          f"rc 0, train_bce {hist['train_bce'][0]:.4f}, val_loss "
          f"{hist['val_loss'][0]:.4f}, {cli_s:.1f} s", flush=True)

    # (b) four gloo ranks on the one card, (dp, tp) = (2, 2)
    spec = Spec(cfg=dfine_nano(num_labels=2), size=640, batch=MULTI_BATCH,
                eval_forward=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = dryrun_multichip(MULTI_RANKS, "cuda", spec,
                           log=lambda m: print(f"    {m}", flush=True))
    ranks_s = time.perf_counter() - t0
    check(got["mesh"] == (2, 2), f"multi (b): mesh {got['mesh']}")
    for r in got["ranks"]:
        counts = {**r["eval_launches"], **{k: v for k, v in
                                           r["launches"].items()
                                           if k != "aifi_attention"}}
        check(all(v > 0 for v in counts.values()),
              f"multi (b): rank {r['rank']} launched {counts}")
    want = one_process_step(spec, dev)
    loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    check(loss_err <= TRAIN_LOSS_TOL, f"multi (b): loss {got['loss']} "
          f"against one process's {want['loss']}")
    noise = rounding_noise(spec, want, dev)
    gw = want["grads"]
    floor = grad_floor(gw)
    ratios = {}
    for n, g in gw.items():
        err = (got["grads"][n] - g).norm().item()
        lim = max(TRAIN_GRAD_TOL * g.norm().item() + floor,
                  MULTI_NOISE_FACTOR * noise[n])
        ratios[n] = (err / lim, err, lim)
    top = sorted(ratios.items(), key=lambda kv: -kv[1][0])[:6]
    whole = global_grad_error(got["grads"], gw)
    noise_whole = (sum(v * v for v in noise.values())
                   / sum(float(g.double().pow(2).sum())
                         for g in gw.values())) ** 0.5
    print(f"    gradients: global error {whole:.3g} (reordering the rows: "
          f"{noise_whole:.3g}); worst leaves "
          + "; ".join(f"{n} {r:.3g} ({e:.3g} / {l:.3g})"
                      for n, (r, e, l) in top), flush=True)
    n, (r, e, l) = top[0]
    check(r <= 1.0, f"multi (b): gradient of {n} off by {e:.3g} > {l:.3g}")
    why = same_detections(*(t.float().numpy() for t in (
        got["eval"]["logits"], got["eval"]["pred_boxes"],
        want["eval"]["logits"], want["eval"]["pred_boxes"])))
    check(not why, f"multi (b): tp eval forward against one process: {why}")
    eval_diff = max_abs_err(got["eval"]["logits"], want["eval"]["logits"])
    print(f"[37 multi (b)] dryrun_multichip({MULTI_RANKS}): gloo ranks on "
          f"cuda:0, (dp, tp) = (2, 2), dfine_nano 640px, global batch "
          f"{MULTI_BATCH} ({MULTI_BATCH // 2} a dp rank): loss "
          f"{got['loss']:.6f} against one process's {want['loss']:.6f} "
          f"(rel {loss_err:.3g}); gradients against one process's: each "
          f"leaf within 1e-3 of its norm plus the floor {floor:.3g}, or "
          f"{MULTI_NOISE_FACTOR} times the one-process step's own noise (its "
          f"rows reversed or rolled by half), worst {n} at {r:.3g} of its "
          f"limit; tp eval "
          f"forward (encoder attention fused, 4 of 8 heads a rank) matches "
          f"the unsharded one by assignment (slot by slot max |logit diff| "
          f"{eval_diff:.3g}); launches by rank: "
          + "; ".join(f"{r['rank']}: eval {r['eval_launches']}, step "
                      f"{r['launches']}" for r in got["ranks"])
          + f"; ranks {ranks_s:.1f} s with their start", flush=True)
    print(f"[37 multi] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def main() -> None:
    # before torch's first cuBLAS call: the step checks run under
    # deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA card and does not run on the CPU")
    sys.path.insert(0, HERE)
    try:
        import pautdx_torch
    except ImportError as e:
        fail(f"pautdx_torch is not beside this script: {e}")
    check(os.path.dirname(os.path.dirname(os.path.abspath(
        pautdx_torch.__file__))) == HERE,
        f"pautdx_torch imported from {pautdx_torch.__file__}, not from "
        f"this checkout")
    from pautdx_torch.models.vision.dfine import DFine
    from pautdx_torch.ops import (_build, attention, gather, masks, qconv,
                                  suppress)
    from pautdx_torch.ops.nms import box_iou_matrix
    from pautdx_torch.serve.throughput import (
        build_serving_model, fold_uint8_stem, make_streaming_forward,
        make_uint8_slab, measure_fps, serving_config,
    )
    from pautdx_torch.serve.yolo_predict import (
        IMG, build_yolo_predictor, make_frame_slab, make_yolo_stream,
        postprocess,
    )
    from pautdx_torch.utils import profiling

    # each launch-path counter: its module and attribute; the kernel
    # wrappers are the labels whose module has a plain version beside them
    # (the served graph's captures and replays have none)
    counters = {label: (importlib.import_module(module), attr)
                for label, module, attr in profiling.LAUNCH_COUNTERS}
    wrappers = {name: mod for name, (mod, _) in counters.items()
                if hasattr(mod, f"{name}_reference")}
    none = dict.fromkeys(counters, 0)

    dev = torch.device("cuda")
    set_tf32(False)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    if sys.argv[1:] == ["--signal-train"]:     # phases 29-31 alone
        print(f"[1 device] {smi_line()}", flush=True)
        signal_train_phases(torch, dev, counters, none)
        return
    if sys.argv[1:] == ["--cli"]:              # phase 36 alone
        print(f"[1 device] {smi_line()}", flush=True)
        print(f"[2 build] {_build.build():.2f} s of parallel nvcc",
              flush=True)
        cli_phase(torch, dev, counters, wrappers, none)
        print(f"[wall] {time.perf_counter() - t_start:.1f} s", flush=True)
        return
    if sys.argv[1:] == ["--multi"]:            # phase 37 alone
        print(f"[1 device] {smi_line()}", flush=True)
        print(f"[2 build] {_build.build():.2f} s of parallel nvcc",
              flush=True)
        multi_phase(torch, dev)
        print(f"[wall] {time.perf_counter() - t_start:.1f} s", flush=True)
        return
    if sys.argv[1:] == ["--int8"]:             # phases 32-35 alone
        print(f"[1 device] {smi_line()}", flush=True)
        print(f"[2 build] {_build.build():.2f} s of parallel nvcc",
              flush=True)
        for r in int8_phases(torch, dev, counters, wrappers, none, None):
            print(json.dumps({k: r[k] for k in (
                "name", "launches", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}), flush=True)
        host_phase(torch, dev)
        print(f"[wall] {time.perf_counter() - t_start:.1f} s", flush=True)
        return

    # 1. device
    smi = smi_line()
    print(f"[1 device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    nvcc_s = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    print(f"[2 build] {len(_build.SOURCES)} kernels "
          f"({', '.join(_build.SOURCES)}): {nvcc_s:.2f} s of parallel nvcc, "
          f"{time.perf_counter() - t0:.2f} s to build and load", flush=True)
    for name in _build.SOURCES:
        log = _build.lib_path(name).with_suffix(".log")
        print(f"[2 ptxas {name}] " + "; ".join(
            ptxas_summary(log.read_text()) if log.is_file()
            else ["no build log"]), flush=True)

    # 3. attention kernel vs plain
    worst = {}
    for dtype, n in ((torch.float32, 400), (torch.bfloat16, 400),
                     (torch.float32, 37), (torch.bfloat16, 37)):
        name = str(dtype).split(".")[1]
        q, k, v = (randn(BATCH, 8, n, 16, dtype=dtype) for _ in range(3))
        q = q * 0.25                       # dh ** -0.5, as TorchMHA scales
        got = attention.fused_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention.fused_attention_reference(q, k, v)
        err = max_abs_err(got, want)
        check(got.dtype == dtype and got.shape == q.shape,
              f"attention {name} N={n}: got {got.dtype} {tuple(got.shape)}")
        tol = ATTN_TOL[name]
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"attention {name} N={n}: max |err| {err:.3g} beyond "
              f"{ATTN_TOL[name]}")
        worst[f"{name} N={n}"] = err
    print("[3 attention] kernel vs plain at (128, 8, N, 16), max |err| "
          + ", ".join(f"{k}: {v:.3g}" for k, v in worst.items())
          + "; tolerance atol=rtol 1e-5 in f32 (3xTF32 on the tensor cores, "
          "TF32 off for the plain version), 2e-2 in bf16 (tensor cores; the "
          "plain version rounds the normalized probabilities to bf16 before "
          "P.V, the kernel the unnormalized ones)", flush=True)

    # 4. gather kernel vs plain
    L, T = 2000, 1200
    for dtype in (torch.bfloat16, torch.float32):
        flat = randn(BATCH, L, 128, dtype=dtype)
        idx = torch.randint(0, L, (BATCH, T), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[:, :2] = torch.tensor([-3, L + 5], dtype=torch.int32, device=dev)
        got = gather.onehot_gather(flat, idx)
        torch.cuda.synchronize()
        check(torch.equal(got, gather.onehot_gather_reference(flat, idx)),
              f"gather {dtype}: kernel differs from the plain version")
    print(f"[4 gather] kernel == plain bit for bit at ({BATCH}, {L}, 128) x "
          f"{T} taps, bf16 and f32, indices -3 and L+5 clamped", flush=True)
    # the one-hot forward's tile plan where it stretches: a denoising
    # step's b4, a ragged last tile, every tap on one row; the weighted
    # forward at the training shapes and a tall table; inputs from a
    # generator of their own, so later phases see the same
    gen4 = torch.Generator(device=dev).manual_seed(4)
    cases = []
    for B4, T4, dtype, pile_up in ((4, 2736, torch.float32, False),
                                   (4, 1201, torch.bfloat16, False),
                                   (4, 2736, torch.float32, True)):
        flat = torch.randn((B4, L, 128), generator=gen4, device=dev).to(dtype)
        idx = torch.randint(-3, L + 3, (B4, T4), generator=gen4, device=dev,
                            dtype=torch.int32)
        if pile_up:
            idx.fill_(L // 2)
        check(torch.equal(gather.onehot_gather(flat, idx),
                          gather.onehot_gather_reference(flat, idx)),
              f"gather ({B4}, {L}, 128) x {T4} {dtype}"
              f"{' pile-up' if pile_up else ''}: kernel differs")
        cases.append(f"one-hot ({B4}, {T4}){' pile-up' if pile_up else ''}")
    for B4, L4, T4 in ((16, L, T), (4, L, 2736), (2, 20000, 500)):
        flat = torch.randn((B4, L4, 128), generator=gen4, device=dev)
        idx = torch.randint(-3, L4 + 3, (B4, T4, 4), generator=gen4,
                            device=dev, dtype=torch.int32)
        w = torch.rand((B4, T4, 4), generator=gen4, device=dev)
        with torch.no_grad():
            err = within(gather.weighted_gather(flat, idx, w),
                         gather.weighted_gather_reference(flat, idx, w))
        check(err <= GATHER_TOL, f"weighted gather ({B4}, {L4}, 128) x "
              f"({T4}, 4): relative error {err:.3g}")
        cases.append(f"weighted ({B4}, {L4}) x {T4} {err:.2g}")
    # the weighted forward on the path's corners: bilinear taps of uniform
    # points on a 40 x 40 and a 20 x 20 level (2,000 rows), a denoising
    # step's b4 and a temporal step's b50, with the plan each took
    from pautdx_torch.ops.deformable import bilinear_taps
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B4, T4 in ((4, 2736), (50, T)):
        loc = torch.rand((B4, T4 // 8, 8, 2), generator=gen4, device=dev)
        idx, w = (t.reshape(B4, T4, 4).contiguous() for t in bilinear_taps(
            ((40, 40), (20, 20)), loc, (4, 4)))
        flat = torch.randn((B4, L, 128), generator=gen4, device=dev)
        with torch.no_grad():
            err = within(gather.weighted_gather(flat, idx, w),
                         gather.weighted_gather_reference(flat, idx, w))
        check(err <= GATHER_TOL, f"weighted gather, bilinear corners, "
              f"({B4}, {L}, 128) x ({T4}, 4): relative error {err:.3g}")
        plan = gather.weighted_plan(B4, T4, 4, 512, sms)
        cases.append(f"weighted bilinear ({B4}, {L}) x {T4} {err:.2g}, plan "
                     f"{plan.group} taps a group, {plan.blocks} blocks of "
                     f"{plan.warps} warps on {sms} SMs")
    print("[4 gather] forwards: one-hot bit for bit, weighted within "
          f"{GATHER_TOL} of the largest magnitude: " + "; ".join(cases),
          flush=True)

    # 5. the full model, f32, kernels vs plain versions
    model = fold_uint8_stem(DFine(serving_config(), device=dev, seed=0))
    frames = make_uint8_slab((4, 80, 80, 192), seed=1, device=dev)
    reset_counts(counters)
    with torch.inference_mode():
        out_k = model(frames)
    torch.cuda.synchronize()
    launches = (attention.LAUNCHES, gather.LAUNCHES)
    check(launch_counts(counters) == dict(none, aifi_attention=1,
                                          onehot_gather=3),
          f"one f32 forward launched {launch_counts(counters)}, want "
          f"attention 1 and gather 3")
    with plain_kernels(wrappers), torch.inference_mode():
        out_p = model(frames)
    check(attention.LAUNCHES == 1 and gather.LAUNCHES == 3,
          "the plain forward launched a kernel")
    la, ba, lb, bb = (t.float().cpu().numpy() for t in (
        out_k["logits"], out_k["pred_boxes"], out_p["logits"],
        out_p["pred_boxes"]))
    why = same_detections(la, ba, lb, bb)
    check(not why, f"f32 model, kernels vs plain: {why}")
    print(f"[5 model] dfine_nano 640px f32 batch 4: kernels vs plain "
          f"detections match by assignment (max |logit diff| slot by slot "
          f"{np.abs(la - lb).max():.3g}); launches per forward: attention "
          f"{launches[0]}, gather {launches[1]}", flush=True)
    del model, out_k, out_p

    # 6. the serving run, eager: the kernels' plain versions swap in by
    # name, and the first inputs are taken at the wrappers
    served = build_serving_model(device=dev, batch=BATCH, seed=0)
    slab = make_uint8_slab(served.slab_shape(N_STEPS), seed=2, device=dev)
    eager = functools.partial(DFine.forward, served.model)
    stream = make_streaming_forward(eager)
    stream(slab[:1])                       # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()
    captured = {}
    with first_inputs(wrappers, captured):
        reset_counts(counters)
        logits, boxes, finite = stream(slab)
        torch.cuda.synchronize()
        counts = launch_counts(counters)
    check(counts == dict(none, aifi_attention=N_STEPS,
                         onehot_gather=3 * N_STEPS),
          f"serving run launches {counts}, want {N_STEPS} and "
          f"{3 * N_STEPS}")
    check(bool(finite), "serving outputs are not all finite")
    check(tuple(logits.shape) == (BATCH, 150, 2)
          and tuple(boxes.shape) == (BATCH, 150, 4),
          f"serving outputs {tuple(logits.shape)} {tuple(boxes.shape)}")
    # the served model's own calls replay a CUDA graph of that forward,
    # captured at the first: bit for bit the eager kernel run's outputs
    gstream = make_streaming_forward(served.model)
    reset_counts(counters)
    gstream(slab[:1])                      # warm-up, capture, one replay
    torch.cuda.synchronize()
    gfirst = launch_counts(counters)
    check(gfirst == dict(none, aifi_attention=2, onehot_gather=6,
                         dfine_graph_capture=1, dfine_graph_replay=1),
          f"the served model's first call counted {gfirst}, want one "
          f"eager warm-up, one capture and one replay")
    reset_counts(counters)
    with torch.inference_mode():
        replayed = [served.model(slab[step]) for step in range(N_STEPS)]
        torch.cuda.synchronize()
        gcounts = launch_counts(counters)
        eager_out = [eager(slab[step]) for step in range(N_STEPS)]
    check(gcounts == dict(none, aifi_attention=N_STEPS,
                          onehot_gather=3 * N_STEPS,
                          dfine_graph_replay=N_STEPS),
          f"replayed serving run counted {gcounts}, want {N_STEPS} replays "
          f"and {N_STEPS} and {3 * N_STEPS} kernel launches")
    unequal = [(step, k) for step in range(N_STEPS)
               for k in ("logits", "pred_boxes")
               if not torch.equal(replayed[step][k], eager_out[step][k])]
    check(not unequal, f"replayed outputs differ from the eager kernel "
          f"run's at (step, output) {unequal}")
    del replayed, eager_out
    # frames/s through the kernels, and through the plain versions for
    # comparison, in turns (kernels, plain, plain, kernels) three times:
    # the host-bound eager loop drifts from call to call
    fps = {"kernels": [], "plain": []}
    for arm in ("kernels", "plain", "plain", "kernels") * 3:
        if arm == "plain":
            with plain_kernels(wrappers):
                fps[arm].append(measure_fps(stream, slab))
        else:
            fps[arm].append(measure_fps(stream, slab))
    fps_graph = [measure_fps(gstream, slab) for _ in range(3)]
    print(f"[6 serving] bench config, bf16, uint8 slab {tuple(slab.shape)}: "
          f"median {statistics.median(fps['kernels']):.1f} frames/s through "
          f"the kernels {[round(f, 1) for f in fps['kernels']]}, median "
          f"{statistics.median(fps['plain']):.1f} through the plain versions "
          f"{[round(f, 1) for f in fps['plain']]} ({N_STEPS} x {BATCH} "
          f"frames x 3 calls each, CUDA events, eager); median "
          f"{statistics.median(fps_graph):.1f} replaying the served CUDA "
          f"graph {[round(f, 1) for f in fps_graph]}, its {N_STEPS} steps "
          f"bit for bit the eager run's; launches over one slab: {counts} "
          f"eager, {gcounts} replayed; outputs finite", flush=True)

    kernels = []
    # AIFI attention at the inputs the serving run gave it
    q, k, v, heads = captured["aifi_attention"]
    got = attention.aifi_attention(q, k, v, heads)
    want = attention.aifi_attention_reference(q, k, v, heads)
    err = max_abs_err(got, want)
    # on the serving run's own inputs the limit is SERVING_ATTN_ULPS bf16
    # ulps at the output's largest magnitude: both outputs are rounded to
    # bf16 once, and the plain version also rounds P to bf16 before P.V
    peak = want.float().abs().max().item()
    tol = SERVING_ATTN_ULPS * 2.0 ** (np.floor(np.log2(peak)) - 7)
    check(err <= tol, f"serving attention: max |err| {err:.3g} beyond "
          f"{SERVING_ATTN_ULPS} bf16 ulps at |out| max {peak:.3g} "
          f"({tol:.3g})")
    kernels.append(attention_record(
        torch, "aifi_attention", q, k, v, heads, counts["aifi_attention"],
        err, f"|out| max {peak:.3g}, limit {tol:.3g}"))
    # the same inputs in f32: the kernel of the f32 model (phase 5, one
    # launch a forward), at the serving shape
    qf, kf, vf = (t.float() for t in (q, k, v))
    got = attention.aifi_attention(qf, kf, vf, heads)
    want = attention.aifi_attention_reference(qf, kf, vf, heads)
    err = max_abs_err(got, want)
    tol = ATTN_TOL["float32"]
    check(torch.allclose(got, want, atol=tol, rtol=tol),
          f"serving inputs in f32: attention max |err| {err:.3g} beyond "
          f"atol=rtol {tol}")
    kernels.append(attention_record(
        torch, "aifi_attention_dh16_float32", qf, kf, vf, heads, launches[0],
        err, f"the serving run's inputs in f32, limit atol=rtol {tol}; "
             f"launches: one f32 forward of phase 5"))
    del qf, kf, vf

    # one-hot row gather at the inputs the serving run gave it
    flat, idx = captured["onehot_gather"]
    kernels.append(onehot_record(torch, dev, flat, idx,
                                 counts["onehot_gather"], "onehot_gather"))
    for r in kernels:
        print_record("6", r, "over the slab")
    del served, slab, stream, captured, logits, boxes

    # 7. NMS sweep kernel vs plain
    nb, nk = YOLO_BATCH, 300
    xy = torch.rand((nb, nk, 2), generator=gen, device=dev) * 560
    wh = 10 + torch.rand((nb, nk, 2), generator=gen, device=dev) * 150
    iou = box_iou_matrix(torch.cat([xy, xy + wh], -1))
    ties = torch.randint(0, nk, (2, 4 * nk), generator=gen, device=dev)
    iou[0, ties[0], ties[1]] = 0.45              # exactly at the threshold
    iou[1, 5] = iou[1, 4]                        # two tied candidates
    valid = torch.rand((nb, nk), generator=gen, device=dev) > 0.2
    got = suppress.nms_suppress(iou, valid, 0.45)
    torch.cuda.synchronize()
    want = suppress.nms_suppress_reference(iou, valid, 0.45)
    check(torch.equal(got, want), "nms: kernel differs from the plain "
          f"version in {(got != want).sum().item()} slots")
    print(f"[7 nms] kernel == plain bit for bit at ({nb}, {nk}) candidates, "
          f"{int(valid.sum())} valid, {int(want.sum())} kept, ties at the "
          f"threshold 0.45 and a repeated row", flush=True)

    # 8. mask decode kernel vs plain
    protos = randn(nb, 160, 160, 32)
    coeffs = randn(nb, 100, 32)
    xy = torch.rand((nb, 100, 2), generator=gen, device=dev) * 700 - 60
    wh = torch.rand((nb, 100, 2), generator=gen, device=dev) * 320
    mboxes = torch.cat([xy, xy + wh], -1)
    mboxes[0, :4] = torch.tensor([[0, 0, 640, 640], [100, 200, 100, 260],
                                  [-90, -90, -10, -10], [700, 10, 900, 30]],
                                 dtype=torch.float32, device=dev)
    got = masks.assemble_masks(protos, coeffs, mboxes, (IMG, IMG))
    torch.cuda.synchronize()
    want = masks.assemble_masks_reference(protos, coeffs, mboxes, (IMG, IMG))
    err = max_abs_err(got, want)
    check(got.shape == want.shape and err <= MASK_TOL,
          f"masks: max |err| {err:.3g} beyond {MASK_TOL}")
    check(bool((got[0, 1:4] == 0).all()) and bool((got[0, 0] > 0).all()),
          "masks: the whole-frame box or the empty ones came out wrong")
    print(f"[8 masks] kernel vs plain at ({nb}, 160, 160, 32) protos, "
          f"K=100, f32 (TF32 off): max |err| {err:.3g} <= {MASK_TOL}; "
          f"zero-area and off-image boxes all zero", flush=True)
    del protos, coeffs, got, want

    # 9. YOLOv8n-seg f32, post-processed through kernels vs plain versions
    predictor = build_yolo_predictor(device=dev, seed=0)
    frames = make_frame_slab(1, 4, seed=3, device=dev)[0]
    with torch.no_grad():
        out = predictor.model(frames.to(torch.float32) / 255.0)
    reset_counts(counters)
    det_k = postprocess(out, (IMG, IMG), predictor.cfg)
    torch.cuda.synchronize()
    post_counts = launch_counts(counters)
    with plain_kernels(wrappers):
        det_p = postprocess(out, (IMG, IMG), predictor.cfg)
    check(launch_counts(counters) == post_counts,
          "the plain post-process launched a kernel")
    differ = [k for k in DETECTION_KEYS if not torch.equal(det_k[k],
                                                           det_p[k])]
    check(not differ, f"yolo: detections through the kernels differ from "
          f"the plain versions' in {differ}")
    err = max_abs_err(det_k["masks"], det_p["masks"])
    check(err <= MASK_TOL, f"yolo: masks differ by {err:.3g}")
    # the predictor owns its precision: with TF32 switched on for the
    # whole process, as a caller may leave it, predict() still gives the
    # full-f32 detections above
    set_tf32(True)
    reset_counts(counters)
    det = predictor(frames)
    torch.cuda.synchronize()
    per_predict = launch_counts(counters)
    want = dict(none, nms_suppress=1, assemble_masks=1)
    check(per_predict == want and post_counts == want,
          f"one predict launched {per_predict}, want {want}")
    check(all(torch.equal(det[k], det_k[k]) for k in DETECTION_KEYS + (
        "masks",)), "yolo: predict() with TF32 on for the process differs "
        "from the model plus postprocess() in full f32")
    # images laid out NCHW in memory, the usual PyTorch form, reach the
    # mask kernel, which needs dense protos
    x = frames.to(torch.float32) / 255.0
    det_n = predictor.forward(x.permute(0, 3, 1, 2).contiguous()
                              .permute(0, 2, 3, 1))
    check(bool(torch.isfinite(det_n["masks"]).all())
          and tuple(det_n["masks"].shape) == (4, 100, 160, 160),
          "yolo: predict on NCHW-laid-out images")
    n_valid = det["valid"].sum(1).tolist()
    print(f"[9 yolo model] yolov8n-seg 640px f32 batch 4: kernels vs plain "
          f"detections identical ({n_valid} valid per frame), masks max "
          f"|err| {err:.3g}; launches per predict: {per_predict}; predict "
          f"with TF32 on for the process gives the same detections and "
          f"masks; NCHW-laid-out images: {det_n['valid'].sum(1).tolist()} "
          f"valid per frame", flush=True)
    del out, det_k, det_p, det, det_n, x

    # 10. the predict run
    yslab = make_frame_slab(YOLO_STEPS, YOLO_BATCH, seed=4, device=dev)
    ystream = make_yolo_stream(predictor)
    ystream(yslab[:1])                     # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()
    captured = {}
    with first_inputs(wrappers, captured):
        reset_counts(counters)
        det, finite = ystream(yslab)
        torch.cuda.synchronize()
        ycounts = launch_counts(counters)
    want = dict(none, nms_suppress=YOLO_STEPS, assemble_masks=YOLO_STEPS)
    check(ycounts == want, f"predict run launches {ycounts}, want {want}")
    check(bool(finite), "predict outputs are not all finite")
    check(tuple(det["boxes"].shape) == (YOLO_BATCH, 100, 4)
          and tuple(det["masks"].shape) == (YOLO_BATCH, 100, 160, 160),
          f"predict outputs {tuple(det['boxes'].shape)} "
          f"{tuple(det['masks'].shape)}")
    yfps = {"kernels": [], "plain": []}
    for arm in ("kernels", "plain", "plain", "kernels") * 3:
        if arm == "plain":
            with plain_kernels(wrappers):
                yfps[arm].append(measure_fps(ystream, yslab))
        else:
            yfps[arm].append(measure_fps(ystream, yslab))
    print(f"[10 yolo serving] yolov8n-seg f32, uint8 slab "
          f"{tuple(yslab.shape)}: median "
          f"{statistics.median(yfps['kernels']):.1f} frames/s through the "
          f"kernels {[round(f, 1) for f in yfps['kernels']]}, median "
          f"{statistics.median(yfps['plain']):.1f} through the plain "
          f"versions {[round(f, 1) for f in yfps['plain']]} ({YOLO_STEPS} x "
          f"{YOLO_BATCH} frames x 3 calls each, CUDA events, eager, TF32 "
          f"on for the process and off inside predict); "
          f"launches over one slab: {ycounts}; outputs finite; "
          f"{det['valid'].sum(1).tolist()} valid per frame in the last step",
          flush=True)

    set_tf32(False)

    # the NMS sweep and the mask decode at the inputs the predict run gave
    # them
    kernels.append(nms_record(torch, captured, ycounts["nms_suppress"],
                              "nms_suppress"))
    kernels.append(masks_record(torch, dev, captured,
                                ycounts["assemble_masks"], "assemble_masks"))
    for r in kernels[2:]:
        print_record("10", r, "over the slab")
    del predictor, yslab, ystream, captured, det

    kernels += train_phases(torch, dev, gen, counters, wrappers, none)
    kernels += hf_phases(torch, dev, gen, counters, wrappers, none)

    # 18. NMS sweep kernel vs plain past the shared-memory bitmask
    nb, found = 4, []
    for nk in WIDE_NMS_K:
        xy = torch.rand((nb, nk, 2), generator=gen, device=dev) * 1200
        wh = 10 + torch.rand((nb, nk, 2), generator=gen, device=dev) * 150
        iou = box_iou_matrix(torch.cat([xy, xy + wh], -1))
        ties = torch.randint(0, nk, (2, 4 * nk), generator=gen, device=dev)
        iou[0, ties[0], ties[1]] = 0.45          # exactly at the threshold
        iou[1, 5] = iou[1, 4]                    # two tied candidates
        valid = torch.rand((nb, nk), generator=gen, device=dev) > 0.2
        reset_counts(counters)
        got = suppress.nms_suppress(iou, valid, 0.45)
        torch.cuda.synchronize()
        check(launch_counts(counters) == dict(none, nms_suppress=1),
              f"nms K={nk}: launched {launch_counts(counters)}")
        want = suppress.nms_suppress_reference(iou, valid, 0.45)
        check(torch.equal(got, want), f"nms K={nk}: kernel differs from the "
              f"plain version in {(got != want).sum().item()} slots")
        ms = device_ms(lambda: suppress.nms_suppress(iou, valid, 0.45),
                       reps=5)
        found.append(f"K={nk}: {int(valid.sum())} valid, {int(want.sum())} "
                     f"kept, kernel {ms:.4f} ms")
        del iou, got, want
    print(f"[18 nms wide] kernel == plain bit for bit at B={nb}, ties at the "
          f"threshold 0.45 and a repeated row: " + "; ".join(found)
          + " (device time per call, L2 flushed)", flush=True)

    volume_phase(torch, dev, counters, none)
    kernels += denoising_phase(torch, dev, counters, wrappers, none)
    kernels += temporal_phases(torch, dev, counters, wrappers, none)
    kernels += yolo_flavour_phases(torch, dev, counters, wrappers, none)
    yolo_train_phase(torch, dev, counters, none)
    kernels += temporal_train_phase(torch, dev, counters, wrappers, none)
    signal_phases(torch, dev, counters, none)
    signal_train_phases(torch, dev, counters, none)
    kernels += int8_phases(torch, dev, counters, wrappers, none,
                           fps["kernels"])
    host_phase(torch, dev)
    cli_phase(torch, dev, counters, wrappers, none)
    multi_phase(torch, dev)

    print(f"[wall] chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
          f"in all, the kernels' build included", flush=True)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "call_ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms",
                           "library_note") if k in r}
        for r in kernels]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
