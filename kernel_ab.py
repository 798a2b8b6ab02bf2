"""A/B of pautdx_torch's CUDA kernels between checkouts, on one card.

    python3 kernel_ab.py times [--tree DIR]
    python3 kernel_ab.py tiles
    python3 kernel_ab.py wplans
    python3 kernel_ab.py sass [--match NAME] [--out DIR] SRC.cu [SRC.cu ...]
    python3 kernel_ab.py mma
    python3 kernel_ab.py phases

``times`` imports ``pautdx_torch`` from DIR (default: the checkout beside
this script), builds its kernels and times each kernel record's wrapper at
the main paths' shapes, on inputs made on the card from a fixed seed:
device time per call from ``torch.profiler`` (``chip_smoke.device_ms``,
the method of ``chip_smoke.py``'s kernel records), with L2 flushed before
each call and without; then the int8 convolution over one forward of each
int8 serving path (its 25 or 40 site shapes, ``INT8_SITES``, each timed
once and weighted by its sites). It prints a digest (sha256) of each
call's output, so that one call shows two trees' outputs bit-identical
(all but the backwards' d_flat, whose atomics sum in an order that
changes from run to run), and, where DIR's one-hot gather plans forward
tiles (``gather.forward_tiles``), the device time of an empty kernel
launched at both gather forwards' grids of a denoising step's b4: the
floor of those launches.
The timing code and the inputs are this checkout's whatever DIR is, so
two checkouts run in turns in one call (parent, change, change, parent)
are measured alike. The last line is one JSON object.

``tiles`` times the one-hot gather forward at the paths' shapes with other
plans (``TILE_PLANS``) in place of the plan's, beside the plan's own.

``wplans`` does the same for the weighted gather forward's six records
(random and bilinear corners at b16, b4 and b50): every group size of
``WPLAN_GROUPS`` with blocks of each of ``WPLAN_WARPS`` warps in place of
the plan's (``gather.weighted_plan``), each output checked bit for bit
against the plan's own.

``sass`` compiles each source with the port's nvcc flags to a cubin and
prints, for every kernel whose name holds NAME, its instruction count and
its opcodes by count (``cuobjdump -sass``), then its registers, static
shared memory and spills from ptxas; with ``--out`` it writes each full
listing there.

``mma`` times ``mma.sync`` alone on the card: TF32 m16n8k8 and bf16
m16n8k16 with f32 accumulators, 8 warps a block and 4 or 2 blocks an SM
(32 or 16 warps), or one warp an SM, each warp issuing C independent
chains (C = 1, 2, 4, 8): the rate an SM sustains, and, with one chain and
one warp, the latency of one product.

``phases`` builds a copy of ``csrc/int8_conv.cu`` with clock64() counters
around each phase of the dense wgmma kernel's consumers (waiting for a
TMA box, quantizing, the barrier, issuing and waiting for wgmma, the
epilogue) and prints each phase's share at the heaviest dense site
shapes. All need the CUDA toolkit, and all but ``sass`` a card.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


# The 65 distinct int8 site shapes of the two serving paths, as the
# serving forwards call them (one image's strides; the batch is 128 for
# D-FINE-nano in bf16, 32 for YOLOv8n-seg in f32): (C, H, W, strides,
# storage offset, weight OIHW, stride, groups, sites a forward).
DFINE_SITES = [
    (128, 80, 80, (819200, 1, 10240, 128), 0, (128, 1, 3, 3), 2, 128, 1),
    (128, 40, 40, (204800, 1, 5120, 128), 0, (64, 128, 1, 1), 1, 1, 1),
    (64, 40, 40, (102400, 1, 2560, 64), 0, (64, 1, 5, 5), 1, 64, 6),
    (64, 40, 40, (102400, 1, 2560, 64), 0, (64, 64, 1, 1), 1, 1, 12),
    (320, 40, 40, (512000, 1, 12800, 320), 0, (128, 320, 1, 1), 1, 1, 1),
    (128, 40, 40, (204800, 1, 5120, 128), 0, (256, 128, 1, 1), 1, 1, 2),
    (256, 40, 40, (409600, 1, 10240, 256), 0, (64, 256, 1, 1), 1, 1, 1),
    (448, 40, 40, (716800, 1, 17920, 448), 0, (128, 448, 1, 1), 1, 1, 1),
    (256, 40, 40, (409600, 1, 10240, 256), 0, (256, 1, 3, 3), 2, 256, 1),
    (256, 20, 20, (102400, 1, 5120, 256), 0, (128, 256, 1, 1), 1, 1, 1),
    (128, 20, 20, (51200, 1, 2560, 128), 0, (128, 1, 5, 5), 1, 128, 3),
    (128, 20, 20, (51200, 1, 2560, 128), 0, (128, 128, 1, 1), 1, 1, 3),
    (640, 20, 20, (256000, 1, 12800, 640), 0, (256, 640, 1, 1), 1, 1, 1),
    (256, 20, 20, (102400, 1, 5120, 256), 0, (512, 256, 1, 1), 1, 1, 1),
    (256, 40, 40, (409600, 1, 10240, 256), 0, (256, 256, 1, 1), 1, 1, 1),
    (128, 40, 40, (409600, 1, 10240, 256), 128, (64, 128, 1, 1), 1, 1, 2),
    (64, 40, 40, (102400, 1, 2560, 64), 0, (64, 64, 3, 3), 1, 1, 8),
    (384, 40, 40, (614400, 1, 15360, 384), 0, (128, 384, 1, 1), 1, 1, 1),
    (128, 40, 40, (204800, 1, 5120, 128), 0, (128, 128, 1, 1), 1, 1, 1),
    (128, 40, 40, (204800, 1, 5120, 128), 0, (128, 1, 3, 3), 2, 128, 1),
    (256, 20, 20, (102400, 1, 5120, 256), 0, (256, 256, 1, 1), 1, 1, 1),
    (128, 20, 20, (102400, 1, 5120, 256), 128, (64, 128, 1, 1), 1, 1, 2),
    (64, 20, 20, (25600, 1, 1280, 64), 0, (64, 64, 3, 3), 1, 1, 8),
    (64, 20, 20, (25600, 1, 1280, 64), 0, (64, 64, 1, 1), 1, 1, 8),
    (384, 20, 20, (153600, 1, 7680, 384), 0, (128, 384, 1, 1), 1, 1, 1)]
YOLO_SITES = [
    (3, 640, 640, (1228800, 1, 1920, 3), 0, (16, 3, 3, 3), 2, 1, 1),
    (16, 320, 320, (1638400, 1, 5120, 16), 0, (32, 16, 3, 3), 2, 1, 1),
    (32, 160, 160, (819200, 1, 5120, 32), 0, (32, 32, 1, 1), 1, 1, 1),
    (16, 160, 160, (819200, 1, 5120, 32), 16, (16, 16, 3, 3), 1, 1, 1),
    (16, 160, 160, (409600, 1, 2560, 16), 0, (16, 16, 3, 3), 1, 1, 1),
    (48, 160, 160, (1228800, 1, 7680, 48), 0, (32, 48, 1, 1), 1, 1, 1),
    (32, 160, 160, (819200, 1, 5120, 32), 0, (64, 32, 3, 3), 2, 1, 1),
    (64, 80, 80, (409600, 1, 5120, 64), 0, (64, 64, 1, 1), 1, 1, 1),
    (32, 80, 80, (409600, 1, 5120, 64), 32, (32, 32, 3, 3), 1, 1, 2),
    (32, 80, 80, (204800, 1, 2560, 32), 0, (32, 32, 3, 3), 1, 1, 5),
    (128, 80, 80, (819200, 1, 10240, 128), 0, (64, 128, 1, 1), 1, 1, 1),
    (64, 80, 80, (409600, 1, 5120, 64), 0, (128, 64, 3, 3), 2, 1, 1),
    (128, 40, 40, (204800, 1, 5120, 128), 0, (128, 128, 1, 1), 1, 1, 1),
    (64, 40, 40, (204800, 1, 5120, 128), 64, (64, 64, 3, 3), 1, 1, 3),
    (64, 40, 40, (102400, 1, 2560, 64), 0, (64, 64, 3, 3), 1, 1, 7),
    (256, 40, 40, (409600, 1, 10240, 256), 0, (128, 256, 1, 1), 1, 1, 1),
    (128, 40, 40, (204800, 1, 5120, 128), 0, (256, 128, 3, 3), 2, 1, 1),
    (256, 20, 20, (102400, 1, 5120, 256), 0, (256, 256, 1, 1), 1, 1, 1),
    (128, 20, 20, (102400, 1, 5120, 256), 128, (128, 128, 3, 3), 1, 1, 2),
    (128, 20, 20, (51200, 1, 2560, 128), 0, (128, 128, 3, 3), 1, 1, 2),
    (384, 20, 20, (153600, 1, 7680, 384), 0, (256, 384, 1, 1), 1, 1, 3),
    (256, 20, 20, (102400, 1, 5120, 256), 0, (128, 256, 1, 1), 1, 1, 1),
    (512, 20, 20, (204800, 1, 10240, 512), 0, (256, 512, 1, 1), 1, 1, 1),
    (384, 40, 40, (614400, 1, 15360, 384), 0, (128, 384, 1, 1), 1, 1, 1),
    (192, 40, 40, (307200, 1, 7680, 192), 0, (128, 192, 1, 1), 1, 1, 3),
    (192, 80, 80, (1228800, 1, 15360, 192), 0, (64, 192, 1, 1), 1, 1, 1),
    (96, 80, 80, (614400, 1, 7680, 96), 0, (64, 96, 1, 1), 1, 1, 1),
    (64, 80, 80, (409600, 1, 5120, 64), 0, (64, 64, 3, 3), 2, 1, 1),
    (128, 40, 40, (204800, 1, 5120, 128), 0, (128, 128, 3, 3), 2, 1, 1),
    (64, 80, 80, (409600, 1, 5120, 64), 0, (64, 64, 3, 3), 1, 1, 5),
    (128, 40, 40, (204800, 1, 5120, 128), 0, (64, 128, 3, 3), 1, 1, 2),
    (256, 20, 20, (102400, 1, 5120, 256), 0, (64, 256, 3, 3), 1, 1, 2),
    (64, 20, 20, (25600, 1, 1280, 64), 0, (64, 64, 3, 3), 1, 1, 2),
    (64, 160, 160, (1638400, 1, 10240, 64), 0, (64, 64, 3, 3), 1, 1, 1),
    (64, 160, 160, (1638400, 1, 10240, 64), 0, (32, 64, 1, 1), 1, 1, 1),
    (64, 80, 80, (409600, 1, 5120, 64), 0, (32, 64, 3, 3), 1, 1, 1),
    (128, 40, 40, (204800, 1, 5120, 128), 0, (32, 128, 3, 3), 1, 1, 1),
    (32, 40, 40, (51200, 1, 1280, 32), 0, (32, 32, 3, 3), 1, 1, 1),
    (256, 20, 20, (102400, 1, 5120, 256), 0, (32, 256, 3, 3), 1, 1, 1),
    (32, 20, 20, (12800, 1, 640, 32), 0, (32, 32, 3, 3), 1, 1, 1)]
# The int8 site shapes of the CLI's YOLOv5su, YOLOv9c and YOLO11n
# (``predict-bscan --quant int8 --flavour v5|v9c|v11``: two classes, f32,
# 640px) that the YOLOv8n-seg forward above lacks: v5su's 6x6 stem, v9c's
# RepConvN branches and 159/79/39-pixel stride-2 inputs, v11n's C3k2 and
# PSA convolutions (its attention's NCHW depthwise and 1x1 sites among
# them), as ``chip_smoke.py`` phase 36 captured them (one image's strides,
# the storage offset in channels, sites a forward). Not timed by ``times``;
# the route each takes is checked on the CPU.
YOLO_FLAVOUR_SITES = {
    "v5": [
        (3, 640, 640, (1228800, 1, 1920, 3), 0, (16, 3, 6, 6), 2, 1, 1),
        (32, 160, 160, (819200, 1, 5120, 32), 0, (16, 32, 1, 1), 1, 1, 2),
        (16, 160, 160, (409600, 1, 2560, 16), 0, (16, 16, 1, 1), 1, 1, 1),
        (64, 80, 80, (409600, 1, 5120, 64), 0, (32, 64, 1, 1), 1, 1, 2),
        (32, 80, 80, (204800, 1, 2560, 32), 0, (32, 32, 1, 1), 1, 1, 3),
        (128, 40, 40, (204800, 1, 5120, 128), 0, (64, 128, 1, 1), 1, 1, 5),
        (64, 40, 40, (102400, 1, 2560, 64), 0, (64, 64, 1, 1), 1, 1, 5),
        (128, 20, 20, (51200, 1, 2560, 128), 0, (128, 128, 1, 1), 1, 1, 2),
        (256, 40, 40, (409600, 1, 10240, 256), 0, (64, 256, 1, 1), 1, 1, 2),
        (128, 80, 80, (819200, 1, 10240, 128), 0, (32, 128, 1, 1), 1, 1, 2)],
    "v9c": [
        (3, 640, 640, (1228800, 1, 1920, 3), 0, (64, 3, 3, 3), 2, 1, 1),
        (64, 320, 320, (6553600, 1, 20480, 64), 0, (128, 64, 3, 3), 2, 1, 1),
        (128, 160, 160, (3276800, 1, 20480, 128), 0, (128, 128, 1, 1), 1, 1, 1),
        (32, 160, 160, (819200, 1, 5120, 32), 0, (32, 32, 3, 3), 1, 1, 4),
        (64, 160, 160, (1638400, 1, 10240, 64), 0, (64, 64, 1, 1), 1, 1, 2),
        (256, 160, 160, (6553600, 1, 40960, 256), 0, (256, 256, 1, 1), 1, 1, 1),
        (128, 159, 159, (6471936, 1, 40704, 256), 0, (128, 128, 3, 3), 2, 1, 1),
        (128, 80, 80, (819200, 1, 10240, 128), 0, (128, 128, 1, 1), 1, 1, 5),
        (256, 80, 80, (1638400, 1, 20480, 256), 0, (256, 256, 1, 1), 1, 1, 1),
        (128, 80, 80, (819200, 1, 10240, 128), 0, (128, 128, 3, 3), 1, 1, 4),
        (512, 80, 80, (3276800, 1, 40960, 512), 0, (512, 512, 1, 1), 1, 1, 1),
        (256, 79, 79, (3195392, 1, 40448, 512), 0, (256, 256, 3, 3), 2, 1, 1),
        (256, 40, 40, (409600, 1, 10240, 256), 0, (256, 256, 1, 1), 1, 1, 7),
        (512, 40, 40, (819200, 1, 20480, 512), 0, (512, 512, 1, 1), 1, 1, 1),
        (128, 40, 40, (204800, 1, 5120, 128), 0, (128, 128, 3, 3), 1, 1, 12),
        (256, 40, 40, (409600, 1, 10240, 256), 0, (256, 256, 3, 3), 1, 1, 7),
        (1024, 40, 40, (1638400, 1, 40960, 1024), 0, (512, 1024, 1, 1), 1, 1, 4),
        (256, 39, 39, (778752, 1, 19968, 512), 0, (256, 256, 3, 3), 2, 1, 2),
        (512, 20, 20, (204800, 1, 10240, 512), 0, (512, 512, 1, 1), 1, 1, 1),
        (128, 20, 20, (51200, 1, 2560, 128), 0, (128, 128, 1, 1), 1, 1, 4),
        (256, 20, 20, (102400, 1, 5120, 256), 0, (256, 256, 3, 3), 1, 1, 5),
        (1024, 20, 20, (409600, 1, 20480, 1024), 0, (512, 1024, 1, 1), 1, 1, 4),
        (1024, 80, 80, (6553600, 1, 81920, 1024), 0, (256, 1024, 1, 1), 1, 1, 1),
        (512, 80, 80, (3276800, 1, 40960, 512), 0, (256, 512, 1, 1), 1, 1, 1),
        (128, 79, 79, (1597696, 1, 20224, 256), 0, (128, 128, 3, 3), 2, 1, 1),
        (768, 40, 40, (1228800, 1, 30720, 768), 0, (512, 768, 1, 1), 1, 1, 1),
        (256, 80, 80, (1638400, 1, 20480, 256), 0, (64, 256, 3, 3), 1, 1, 1),
        (256, 80, 80, (1638400, 1, 20480, 256), 0, (256, 256, 3, 3), 1, 1, 2),
        (512, 40, 40, (819200, 1, 20480, 512), 0, (64, 512, 3, 3), 1, 1, 1),
        (512, 40, 40, (819200, 1, 20480, 512), 0, (256, 512, 3, 3), 1, 1, 1),
        (512, 20, 20, (204800, 1, 10240, 512), 0, (64, 512, 3, 3), 1, 1, 1),
        (512, 20, 20, (204800, 1, 10240, 512), 0, (256, 512, 3, 3), 1, 1, 1)],
    "v11": [
        (16, 160, 160, (819200, 1, 5120, 32), 16, (8, 16, 3, 3), 1, 1, 1),
        (8, 160, 160, (204800, 1, 1280, 8), 0, (16, 8, 3, 3), 1, 1, 1),
        (48, 160, 160, (1228800, 1, 7680, 48), 0, (64, 48, 1, 1), 1, 1, 1),
        (64, 160, 160, (1638400, 1, 10240, 64), 0, (64, 64, 3, 3), 2, 1, 1),
        (32, 80, 80, (409600, 1, 5120, 64), 32, (16, 32, 3, 3), 1, 1, 2),
        (16, 80, 80, (102400, 1, 1280, 16), 0, (32, 16, 3, 3), 1, 1, 2),
        (96, 80, 80, (614400, 1, 7680, 96), 0, (128, 96, 1, 1), 1, 1, 1),
        (128, 80, 80, (819200, 1, 10240, 128), 0, (128, 128, 3, 3), 2, 1, 1),
        (64, 40, 40, (204800, 1, 5120, 128), 64, (32, 64, 1, 1), 1, 1, 2),
        (64, 40, 40, (102400, 1, 2560, 64), 0, (64, 64, 1, 1), 1, 1, 2),
        (128, 20, 20, (102400, 1, 5120, 256), 128, (64, 128, 1, 1), 1, 1, 4),
        (128, 20, 20, (51200, 1, 2560, 128), 0, (128, 128, 1, 1), 1, 1, 2),
        (128, 20, 20, (102400, 1, 5120, 256), 128, (256, 128, 1, 1), 1, 1, 1),
        (128, 20, 20, (51200, 400, 20, 1), 0, (128, 1, 3, 3), 1, 128, 1),
        (128, 20, 20, (51200, 400, 20, 1), 0, (128, 128, 1, 1), 1, 1, 1),
        (128, 20, 20, (51200, 1, 2560, 128), 0, (256, 128, 1, 1), 1, 1, 1),
        (64, 40, 40, (204800, 1, 5120, 128), 64, (32, 64, 3, 3), 1, 1, 2),
        (32, 40, 40, (51200, 1, 1280, 32), 0, (64, 32, 3, 3), 1, 1, 2),
        (256, 80, 80, (1638400, 1, 20480, 256), 0, (64, 256, 1, 1), 1, 1, 1),
        (64, 80, 80, (409600, 1, 5120, 64), 0, (64, 1, 3, 3), 1, 64, 2),
        (128, 40, 40, (204800, 1, 5120, 128), 0, (128, 1, 3, 3), 1, 128, 1),
        (128, 40, 40, (204800, 1, 5120, 128), 0, (64, 128, 1, 1), 1, 1, 1),
        (64, 40, 40, (102400, 1, 2560, 64), 0, (64, 1, 3, 3), 1, 64, 1),
        (256, 20, 20, (102400, 1, 5120, 256), 0, (256, 1, 3, 3), 1, 256, 1),
        (256, 20, 20, (102400, 1, 5120, 256), 0, (64, 256, 1, 1), 1, 1, 1),
        (64, 20, 20, (25600, 1, 1280, 64), 0, (64, 1, 3, 3), 1, 64, 1),
        (64, 20, 20, (25600, 1, 1280, 64), 0, (64, 64, 1, 1), 1, 1, 1)]}
INT8_SITES = {"dfine": DFINE_SITES, "yolo": YOLO_SITES,
              **{f"yolo_{k}": v for k, v in YOLO_FLAVOUR_SITES.items()}}
INT8_PATHS = (("dfine", 128, "bfloat16"), ("yolo", 32, "float32"))
# the heaviest site shapes, by index, timed on their own
INT8_HEAVY = {"dfine": {"3x3_64_40": 16, "1x1_448_128": 7,
                        "1x1_640_256": 12, "dw_k5_40": 2, "dw_k3s2_80": 0},
              "yolo": {"3x3_64_160": 33, "stem": 0}}


def int8_site_call(torch, dev, site, batch: int, dtype, seed: int):
    """A call of ``qconv.int8_conv`` at one site shape: the input a slice
    of a channels-last tensor with the site's strides and offset, weights
    in the input's dtype, the scale from the input's max, all from a
    seed."""
    from pautdx_torch.ops import qconv

    C, H, W, strides, off, wshape, st, g, _ = site
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn((batch, strides[3] if C > 1 else C, H, W),
                       generator=gen, device=dev).to(dtype)
    x = base.to(memory_format=torch.channels_last)[:, off:off + C]
    w = torch.randn(wshape, generator=gen, device=dev).to(dtype)
    prep = qconv.prepare_int8_weight(w, float(x.float().abs().max()) / 127,
                                     g)
    pad = (wshape[2] - 1) // 2
    return lambda: qconv.int8_conv(x, w, st, pad, g, None, prep)


def kernel_calls(torch, dev) -> dict:
    """name -> a call of one kernel wrapper at a main path's shape."""
    from pautdx_torch.ops import attention, deformable, gather, masks, suppress
    from pautdx_torch.ops.nms import box_iou_matrix

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    calls = {}
    # AIFI attention: the serving shape (dh 16) and the HF predict's (32)
    for B, dh in ((128, 16), (32, 32)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn(B, 400, 8 * dh, dtype=dtype) for _ in range(3))
            q = q * dh ** -0.5
            name = f"aifi_attention_dh{dh}_{str(dtype).split('.')[1]}"
            calls[name] = (lambda q=q, k=k, v=v:
                           attention.aifi_attention(q, k, v, 8))
    # YOLO predict: NMS over (32, 300) candidates, masks of K=100 boxes
    xy = rand(32, 300, 2) * 560
    iou = box_iou_matrix(torch.cat([xy, xy + 10 + rand(32, 300, 2) * 150],
                                   -1))
    valid = rand(32, 300) > 0.2
    calls["nms_suppress"] = lambda: suppress.nms_suppress(iou, valid, 0.45)
    protos, coeffs = randn(32, 160, 160, 32), randn(32, 100, 32)
    mxy = rand(32, 100, 2) * 700 - 60
    mboxes = torch.cat([mxy, mxy + rand(32, 100, 2) * 320], -1)
    calls["assemble_masks"] = lambda: masks.assemble_masks(
        protos, coeffs, mboxes, (640, 640))
    # serving's one-hot gather; training's weighted gather and backwards
    table = randn(128, 2000, 128, dtype=torch.bfloat16)
    idx = torch.randint(0, 2000, (128, 1200), generator=gen, device=dev,
                        dtype=torch.int32)
    calls["onehot_gather"] = lambda: gather.onehot_gather(table, idx)
    flat, g = randn(16, 2000, 128), randn(16, 1200, 128)
    widx = torch.randint(-3, 2003, (16, 1200, 4), generator=gen, device=dev,
                         dtype=torch.int32)
    w = rand(16, 1200, 4)
    calls["weighted_gather"] = lambda: gather.weighted_gather(flat, widx, w)
    calls["weighted_gather_backward"] = lambda: (
        gather.weighted_gather_backward(flat, widx, w, g))
    oidx = widx[..., 0].contiguous()
    calls["onehot_gather_backward"] = lambda: (
        gather.onehot_gather_backward(g, oidx, 2000))
    # the weighted gather's two other training shapes: the b4 step with a
    # denoising group (342 queries x 8 points) and a temporal v3 step (one
    # 50-frame sequence as the batch)
    for suffix, B, T in (("_denoising", 4, 2736), ("_temporal_train", 50,
                                                   1200)):
        tf, tg = randn(B, 2000, 128), randn(B, T, 128)
        ti = torch.randint(-3, 2003, (B, T, 4), generator=gen, device=dev,
                           dtype=torch.int32)
        tw = rand(B, T, 4)
        calls["weighted_gather" + suffix] = (
            lambda tf=tf, ti=ti, tw=tw: gather.weighted_gather(tf, ti, tw))
        calls["weighted_gather_backward" + suffix] = (
            lambda tf=tf, ti=ti, tw=tw, tg=tg:
            gather.weighted_gather_backward(tf, ti, tw, tg))
    # the weighted gather's three training shapes again with the path's
    # corners: bilinear taps (ops/deformable.bilinear_taps) of uniform
    # random points on a 40 x 40 and a 20 x 20 level (2,000 rows), four
    # points on each, so that corners (0, 0), (0, 1) and (1, 0), (1, 1) lie
    # on consecutive rows but at the grid's edges
    for suffix, B, T in (("", 16, 1200), ("_denoising", 4, 2736),
                         ("_temporal_train", 50, 1200)):
        loc = rand(B, T // 8, 8, 2)
        bi, bw = deformable.bilinear_taps(((40, 40), (20, 20)), loc, (4, 4))
        bf = randn(B, 2000, 128)
        bi = bi.reshape(B, T, 4).contiguous()
        bw = bw.reshape(B, T, 4).contiguous()
        calls["weighted_gather_bilinear" + suffix] = (
            lambda bf=bf, bi=bi, bw=bw: gather.weighted_gather(bf, bi, bw))
    # the one-hot gather at a denoising step (f32, b4, 342 queries x 8
    # points) and at a temporal chunk (bf16, one 50-frame sequence)
    for suffix, B, T, dtype in (("_denoising", 4, 2736, torch.float32),
                                ("_temporal", 50, 1200, torch.bfloat16)):
        ot = randn(B, 2000, 128, dtype=dtype)
        oi = torch.randint(-3, 2003, (B, T), generator=gen, device=dev,
                           dtype=torch.int32)
        calls["onehot_gather" + suffix] = (
            lambda ot=ot, oi=oi: gather.onehot_gather(ot, oi))
    # the int8 convolution at the serving paths' heaviest site shapes
    for path, batch, dtype in INT8_PATHS:
        for name, i in INT8_HEAVY[path].items():
            calls[f"int8_{path}_{name}"] = int8_site_call(
                torch, dev, INT8_SITES[path][i], batch, getattr(torch, dtype),
                i)
    return calls


def int8_forward_ms(torch, dev, chip_smoke) -> dict:
    """Device ms of the int8 convolution over one forward of each serving
    path: every site shape once (L2 flushed), times its sites a forward,
    summed; and split into dense and depthwise."""
    out = {}
    for path, batch, dtype in INT8_PATHS:
        sums = {"all": 0.0, "dense": 0.0, "depthwise": 0.0}
        for i, site in enumerate(INT8_SITES[path]):
            fn = int8_site_call(torch, dev, site, batch, getattr(torch, dtype),
                                i)
            ms = chip_smoke.device_ms(fn, reps=5) * site[-1]
            sums["all"] += ms
            sums["depthwise" if site[7] > 1 else "dense"] += ms
        out[path] = sums
    return out


def digest(out) -> str:
    """sha256 of a call's output tensors' bytes, the first 16 hex digits."""
    import torch

    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()[:16]


_EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int gx, int gy, int threads, int smem,
                            void* stream) {
  if (smem > 47 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  empty_kernel<<<dim3(gx, gy), threads, smem, (cudaStream_t)stream>>>();
  return cudaGetLastError();
}
"""


def empty_floor(torch, chip_smoke, gather) -> dict:
    """Device ms of an empty kernel launched as each gather forward launches
    at a denoising step's b4, (4, 2000, 128) f32 x 2736 taps: the one-hot
    plan's grid, threads and dynamic shared memory, and the weighted
    forward's grid (``gather.weighted_plan``, or one warp a tap, at most
    132 x 16 blocks of 8 warps, where DIR has no plan). The launch and
    block-scheduling floor of those rows."""
    import ctypes

    from pautdx_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "e.cu"), os.path.join(tmp, "e.so")
        with open(src, "w") as f:
            f.write(_EMPTY_SRC)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                       check=True, capture_output=True, text=True)
        fn = ctypes.CDLL(lib).empty_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    plan = gather.forward_tiles(4, 2736, 512, props.multi_processor_count,
                                props.shared_memory_per_multiprocessor)
    if hasattr(gather, "weighted_plan"):
        wplan = gather.weighted_plan(4, 2736, 4, 512,
                                     props.multi_processor_count)
        weighted = (wplan.blocks, 32 * wplan.warps)
    else:
        weighted = (min(-(-4 * 2736 // 8), 132 * 16), 256)
    out = {}
    for name, blocks, threads, smem in (
            ("onehot_gather_denoising", plan.blocks, 32, plan.smem),
            ("weighted_gather_denoising", *weighted, 0)):

        def run(blocks=blocks, threads=threads, smem=smem):
            chip_smoke.check(fn(blocks, 1, threads, smem,
                                torch.cuda.current_stream().cuda_stream) == 0,
                             "empty kernel launch failed")

        out[name] = dict(blocks=blocks, threads=threads, smem=smem,
                         ms=chip_smoke.device_ms(run))
    return out


def times(tree: str) -> None:
    import chip_smoke  # this checkout's timing method, before DIR's package

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import pautdx_torch
    from pautdx_torch.ops import _build

    where = os.path.dirname(os.path.dirname(os.path.abspath(
        pautdx_torch.__file__)))
    chip_smoke.check(where == os.path.abspath(tree),
                     f"pautdx_torch imported from {where}, not {tree}")
    chip_smoke.check(torch.cuda.is_available(), "needs a card")
    chip_smoke.set_tf32(False)
    _build.build()
    calls = kernel_calls(torch, torch.device("cuda"))
    out = {"tree": os.path.abspath(tree), "card": chip_smoke.smi_line()}
    with torch.no_grad():
        out["digest"] = {name: digest(fn()) for name, fn in calls.items()}
    from pautdx_torch.ops import gather
    if hasattr(gather, "forward_tiles"):
        out["empty_floor"] = empty_floor(torch, chip_smoke, gather)
    flush = chip_smoke.FLUSH_BYTES
    with torch.no_grad():
        for mode, nbytes in (("flushed", flush), ("warm", 0)):
            chip_smoke.FLUSH_BYTES = nbytes
            out[mode] = {name: chip_smoke.device_ms(fn)
                         for name, fn in calls.items()}
    chip_smoke.FLUSH_BYTES = flush
    with torch.no_grad():
        out["int8_forward"] = int8_forward_ms(torch, torch.device("cuda"),
                                              chip_smoke)
    for name in calls:
        print(f"{name}: device ms per call, L2 flushed "
              f"{out['flushed'][name]:.4f}, warm {out['warm'][name]:.4f}; "
              f"output sha256 {out['digest'][name]}", flush=True)
    for name, r in out.get("empty_floor", {}).items():
        print(f"empty kernel at {name}'s grid, {r['blocks']} blocks of "
              f"{r['threads']} threads, {r['smem']} B shared: device ms "
              f"{r['ms']:.4f}", flush=True)
    for path, sums in out["int8_forward"].items():
        print(f"int8 convolutions over one {path} forward: device ms, L2 "
              f"flushed, " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in sums.items()), flush=True)
    print(json.dumps(out))


# the one-hot forward's records of ``kernel_calls`` that ``tiles`` times,
# and the plans (taps a tile, stages) it times in place of the plan's
GATHER_FORWARDS = ("onehot_gather", "onehot_gather_denoising",
                   "onehot_gather_temporal")
TILE_PLANS = ((8, 1), (16, 1), (32, 1), (8, 2), (16, 2), (32, 2), (64, 1))


def tiles() -> None:
    """Device ms per call (L2 flushed) of the one-hot forward at the paths'
    shapes with each plan (taps a tile, stages) of ``TILE_PLANS`` in place
    of the plan's, set through ``gather``'s plan constants, and with the
    plan's own; each plan's output must equal the plan's own bit for
    bit."""
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke
    from pautdx_torch.ops import _build, gather

    chip_smoke.check(torch.cuda.is_available(), "needs a card")
    _build.build(["onehot_gather"])
    calls = kernel_calls(torch, torch.device("cuda"))
    own = (gather.MAX_TILE_TAPS, gather.MIN_TILE_TAPS, gather.STAGES)
    print(f"card {chip_smoke.smi_line()}", flush=True)
    out = {}
    with torch.no_grad():
        for name in GATHER_FORWARDS:
            row = {"plan": chip_smoke.device_ms(calls[name])}
            want = calls[name]()
            for tt, st in TILE_PLANS:
                try:
                    (gather.MAX_TILE_TAPS, gather.MIN_TILE_TAPS,
                     gather.STAGES) = (tt, tt, st)
                    chip_smoke.check(torch.equal(calls[name](), want),
                                     f"{name}, {tt}x{st}: the output "
                                     f"differs from the plan's")
                    row[f"{tt}x{st}"] = chip_smoke.device_ms(calls[name])
                finally:
                    (gather.MAX_TILE_TAPS, gather.MIN_TILE_TAPS,
                     gather.STAGES) = own
            out[name] = row
            print(f"{name}: device ms per call, L2 flushed, by plan (taps a "
                  f"tile x stages): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    print(json.dumps(out))


# the weighted forward's records of ``kernel_calls`` that ``wplans`` times,
# and the group sizes (taps a warp) and warps a block it times in place of
# the plan's
WEIGHTED_FORWARDS = tuple(f"weighted_gather{c}{s}" for c in ("", "_bilinear")
                          for s in ("", "_denoising", "_temporal_train"))
WPLAN_GROUPS = (1, 2, 3, 4, 6, 8)
WPLAN_WARPS = (4, 8)


def wplans() -> None:
    """Device ms per call (L2 flushed) of the weighted forward at the
    paths' shapes with each group size of ``WPLAN_GROUPS`` and blocks of
    each of ``WPLAN_WARPS`` warps in place of the plan's, set through
    ``gather``'s plan bounds, and with the plan's own (printed); each
    output must equal the plan's own bit for bit."""
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke
    from pautdx_torch.ops import _build, gather

    chip_smoke.check(torch.cuda.is_available(), "needs a card")
    _build.build(["weighted_gather"])
    calls = kernel_calls(torch, torch.device("cuda"))
    own = (gather.MIN_GROUP, gather.MAX_GROUP, gather.WEIGHTED_WARPS)
    plan_of, taken = gather.weighted_plan, []

    def recording_plan(*args):
        taken.append(plan_of(*args))
        return taken[-1]

    print(f"card {chip_smoke.smi_line()}", flush=True)
    out = {}
    with torch.no_grad():
        for name in WEIGHTED_FORWARDS:
            gather.weighted_plan = recording_plan
            try:
                want = calls[name]()
            finally:
                gather.weighted_plan = plan_of
            plan = taken[-1]
            row = {f"plan {plan.group}x{plan.warps}":
                   chip_smoke.device_ms(calls[name])}
            for group in WPLAN_GROUPS:
                for warps in WPLAN_WARPS:
                    try:
                        (gather.MIN_GROUP, gather.MAX_GROUP,
                         gather.WEIGHTED_WARPS) = (group, group, warps)
                        chip_smoke.check(torch.equal(calls[name](), want),
                                         f"{name}, {group}x{warps}: the "
                                         f"output differs from the plan's")
                        row[f"{group}x{warps}"] = chip_smoke.device_ms(
                            calls[name])
                    finally:
                        (gather.MIN_GROUP, gather.MAX_GROUP,
                         gather.WEIGHTED_WARPS) = own
            out[name] = dict(row, plan=plan._asdict())
            print(f"{name}: plan {plan.group} taps a group, {plan.blocks} "
                  f"blocks of {plan.warps} warps; device ms per call, L2 "
                  f"flushed, by taps a group x warps a block: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    print(json.dumps(out))


# phases: (text in csrc/int8_conv.cu, instrumented text); PROF(k, t) adds
# clock64() - t to counter k from consumer thread 0 of every block (and
# from the producer thread for k = 6)
_PHASE_PATCHES = (
    ("namespace {\n\nconstexpr int BM",
     "namespace {\n__device__ unsigned long long g_prof[16];\n"
     "#define PROF(k, t) do { if (tid == 0 || (k) == 6) atomicAdd(&g_prof[k],"
     " (unsigned long long)(clock64() - (t))); } while (0)\n\n"
     "constexpr int BM"),
    ("      mbar_wait(full(slot), phase);\n      const uint8_t* raw =",
     "      long long tq = clock64();\n      mbar_wait(full(slot), phase);\n"
     "      PROF(0, tq);\n      tq = clock64();\n      const uint8_t* raw ="),
    ("      __syncwarp();\n      if (lane == 0) mbar_arrive(empty(slot));",
     "      PROF(1, tq);\n      __syncwarp();\n"
     "      if (lane == 0) mbar_arrive(empty(slot));"),
    ("        mbar_wait(empty(slot), phase ^ 1);",
     "        { long long tp = clock64(); mbar_wait(empty(slot), phase ^ 1);"
     " PROF(6, tp); }"),
    ("    fence_proxy_async();\n    consumers_sync();",
     "    long long t0 = clock64();\n    if (te) { PROF(5, te); te = 0; }\n"
     "    fence_proxy_async();\n    consumers_sync();\n    PROF(2, t0);\n"
     "    t0 = clock64();"),
    ("    wg_commit();\n    if (i + 1 < items) quantize_item(i + 1, (i + 1) & 1);"
     "\n    wg_wait_all();",
     "    wg_commit();\n    PROF(3, t0);\n"
     "    if (i + 1 < items) quantize_item(i + 1, (i + 1) & 1);\n"
     "    t0 = clock64();\n    wg_wait_all();\n    PROF(4, t0);"),
    ("    if (chunk != p.nchunks - 1) continue;",
     "    if (chunk != p.nchunks - 1) continue;\n    te = clock64();"),
    ("      wg * (p.wg_dy * p.s * p.RS + p.wg_dx * 16);",
     "      wg * (p.wg_dy * p.s * p.RS + p.wg_dx * 16);\n  long long te = 0;"),
    ("  if (items > 0) quantize_item(0, 0);\n"
     "  if (p.b_resident && items > 0) mbar_wait(b_full(0), 0);",
     "  long long tb = clock64();\n  if (items > 0) quantize_item(0, 0);\n"
     "  if (p.b_resident && items > 0) mbar_wait(b_full(0), 0);\n"
     "  PROF(7, tb);"),
)
_PHASES = ("waiting for a TMA box", "quantizing", "at the consumers' barrier",
           "issuing wgmma", "waiting for wgmma", "epilogue", None,
           "first chunk and resident weights")


def phases() -> None:
    """Where the dense wgmma kernel's consumers spend their time at the
    heaviest dense site shapes: a copy of ``csrc/int8_conv.cu`` with
    clock64() counters around each phase of consumer thread 0 of every
    block, built and called through the wrapper; the producer's wait for a
    free ring slot as a share of the same total."""
    import ctypes

    import torch

    sys.path.insert(0, HERE)
    import chip_smoke
    from pautdx_torch.ops import _build, qconv

    chip_smoke.check(torch.cuda.is_available(), "needs a card")
    src = open(os.path.join(HERE, "pautdx_torch", "csrc",
                            "int8_conv.cu")).read()
    for old, new in _PHASE_PATCHES:
        chip_smoke.check(src.count(old) == 1, f"phases: no unique {old!r}")
        src = src.replace(old, new)
    src += ("\nextern \"C\" int prof_read(void* out) { return "
            "cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)); }\n"
            "extern \"C\" int prof_reset() { unsigned long long z[16] = {}; "
            "return cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n")
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "p.cu"), os.path.join(tmp, "p.so")
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(so)
    fn = lib.pautdx_int8_conv
    fn.argtypes, fn.restype = qconv._ARGTYPES, ctypes.c_int
    _build._FUNCS["pautdx_int8_conv"] = fn
    dev = torch.device("cuda")
    print(f"card {chip_smoke.smi_line()}", flush=True)
    for path, batch, dtype in INT8_PATHS:
        for name, i in INT8_HEAVY[path].items():
            site = INT8_SITES[path][i]
            if site[7] > 1 or site[0] == 3:
                continue
            call = int8_site_call(torch, dev, site, batch,
                                  getattr(torch, dtype), i)
            with torch.no_grad():
                call()
                torch.cuda.synchronize()
                lib.prof_reset()
                call()
                torch.cuda.synchronize()
            out = (ctypes.c_ulonglong * 16)()
            lib.prof_read(out)
            total = sum(out[k] for k in range(8) if k != 6) or 1
            print(f"int8_{path}_{name}: consumer time by phase, "
                  + ", ".join(f"{label} {out[k] / total:.2f}"
                              for k, label in enumerate(_PHASES) if label)
                  + f"; the producer waits for a free slot "
                  f"{out[6] / total:.2f} of that", flush=True)


_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T\d]+\s+)?([A-Z][A-Z0-9_]*)")


def sass(sources: list, match: str, out_dir: str) -> None:
    sys.path.insert(0, HERE)
    import chip_smoke
    from pautdx_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    for src in sources:
        with tempfile.TemporaryDirectory() as tmp:
            cubin = os.path.join(tmp, "k.cubin")
            log = subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, src],
                                 check=True, capture_output=True, text=True)
            listing = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                                     capture_output=True, text=True).stdout
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            name = os.path.basename(os.path.dirname(os.path.abspath(src)))
            with open(os.path.join(out_dir, f"{name}_{os.path.basename(src)}"
                                   ".sass"), "w") as f:
                f.write(listing)
        for part in listing.split("Function : ")[1:]:
            fname = part.split("\n", 1)[0].strip()
            if match not in fname:
                continue
            ops = collections.Counter(_OPCODE.findall(part))
            print(f"{src} {fname}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {n}" for k, n in ops.most_common()),
                  flush=True)
        for row in chip_smoke.ptxas_summary(log.stdout + log.stderr):
            if match in row.split(":")[0]:
                print(f"{src} ptxas {row}", flush=True)


_MMA_SRC = r"""
#include <cuda_runtime.h>
template <int C, bool TF32>
__global__ void __launch_bounds__(256) bench(float* out, int iters) {
  float d[C][4] = {};
  const unsigned a0 = threadIdx.x, a1 = a0 * 3u, a2 = a0 ^ 5u, a3 = a0 + 7u;
  const unsigned b0 = blockIdx.x, b1 = b0 + 1u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (TF32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float x = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) x += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}
template <int C>
int go(bool tf32, float* out, int blocks, int threads, int iters, cudaStream_t s) {
  if (tf32) bench<C, true><<<blocks, threads, 0, s>>>(out, iters);
  else bench<C, false><<<blocks, threads, 0, s>>>(out, iters);
  return cudaGetLastError();
}
extern "C" int mma_bench(int tf32, int chains, float* out, int blocks,
                         int threads, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return go<1>(tf32, out, blocks, threads, iters, s);
    case 2: return go<2>(tf32, out, blocks, threads, iters, s);
    case 4: return go<4>(tf32, out, blocks, threads, iters, s);
    default: return go<8>(tf32, out, blocks, threads, iters, s);
  }
}
"""


def mma() -> None:
    import ctypes

    import torch

    sys.path.insert(0, HERE)
    import chip_smoke
    from pautdx_torch.ops import _build

    chip_smoke.check(torch.cuda.is_available(), "needs a card")
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "mma.cu"), os.path.join(tmp, "mma.so")
        with open(src, "w") as f:
            f.write(_MMA_SRC)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                       check=True, capture_output=True, text=True)
        fn = ctypes.CDLL(lib).mma_bench
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    f_sm = chip_smoke.max_sm_clock_hz()
    out = torch.empty(4 * n_sm * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(f"card {chip_smoke.smi_line()}, {n_sm} SMs, clocks.max.sm "
          f"{f_sm / 1e6:.0f} MHz", flush=True)
    for tf32, flop in ((1, 2 * 16 * 8 * 8), (0, 2 * 16 * 8 * 16)):
        for chains in (1, 2, 4, 8):
            for blocks, threads in ((4 * n_sm, 256), (2 * n_sm, 256),
                                    (n_sm, 32)):
                iters = 4096

                def run():
                    chip_smoke.check(fn(tf32, chains, out.data_ptr(), blocks,
                                        threads, iters, stream) == 0,
                                     "mma bench launch failed")

                ms = chip_smoke.time_ms(run, reps=10)
                n = blocks * threads // 32 * iters * chains
                print(f"{'tf32 m16n8k8' if tf32 else 'bf16 m16n8k16'}: "
                      f"{chains} chain(s) a warp, {blocks} blocks of "
                      f"{threads} threads: {ms:.4f} ms, "
                      f"{n * flop / ms / 1e9:.1f} TFLOP/s, "
                      f"{n / n_sm / (ms * 1e-3 * f_sm):.3f} mma a clock an "
                      f"SM at clocks.max.sm", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("times")
    t.add_argument("--tree", default=HERE)
    sub.add_parser("tiles")
    sub.add_parser("wplans")
    s = sub.add_parser("sass")
    s.add_argument("--match", default="")
    s.add_argument("--out", default="")
    s.add_argument("sources", nargs="+")
    sub.add_parser("mma")
    sub.add_parser("phases")
    args = ap.parse_args()
    if args.cmd == "times":
        times(args.tree)
    elif args.cmd == "tiles":
        tiles()
    elif args.cmd == "wplans":
        wplans()
    elif args.cmd == "sass":
        sass(args.sources, args.match, args.out)
    elif args.cmd == "phases":
        phases()
    else:
        mma()


if __name__ == "__main__":
    main()
