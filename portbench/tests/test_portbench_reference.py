"""The frozen reference against the port's plain CPU path at tiny sizes:
the same weights and inputs give the same outputs, so the reference the
cells are judged by is the port's own mathematics."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.core import spec
from portbench.reference import common, yolo as ref_yolo
from portbench.reference.weights import seeded_state_dict

CONFIGS = spec.CHECKOUT / "portbench" / "configs"


def _close(a, b, tol=1e-5):
    assert torch.allclose(a.float(), b.float(), rtol=tol, atol=tol), \
        (a.float() - b.float()).abs().max().item()


def test_dfine_reference_is_the_ports_forward():
    from pautdx_torch.models.vision import dfine
    from portbench.entries.dfine_serve import reference_config
    from portbench.reference import dfine as ref_dfine
    model = json.load(open(CONFIGS / "dfine-nano.json"))["model"]
    rcfg = reference_config(model)
    ref = ref_dfine.DFine(rcfg, device="cpu")
    sd = seeded_state_dict(ref, 3, (64, 64, 3))
    port = dfine.DFine(dfine.config_from_dict(
        json.loads(json.dumps(dataclasses.asdict(rcfg)))), device="cpu")
    port.load_state_dict(sd, strict=True)
    port.eval()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = ref(x), port(x)
    for k in ("logits", "pred_boxes", "enc_topk_logits"):
        _close(a[k], b[k])
    pa = ref_dfine.post_process(a["logits"], a["pred_boxes"], (64, 64),
                                0.3, 16)
    pb = dfine.post_process(b["logits"], b["pred_boxes"], (64, 64), 0.3, 16)
    _close(pa["scores"], pb["scores"])


def test_dfine_reference_follows_a_given_selection():
    from portbench.entries.dfine_serve import reference_config
    from portbench.reference import dfine as ref_dfine
    model = json.load(open(CONFIGS / "dfine-nano.json"))["model"]
    ref = ref_dfine.DFine(reference_config(model), device="cpu")
    seeded_state_dict(ref, 3, (64, 64, 3))
    x = torch.rand(1, 64, 64, 3)
    with torch.no_grad():
        own = ref(x)
        sel = torch.topk(own["enc_class"].max(-1).values.float(),
                         own["logits"].shape[1], dim=1).indices
        again = ref(x, topk_ind=sel)
    _close(own["logits"], again["logits"], 0)


def _yolo_pair(size=128):
    from pautdx_torch.models.vision import yolo
    model = json.load(open(CONFIGS / "yolov8n-seg.json"))["model"]
    ref = ref_yolo.YOLO(ref_yolo.YoloConfig(**model), device="cpu")
    sd = seeded_state_dict(ref, 4, (size, size, 3))
    port = yolo.YOLO(yolo.YoloConfig(**model), device="cpu")
    port.load_state_dict(sd, strict=True)
    port.eval()
    return ref, port, sd


def test_yolo_reference_is_the_ports_predict_chain():
    from pautdx_torch.serve import yolo_predict
    from portbench.entries.yolo_serve import reference_predict
    ref, port, _ = _yolo_pair()
    cfg = json.load(open(CONFIGS / "yolov8n-seg.json"))
    frames = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    pred = yolo_predict.YoloPredictor(model=port, cfg=port.cfg)
    with torch.no_grad():
        got = pred(frames)
        want = reference_predict(ref, frames, ref.cfg, cfg["serve"]["nms"])
    assert int(want["valid"].sum()) > 0
    for k in ("boxes", "scores", "masks"):
        _close(got[k], want[k])
    assert torch.equal(got["indices"], want["indices"])


def test_nms_sweep_and_masks_are_the_ports_plain_versions():
    from pautdx_torch.ops import masks, suppress
    g = torch.Generator().manual_seed(5)
    iou = torch.rand(3, 40, 40, generator=g)
    valid = torch.rand(3, 40, generator=g) > 0.2
    assert torch.equal(common.nms_suppress(iou, valid, 0.45),
                       suppress.nms_suppress_reference(iou, valid, 0.45))
    protos = torch.randn(2, 16, 16, 8, generator=g)
    coeffs = torch.randn(2, 5, 8, generator=g)
    boxes = torch.rand(2, 5, 4, generator=g).sort(-1).values * 64
    boxes = boxes[..., [0, 1, 2, 3]]
    _close(common.assemble_masks(protos, coeffs, boxes, (64, 64)),
           masks.assemble_masks_reference(protos, coeffs, boxes, (64, 64)),
           0)


def test_gathers_and_attention_are_the_ports_plain_versions():
    from pautdx_torch.ops import attention, gather
    g = torch.Generator().manual_seed(6)
    flat = torch.randn(2, 30, 8, generator=g)
    idx = torch.randint(-3, 33, (2, 12), generator=g, dtype=torch.int32)
    assert torch.equal(common.onehot_gather(flat, idx),
                       gather.onehot_gather_reference(flat, idx))
    idx4 = torch.randint(0, 30, (2, 12, 4), generator=g, dtype=torch.int32)
    w = torch.rand(2, 12, 4, generator=g)
    _close(common.weighted_gather(flat, idx4, w),
           gather.weighted_gather_reference(flat, idx4, w), 0)
    q, k, v = (torch.randn(2, 10, 16, generator=g) for _ in range(3))
    _close(common.aifi_attention(q, k, v, 4),
           attention.aifi_attention_reference(q, k, v, 4), 0)


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, pkgutil, importlib, portbench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('portbench.reference.' + m.name)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('pautdx_torch', 'pautdx', 'jax', 'jaxlib', 'flax'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.CHECKOUT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
