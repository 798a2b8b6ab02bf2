"""Entry adapter: YOLOv8n-seg served on B-scan frames, f32 with TF32 off.

The program's path (``pautdx_torch.serve.yolo_predict``): the
``YoloPredictor`` of ``build_yolo_predictor`` over (B, H, W, 3) uint8
frames on the card (the model, the dense decode, batched NMS on the
``nms_suppress`` kernel, the kept anchors' masks on the ``assemble_masks``
kernel); its masks binarised at 0.5 as uint8 on the card, the form an
overlay uses. The answer a frame is its ``max_det`` slots: boxes, scores,
classes, valid flags, anchor indices and masks.

The check reads each served detection at its own anchor in the reference's
dense outputs:

- ``score_err``, ``box_err``: the served score and box (in fractions of
  the frame side) against the reference's at that anchor;
- ``nms_violation``: how far the served set of valid anchors is from
  being the greedy NMS of the reference's dense outputs, by the
  conditions that fix that set: each served anchor a candidate (its score
  no lower than the ``top_k``-th and the threshold), no two served
  anchors of a class overlapping past the IoU threshold, and each
  candidate left out suppressed by a served anchor of its class with a
  higher score at an IoU past the threshold (or, with ``max_det`` slots
  full, scoring below the lowest served). Each condition reads the least
  change of a score or an IoU that would meet it; the worst is compared;
- ``mask_margin``: over the mask pixels that differ from the reference's
  (its coefficients at the anchor, its protos, its box), the largest
  distance from the reference's decision: the smaller of the pixel's
  distance from 0.5 and its distance in proto pixels from the box's edge
  (0 where no pixel differs).

The control (``program="control"``) is the reference in the program's
place with TF32 products (``reference/lowp.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import torch

from portbench.reference import yolo as ref_yolo
from portbench.reference.common import assemble_masks
from portbench.reference.lowp import full_f32, lower_precision
from portbench.reference.nms import dense_to_detections
from portbench.reference.weights import seeded_state_dict

SOURCES = ("nms_suppress", "assemble_masks")


def reference_config(model: dict) -> ref_yolo.YoloConfig:
    return ref_yolo.YoloConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in model.items()})


def reference_predict(model, frames: torch.Tensor, cfg, nms: dict
                      ) -> Dict[str, torch.Tensor]:
    """The plain predict chain over uint8 frames: the model, the dense
    decode, batched NMS, the kept anchors' masks."""
    img = tuple(frames.shape[1:3])
    out = model(frames.float() / 255.0)
    d = ref_yolo.decode_boxes(out, img, cfg)
    det = dense_to_detections(d, **nms)
    coeffs = torch.take_along_dim(d["coeffs"], det["indices"][..., None], 1)
    det["masks"] = assemble_masks(out["protos"], coeffs, det["boxes"], img)
    return det


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 4), (..., N, 4) xyxy -> (..., M, N)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :]
                    - inter).clamp(min=1e-9)


def nms_violation(d: Dict[str, torch.Tensor], anchors: torch.Tensor,
                  valid: torch.Tensor, classes: torch.Tensor,
                  nms: dict) -> float:
    """The worst violation over the frames of the conditions that make
    the served anchors the greedy NMS of the reference's dense outputs
    ``d`` (see the module's docstring), in units of score or IoU."""
    thr, floor = nms["iou_threshold"], nms["score_threshold"]
    top_k, max_det = nms["top_k"], nms["max_det"]
    score, cls = d["scores"].max(-1)                     # (b, A)
    worst = 0.0
    for f in range(score.shape[0]):
        s, c, box = score[f], cls[f], d["boxes"][f]
        k = anchors[f][valid[f]]                         # served anchors
        kth = max(torch.topk(s, min(top_k, s.numel())).values[-1].item(),
                  floor)
        if k.numel():
            worst = max(worst, (kth - s[k]).clamp(min=0).max().item())
            served_cls = classes[f][valid[f]].long()
            worst = max(worst, (served_cls != c[k]).float().max().item())
            same = c[k][:, None] == c[k][None, :]
            iou_kk = _iou(box[k], box[k])
            pair = (iou_kk - thr).clamp(min=0) * same
            pair = pair.triu(diagonal=1)
            worst = max(worst, pair.max().item() if pair.numel() else 0.0)
        cand = torch.nonzero(s >= kth).squeeze(1)
        left = cand[~torch.isin(cand, k)]
        if not left.numel():
            continue
        if k.numel() >= max_det:
            # every slot full: candidates scoring below the lowest served
            # anchor may be kept by the sweep and cut by max_det
            left = left[s[left] > s[k].min()]
            if not left.numel():
                continue
        if not k.numel():
            worst = max(worst, (s[left] - floor).clamp(min=0).max().item()
                        + 1.0)
            continue
        iou_lk = _iou(box[left], box[k])                 # (L, K)
        need = torch.maximum((thr - iou_lk).clamp(min=0),
                             (s[left][:, None] - s[k][None, :]).clamp(min=0))
        need = torch.where(c[left][:, None] == c[k][None, :], need,
                           torch.full_like(need, 1.0))
        worst = max(worst, need.min(1).values.max().item())
    return worst


class Entry:

    def __init__(self, config: dict, traffic: dict, workload: dict,
                 seed: int, device: torch.device, program: str = "port"):
        self.config, self.traffic, self.workload = config, traffic, workload
        self.device = device
        self.cfg = reference_config(config["model"])
        self.nms = config["serve"]["nms"]
        with full_f32():
            ref = ref_yolo.YOLO(self.cfg, device=device, seed=0)
            self.state_dict = seeded_state_dict(ref, seed,
                                                tuple(traffic["size"]))
        if program == "port":
            from pautdx_torch.serve import yolo_predict
            name = config["serve"]["program_config"]
            stated = json.loads(json.dumps(dataclasses.asdict(
                yolo_predict.yolo_config(name))))
            if stated != config["model"]:
                raise ValueError(f"the program's {name} differs from the "
                                 f"configuration file's model")
            if device.type == "cuda":
                from pautdx_torch.ops import _build
                _build.build(SOURCES)
            pred = yolo_predict.build_yolo_predictor(
                device=device, cfg=yolo_predict.yolo_config(name))
            pred.model.load_state_dict(self.state_dict, strict=True)
            self.predict = pred
        elif program == "control":
            ref.eval()
            self.predict = self._control(lower_precision(ref, "tf32"))
        else:
            raise ValueError(f"program {program!r}: 'port' or 'control'")

    def _control(self, ref):
        def predict(frames):
            with torch.no_grad(), full_f32():
                return reference_predict(ref, frames, self.cfg, self.nms)
        return predict

    def step(self, frames: torch.Tensor
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        det = self.predict(frames)
        served = {k: det[k] for k in ("boxes", "scores", "classes", "valid",
                                      "indices")}
        served["masks"] = (det["masks"] > 0.5).to(torch.uint8)
        return served, {}

    def release(self) -> None:
        self.predict = None

    @torch.no_grad()
    def check(self, samples, ring: torch.Tensor, batch: int
              ) -> Tuple[Dict[str, float], Dict[str, float]]:
        with full_f32():
            ref = ref_yolo.YOLO(self.cfg, device=self.device, seed=0)
            ref.load_state_dict(self.state_dict, strict=True)
            ref.eval()
            return self._compare(ref, samples, ring, batch)

    def _compare(self, ref, samples, ring, batch):
        H, W = self.traffic["size"][:2]
        worst = {"score_err": 0.0, "box_err": 0.0, "nms_violation": 0.0,
                 "mask_margin": 0.0}
        frames = 0
        alive_tail = inside = kept = 0.0
        block = self.workload["check"]["block"]
        for s in samples:
            ring_frames = ring[s.ring_batch * batch:(s.ring_batch + 1) * batch]
            for lo in range(0, batch, block):
                hi = min(lo + block, batch)
                x = ring_frames[lo:hi].to(self.device)
                out = ref(x.float() / 255.0)
                d = ref_yolo.decode_boxes(out, (H, W), self.cfg)
                got = {k: v[lo:hi].to(self.device)
                       for k, v in s.served.items()}
                valid = got["valid"]
                a = got["indices"].long()
                cls = got["classes"].long().clamp(min=0)
                r_box = torch.take_along_dim(d["boxes"], a[..., None], 1)
                r_score = torch.take_along_dim(
                    torch.take_along_dim(d["scores"], a[..., None], 1),
                    cls[..., None], 2).squeeze(-1)
                s_err = ((got["scores"] - r_score).abs() * valid)
                b_err = ((got["boxes"] - r_box).abs().amax(-1) / max(H, W)
                         * valid)
                worst["score_err"] = max(worst["score_err"],
                                         s_err.max().item())
                worst["box_err"] = max(worst["box_err"], b_err.max().item())
                own = dense_to_detections(d, **self.nms)
                worst["nms_violation"] = max(
                    worst["nms_violation"],
                    nms_violation(d, a, valid, got["classes"], self.nms))
                frames += hi - lo
                # the reference's masks at the served anchors, its boxes
                coeffs = torch.take_along_dim(d["coeffs"], a[..., None], 1)
                m = torch.sigmoid(torch.einsum(
                    "bhwp,bkp->bkhw", out["protos"].float(), coeffs))
                Hp, Wp = m.shape[2:]
                pb = r_box * torch.tensor([Wp / W, Hp / H, Wp / W, Hp / H],
                                          device=self.device)
                ys = torch.arange(Hp, device=self.device,
                                  dtype=torch.float32)[:, None]
                xs = torch.arange(Wp, device=self.device,
                                  dtype=torch.float32)[None, :]
                x1, y1, x2, y2 = (pb[..., i, None, None] for i in range(4))
                inside_box = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
                want = inside_box & (m > 0.5)
                differs = (want != got["masks"].bool()) & valid[..., None,
                                                                None]
                if differs.any():
                    edge = torch.minimum(
                        torch.minimum((xs - x1).abs(), (xs - x2).abs()),
                        torch.minimum((ys - y1).abs(), (ys - y2).abs()))
                    margin = torch.minimum((m - 0.5).abs(), edge)
                    worst["mask_margin"] = max(
                        worst["mask_margin"], margin[differs].max().item())
                # the work the kernels' bounds need, from the reference
                keep = own["keep"]
                K = keep.shape[-1]
                tail = (K - 1 - torch.arange(K, device=self.device)) \
                    * (keep > 0)
                alive_tail += float(tail.sum().item())
                inside += float((inside_box & valid[..., None, None])
                                .sum().item())
                kept += float(valid.sum().item())
        stats = {"frames_checked": float(frames),
                 "valid_per_frame": kept / max(frames, 1)}
        if frames:
            stats["nms_alive_tail_per_frame"] = alive_tail / frames
            stats["mask_inside_pixels_per_frame"] = inside / frames
        return worst, stats
