"""Entry adapter: D-FINE-nano served on B-scan frames, bf16.

The program's path (``pautdx_torch.serve.throughput``): the serving model of
``build_serving_model`` (bf16 weights and statistics, 1/255 folded into the
space-to-depth stem, the fused AIFI attention, the discrete deformable
decoder), frames rearranged on the card by ``prepatchify_uint8``, then
``models.vision.dfine.post_process``; the answer a frame is its
``max_det`` detections (scores, classes, xyxy pixel boxes, valid flags).

The check follows the program's own query selection: a forward hook keeps
the encoder's class scores of each sampled batch, the reference selects
the same queries from them, and the check holds both stages apart:

- ``enc_select_gap_mean``: how far, in standard deviations of the frame's
  f32 encoder scores, the weakest query the program selected lies below
  the reference's own ``num_queries``-th best (0 where the sets agree),
  the mean over the frames;
- ``box_err``: each served detection against the reference detection
  nearest to it (same class): the gap of its box, in fractions of the
  frame side, the worst;
- ``score_logit_gap_mean``: each frame's served scores, sorted, against
  the reference's best ``max_det`` scores of the same queries, as logits:
  the mean gap over the ranks and the frames (the k-th largest score moves
  by no more than the largest gap of any one score, so no matching is
  needed);
- ``valid_flags_wrong``: served valid flags that disagree with the served
  scores and the threshold (exact).

The control (``program="control"``) is the reference itself in fp8 (e4m3,
per-tensor scales) at every matmul and convolution, in the program's
place.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

import torch

from portbench.reference import dfine as ref_dfine
from portbench.reference.common import observe_gathers
from portbench.reference.lowp import full_f32, lower_precision
from portbench.reference.weights import seeded_state_dict

SOURCES = ("aifi_attention", "onehot_gather")


def logit(p: torch.Tensor) -> torch.Tensor:
    p = p.float().clamp(1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def reference_config(model: dict) -> ref_dfine.DFineConfig:
    """The file's configuration as the reference runs it: frames in, its
    own space-to-depth (the program's wire format is the program's)."""
    cfg = ref_dfine.config_from_dict(model)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, stem_pre_patchified=False))


class Entry:

    def __init__(self, config: dict, traffic: dict, workload: dict,
                 seed: int, device: torch.device, program: str = "port"):
        self.config, self.traffic, self.workload = config, traffic, workload
        self.device = device
        self.img = tuple(traffic["size"][:2])
        self.serve = config["serve"]
        with full_f32():
            ref = ref_dfine.DFine(reference_config(config["model"]),
                                  device=device, seed=0)
            self.state_dict = seeded_state_dict(ref, seed,
                                                tuple(traffic["size"]))
        self._enc = None
        if program == "port":
            self._build_port(config, traffic)
        elif program == "control":
            ref.eval()
            self.model = lower_precision(ref, torch.float8_e4m3fn)
            self.patch = None
        else:
            raise ValueError(f"program {program!r}: 'port' or 'control'")
        if program != "port":
            self.post_process = ref_dfine.post_process
        self.model.model.enc_score_head.register_forward_hook(self._keep_enc)

    def _build_port(self, config: dict, traffic: dict) -> None:
        from pautdx_torch.models.vision import dfine
        from pautdx_torch.serve import throughput
        stated = json.loads(json.dumps(
            dfine.config_to_dict(throughput.serving_config())))
        if stated != config["model"]:
            raise ValueError("the program's serving configuration differs "
                             "from configs/dfine-nano.json's model")
        if self.device.type == "cuda":
            from pautdx_torch.ops import _build
            _build.build(SOURCES)
        sm = throughput.build_serving_model(
            device=self.device, batch=traffic["batch"],
            state_dict=self.state_dict)
        self.model = sm.model
        self.patch = sm.cfg.backbone.stem_patch
        self.prepatchify = throughput.prepatchify_uint8
        self.post_process = dfine.post_process

    def _keep_enc(self, module, args, out) -> None:
        self._enc = out

    def step(self, frames: torch.Tensor
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        with torch.inference_mode():
            if self.patch is None:      # the control: float frames
                with full_f32():
                    out = self.model(frames.float() / 255.0)
            else:
                out = self.model(self.prepatchify(frames, self.patch))
            det = self.post_process(out["logits"], out["pred_boxes"],
                                    self.img, self.serve["threshold"],
                                    self.serve["max_det"])
        served = {"scores": det["scores"].float(), "classes": det["classes"],
                  "boxes": det["boxes"].float(), "valid": det["valid"]}
        return served, {"enc_class": self._enc}

    def release(self) -> None:
        self.model = None
        self._enc = None

    @torch.no_grad()
    def check(self, samples, ring: torch.Tensor, batch: int
              ) -> Tuple[Dict[str, float], Dict[str, float]]:
        """The numbers compared, and the reference's counts of the work
        the kernels' bounds need (distinct gathered rows a frame)."""
        with full_f32():
            ref = ref_dfine.DFine(reference_config(self.config["model"]),
                                  device=self.device, seed=0)
            ref.load_state_dict(self.state_dict, strict=True)
            ref.eval()
            return self._compare(ref, samples, ring, batch)

    def _compare(self, ref, samples, ring, batch):
        thr, max_det = self.serve["threshold"], self.serve["max_det"]
        H, W = self.img
        side = torch.tensor([W, H, W, H], device=self.device,
                            dtype=torch.float32)
        worst = {"enc_select_gap_mean": 0.0, "box_err": 0.0,
                 "score_logit_gap_mean": 0.0, "valid_flags_wrong": 0.0}
        rows: List[int] = []
        frames_seen = 0
        n_valid = 0.0
        block = self.workload["check"]["block"]
        for s in samples:
            frames = ring[s.ring_batch * batch:(s.ring_batch + 1) * batch]
            enc_prog = s.extra["enc_class"]
            for lo in range(0, batch, block):
                hi = min(lo + block, batch)
                x = frames[lo:hi].to(self.device).float() / 255.0
                prog_s = enc_prog[lo:hi].max(-1).values.float()
                Q = min(ref.cfg.num_queries, prog_s.shape[1])
                sel = torch.topk(prog_s, Q, dim=1).indices
                with observe_gathers() as seen:
                    out = ref(x, topk_ind=sel)
                rows.extend(seen)
                ref_s = out["enc_class"].max(-1).values.float()
                kth = torch.topk(ref_s, Q, dim=1).values[:, -1]
                weakest = ref_s.gather(1, sel).min(1).values
                gap = ((kth - weakest).clamp(min=0)
                       / ref_s.std(1).clamp(min=1e-12))
                worst["enc_select_gap_mean"] += gap.sum().item()
                prob = torch.sigmoid(out["logits"].float())      # (b, Q, L)
                cx, cy, w, h = out["pred_boxes"].float().unbind(-1)
                box = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                   cy + h / 2], -1) * side      # (b, Q, 4)
                got = {k: v[lo:hi].to(self.device) for k, v in s.served.items()}
                cls = got["classes"].long()                      # (b, D)
                # each served detection's nearest reference slot
                p_at = prob.gather(2, cls[:, None, :].expand(
                    -1, prob.shape[1], -1))                      # (b, Q, D)
                d_box = ((box[:, :, None, :] - got["boxes"][:, None])
                         .abs().amax(-1) / max(H, W))            # (b, Q, D)
                d_score = (p_at - got["scores"][:, None]).abs()
                q = (d_box + d_score).argmin(1)                  # (b, D)
                b_err = d_box.gather(1, q[:, None]).squeeze(1)
                worst["box_err"] = max(worst["box_err"], b_err.max().item())
                top_det = torch.topk(prob.reshape(prob.shape[0], -1),
                                     max_det, dim=1).values
                # the served scores, sorted, against the reference's best
                # max_det of the same queries, as logits: the k-th largest
                # moves by no more than the largest gap of any one score
                lg = (logit(got["scores"].sort(1, descending=True).values)
                      - logit(top_det))
                worst["score_logit_gap_mean"] += lg.abs().mean(1).sum().item()
                n_valid += float(got["valid"].sum().item())
                flags = got["valid"] != (got["scores"] >= thr)
                worst["valid_flags_wrong"] += float(flags.sum().item())
                frames_seen += hi - lo
        if frames_seen:
            worst["enc_select_gap_mean"] /= frames_seen
            worst["score_logit_gap_mean"] /= frames_seen
        stats = {"frames_checked": float(frames_seen),
                 "valid_per_frame": n_valid / max(frames_seen, 1)}
        if rows and frames_seen:
            # distinct rows a frame and a call, over the decoder's calls
            stats["onehot_rows_per_frame_call"] = sum(rows) / (
                frames_seen * ref.cfg.decoder_layers)
        return worst, stats
