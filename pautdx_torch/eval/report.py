"""Evaluation harness of the signal detectors: report artifacts and the
prediction map.

Counterpart of ``pautdx/eval/report.py``: ``SignalEvaluator`` runs a
per-signal detector over a dataset and reports the detection metrics
(confusion, accuracy, P/R/F1, specificity, balanced accuracy, MCC, AUC)
and, where the detector gives positions, the 1-d IoU statistics of the
defect signals, with text, CSV and JSON artifacts; ``prediction_map``
gives the beam x scan probability map behind ``predict-signal``.

Both take a host ``predict_fn``: (B, N, S) numpy -> a dict with
``"prob"`` (and ``"positions"``) or the probabilities alone, e.g.
``serve.endpoints.SignalEndpoint.predict``.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Callable, Dict, Optional

import numpy as np

from pautdx_torch.data.datasets import BatchIterator, SignalSequences
from pautdx_torch.data.volume import ParsedVolume
from pautdx_torch.data.windowing import chunked_windows, padded_window
from pautdx_torch.eval.iou import iou_statistics
from pautdx_torch.eval.metrics import (
    auc_roc, classification_report, format_report,
)


def _prob(out) -> np.ndarray:
    return np.asarray(out["prob"] if isinstance(out, dict) else out)


class SignalEvaluator:
    """Evaluate a per-signal detector (probabilities, optional
    positions)."""

    def __init__(self, predict_fn: Callable[[np.ndarray], Dict],
                 threshold: float = 0.5, batch_size: int = 8):
        self.predict_fn = predict_fn
        self.threshold = threshold
        self.batch_size = batch_size

    def run(self, ds: SignalSequences,
            out_dir: Optional[str] = None) -> Dict[str, float]:
        probs, labels, masks = [], [], []
        pred_pos, true_pos = [], []
        it = BatchIterator(ds, self.batch_size, shuffle=False,
                           drop_remainder=False)
        for batch in it:
            out = self.predict_fn(batch["signals"])
            p = _prob(out)
            probs.append(p)
            labels.append(batch["labels"])
            masks.append(np.broadcast_to(batch["sample_mask"][:, None],
                                         p.shape))
            if isinstance(out, dict) and "positions" in out:
                pred_pos.append(np.asarray(out["positions"]))
                true_pos.append(batch["positions"])
        probs = np.concatenate(probs)
        labels = np.concatenate(labels)
        masks = np.concatenate(masks)

        report = classification_report(probs, labels, self.threshold, masks)
        report["auc"] = auc_roc(probs, labels, masks)
        if pred_pos:
            defect_mask = (labels > 0.5) & (masks > 0)
            report.update(iou_statistics(
                np.concatenate(pred_pos).reshape(-1, 2),
                np.concatenate(true_pos).reshape(-1, 2),
                defect_mask.reshape(-1)))
        if out_dir is not None:
            self.save_artifacts(report, out_dir)
        return report

    @staticmethod
    def save_artifacts(report: Dict[str, float], out_dir: str) -> None:
        """metrics.txt, metrics.csv and metrics.json (NaN as null: strict
        JSON parsers reject a bare NaN) under ``out_dir``."""
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
            f.write(format_report(report, "evaluation metrics") + "\n")
        with open(os.path.join(out_dir, "metrics.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["metric", "value"])
            for k, v in report.items():
                w.writerow([k, v])
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            clean = {k: (None if isinstance(v, float) and v != v else v)
                     for k, v in report.items()}
            json.dump(clean, f, indent=1)


def prediction_map(predict_fn: Callable[[np.ndarray], Dict],
                   vol: ParsedVolume, seq_len: int = 50) -> np.ndarray:
    """Beam x scan probability map of a parsed volume, (n_beams, n_scans)
    float32: every beam runs through the detector in chunked windows of
    ``seq_len`` (the tail re-anchored; each scan keeps the first window's
    probability), a beam shorter than ``seq_len`` zero-padded up to it;
    scans a beam lacks stay NaN."""
    n_scans = max(v.shape[0] for v in vol.signals.values())
    heat = np.full((vol.n_beams, n_scans), np.nan, np.float32)
    for bi, bk in enumerate(vol.beam_keys):
        sig = vol.signals[bk]
        n = sig.shape[0]
        windows = chunked_windows(n, seq_len)
        if not windows:
            _, _, pad = padded_window(n, seq_len)
            padded = np.concatenate(
                [sig, np.zeros((pad, sig.shape[1]), sig.dtype)])
            heat[bi, :n] = _prob(predict_fn(padded[None]))[0][:n]
            continue
        for (a, b) in windows:
            p = _prob(predict_fn(sig[None, a:b]))[0]
            for j in range(a, b):
                if np.isnan(heat[bi, j]):
                    heat[bi, j] = p[j - a]
    return heat
