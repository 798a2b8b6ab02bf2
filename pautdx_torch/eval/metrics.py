"""Detection metrics: confusion counts, accuracy/P/R/F1/specificity/
balanced accuracy/MCC, and AUC.

The port's own copy of ``pautdx/eval/metrics.py``: host numpy over the
probabilities a detector returns, with the reference's report schema.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def confusion_counts(probs: np.ndarray, labels: np.ndarray,
                     threshold: float = 0.5,
                     mask: Optional[np.ndarray] = None) -> Dict[str, int]:
    probs = np.asarray(probs).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    if mask is not None:
        keep = np.asarray(mask).reshape(-1) > 0
        probs, labels = probs[keep], labels[keep]
    pred = probs >= threshold
    pos = labels > 0.5
    tp = int(np.sum(pred & pos))
    tn = int(np.sum(~pred & ~pos))
    fp = int(np.sum(pred & ~pos))
    fn = int(np.sum(~pred & pos))
    return {"tp": tp, "tn": tn, "fp": fp, "fn": fn}


def classification_report(probs: np.ndarray, labels: np.ndarray,
                          threshold: float = 0.5,
                          mask: Optional[np.ndarray] = None) -> Dict[str, float]:
    c = confusion_counts(probs, labels, threshold, mask)
    tp, tn, fp, fn = c["tp"], c["tn"], c["fp"], c["fn"]
    n = max(tp + tn + fp + fn, 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    specificity = tn / max(tn + fp, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    mcc_den = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    mcc = ((tp * tn - fp * fn) / mcc_den) if mcc_den > 0 else 0.0
    return {
        "accuracy": (tp + tn) / n,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "specificity": specificity,
        "balanced_accuracy": 0.5 * (recall + specificity),
        "mcc": float(mcc),
        **{k: float(v) for k, v in c.items()},
    }


def auc_roc(probs: np.ndarray, labels: np.ndarray,
            mask: Optional[np.ndarray] = None) -> float:
    """Rank-based AUC (Mann-Whitney), ties handled by average rank."""
    probs = np.asarray(probs, np.float64).reshape(-1)
    labels = np.asarray(labels).reshape(-1) > 0.5
    if mask is not None:
        keep = np.asarray(mask).reshape(-1) > 0
        probs, labels = probs[keep], labels[keep]
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(probs, kind="mergesort")
    ranks = np.empty_like(probs)
    ranks[order] = np.arange(1, probs.size + 1)
    # average ranks for ties
    sorted_p = probs[order]
    i = 0
    while i < sorted_p.size:
        j = i
        while j + 1 < sorted_p.size and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def format_report(report: Dict[str, float], title: str = "metrics") -> str:
    """Render the report in the reference's metrics.txt style."""
    lines = [title, "=" * len(title)]
    for k in ("accuracy", "precision", "recall", "f1", "specificity",
              "balanced_accuracy", "mcc"):
        if k in report:
            lines.append(f"{k}: {report[k]:.4f}")
    lines.append("confusion:")
    for k in ("tn", "fp", "fn", "tp"):
        if k in report:
            lines.append(f"  {k}: {int(report[k])}")
    return "\n".join(lines)
