"""Host-side visualization: heatmaps, bbox overlays, training curves.

The port's own copy of ``pautdx/viz/__init__.py``: the same matplotlib
figures from the same numpy arrays, so the PNGs are the reference's pixel
for pixel. Matplotlib equivalents of the reference's plotting surface (SURVEY.md §5.5):
multi-panel training history (`train_detection.py:25-93`), beam x scan
prediction heatmaps (`GNN_testing_multi_v2_MAP.py`), bbox overlays
(`draw_bbox_on_images.py`), and per-signal prediction plots with defect
spans (`predict.py:14-240`). All functions write PNG files; where
matplotlib is not installed they write nothing and say so on stderr
(:func:`have_matplotlib` tells a caller beforehand).
"""

from __future__ import annotations

import importlib.util
import sys
from typing import Dict, Optional, Sequence

import numpy as np


def have_matplotlib() -> bool:
    """Whether the plots can be drawn here."""
    return importlib.util.find_spec("matplotlib") is not None


def _plt(path: str):
    """``matplotlib.pyplot`` on the Agg backend, or None (with a note on
    stderr that ``path`` is not written) where matplotlib is missing."""
    if not have_matplotlib():
        print(f"pautdx_torch.viz: matplotlib is not installed; {path} not "
              f"written", file=sys.stderr)
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_training_history(history: Dict[str, list], path: str) -> None:
    """Multi-panel loss/accuracy/lr curves from the Trainer history dict."""
    plt = _plt(path)
    if plt is None:
        return
    keys = [k for k in history if k not in ("epoch", "time_s")
            and isinstance(history[k], list) and history[k]
            and isinstance(history[k][0], (int, float))]
    n = max(len(keys), 1)
    cols = min(3, n)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.5 * rows),
                             squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        ax.plot(history[k])
        ax.set_title(k)
        ax.set_xlabel("epoch")
        if k == "lr_scale":
            ax.set_yscale("log")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_prediction_heatmap(heat: np.ndarray, path: str,
                            title: str = "defect probability") -> None:
    """Beam x scan probability map."""
    plt = _plt(path)
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(heat, aspect="auto", cmap="hot", vmin=0, vmax=1)
    ax.set_xlabel("scan")
    ax.set_ylabel("beam")
    ax.set_title(title)
    fig.colorbar(im)
    fig.savefig(path, dpi=100)
    plt.close(fig)


def draw_boxes_on_image(image: np.ndarray, boxes_xyxy: Sequence,
                        path: str, labels: Optional[Sequence] = None,
                        scores: Optional[Sequence] = None) -> None:
    """B-scan frame + detection boxes."""
    plt = _plt(path)
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.asarray(image).squeeze(), cmap="gray")
    for i, b in enumerate(boxes_xyxy):
        x1, y1, x2, y2 = [float(v) for v in b]
        ax.add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                   fill=False, edgecolor="red", linewidth=1.5))
        tag = ""
        if labels is not None:
            tag += str(labels[i])
        if scores is not None:
            tag += f" {float(scores[i]):.2f}"
        if tag:
            ax.text(x1, max(y1 - 2, 0), tag, color="red", fontsize=8)
    ax.axis("off")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_signal_predictions(signals: np.ndarray, probs: np.ndarray,
                            positions: Optional[np.ndarray], path: str,
                            threshold: float = 0.5,
                            max_panels: int = 8) -> None:
    """Per-signal plots with predicted defect spans (axvspan style)."""
    plt = _plt(path)
    if plt is None:
        return
    n = min(signals.shape[0], max_panels)
    fig, axes = plt.subplots(n, 1, figsize=(8, 2 * n), squeeze=False)
    S = signals.shape[-1]
    for i in range(n):
        ax = axes[i][0]
        ax.plot(signals[i], linewidth=0.7)
        p = float(probs[i])
        ax.set_title(f"signal {i}: p(defect)={p:.3f}", fontsize=8)
        if positions is not None and p >= threshold:
            s, e = positions[i]
            ax.axvspan(float(s) * S, float(e) * S, alpha=0.3, color="red")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
from pautdx_torch.viz.model_graph import model_dot, save_model_dot  # noqa: E402,F401
