"""Faults planted in the program underneath a benchmark run, to show that
the check catches them.

    python -m portbench.tests.plant <fault> <portbench.run arguments>
    python -m portbench.tests.plant control <portbench.run arguments>

runs one cell on the card at its own size with ``<fault>`` planted, or
with the cell's lower-precision control in the program's place: the
readings a limit is set from. The tests drive the same at a small size on
the CPU. Each fault patches the port where the work is done, for this
process only:

- ``serve_half_batch``: the second half of each batch answered with the
  first half's frames (D-FINE and YOLO);
- ``dfine_gather_altered``: the one-hot gather reads the next row;
- ``dfine_scores_altered``: the served scores scaled by 0.9 where
  ``post_process`` produces them (the valid flags follow them);
- ``yolo_nms_altered``: the NMS sweep keeps every valid candidate;
- ``yolo_masks_altered``: the mask decode's masks transposed.
"""

from __future__ import annotations

import sys
from contextlib import contextmanager
from typing import Iterator

FAULTS = ("serve_half_batch", "dfine_gather_altered", "dfine_scores_altered",
          "yolo_nms_altered", "yolo_masks_altered")


def _half(x):
    h = x.shape[0] // 2
    return x[:h].repeat(2, *([1] * (x.dim() - 1)))[:x.shape[0]] \
        if x.shape[0] > 1 else x


@contextmanager
def planted(fault: str) -> Iterator[None]:
    """``fault`` planted in the port while the block runs."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}; known: {', '.join(FAULTS)}")
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "serve_half_batch":
        from pautdx_torch.serve import throughput, yolo_predict
        pre = throughput.prepatchify_uint8
        patch(throughput, "prepatchify_uint8",
              lambda frames, p: _half(pre(frames, p)))
        call = yolo_predict.YoloPredictor.__call__
        patch(yolo_predict.YoloPredictor, "__call__",
              lambda self, frames: call(self, _half(frames)))
    elif fault == "dfine_gather_altered":
        from pautdx_torch.ops import gather
        fn = gather.onehot_gather
        patch(gather, "onehot_gather",
              lambda flat, idx: fn(flat, (idx + 1).contiguous()))
    elif fault == "dfine_scores_altered":
        from pautdx_torch.models.vision import dfine
        post = dfine.post_process

        def altered(logits, boxes, size, threshold, *a, **k):
            det = dict(post(logits, boxes, size, threshold, *a, **k))
            det["scores"] = det["scores"] * 0.9
            det["valid"] = det["scores"] >= threshold
            return det
        patch(dfine, "post_process", altered)
    elif fault == "yolo_nms_altered":
        from pautdx_torch.ops import suppress
        patch(suppress, "nms_suppress",
              lambda iou, valid, thr=0.45: valid.float().clone())
    elif fault == "yolo_masks_altered":
        from pautdx_torch.ops import masks
        fn = masks.assemble_masks
        patch(masks, "assemble_masks",
              lambda *a: fn(*a).transpose(-1, -2).contiguous())
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    from portbench import run
    if argv[0] == "control":
        return run.main(argv[1:], program="control")
    with planted(argv[0]):
        return run.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
