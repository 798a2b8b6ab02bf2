"""pautdx_torch's mAP evaluator held to the JAX package's on seeded
predictions and ground truths, to 1e-12: overlapping boxes, frames with no
predictions and with no ground truth, a class with no ground truth, tied
scores, and several IoU thresholds."""

import numpy as np
import pytest

from pautdx.eval.map import average_precision as j_ap
from pautdx.eval.map import box_iou_xyxy as j_iou
from pautdx.eval.map import evaluate_map as j_map
from pautdx_torch.eval.map import average_precision as t_ap
from pautdx_torch.eval.map import box_iou_xyxy as t_iou
from pautdx_torch.eval.map import evaluate_map as t_map


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(2, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _case(seed, num_classes):
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for i in range(12):
        m = int(rng.integers(0, 4)) if i != 3 else 0     # frame 3: no gt
        gt = _boxes(rng, m)
        gt_cls = rng.integers(0, 2, m)      # class 2 never has ground truth
        n = int(rng.integers(0, 6)) if i != 5 else 0     # frame 5: no preds
        near = gt[rng.integers(0, max(m, 1), n)] if m else _boxes(rng, n)
        p = (near + rng.normal(0, 4, near.shape)).astype(np.float32)
        scores = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)  # ties
        preds.append({"boxes": p, "scores": scores,
                      "classes": rng.integers(0, num_classes, n)})
        gts.append({"boxes": gt, "classes": gt_cls})
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_map_matches_reference(seed):
    preds, gts = _case(seed, num_classes=3)
    for kw in (dict(num_classes=3), dict(num_classes=2),
               dict(num_classes=3, iou_thresholds=(0.5, 0.75, 0.95))):
        got, want = t_map(preds, gts, **kw), j_map(preds, gts, **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12, (kw, k, got[k], want[k])
    assert 0.0 < t_map(preds, gts, num_classes=2)["mAP@0.5"] <= 1.0


def test_empty_and_misaligned_inputs():
    nothing = [{"boxes": np.zeros((0, 4)), "scores": np.zeros(0),
                "classes": np.zeros(0, int)}]
    gt = [{"boxes": np.asarray([[0, 0, 10, 10]], np.float32),
           "classes": np.asarray([0])}]
    no_gt = [{"boxes": np.zeros((0, 4)), "classes": np.zeros(0, int)}]
    for p, g in ((nothing, gt), (nothing, no_gt)):
        assert t_map(p, g) == j_map(p, g)
    with pytest.raises(ValueError):
        t_map(nothing * 2, gt)
    rng = np.random.default_rng(4)
    a, b = _boxes(rng, 5), _boxes(rng, 7)
    np.testing.assert_array_equal(t_iou(a, b), j_iou(a, b))
    r = np.sort(rng.uniform(0, 1, 9))
    p = rng.uniform(0, 1, 9)
    assert t_ap(r, p) == j_ap(r, p)
