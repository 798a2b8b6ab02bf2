"""pautdx_torch's YOLO training slice held to the JAX reference on the CPU:
the criterion's parts (IoU, CIoU, the task-aligned assigner, DFL), the
whole ``yolo_loss`` and its gradients over raw head outputs, one train-mode
model step of each of the four YOLO configurations, the BatchNorm
momentum, ``data/annotations.py``, ``eval/seg.py`` and
``train_bscan_detector(detector="yolo")``.

The model steps' JAX variables come from ``jax.eval_shape`` of the init,
filled from a seeded numpy generator (kernels N(0, 1/fan_in), biases, BN
scales and statistics randomised), so that no JAX init is compiled; each
flavour's step is one jitted ``jax.value_and_grad``.
"""

import json
import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.data import annotations as jann
from pautdx.eval import seg as jseg
from pautdx.losses import yolo as jloss
from pautdx.models.vision import yolo as jyolo
from pautdx_torch.compat.jax_weights import load_jax_variables, port_state_dict
from pautdx_torch.data import annotations as tann
from pautdx_torch.data import synthetic
from pautdx_torch.eval import seg as tseg
from pautdx_torch.losses import yolo as tloss
from pautdx_torch.models.vision import yolo as tyolo
from pautdx_torch.serve import yolo_predict
from pautdx_torch.train import detector
from torch_threads import one_torch_thread  # noqa: F401

IMG = 64
NC = 2
FLAVOURS = ("yolov8n-seg", "yolov9c-seg", "yolo11n", "yolov5su")


def _jcfg(cfg):
    return jyolo.YoloConfig(num_classes=cfg.num_classes, scale=cfg.scale,
                            flavour=cfg.flavour, reg_max=cfg.reg_max,
                            num_protos=cfg.num_protos, seg=cfg.seg)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _boxes(rng, n, lo=4.0, hi=60.0):
    """(n, 4) random xyxy pixel boxes inside the 64px frame."""
    xy = rng.uniform(lo, hi / 2, (n, 2))
    wh = rng.uniform(8.0, hi / 2, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread for this module: the suite runs in several
    worker processes at once, where each op's thread team would otherwise
    wait on the others' (many small ops a step, tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the criterion's parts


def test_iou_and_ciou_match_reference():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 7)
    a[3] = a[4]                               # a degenerate pair below
    a[5, 2:] = a[5, :2]                       # zero area
    want = np.asarray(jax.jit(jloss.pairwise_iou_xyxy)(a, b))
    got = tloss.pairwise_iou_xyxy(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    c = _boxes(rng, 40)
    want = np.asarray(jax.jit(jloss.ciou_xyxy)(a, c))
    got = tloss.ciou_xyxy(_t(a), _t(c)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _assign_case():
    """Two images over the 64px anchors: random predictions, plus a block
    of anchors with identical boxes and probabilities (metrics tied
    exactly: IoU 0.5 and p 0.25 are exact under the powers), a gt that two
    others tie with on IoU, and padded gt rows with garbage boxes."""
    rng = np.random.default_rng(1)
    pts, _ = tyolo.anchor_points((IMG, IMG), device="cpu")
    A, M = pts.shape[0], 5
    pts = pts.numpy()
    pred = np.concatenate([pts - rng.uniform(2, 14, (A, 2)),
                           pts + rng.uniform(2, 14, (A, 2))], -1)
    probs = rng.uniform(0.05, 0.95, (A, NC))
    gt = np.zeros((2, M, 4), np.float32)
    gt[:, 0] = [0, 0, 32, 32]
    gt[:, 1] = [0, 0, 32, 32]                  # a duplicate: ties on IoU
    gt[:, 2] = _boxes(rng, 1)[0]
    gt[1, 3] = _boxes(rng, 1)[0]
    gt[:, 4] = [5, 5, 60, 60]                  # padding, masked out
    gt_mask = np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 0]], np.float32)
    classes = np.asarray([[0, 1, 1, 0, 1], [1, 0, 1, 1, 0]], np.int32)
    preds = np.stack([pred, pred]).astype(np.float32)
    cls_probs = np.stack([probs, probs]).astype(np.float32)
    inside = (pts[:, 0] < 32) & (pts[:, 1] < 32)
    preds[:, inside] = [0, 0, 32, 16]          # IoU exactly 0.5 with gt 0
    cls_probs[:, inside] = 0.25
    return cls_probs, preds, gt, classes, gt_mask, pts


def test_task_aligned_assign_matches_reference_with_ties():
    cls_probs, preds, gt, classes, gt_mask, pts = _assign_case()
    want = jax.jit(jax.vmap(lambda cp, pb, gb, gc, gm: jloss.task_aligned_assign(
        cp, pb, gb, gc, gm, jnp.asarray(pts))))(cls_probs, preds, gt, classes,
                                                gt_mask)
    got = tloss.task_aligned_assign(_t(cls_probs), _t(preds), _t(gt),
                                    _t(classes), _t(gt_mask), _t(pts))
    assert float(np.asarray(want["fg"]).sum()) > 10
    np.testing.assert_array_equal(got["fg"].numpy(), np.asarray(want["fg"]))
    np.testing.assert_array_equal(got["target_gt_idx"].numpy(),
                                  np.asarray(want["target_gt_idx"]))
    np.testing.assert_array_equal(got["target_boxes"].numpy(),
                                  np.asarray(want["target_boxes"]))
    np.testing.assert_allclose(got["target_scores"].numpy(),
                               np.asarray(want["target_scores"]), atol=1e-6,
                               rtol=0)


def test_dfl_loss_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (2, 30, 64)).astype(np.float32)
    target = rng.uniform(-2, 18, (2, 30, 4)).astype(np.float32)
    target[0, 0] = [0.0, 14.999, 15.0, 3.0]    # both clip ends, an integer
    want = jax.jit(lambda x, t: jloss._dfl_loss(x, t, 16))(logits, target)
    got = tloss._dfl_loss(_t(logits), _t(target), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def _raw_outputs(rng, seg):
    """Random raw head outputs of a 64px batch of 2 (levels 8, 4, 2)."""
    levels = [{"box": rng.normal(0, 1.5, (2, s, s, 64)),
               "cls": rng.normal(-1, 2, (2, s, s, NC))} for s in (8, 4, 2)]
    out = {"levels": [{k: v.astype(np.float32) for k, v in lvl.items()}
                      for lvl in levels]}
    if seg:
        out["protos"] = rng.normal(0, 1, (2, 16, 16, 32)).astype(np.float32)
        out["mask_coeffs"] = [rng.normal(0, 0.5, (2, s, s, 32)).astype(
            np.float32) for s in (8, 4, 2)]
    return out


def _targets(rng, seg):
    boxes = np.stack([_boxes(rng, 3), _boxes(rng, 3)])
    mask = np.asarray([[1, 1, 0], [1, 1, 1]], np.float32)
    boxes[0, 2] = 0.0
    batch = {"images": np.zeros((2, IMG, IMG, 3), np.float32),
             "boxes": boxes, "classes": np.asarray([[0, 1, 0], [1, 1, 0]],
                                                   np.int32), "mask": mask}
    return detector.add_box_masks(batch) if seg else batch


@pytest.mark.parametrize("seg", [False, True])
def test_yolo_loss_and_grads_match_reference(seg):
    """The loss, its parts, and the gradient to every raw output within
    1e-5 (relative to each output's largest gradient), with no model."""
    rng = np.random.default_rng(3)
    raw = _raw_outputs(rng, seg)
    batch = _targets(rng, seg)
    cfg = tyolo.YoloConfig(num_classes=NC, seg=seg)
    jcfg = _jcfg(cfg)
    masks = batch.get("gt_masks")

    def jfn(r):
        return jloss.yolo_loss(r, batch["boxes"], batch["classes"],
                               batch["mask"], jcfg, (IMG, IMG),
                               gt_masks=masks)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(raw)
    traw = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(), raw)
    tl, taux = tloss.yolo_loss(traw, _t(batch["boxes"]), _t(batch["classes"]),
                               _t(batch["mask"]), cfg, (IMG, IMG),
                               gt_masks=None if masks is None else _t(masks))
    tl.backward()
    assert set(taux) == set(jaux) == ({"box", "cls", "dfl"}
                                      | ({"seg"} if seg else set()))
    assert float(jaux["box"]) > 0 and (not seg or float(jaux["seg"]) > 0)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    pairs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t, g: (t.grad.numpy(), np.asarray(g)), traw, jg,
        is_leaf=lambda x: isinstance(x, torch.Tensor)), is_leaf=lambda x:
        isinstance(x, tuple))
    assert len(pairs) == (10 if seg else 6)
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the BatchNorm momentum


def test_conv_bn_silu_running_statistics_match_reference():
    """One train-mode call of each package's ConvBnSiLU (features 5,
    kernel 3) on the same (4, 8, 8, 3) input and weights: the running mean
    and variance move at the reference's rate (momentum 0.97)."""
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, (4, 8, 8, 3)).astype(np.float32)
    ref = jyolo.ConvBnSiLU(5, 3)
    variables = jax.tree_util.tree_map(np.asarray, ref.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    _, mutated = ref.apply(variables, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    port = load_jax_variables(tyolo.ConvBnSiLU(3, 5, 3), variables,
                              device="cpu").train()
    port(_t(x).permute(0, 3, 1, 2))
    stats = mutated["batch_stats"]["bn"]
    assert np.abs(np.asarray(stats["mean"])).max() > 1e-2
    np.testing.assert_allclose(port.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# one train-mode model step per configuration


def _filled(shapes, rng):
    """The variables' tree filled from ``rng``: kernels N(0, 1/fan_in),
    biases and BN means N(0, 0.1), scales 1 + N(0, 0.1), variances
    U(0.5, 1.5)."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, Mapping):
            out[k] = _filled(v, rng)
            continue
        shape = tuple(v.shape)
        if k == "kernel":
            a = rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape)
        elif k in ("bias", "mean"):
            a = rng.normal(0.0, 0.1, shape)
        elif k == "scale":
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        else:
            assert k == "var", k
            a = rng.uniform(0.5, 1.5, shape)
        out[k] = a.astype(np.float32)
    return out


def _model_batch(cfg):
    rng = np.random.default_rng(5)
    batch = _targets(rng, cfg.seg)
    batch["images"] = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=FLAVOURS)
def model_step(request):
    return _model_step(request.param)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


def _model_step(name):
    """One train-mode step of configuration ``name`` in float64 on both
    sides, from the same f32 weights and batch: the reference's loss,
    gradients and new BN statistics (``jax.enable_x64``), and the port's
    model after the same step."""
    cfg = yolo_predict.yolo_config(name)
    cfg = tyolo.YoloConfig(**{**cfg.__dict__, "num_classes": NC})
    jmodel = jyolo.YOLO(_jcfg(cfg))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)),
        train=False))
    variables = _filled(shapes, np.random.default_rng(FLAVOURS.index(name)))
    batch = _f64(_model_batch(cfg))
    masks = batch.get("gt_masks")

    def loss_fn(params, stats):
        out, mutated = jmodel.apply({"params": params, "batch_stats": stats},
                                    batch["images"], train=True,
                                    mutable=["batch_stats"])
        loss, _ = jloss.yolo_loss(out, batch["boxes"], batch["classes"],
                                  batch["mask"], _jcfg(cfg), (IMG, IMG),
                                  gt_masks=masks)
        return loss, mutated["batch_stats"]

    with jax.enable_x64(True):
        v64 = _f64(variables)
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v64["params"], v64["batch_stats"])
        loss, grads, stats = jax.tree_util.tree_map(
            np.asarray, (loss, grads, stats))
    model = load_jax_variables(tyolo.YOLO(cfg, device="cpu"), variables,
                               device="cpu").double()
    tbatch = {k: _t(v) for k, v in batch.items()}
    out = model(tbatch["images"], train=True)
    tl, _ = detector.yolo_objective(IMG, cfg)(out, tbatch)
    tl.backward()
    return dict(name=name, cfg=cfg, model=model, loss=float(loss),
                tloss=tl.item(), grads=grads, stats=stats)


def _transposed(model):
    return [f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, torch.nn.ConvTranspose2d)]


def test_train_step_loss_and_grads_match_reference(model_step):
    """In float64: the loss within 1e-10 relative, every gradient leaf
    within 1e-7 of the gradient's global norm. (In float32 the two
    packages' gradients of the deep v9c-seg differ by 4e-2 in norm: the
    reference's train-mode BatchNorm takes the variance as E[x^2] - E[x]^2,
    which loses digits where a channel's mean dwarfs its spread; its own
    f32 gradient lies 4.1e-2 from the float64 one, the port's 3.2e-3.)"""
    model = model_step["model"]
    assert model.training
    assert abs(model_step["tloss"] - model_step["loss"]) <= \
        1e-10 * abs(model_step["loss"])
    names = [n for n, _ in model.named_parameters()]
    want = port_state_dict({"params": model_step["grads"]}, names,
                           _transposed(model))
    params = dict(model.named_parameters())
    norm = sum(float(w.pow(2).sum()) for w in want.values()) ** 0.5
    assert norm > 0
    for n, w in want.items():
        g = params[n].grad
        g = torch.zeros_like(w) if g is None else g
        assert (g - w).norm().item() <= 1e-7 * norm, (n, (g - w).norm())


def test_train_step_bn_statistics_match_reference(model_step):
    """In float64, every BatchNorm's running mean and variance after the
    step within 1e-9: each moved by 0.03 of its batch's statistics."""
    model = model_step["model"]
    want = port_state_dict({"batch_stats": model_step["stats"]},
                           [n for n, _ in model.named_buffers()])
    assert all(m.momentum == 0.97 for m in model.modules()
               if isinstance(m, tyolo.BatchNorm))
    for n, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[n].numpy(), atol=1e-9,
                                   rtol=0, err_msg=n)


# ---------------------------------------------------------------------------
# annotations and the mask evaluator


ANN = {"seqA": {"0.png": [{"bbox": [10, 40, 0.1, 0.5], "label": "FO"},
                          {"bbox": [3, 3, 0.2, 0.4], "label": "Delamination"}],
                "1.png": [],
                "2.png": [{"bbox": [200, 100, 0.3, 0.9],
                           "label": "Delamination"}]},
       "seqB": {f"{i}.png": ([] if i % 3 else
                             [{"bbox": [i, i + 30, 0.05, 0.25],
                               "label": "FO"}]) for i in range(30)}}


def test_annotations_match_reference(tmp_path):
    cmap = {"Delamination": 0, "FO": 1}
    for defects in ANN["seqA"].values():
        np.testing.assert_array_equal(
            tann.to_yolo_labels(defects, (320, 200), cmap),
            jann.to_yolo_labels(defects, (320, 200), cmap))
    got = tann.prepare_yolo_split(ANN, (320, 320), class_map=cmap)
    want = jann.prepare_yolo_split(ANN, (320, 320), class_map=cmap)
    assert [(e.image_key, e.split) for e in got] == \
        [(e.image_key, e.split) for e in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes, w.boxes)
    images = {e.image_key: np.full((4, 4), i, np.float32)
              for i, e in enumerate(want)}
    roots = [str(tmp_path / d) for d in ("t", "j")]
    tann.write_yolo_dataset(got, images, roots[0])
    jann.write_yolo_dataset(want, images, roots[1])
    for d, _, files in os.walk(roots[1]):
        for f in files:
            mine = os.path.join(roots[0], os.path.relpath(d, roots[1]), f)
            with open(mine, "rb") as a, open(os.path.join(d, f), "rb") as b:
                if f == "data.yaml":
                    assert a.read().replace(roots[0].encode(), b"R") == \
                        b.read().replace(roots[1].encode(), b"R")
                else:
                    assert a.read() == b.read(), f
    path = str(tmp_path / "ann.json")
    tann.save_annotations(path, ANN)
    assert jann.load_annotations(path) == tann.load_annotations(path) == \
        json.loads(json.dumps(ANN))
    boxes = np.asarray([[3.5, 2.0, 20.2, 9.9], [0, 0, 64, 64], [30, 30, 30,
                                                                 40]])
    np.testing.assert_array_equal(tann.rasterize_boxes(boxes, (48, 32)),
                                  jann.rasterize_boxes(boxes, (48, 32)))
    rows = tann.to_yolo_labels(ANN["seqA"]["0.png"], (320, 200))
    np.testing.assert_array_equal(tann.yolo_to_xyxy(rows, (320, 200)),
                                  jann.yolo_to_xyxy(rows, (320, 200)))


def _disk(h, w, cy, cx, r):
    ys, xs = np.mgrid[:h, :w]
    return ((ys - cy) ** 2 + (xs - cx) ** 2 <= r * r).astype(np.float32)


def test_mask_iou_matches_reference():
    """tests/test_seg_eval.py's identity and disjoint cases, and random
    masks, at 1e-12."""
    a = _disk(32, 32, 10, 10, 5)[None]
    b = _disk(32, 32, 25, 25, 4)[None]
    assert tseg.mask_iou(a, a)[0, 0] == 1.0
    assert tseg.mask_iou(a, b)[0, 0] == 0.0
    rng = np.random.default_rng(6)
    p = rng.uniform(size=(7, 16, 16)) > 0.6
    g = rng.uniform(size=(4, 16, 16)) > 0.5
    np.testing.assert_allclose(tseg.mask_iou(p, g), jseg.mask_iou(p, g),
                               atol=1e-12, rtol=0)


def test_mask_map_matches_reference():
    """tests/test_seg_eval.py's perfect and missed cases, and random
    predictions over two classes and three images, at 1e-12."""
    gt_mask = _disk(32, 32, 12, 12, 6)
    gt = [{"masks": gt_mask[None], "classes": np.asarray([0])}]
    good = [{"masks": gt_mask[None], "scores": np.asarray([0.9]),
             "classes": np.asarray([0])}]
    bad = [{"masks": _disk(32, 32, 28, 28, 3)[None],
            "scores": np.asarray([0.9]), "classes": np.asarray([0])}]
    assert tseg.evaluate_mask_map(good, gt)["mask_mAP@0.5"] > 0.99
    assert tseg.evaluate_mask_map(bad, gt)["mask_mAP@0.5"] < 0.01
    rng = np.random.default_rng(7)
    preds, gts = [], []
    for n, m in ((5, 2), (0, 1), (4, 0)):
        centres = rng.uniform(6, 26, (n + m, 2))
        disks = np.stack([_disk(32, 32, cy, cx, rng.uniform(3, 7))
                          for cy, cx in centres]) if n + m else \
            np.zeros((0, 32, 32), np.float32)
        gts.append({"masks": disks[n:], "classes": rng.integers(0, 2, m)})
        preds.append({"masks": disks[:n] * rng.uniform(0.3, 1.0, (n, 1, 1)),
                      "scores": rng.uniform(size=n),
                      "classes": rng.integers(0, 2, n)})
    for kw in ({}, {"iou_thresholds": (0.5, 0.75), "num_classes": 2}):
        got = tseg.evaluate_mask_map(preds, gts, **kw)
        want = jseg.evaluate_mask_map(preds, gts, **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    with pytest.raises(ValueError, match="index-aligned"):
        tseg.evaluate_mask_map(preds, gts[:2])


# ---------------------------------------------------------------------------
# train_bscan_detector(detector="yolo")


@pytest.fixture(scope="module")
def volume_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("yolo_volumes")
    synthetic.write_json_volume(
        str(d / "v.json"), synthetic.VolumeSpec(n_scans=8, seed=3),
        [synthetic.SyntheticDefect(1, 5, 0, 7, 0.2, 0.5),
         synthetic.SyntheticDefect(2, 6, 2, 6, 0.6, 0.8, label="FO")])
    return str(d)


@pytest.mark.parametrize("flavour,scale,seg", [
    ("v8", "n", True), ("v9c", "n", True), ("v11", "n", False),
    ("v5", "s", False)])
def test_train_bscan_detector_yolo(volume_dir, tmp_path, flavour, scale,
                                   seg):
    """One epoch at 64px on the CPU over one JSON volume: the checkpoint's
    metadata is the CLI's, every loss finite, the BN statistics moved."""
    out = str(tmp_path / "ckpt")
    trainer, state = detector.train_bscan_detector(
        volume_dir, size=IMG, batch_size=4, detector="yolo", flavour=flavour,
        scale=scale, seg=seg, out=out, ema_decay=0.9, device="cpu",
        log=lambda s: None)
    assert state.step == 2
    meta = json.load(open(os.path.join(out, "metadata.json")))
    want = {"detector": "yolo", "num_classes": 2, "size": IMG,
            "scale": scale, "flavour": flavour}
    assert meta == (dict(want, seg=True) if seg else want)
    history = json.load(open(os.path.join(out, "history.json")))
    assert set(history) >= {"box", "cls", "dfl"} | ({"seg"} if seg
                                                     else set())
    assert all(np.isfinite(v[0]) for v in history.values())
    assert history["update_was_finite"] == [1.0]
    bn = next(m for m in state.model.modules()
              if isinstance(m, tyolo.BatchNorm))
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))


def test_train_bscan_detector_refuses_yolo_denoising(volume_dir):
    with pytest.raises(ValueError, match="denoising"):
        detector.train_bscan_detector(volume_dir, size=IMG, batch_size=4,
                                      detector="yolo", num_denoising=16,
                                      device="cpu")
    with pytest.raises(ValueError, match="seg is a YOLO option"):
        detector.train_bscan_detector(volume_dir, size=IMG, batch_size=4,
                                      seg=True, device="cpu")
