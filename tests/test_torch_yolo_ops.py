"""pautdx_torch's YOLO post-processing ops held to the JAX package on the CPU:
the NMS sweep, batched NMS and the prototype mask decode.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode, as tests/test_pallas_ops.py does.
Inputs are made with numpy from a seed and handed to both. The CUDA
kernels are held to the plain versions on the card by
tests/test_torch_kernels.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.models.vision.yolo import assemble_masks as j_assemble_masks
from pautdx.ops.pallas_mask import pallas_assemble_masks
from pautdx.ops.pallas_nms import nms_suppress as j_nms_suppress
from pautdx_torch.ops import masks, nms, suppress
from torch_threads import one_torch_thread  # noqa: F401

# the module: ``pautdx.ops`` re-exports its function ``nms`` under that name
jnms = importlib.import_module("pautdx.ops.nms")


def _boxes(rng, shape, lo=0.0, hi=100.0, wmin=5.0, wmax=30.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(wmin, wmax, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# --------------------------------------------------------------- the sweep


def _sweep_inputs(K, seed, thr):
    """(2, K, K) IoU of random boxes with ties: entries exactly at the
    threshold, repeated rows, and invalid slots."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, (2, K), hi=60.0)
    iou = np.asarray(jnms.box_iou_matrix(jnp.asarray(boxes[0])))[None]
    iou = np.concatenate([iou, np.asarray(jnms.box_iou_matrix(
        jnp.asarray(boxes[1])))[None]]).copy()
    hits = rng.integers(0, K, (2, 2 * K, 2))
    iou[0, hits[0, :, 0], hits[0, :, 1]] = np.float32(thr)
    if K > 2:
        iou[1, 2] = iou[1, 1]                 # a tied pair of candidates
    valid = (rng.uniform(size=(2, K)) > 0.2).astype(np.float32)
    valid[:, 0] = 1.0
    return iou.astype(np.float32), valid


@pytest.mark.parametrize("K", [3, 64, 300, 1100, 1500])
def test_nms_suppress_reference_matches_pallas(K):
    """Exact: the sweep only compares IoU values against the threshold.
    1100 and 1500 are past the K the card's sweep holds in shared memory
    (1024), where it reads the kept rows from L2."""
    thr = 0.45
    iou, valid = _sweep_inputs(K, K, thr)
    before = suppress.LAUNCHES
    got = suppress.nms_suppress(torch.from_numpy(iou),
                                torch.from_numpy(valid), thr)
    assert suppress.LAUNCHES == before      # the CPU path launches nothing
    assert got.dtype == torch.float32 and got.shape == (2, K)
    for b in range(2):
        want = j_nms_suppress(jnp.asarray(iou[b]), jnp.asarray(valid[b]),
                              thr, interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert torch.equal(got, suppress.nms_suppress_reference(
        torch.from_numpy(iou), torch.from_numpy(valid > 0), thr))


def test_nms_suppress_takes_bf16_iou():
    """A bf16 IoU is cast to f32, as ``nms_suppress`` casts it
    (``pallas_nms.py:59``): the same keep mask as the Pallas sweep given the
    same bf16 values, exactly."""
    thr = 0.45
    iou, valid = _sweep_inputs(300, 9, thr)
    iou16 = torch.from_numpy(iou).bfloat16()
    got = suppress.nms_suppress(iou16, torch.from_numpy(valid), thr)
    assert got.dtype == torch.float32
    for b in range(2):
        want = j_nms_suppress(jnp.asarray(iou16[b].float().numpy(),
                                          jnp.bfloat16),
                              jnp.asarray(valid[b]), thr, interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert torch.equal(got, suppress.nms_suppress_reference(
        iou16.float(), torch.from_numpy(valid), thr))


def test_nms_suppress_validates():
    iou = torch.zeros(2, 5, 5)
    with pytest.raises(ValueError, match="want iou"):
        suppress.nms_suppress(iou, torch.ones(2, 4))
    with pytest.raises(ValueError, match="want iou"):
        suppress.nms_suppress(iou[:, :4], torch.ones(2, 5))


# ------------------------------------------------------------------ the NMS


def test_box_iou_matrix_matches_reference():
    boxes = _boxes(np.random.default_rng(0), (2, 40))
    got = nms.box_iou_matrix(torch.from_numpy(boxes))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jnms.box_iou_matrix(
                jnp.asarray(boxes[b]))))


def _decoded(seed, B=2, A=400, nc=3):
    """Dense decode outputs with equal scores: a block of saturated 1.0,
    and many at 0, below any threshold."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, (B, A), hi=200.0, wmin=4.0, wmax=60.0)
    scores = rng.uniform(size=(B, A, nc)).astype(np.float32)
    scores[:, :A // 4] = 0.0
    scores[:, A // 2:A // 2 + 40, nc // 2] = 1.0
    scores[0, 7::13, :] = 0.625                     # ties across classes
    return boxes, scores


@pytest.mark.parametrize("kw", [
    {},                                               # nms() defaults
    {"score_threshold": 0.0, "top_k": 64, "max_det": 16},
    {"iou_threshold": 0.3, "top_k": 128, "max_det": 50},
])
def test_dense_to_detections_matches_reference(kw):
    """valid, classes and indices exactly; boxes and scores exactly on the
    valid slots."""
    boxes, scores = _decoded(1)
    want = jnms.dense_to_detections(
        {"boxes": jnp.asarray(boxes), "scores": jnp.asarray(scores)}, **kw)
    got = nms.dense_to_detections(
        {"boxes": torch.from_numpy(boxes), "scores": torch.from_numpy(scores)},
        **kw)
    w = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(w)
    valid = w["valid"]
    assert valid.any()
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["classes"].numpy(), w["classes"])
    np.testing.assert_array_equal(got["indices"].numpy(), w["indices"])
    np.testing.assert_array_equal(got["scores"].numpy()[valid],
                                  w["scores"][valid])
    np.testing.assert_array_equal(got["boxes"].numpy()[valid],
                                  w["boxes"][valid])


def test_single_image_nms_matches_reference():
    boxes, scores = _decoded(2, B=1, A=120, nc=1)
    classes = np.zeros((120,), np.int32)
    want = jnms.nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0, :, 0]),
                    jnp.asarray(classes), top_k=100, max_det=20)
    got = nms.nms(torch.from_numpy(boxes[0]),
                  torch.from_numpy(scores[0, :, 0]),
                  torch.from_numpy(classes), top_k=100, max_det=20)
    for k in ("valid", "indices", "scores", "boxes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_batched_nms_refuses_more_slots_than_candidates():
    boxes, scores = _decoded(3, A=50, nc=1)
    with pytest.raises(ValueError, match="max_det"):
        nms.dense_to_detections({"boxes": torch.from_numpy(boxes),
                                 "scores": torch.from_numpy(scores)})


# ---------------------------------------------------------------- the masks


@pytest.mark.parametrize("shape", [
    # (B, Hp, Wp, P, K, image (H, W)), as tests/test_pallas_ops.py:46-80
    (2, 32, 32, 8, 5, (128, 128)),
    (1, 24, 16, 4, 3, (96, 64)),        # uneven: Hp % 16 != 0, H != W
    (2, 16, 16, 32, 12, (64, 64)),      # the predict path's P
    (1, 16, 16, 16, 400, (64, 64)),     # K past one shared-memory chunk
    (1, 12, 12, 37, 9, (48, 48)),       # P off a multiple of 4, over 32
])
def test_assemble_masks_reference_matches_pallas_and_xla(shape):
    """atol = rtol = 1e-5 in f32, the gate of tests/test_pallas_ops.py."""
    B, Hp, Wp, P, K, img = shape
    rng = np.random.default_rng(sum(shape[:5]))
    protos = rng.normal(size=(B, Hp, Wp, P)).astype(np.float32)
    coeffs = rng.normal(size=(B, K, P)).astype(np.float32)
    boxes = _boxes(rng, (B, K), lo=-10.0, hi=float(min(img)) - 10,
                   wmin=0.0, wmax=float(min(img)) / 2)
    boxes[0, 0] = (0, 0, img[1], img[0])            # the whole frame
    boxes[0, 1] = (10, 10, 10, 30)                  # zero width
    before = masks.LAUNCHES
    got = masks.assemble_masks(*map(torch.from_numpy, (protos, coeffs,
                                                       boxes)), img)
    assert masks.LAUNCHES == before
    assert got.shape == (B, K, Hp, Wp) and got.dtype == torch.float32
    assert (got[0, 1] == 0).all() and (got[0, 0] > 0).all()
    args = (jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes), img)
    for want in (pallas_assemble_masks(*args, interpret=True),
                 j_assemble_masks(*args, impl="xla")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_assemble_masks_validates():
    protos = torch.zeros(2, 8, 8, 4)
    with pytest.raises(ValueError, match="want protos"):
        masks.assemble_masks(protos, torch.zeros(2, 3, 5),
                             torch.zeros(2, 3, 4), (32, 32))
    with pytest.raises(ValueError, match="want protos"):
        masks.assemble_masks(protos, torch.zeros(2, 3, 4),
                             torch.zeros(2, 2, 4), (32, 32))


def test_assemble_masks_casts_inputs_to_float32():
    """bf16 protos and coefficients and f16 boxes are cast to f32, as
    ``pallas_assemble_masks`` casts them (``pallas_mask.py:101``): the
    Pallas kernel's masks on the same values within 1e-5."""
    rng = np.random.default_rng(12)
    protos = torch.from_numpy(rng.normal(size=(2, 16, 16, 32))
                              .astype(np.float32)).bfloat16()
    coeffs = torch.from_numpy(rng.normal(size=(2, 7, 32))
                              .astype(np.float32)).bfloat16()
    boxes = torch.from_numpy(_boxes(rng, (2, 7), hi=40.0)).half()
    got = masks.assemble_masks(protos, coeffs, boxes, (64, 64))
    assert got.dtype == torch.float32
    want = pallas_assemble_masks(
        jnp.asarray(protos.float().numpy(), jnp.bfloat16),
        jnp.asarray(coeffs.float().numpy(), jnp.bfloat16),
        jnp.asarray(boxes.float().numpy(), jnp.float16), (64, 64),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
