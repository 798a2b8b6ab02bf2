"""pautdx_torch's CUDA kernels held to their plain PyTorch versions on the
card, and the build that makes them.

Imports neither JAX nor the JAX package, so that on a machine with the card
it runs without them:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The kernel tests skip without a card (a CUDA kernel has no CPU mode); the
build tests run anywhere.
"""

import os
import stat

import numpy as np
import pytest
import torch

from pautdx_torch.ops import _build, attention, gather, masks, suppress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# -------------------------------------------------------------------- build


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build(["onehot_gather"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_rebuilds_when_the_source_changes(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.lib_path("k")
    assert first == _build.lib_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build.lib_path("k") != first
    assert first.parent == _build.BUILD_DIR


def test_launch_check_raises():
    _build.check(0, "x")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "aifi_attention")


def test_build_dir_is_gitignored():
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == \
        sorted(_build.SOURCES)


# ----------------------------------------------------- kernels on the card


def _randn(shape, seed, device, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.parametrize("dtype,N,scale", [
    ("float32", 400, 1.0), ("float32", 37, 1.0),
    *(("bfloat16", n, 1.0) for n in (1, 15, 16, 17, 37, 64, 65, 400, 600)),
    ("bfloat16", 400, 8.0)])
def test_attention_kernel_matches_plain(cuda, dtype, N, scale):
    """f32 (CUDA cores) with TF32 off: 1e-5. bf16 (tensor cores): 2e-2,
    since the plain version rounds the normalized probabilities to bf16
    before P.V and the kernel the unnormalized ones. N off a multiple of 16
    leaves a ragged query tile, off 64 a ragged key step; 600 keys take two
    shared-memory chunks. q scaled 8x makes the running max move many
    times within a row."""
    dt = getattr(torch, dtype)
    q, k, v = (_randn((3, 8, N, 16), s, cuda, dt) for s in range(3))
    q = q * (0.25 * scale)
    before = attention.LAUNCHES
    got = attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = attention.fused_attention_reference(q, k, v)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # the (B, N, D) form reads the heads through strides
    x = [t.transpose(1, 2).reshape(3, N, 128).contiguous() for t in (q, k, v)]
    got = attention.aifi_attention(*x, 8)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == before + 2
    want = attention.aifi_attention_reference(*x, 8)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_attention_kernel_refuses_what_it_cannot_take(cuda):
    q = _randn((2, 4, 8, 24), 0, cuda, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        attention.fused_attention(q, q, q)
    q = _randn((2, 8, 4, 16), 0, cuda, torch.float32).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.fused_attention(q, q, q)
    before = attention.LAUNCHES
    q = _randn((2 * 4 * 8 * 16 + 1,), 0, cuda, torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        attention.fused_attention(*(q.view(2, 4, 8, 16),) * 3)
    assert attention.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_gather_kernel_matches_plain(cuda, dtype):
    """Bit for bit, indices out of range clamped."""
    L = 50
    flat = _randn((3, L, 128), 1, cuda, getattr(torch, dtype))
    idx = torch.from_numpy(np.random.default_rng(2).integers(
        -3, L + 5, (3, 37)).astype(np.int32)).to(cuda)
    before = gather.LAUNCHES
    got = gather.onehot_gather(flat, idx)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    assert torch.equal(got, gather.onehot_gather_reference(flat, idx))
    with pytest.raises(TypeError, match="int32"):
        gather.onehot_gather(flat, idx.long())


def test_gather_kernel_refuses_rows_it_cannot_copy(cuda):
    """The kernel copies 16-byte pieces: 6-byte rows and a table that
    starts off 16-byte alignment are refused, and nothing is launched."""
    idx = torch.tensor([[0, 8, 4, 11], [-1, 2, 2, 7]], dtype=torch.int32,
                       device=cuda)
    before = gather.LAUNCHES
    with pytest.raises(ValueError, match="6-byte rows"):
        gather.onehot_gather(_randn((2, 9, 3), 3, cuda, torch.bfloat16), idx)
    off = _randn((2 * 9 * 8 + 1,), 3, cuda, torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="2 bytes past"):
        gather.onehot_gather(off.view(2, 9, 8), idx)
    assert gather.LAUNCHES == before


def _nms_inputs(B, K, seed, device):
    """(B, K, K) IoU of random boxes, ties at the threshold and a repeated
    row, plus a valid mask with invalid slots."""
    from pautdx_torch.ops.nms import box_iou_matrix

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (B, K, 2))
    wh = rng.uniform(10, 120, (B, K, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                             .astype(np.float32))
    iou = box_iou_matrix(boxes)
    hits = torch.from_numpy(rng.integers(0, K, (2 * K, 2)))
    iou[0, hits[:, 0], hits[:, 1]] = 0.45
    if K > 3:
        iou[-1, 3] = iou[-1, 2]
    valid = torch.from_numpy(rng.uniform(size=(B, K)) > 0.2)
    return iou.to(device), valid.to(device)


def _nms_equal(iou, valid, thr=0.45):
    """The kernel's keep against the plain sweep's, bit for bit, after
    exactly one launch."""
    before = suppress.LAUNCHES
    got = suppress.nms_suppress(iou, valid, thr)
    torch.cuda.synchronize()
    assert suppress.LAUNCHES == before + 1
    want = suppress.nms_suppress_reference(iou, valid, thr)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    return want


@pytest.mark.parametrize("B,K", [(32, 300), (3, 77), (2, 1024), (2, 1),
                                 (2, 63), (2, 64), (2, 65)])
def test_nms_kernel_matches_plain(cuda, B, K):
    """Bit for bit: the sweep only compares IoU values. K off a multiple
    of 32 or 64 leaves a ragged last word of the bitmask; 1024 is the
    largest K."""
    iou, valid = _nms_inputs(B, K, K, cuda)
    want = _nms_equal(iou, valid)
    if K > 1:
        assert 0 < want.sum() < valid.sum()


@pytest.mark.parametrize("case", ["all_invalid", "identical", "at_threshold"])
def test_nms_kernel_edge_cases(cuda, case):
    """No valid slot keeps nothing; identical boxes, all valid, keep only
    slot 0; an IoU exactly at the threshold suppresses nothing (the test
    is iou > thr in f32)."""
    B, K = 3, 300
    iou, valid = _nms_inputs(B, K, 11, cuda)
    if case == "all_invalid":
        valid = torch.zeros_like(valid)
    elif case == "identical":
        iou = torch.ones_like(iou)
        valid = torch.ones_like(valid)
    else:
        iou = torch.full_like(iou, 0.45)
    want = _nms_equal(iou, valid)
    if case == "all_invalid":
        assert want.sum() == 0
    elif case == "identical":
        assert want[:, 0].eq(1).all() and want[:, 1:].eq(0).all()
    else:
        assert torch.equal(want, valid.float())


def test_nms_kernel_refuses_what_it_cannot_take(cuda):
    before = suppress.LAUNCHES
    iou, valid = _nms_inputs(1, 1025, 0, cuda)
    with pytest.raises(ValueError, match="at most 1024"):
        suppress.nms_suppress(iou, valid)
    iou, valid = _nms_inputs(2, 8, 0, cuda)
    with pytest.raises(TypeError, match="float32"):
        suppress.nms_suppress(iou.double(), valid)
    with pytest.raises(ValueError, match="contiguous"):
        suppress.nms_suppress(iou.transpose(1, 2), valid)
    assert suppress.LAUNCHES == before


def _mask_inputs(B, Hp, Wp, P, K, img, seed, device):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(B, Hp, Wp, P)).astype(np.float32)
    coeffs = rng.normal(size=(B, K, P)).astype(np.float32)
    xy = rng.uniform(-50, max(img), (B, K, 2))
    wh = rng.uniform(0, max(img) / 2, (B, K, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 0] = (0, 0, img[1], img[0])          # the whole frame
    boxes[0, 1] = (100, 200, 100, 260)            # zero width
    boxes[0, 2] = (-90, -90, -10, -10)            # off the image
    boxes[0, 3] = (700, 10, 900, 30)              # off the image
    return [torch.from_numpy(a).to(device) for a in (protos, coeffs, boxes)]


@pytest.mark.parametrize("shape", [(32, 160, 160, 32, 100, (640, 640)),
                                   (3, 24, 16, 32, 7, (96, 64))])
def test_masks_kernel_matches_plain(cuda, shape):
    """atol = rtol = 1e-5 in f32 with TF32 off. (32, 160, 160, 32) at
    K=100 is the predict path's; the other is uneven in Hp, Wp and K."""
    B, Hp, Wp, P, K, img = shape
    protos, coeffs, boxes = _mask_inputs(B, Hp, Wp, P, K, img, sum(shape[:5]),
                                         cuda)
    before = masks.LAUNCHES
    got = masks.assemble_masks(protos, coeffs, boxes, img)
    torch.cuda.synchronize()
    assert masks.LAUNCHES == before + 1
    assert got.shape == (B, K, Hp, Wp) and got.dtype == torch.float32
    want = masks.assemble_masks_reference(protos, coeffs, boxes, img)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert (got[0, 1:4] == 0).all() and (got[0, 0] > 0).all()


def test_masks_kernel_refuses_what_it_cannot_take(cuda):
    protos, coeffs, boxes = _mask_inputs(2, 16, 16, 12, 5, (64, 64), 0, cuda)
    before = masks.LAUNCHES
    with pytest.raises(ValueError, match="P=12"):
        masks.assemble_masks(protos, coeffs, boxes, (64, 64))
    protos, coeffs, boxes = _mask_inputs(2, 16, 16, 32, 5, (64, 64), 0, cuda)
    with pytest.raises(TypeError, match="float32"):
        masks.assemble_masks(protos.half(), coeffs, boxes, (64, 64))
    with pytest.raises(ValueError, match="contiguous"):
        masks.assemble_masks(protos.transpose(1, 2), coeffs, boxes, (64, 64))
    with pytest.raises(ValueError, match="shared memory"):
        masks.assemble_masks(torch.zeros(1, 4, 4, 32, device=cuda),
                             torch.zeros(1, 342, 32, device=cuda),
                             torch.zeros(1, 342, 4, device=cuda), (16, 16))
    assert masks.LAUNCHES == before


def _weighted_inputs(B, L, C, T, seed, device):
    """A (B, L, C) table and (B, T, 4) corners and weights with rows off
    the table (clamped by the kernel) and corners of weight 0."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.normal(size=(B, L, C)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-2, L + 3, (B, T, 4))
                           .astype(np.int32))
    w = torch.from_numpy(rng.uniform(0, 1, (B, T, 4)).astype(np.float32))
    w[:, ::5, 1] = 0.0
    return flat.to(device), idx.to(device), w.to(device)


@pytest.mark.parametrize("shape", [(16, 2000, 128, 1200), (3, 50, 128, 37),
                                   (2, 30, 8, 5)])
def test_weighted_gather_kernel_matches_plain(cuda, shape):
    """Forward and both gradients against the plain version and its
    autograd, to 1e-5 of the largest magnitude: the forward sums four
    products in another order, and the backward's scatter runs in atomics
    whose order changes from run to run. (16, 2000, 128) x 1200 taps is
    the training path's; T=37 and C=8 are ragged."""
    from pautdx_torch.ops import gather

    flat, idx, w = _weighted_inputs(*shape, seed=sum(shape), device=cuda)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(shape[0], shape[3], shape[2])).astype(np.float32)).to(cuda)
    before = (gather.WEIGHTED_LAUNCHES, gather.WEIGHTED_BACKWARD_LAUNCHES)
    fk, wk = flat.clone().requires_grad_(), w.clone().requires_grad_()
    got = gather.weighted_gather(fk, idx, wk)
    got.backward(g)
    torch.cuda.synchronize()
    assert (gather.WEIGHTED_LAUNCHES, gather.WEIGHTED_BACKWARD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    fp, wp = flat.clone().requires_grad_(), w.clone().requires_grad_()
    want = gather.weighted_gather_reference(fp, idx, wp)
    want.backward(g)
    for a, b in ((got, want), (fk.grad, fp.grad), (wk.grad, wp.grad)):
        tol = 1e-5 * b.abs().max().item()
        torch.testing.assert_close(a.detach(), b.detach(), atol=tol, rtol=0)
    # the backward kernel alone against the written-out VJP
    d_flat, d_w = gather.weighted_gather_backward(flat, idx, w, g)
    r_flat, r_w = gather.weighted_gather_backward_reference(flat, idx, w, g)
    torch.testing.assert_close(d_flat, r_flat, rtol=0,
                               atol=1e-5 * r_flat.abs().max().item())
    torch.testing.assert_close(d_w, r_w, rtol=0,
                               atol=1e-5 * r_w.abs().max().item())


def test_weighted_gather_kernel_refuses_what_it_cannot_take(cuda):
    from pautdx_torch.ops import gather

    flat, idx, w = _weighted_inputs(2, 10, 128, 6, 0, cuda)
    before = gather.WEIGHTED_LAUNCHES
    with pytest.raises(TypeError, match="float32"):
        gather.weighted_gather(flat.bfloat16(), idx, w)
    with pytest.raises(TypeError, match="int32"):
        gather.weighted_gather(flat, idx.long(), w)
    with pytest.raises(ValueError, match="float4"):
        gather.weighted_gather(flat[..., :6].contiguous(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        gather.weighted_gather(flat.transpose(1, 2).contiguous()
                               .transpose(1, 2), idx, w)
    assert gather.WEIGHTED_LAUNCHES == before


def test_inference_kernels_refuse_grad_mode(cuda):
    """The one-hot gather and the attention kernel have no backward: under
    grad mode an input that needs a gradient raises instead of cutting the
    graph, and nothing is launched; under no_grad they run."""
    from pautdx_torch.ops import gather

    flat = _randn((2, 10, 128), 0, cuda, torch.float32).requires_grad_()
    idx = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    q = _randn((2, 40, 128), 1, cuda, torch.float32).requires_grad_()
    before = (gather.LAUNCHES, attention.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        gather.onehot_gather(flat, idx)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.aifi_attention(q, q, q, 8)
    assert (gather.LAUNCHES, attention.LAUNCHES) == before
    with torch.no_grad():
        gather.onehot_gather(flat, idx)
        attention.aifi_attention(q, q, q, 8)
    assert (gather.LAUNCHES, attention.LAUNCHES) == (before[0] + 1,
                                                     before[1] + 1)


def test_yolo_predict_takes_any_layout_and_owns_its_precision(cuda):
    """The predict path on the card: images laid out NCHW in memory reach
    the mask kernel (whose protos must be dense) and match dense NHWC
    ones; global TF32 settings leave the detections unchanged."""
    from pautdx_torch.serve import yolo_predict

    predictor = yolo_predict.build_yolo_predictor(device=cuda, seed=0)
    frames = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (2, 128, 128, 3)).astype(np.uint8)).to(cuda)
    x = frames.float() / 255.0
    before = (suppress.LAUNCHES, masks.LAUNCHES)
    dense = predictor.forward(x)
    permuted = predictor.forward(x.permute(0, 3, 1, 2).contiguous()
                                 .permute(0, 2, 3, 1))
    assert (suppress.LAUNCHES, masks.LAUNCHES) == (before[0] + 2,
                                                    before[1] + 2)
    assert permuted["masks"].shape == (2, 100, 32, 32)
    assert torch.isfinite(permuted["masks"]).all()
    with yolo_predict.full_f32():
        raw = [predictor.model(t) for t in (x, x.permute(0, 3, 1, 2)
                                            .contiguous().permute(0, 2, 3, 1))]
    torch.testing.assert_close(raw[1]["protos"], raw[0]["protos"],
                               atol=1e-4, rtol=1e-4)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loose = predictor(frames)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    for k in ("boxes", "scores", "classes", "valid", "indices", "masks"):
        assert torch.equal(loose[k], dense[k]), k
