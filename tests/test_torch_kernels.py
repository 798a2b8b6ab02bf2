"""pautdx_torch's CUDA kernels held to their plain PyTorch versions on the
card, the build that makes them, and the tracer's spans placed on the
device trace's axis.

Imports neither JAX nor the JAX package, so that on a machine with the card
it runs without them:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The kernel tests skip without a card (a CUDA kernel has no CPU mode); the
build tests run anywhere.
"""

import importlib.util
import os
import stat
import time

import numpy as np
import pytest
import torch

from pautdx_torch.ops import (_build, attention, gather, masks, qconv,
                              suppress)
from pautdx_torch.utils import profiling

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [1, 8, 24, 32, 37, 48, 64, 80, 100, 128,
                                200, 256])
@pytest.mark.parametrize("N", [400, 37, 600])
def test_attention_kernel_matches_plain_at_head_dims(cuda, dtype, dh, N):
    """Every head dim the kernel takes, at the gates of the dh-16 test:
    1e-5 in f32, 2e-2 in bf16. 32 is DFineConfig()'s AIFI layer, and
    (32, 8, 400, 32) the HF-architecture eval path's shape; 32, 64, 128
    and 256 are instantiations, the others zero-padded up to one; past 64
    the columns of v and o split across blocks (80, 100, 200); 1, 37 and
    (in bf16) 100 leave the rows off 16-byte pieces, staged element by
    element. N=37 is ragged in queries and keys; 600 keys take two or more
    shared-memory chunks."""
    dt = getattr(torch, dtype)
    B = 32 if N == 400 else 3
    q, k, v = (_randn((B, 8, N, dh), s, cuda, dt) for s in range(3))
    q = q * dh ** -0.5
    before = attention.LAUNCHES
    got = attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = attention.fused_attention_reference(q, k, v)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    x = [t.transpose(1, 2).reshape(B, N, 8 * dh).contiguous()
         for t in (q, k, v)]
    got = attention.aifi_attention(*x, 8)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == before + 2
    want = attention.aifi_attention_reference(*x, 8)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_attention_kernel_refuses_what_it_cannot_take(cuda):
    """A head dim past the port's ceiling of 256, non-contiguous inputs
    and bf16 off 16-byte alignment raise, and nothing is launched."""
    before = attention.LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn((2, 4, 8, 257), 0, cuda, dtype)
        with pytest.raises(ValueError, match="head dim"):
            attention.fused_attention(q, q, q)
    assert attention.LAUNCHES == before
    q = _randn((2, 8, 4, 16), 0, cuda, torch.float32).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.fused_attention(q, q, q)
    before = attention.LAUNCHES
    q = _randn((2 * 4 * 8 * 16 + 1,), 0, cuda, torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        attention.fused_attention(*(q.view(2, 4, 8, 16),) * 3)
    assert attention.LAUNCHES == before


@pytest.mark.parametrize("dtype,shape,pile_up", [
    ("float32", (3, 50, 128, 37), False),
    ("bfloat16", (3, 50, 128, 37), False),
    ("float16", (3, 50, 128, 37), False),
    ("float32", (4, 2000, 128, 2736), False),
    ("bfloat16", (50, 2000, 128, 1200), False),
    ("bfloat16", (4, 2000, 128, 1201), False),
    ("float32", (4, 2000, 128, 2736), True)])
def test_gather_kernel_matches_plain(cuda, dtype, shape, pile_up):
    """Bit for bit, indices out of range clamped: (B, L, C) x T at T=37,
    a denoising step's (4, 2000, 128) f32 x 2736 taps, a temporal chunk's
    (50, 2000, 128) bf16 x 1200, a ragged T=1201 (the last tile short), and
    a pile-up of every tap of a frame on one row."""
    B, L, C, T = shape
    flat = _randn((B, L, C), 1, cuda, getattr(torch, dtype))
    idx = torch.from_numpy(np.random.default_rng(2).integers(
        -3, L + 5, (B, T)).astype(np.int32)).to(cuda)
    if pile_up:
        idx.fill_(L // 2)
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
                                 (2, 63), (2, 64), (2, 65), (2, 1025),
                                 (2, 2048), (2, 4096)])
def test_nms_kernel_matches_plain(cuda, B, K):
    """Bit for bit: the sweep only compares IoU values. K off a multiple
    of 32 or 64 leaves a ragged last word of the bitmask; 1024 is the
    largest K whose bitmask the sweep holds in shared memory, 1025-4096
    take the sweep that reads the kept rows from L2 (4096 the largest)."""
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float64"])
def test_nms_kernel_takes_any_float_iou(cuda, dtype):
    """An IoU of another float dtype is cast to f32, as the TPU kernel's
    wrapper casts it: bit for bit the plain sweep on the cast values, at
    the predict path's (32, 300)."""
    iou, valid = _nms_inputs(32, 300, 3, cuda)
    iou = iou.to(getattr(torch, dtype))
    want = _nms_equal(iou, valid)
    assert torch.equal(want, suppress.nms_suppress_reference(iou.float(),
                                                             valid))


def test_nms_kernel_refuses_what_it_cannot_take(cuda):
    """K past 4096 (beyond the TPU kernel's own ceiling: its (K, K) f32
    IoU fits its VMEM to about K = 1,400-2,000), an integer IoU and a
    non-contiguous one raise, and nothing is launched."""
    before = suppress.LAUNCHES
    iou, valid = _nms_inputs(1, 4097, 0, cuda)
    with pytest.raises(ValueError, match="at most 4096"):
        suppress.nms_suppress(iou, valid)
    iou, valid = _nms_inputs(2, 8, 0, cuda)
    with pytest.raises(TypeError, match="float"):
        suppress.nms_suppress(iou.int(), valid)
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
                                   (3, 24, 16, 32, 7, (96, 64)),
                                   (4, 160, 160, 32, 400, (640, 640)),
                                   (2, 40, 40, 16, 400, (160, 160)),
                                   (2, 40, 40, 37, 30, (160, 160)),
                                   (2, 24, 24, 70, 9, (96, 96)),
                                   (1, 16, 16, 5, 6, (64, 64))])
def test_masks_kernel_matches_plain(cuda, shape):
    """atol = rtol = 1e-5 in f32 with TF32 off. (32, 160, 160, 32) at
    K=100 is the predict path's; (3, 24, 16) is uneven in Hp, Wp and K;
    K=400 takes two shared-memory chunks of detections; P=16, 5 and 37
    are off the predict path's 32 (37 and 5 off a multiple of 4: scalar
    loads), and P=37 and 70 past the 32 a thread keeps in registers."""
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


def test_masks_kernel_casts_inputs_to_float32(cuda):
    """bf16 protos and coefficients and f16 boxes are cast to f32 before
    the launch, as the TPU kernel's wrapper casts them: the plain version
    on the same values within 1e-5."""
    protos, coeffs, boxes = _mask_inputs(2, 40, 40, 32, 50, (160, 160), 4,
                                         cuda)
    args = (protos.bfloat16(), coeffs.bfloat16(), boxes.half())
    before = masks.LAUNCHES
    got = masks.assemble_masks(*args, (160, 160))
    torch.cuda.synchronize()
    assert masks.LAUNCHES == before + 1 and got.dtype == torch.float32
    want = masks.assemble_masks_reference(*(a.float() for a in args),
                                          (160, 160))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_masks_kernel_refuses_what_it_cannot_take(cuda):
    """Non-contiguous and complex inputs raise, and nothing is launched:
    every P and K and every real dtype is taken."""
    protos, coeffs, boxes = _mask_inputs(2, 16, 16, 32, 5, (64, 64), 0, cuda)
    before = masks.LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        masks.assemble_masks(protos.transpose(1, 2), coeffs, boxes, (64, 64))
    with pytest.raises(TypeError, match="complex"):
        masks.assemble_masks(protos.to(torch.complex64), coeffs, boxes,
                             (64, 64))
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


@pytest.mark.parametrize("shape,pile_up", [
    ((16, 2000, 128, 1200), False), ((3, 50, 128, 37), False),
    ((2, 30, 8, 5), False), ((2, 20000, 128, 500), False),
    ((4, 2000, 128, 1200), True), ((16, 2000, 128, 2736), False),
    ((4, 2000, 128, 2736), False), ((50, 2000, 128, 1200), False),
    ((4, 2000, 128, 1201), False), ((3, 50, 12, 37), False)])
def test_weighted_gather_kernel_matches_plain(cuda, shape, pile_up):
    """Forward and both gradients against the plain version and its
    autograd, to 1e-5 of the largest magnitude: the forward sums four
    products in another order, and the backward's scatter runs in
    shared-memory atomics whose order changes from run to run. (16, 2000,
    128) x 1200 taps is the training path's, x 2736 its taps with a
    denoising group of 192 queries (150 + 192 queries x 8 points), at b16
    and at b4, and (50, 2000, 128) x 1200 a temporal v3 step's, one
    50-frame sequence as the batch; T=37, T=1201 and C=8 are ragged;
    L=20000 splits the backward's rows into ranges; the pile-up sends
    every corner of a frame to one row; C=12 gives 48-byte rows."""
    flat, idx, w = _weighted_inputs(*shape, seed=sum(shape), device=cuda)
    if pile_up:
        idx.fill_(shape[1] // 2)
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


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,pile_up", [
    ((16, 2000, 128, 1200), False), ((3, 50, 128, 37), False),
    ((2, 20000, 128, 500), False), ((4, 2000, 128, 1200), True),
    ((3, 50, 4, 37), False), ((4, 2000, 4, 1201), True)])
def test_weighted_gather_kernel_matches_plain_bf16(cuda, shape, pile_up,
                                                   w_dtype):
    """A bf16 table: forward, d_flat and d_w through autograd and the
    backward kernels alone against the plain versions (w rounded to bf16,
    f32 sums, each output rounded once), to one bf16 ulp of each output's
    largest magnitude plus 1e-5 of it for the reordered f32 sums. d_w comes
    back in w's dtype. C = 4 gives 8-byte rows, one 8-byte piece a row."""
    flat, idx, w = _weighted_inputs(*shape, seed=sum(shape), device=cuda)
    if pile_up:
        idx.fill_(shape[1] // 2)
    flat, w = flat.bfloat16(), w.to(getattr(torch, w_dtype))
    g = _randn((shape[0], shape[3], shape[2]), 5, cuda, torch.bfloat16)
    before = (gather.WEIGHTED_LAUNCHES, gather.WEIGHTED_BACKWARD_LAUNCHES)
    fk, wk = flat.clone().requires_grad_(), w.clone().requires_grad_()
    got = gather.weighted_gather(fk, idx, wk)
    got.backward(g)
    torch.cuda.synchronize()
    assert (gather.WEIGHTED_LAUNCHES, gather.WEIGHTED_BACKWARD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16 and wk.grad.dtype == w.dtype
    want = gather.weighted_gather_reference(flat, idx, w)
    d_flat, d_w = gather.weighted_gather_backward(flat, idx, w, g)
    r_flat, r_w = gather.weighted_gather_backward_reference(flat, idx, w, g)
    for a, b in ((got, want), (fk.grad, r_flat), (wk.grad, r_w),
                 (d_flat, r_flat), (d_w, r_w)):
        peak = b.float().abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7) if a.dtype == \
            torch.bfloat16 else 0.0
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=ulp + 1e-5 * peak)


def _assert_gather_close(got, want):
    """Within 1e-5 of want's largest magnitude, plus one bf16 ulp of it
    for a bf16 output (the plain version sums in another order)."""
    peak = want.float().abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 7) if got.dtype == \
        torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=ulp + 1e-5 * peak)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_gather_routes_agree_bit_for_bit(cuda, dtype):
    """The forward's two routes: K = 4 (the paths') by the kernel that
    fixes K at compile time, any other K by the one that takes it at run
    time; both sum fmaf(w_k, x_k, acc) in corner order. K = 5 with a
    zero-weight fifth corner over a finite table equals K = 4 bit for bit;
    K in {1, 2, 3, 8} and K = 40 (past a warp's 32 lanes: one tap a group,
    its entries loaded 32 at a time) are held to the plain version. T =
    1201 leaves a ragged last group."""
    B, L, C, T = 4, 2000, 128, 1201
    dt = getattr(torch, dtype)
    flat, idx, w = _weighted_inputs(B, L, C, T, seed=19, device=cuda)
    flat = flat.to(dt)
    rng = np.random.default_rng(20)
    idx5 = torch.cat([idx, torch.from_numpy(rng.integers(
        -2, L + 3, (B, T, 1)).astype(np.int32)).to(cuda)], -1).contiguous()
    w5 = torch.cat([w, torch.zeros_like(w[..., :1])], -1).contiguous()
    before = gather.WEIGHTED_LAUNCHES
    with torch.no_grad():
        got4 = gather.weighted_gather(flat, idx, w)
        got5 = gather.weighted_gather(flat, idx5, w5)
    torch.cuda.synchronize()
    assert gather.WEIGHTED_LAUNCHES == before + 2
    assert torch.equal(got4, got5)
    for K in (1, 2, 3, 8, 40):
        idxk = torch.from_numpy(rng.integers(-2, L + 3, (B, T, K))
                                .astype(np.int32)).to(cuda)
        wk = torch.from_numpy(rng.uniform(0, 1, (B, T, K))
                              .astype(np.float32)).to(cuda)
        with torch.no_grad():
            got = gather.weighted_gather(flat, idxk, wk)
        _assert_gather_close(got, gather.weighted_gather_reference(
            flat, idxk, wk))


@pytest.mark.parametrize("group", [1, 2, 3, 4, 6, 8])
def test_weighted_gather_every_group_equals_the_plan(cuda, group,
                                                     monkeypatch):
    """Each group size that ``kernel_ab.py wplans`` sweeps (taps a warp's
    group), set through the plan's bounds, gives the plan's own output bit
    for bit, f32 and bf16 (one tap and two taps a pass), at a denoising
    step's b4 with a ragged T; blocks of 4 warps alike."""
    B, L, C, T = 4, 2000, 128, 1201
    flat, idx, w = _weighted_inputs(B, L, C, T, seed=group, device=cuda)
    for dt in (torch.float32, torch.bfloat16):
        table = flat.to(dt)
        with torch.no_grad():
            want = gather.weighted_gather(table, idx, w)
            for warps in (8, 4):
                with monkeypatch.context() as m:
                    m.setattr(gather, "MIN_GROUP", group)
                    m.setattr(gather, "MAX_GROUP", group)
                    m.setattr(gather, "WEIGHTED_WARPS", warps)
                    plan = gather.weighted_plan(B, T, 4, C * table
                                                .element_size(), 132)
                    assert (plan.group, plan.warps) == (group, warps)
                    got = gather.weighted_gather(table, idx, w)
                assert torch.equal(got, want), (dt, warps)
        _assert_gather_close(want, gather.weighted_gather_reference(
            table, idx, w))


@pytest.mark.parametrize("case", ["frames", "rows"])
def test_gather_forwards_past_a_grid_and_a_tile(cuda, case):
    """The forward kernels at their edges: 70,000 frames, more than a
    grid's 65,535, and wide rows (a 128 KB one-hot row, which outgrows a
    tile and is cut into pieces; four 32 KB corner rows of a tap). The
    one-hot gather bit for bit, the weighted gather to 1e-5 of the largest
    magnitude; one launch each."""
    B, L, C, T = (70000, 2, 8, 3) if case == "frames" else (2, 5, 8192, 7)
    flat, idx, w = _weighted_inputs(B, L, C, T, seed=7, device=cuda)
    one = _randn((B, L, 4 * C), 8, cuda, torch.float32)
    before = (gather.LAUNCHES, gather.WEIGHTED_LAUNCHES)
    got_one = gather.onehot_gather(one, idx[..., 0].contiguous())
    got = gather.weighted_gather(flat, idx, w)
    torch.cuda.synchronize()
    assert (gather.LAUNCHES, gather.WEIGHTED_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got_one, gather.onehot_gather_reference(
        one, idx[..., 0].contiguous()))
    want = gather.weighted_gather_reference(flat, idx, w)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_weighted_gather_kernel_refuses_what_it_cannot_take(cuda):
    flat, idx, w = _weighted_inputs(2, 10, 128, 6, 0, cuda)
    before = gather.WEIGHTED_LAUNCHES
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gather.weighted_gather(flat.half(), idx, w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gather.weighted_gather_backward(
            flat.bfloat16(), idx, w, torch.zeros(2, 6, 128, device=cuda))
    with pytest.raises(TypeError, match="int32"):
        gather.weighted_gather(flat, idx.long(), w)
    with pytest.raises(ValueError, match="4-element"):
        gather.weighted_gather(flat[..., :6].contiguous(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        gather.weighted_gather(flat.transpose(1, 2).contiguous()
                               .transpose(1, 2), idx, w)
    assert gather.WEIGHTED_LAUNCHES == before


def test_inference_kernels_refuse_grad_mode(cuda):
    """The attention kernel has no backward (nor has the TPU kernel): under
    grad mode an input that needs a gradient raises instead of cutting the
    graph, and nothing is launched; under no_grad it runs."""
    q = _randn((2, 40, 128), 1, cuda, torch.float32).requires_grad_()
    before = attention.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        attention.aifi_attention(q, q, q, 8)
    assert attention.LAUNCHES == before
    with torch.no_grad():
        attention.aifi_attention(q, q, q, 8)
    assert attention.LAUNCHES == before + 1


def _onehot_grad_inputs(B, L, C, T, seed, device, pile_up=False):
    """A (B, L, C) f32 table, (B, T) indices past both ends (or all on one
    row), and an output gradient."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.normal(size=(B, L, C)).astype(np.float32))
    idx = rng.integers(-3, L + 3, (B, T)).astype(np.int32)
    idx[:, :2] = (-3, L + 2)
    if pile_up:
        idx[:] = L // 2
    g = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    return flat.to(device), torch.from_numpy(idx).to(device), g.to(device)


@pytest.mark.parametrize("shape,pile_up", [
    ((16, 2000, 128, 1200), False), ((3, 50, 128, 37), False),
    ((2, 30, 8, 5), False), ((2, 20000, 128, 500), False),
    ((4, 2000, 128, 1200), True)])
def test_onehot_backward_kernel_matches_plain(cuda, shape, pile_up):
    """The one-hot gather's gradient through autograd (the forward kernel,
    then the backward kernel) and the backward kernel alone, against the
    plain clipped scatter-add, to 1e-5 of the largest magnitude: the
    kernel sums in shared-memory atomics whose order changes from run to
    run. (16, 2000, 128) x 1200 is the discrete training step's shape;
    T=37 and C=8 are ragged; L=20000 splits the rows into ranges; the
    pile-up sends every tap of a frame to one row."""
    B, L, C, T = shape
    flat, idx, g = _onehot_grad_inputs(B, L, C, T, sum(shape), cuda, pile_up)
    before = (gather.LAUNCHES, gather.ONEHOT_BACKWARD_LAUNCHES)
    fk = flat.clone().requires_grad_()
    out = gather.onehot_gather(fk, idx)
    out.backward(g)
    torch.cuda.synchronize()
    assert (gather.LAUNCHES, gather.ONEHOT_BACKWARD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(out.detach(), gather.onehot_gather_reference(flat, idx))
    want = gather.onehot_gather_backward_reference(g, idx, L)
    tol = 1e-5 * want.abs().max().item()
    torch.testing.assert_close(fk.grad, want, atol=tol, rtol=0)
    got = gather.onehot_gather_backward(g, idx, L)
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("shape,pile_up", [
    ((16, 2000, 128, 1200), False), ((3, 50, 128, 37), False),
    ((4, 2000, 128, 1200), True)])
def test_onehot_backward_kernel_matches_plain_bf16(cuda, shape, pile_up):
    """A bf16 table and gradient through autograd, and the backward kernel
    alone: the plain version (an f32 sum, rounded once to bf16) within one
    bf16 ulp of the largest magnitude plus 1e-5 of it."""
    B, L, C, T = shape
    flat, idx, g = _onehot_grad_inputs(B, L, C, T, sum(shape), cuda, pile_up)
    flat, g = flat.bfloat16(), g.bfloat16()
    before = gather.ONEHOT_BACKWARD_LAUNCHES
    fk = flat.clone().requires_grad_()
    gather.onehot_gather(fk, idx).backward(g)
    alone = gather.onehot_gather_backward(g, idx, L)
    torch.cuda.synchronize()
    assert gather.ONEHOT_BACKWARD_LAUNCHES == before + 2
    want = gather.onehot_gather_backward_reference(g, idx, L)
    peak = want.float().abs().max().item()
    tol = 2.0 ** (np.floor(np.log2(peak)) - 7) + 1e-5 * peak
    for got in (fk.grad, alone):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)


def test_onehot_backward_kernel_refuses_what_it_cannot_take(cuda):
    """A gradient other than float32 or bfloat16 raises TypeError, through
    autograd too, and nothing is launched."""
    flat, idx, g = _onehot_grad_inputs(2, 10, 128, 6, 0, cuda)
    before = gather.ONEHOT_BACKWARD_LAUNCHES
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gather.onehot_gather_backward(g.half(), idx, 10)
    with pytest.raises(TypeError, match="int32"):
        gather.onehot_gather_backward(g, idx.long(), 10)
    fk = flat.half().requires_grad_()
    out = gather.onehot_gather(fk, idx)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        out.backward(g.half())
    assert gather.ONEHOT_BACKWARD_LAUNCHES == before


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
    with yolo_predict.full_f32(), torch.no_grad():
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


@pytest.mark.parametrize("name", ["yolov9c-seg", "yolo11n", "yolov5su"])
def test_yolo_flavour_postprocess_matches_plain(cuda, name, monkeypatch):
    """Each YOLO configuration's post-process at 640px, batch 2, with its
    served NMS settings: through the kernels, then through the plain
    versions on the same raw outputs, identical detections and masks
    within 1e-5; one NMS sweep and, for seg only, one mask decode."""
    from pautdx_torch.serve import yolo_predict

    cfg = yolo_predict.yolo_config(name)
    predictor = yolo_predict.build_yolo_predictor(device=cuda, seed=1,
                                                  cfg=cfg)
    frames = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, 640, 640, 3)).astype(np.uint8)).to(cuda)
    with yolo_predict.full_f32(), torch.no_grad():
        out = predictor.model(frames.float() / 255.0)
    before = (suppress.LAUNCHES, masks.LAUNCHES)
    got = yolo_predict.postprocess(out, (640, 640), cfg)
    assert (suppress.LAUNCHES, masks.LAUNCHES) == (before[0] + 1,
                                                    before[1] + cfg.seg)
    monkeypatch.setattr(suppress, "nms_suppress",
                        suppress.nms_suppress_reference)
    monkeypatch.setattr(masks, "assemble_masks",
                        masks.assemble_masks_reference)
    want = yolo_predict.postprocess(out, (640, 640), cfg)
    assert set(got) == set(want)
    assert ("masks" in got) == cfg.seg
    # the served max_det: nms()'s 100 for seg, the CLI head's 16 else
    assert got["boxes"].shape == (2, 100 if cfg.seg else 16, 4)
    assert got["valid"].any()
    for k in ("boxes", "scores", "classes", "valid", "indices"):
        assert torch.equal(got[k], want[k]), k
    if cfg.seg:
        assert got["masks"].shape == (2, 100, 160, 160)
        torch.testing.assert_close(got["masks"], want["masks"], atol=1e-5,
                                   rtol=0)


# ------------------------------------------------------------ int8 conv

# (N, C, H, W, Cout, k, stride, groups, layout): the serving sites' kinds
# (dense 1x1 and 3x3, stride 2, depthwise k5 and k3 s2), YOLO's first
# conv (C = 3, one value at a time), a channel slice of a channels-last
# tensor, NCHW memory, ragged tiles; then the wgmma and dp4a routes' edges:
# Cout 512 (two N tiles), ragged Cout (40, 72), C 16 and 48 (a chunk
# padded to 32 channels), a 1x1 with K 640, 3x3 stride 2 with weights
# streamed by chunk (128 -> 256, too big to stay in shared memory), a
# slice 8 channels in (16-byte aligned), ragged spatial tiles (17 x 19),
# depthwise with C not a multiple of 64; inputs with zeros, subnormals and
# values at +-s/2 (the quantizer's shortcut to 0) and at +-1.5 s (ties);
# inputs with NaN (quantized to 0) and +-inf (to +-127) on each route:
# wgmma, dp4a, and the generic kernel through a 3-channel input
INT8_CASES = [
    (2, 64, 40, 40, 64, 1, 1, 1, "cl"), (2, 64, 20, 20, 64, 3, 1, 1, "cl"),
    (2, 64, 40, 40, 128, 3, 2, 1, "cl"), (2, 320, 17, 19, 128, 1, 1, 1, "cl"),
    (2, 64, 40, 40, 64, 5, 1, 64, "cl"), (2, 128, 40, 40, 128, 3, 2, 128,
                                          "cl"),
    (2, 3, 64, 64, 16, 3, 2, 1, "cl"), (2, 64, 21, 23, 72, 3, 1, 1, "slice"),
    (3, 48, 13, 11, 40, 3, 1, 1, "nchw"), (2, 24, 9, 9, 24, 5, 1, 24,
                                           "nchw"),
    (2, 256, 20, 20, 512, 1, 1, 1, "cl"), (1, 32, 12, 12, 512, 3, 1, 1, "cl"),
    (2, 32, 15, 13, 40, 1, 1, 1, "cl"), (2, 16, 33, 35, 16, 3, 1, 1, "cl"),
    (2, 16, 34, 30, 32, 3, 2, 1, "cl"), (2, 48, 19, 17, 32, 1, 1, 1, "cl"),
    (2, 48, 18, 20, 40, 3, 2, 1, "cl"), (2, 640, 20, 20, 256, 1, 1, 1, "cl"),
    (2, 128, 20, 20, 256, 3, 2, 1, "cl"), (2, 64, 17, 19, 64, 3, 1, 1, "cl"),
    (2, 32, 17, 19, 48, 3, 1, 1, "off8"), (2, 64, 30, 26, 64, 1, 1, 1,
                                           "off8"),
    (2, 96, 20, 20, 96, 5, 1, 96, "cl"), (2, 40, 33, 31, 40, 3, 2, 40, "cl"),
    (1, 160, 21, 19, 160, 3, 1, 160, "off8"), (2, 72, 17, 15, 72, 5, 2, 72,
                                               "cl"),
    (2, 64, 20, 20, 64, 3, 1, 1, "edge"), (2, 96, 24, 24, 128, 1, 1, 1,
                                           "edge"),
    (2, 64, 21, 21, 64, 5, 1, 64, "edge"),
    (2, 64, 20, 20, 64, 3, 1, 1, "nonfinite"), (2, 64, 21, 21, 64, 5, 1, 64,
                                                "nonfinite"),
    (2, 3, 64, 64, 16, 3, 2, 1, "nonfinite")]


def _int8_inputs(case, dtype, device, seed):
    N, C, H, W, O, k, st, g, layout = case
    gen = torch.Generator().manual_seed(seed)
    c_all = {"slice": 2 * C, "off8": C + 16}.get(layout, C)
    x = torch.randn((N, c_all, H, W), generator=gen).to(dtype)
    if layout != "nchw":
        x = x.to(memory_format=torch.channels_last)
    x = x.to(device)
    if layout == "slice":
        x = x[:, C:]
    elif layout == "off8":
        x = x[:, 8:8 + C]
    w = torch.randn((O, C // g, k, k), generator=gen).to(dtype).to(device)
    s = float(x.float().abs().max()) / 127.0
    if layout == "edge":
        x[:, :, ::3] = 0
        x[:, 1::4, 1::3] *= 1e-39
        x[:, ::5, 2::6] = s / 2
        x[:, 2::5, 2::6] = -s / 2
        x[:, 3::5, 2::6] = 1.5 * s
        x[:, 4::5, 5::6] = torch.finfo(dtype).tiny / 4
    elif layout == "nonfinite":
        x[:, ::3, ::4, 1::5] = float("nan")
        x[:, 1::3, 2::4, ::7] = float("inf")
        x[:, 2::3, 1::5, 3::6] = -float("inf")
    return x, qconv.prepare_int8_weight(w, s, g), w, st, (k - 1) // 2, g


def _want_route(case, dtype) -> str:
    """The route a case must take: the TMA routes for channels-last inputs
    whose rows are 16-byte multiples, the generic kernel else."""
    N, C, H, W, O, k, st, g, layout = case
    elt = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    if layout == "nchw" or (C * elt) % 16:
        return "generic"
    return "dp4a" if g > 1 else "wgmma"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_conv_kernel_matches_plain(cuda, case, dtype):
    """The kernel's int32 accumulators and its dequantized output equal the
    plain version's bit for bit, the output in the input's memory format;
    one launch a call, on the route the shape calls for."""
    x, prep, w, st, pad, g = _int8_inputs(case, getattr(torch, dtype),
                                          cuda, seed=len(case) + case[1])
    route = _want_route(case, dtype)
    assert qconv.int8_route(x.shape, x.stride(), x.element_size(),
                            x.data_ptr(), prep.q.shape, st, g) == route
    before = qconv.LAUNCHES
    by_route = dict(qconv.LAUNCHES_BY_ROUTE)
    acc = qconv.int8_accumulators(x, prep, st, pad)
    out = qconv.int8_conv(x, w, st, pad, g, None, prep)
    torch.cuda.synchronize()
    assert qconv.LAUNCHES == before + 2
    assert qconv.LAUNCHES_BY_ROUTE == dict(by_route, **{
        route: by_route[route] + 2})
    want_acc = qconv.int8_accumulators_reference(x, prep, st, pad)
    want = qconv.int8_conv_reference(x, w, st, pad, g, None, prep)
    assert torch.equal(acc, want_acc)
    assert out.dtype == want.dtype == x.dtype
    assert torch.equal(out, want)
    assert out.is_contiguous(memory_format=qconv.memory_format(x))
    assert (qconv.memory_format(x) == torch.channels_last) == (
        case[-1] != "nchw")


def _kernel_ab():
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", os.path.join(ROOT, "kernel_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path,batch,elt", [("dfine", 128, 2),
                                            ("yolo", 32, 4),
                                            ("yolo_v5", 60, 4),
                                            ("yolo_v9c", 60, 4),
                                            ("yolo_v11", 60, 4)])
def test_int8_route_at_every_serving_site(path, batch, elt):
    """Pure Python, no card: every site of the two serving forwards but
    YOLO's 3-channel stem takes a TMA route (wgmma dense, dp4a
    depthwise); the stem, whose channels-last rows are 12 bytes, the
    generic kernel. The CLI's other YOLO flavours (their sites that
    YOLOv8n-seg lacks): the 3-channel stems and YOLO11n's NCHW attention
    sites generic, the rest on a TMA route. A base 256 bytes into an
    allocation stands for the allocator's alignment."""
    sites = _kernel_ab().INT8_SITES[path]
    assert sum(site[-1] for site in sites) == {
        "dfine": 69, "yolo": 66, "yolo_v5": 25, "yolo_v9c": 81,
        "yolo_v11": 38}[path]
    routes = []
    for C, H, W, strides, offset, wshape, st, g, _ in sites:
        routes.append(qconv.int8_route((batch, C, H, W), strides, elt,
                                       256 + offset * elt, wshape, st, g))
        want = ("generic" if C == 3 or strides[1] != 1
                else "dp4a" if g > 1 else "wgmma")
        assert routes[-1] == want, (C, H, W, wshape, st, g)
    assert routes.count("generic") == {
        "dfine": 0, "yolo": 1, "yolo_v5": 1, "yolo_v9c": 1,
        "yolo_v11": 2}[path]


def test_kernel_ab_phase_anchors_match_the_kernel_source():
    """``kernel_ab.py phases`` instruments a copy of the int8 kernel source
    by text: every anchor it patches occurs exactly once there."""
    with open(os.path.join(ROOT, "pautdx_torch", "csrc", "int8_conv.cu")) as f:
        src = f.read()
    for old, _ in _kernel_ab()._PHASE_PATCHES:
        assert src.count(old) == 1, old


@pytest.mark.parametrize("shape", [(72, 48, 3, 3), (512, 256, 1, 1),
                                   (16, 16, 3, 3), (40, 32, 1, 1),
                                   (256, 128, 3, 3)])
def test_int8_wgmma_weight_unpacks_to_q(shape):
    """The dense route's packed weight, read back by its documented layout
    (N tile, 32-channel chunk, tap, 8-row group, 16-channel half, row,
    byte), is ``q`` with zeros past Cout and C."""
    O, C, k, _ = shape
    w = torch.randn(shape, generator=torch.Generator().manual_seed(O + C))
    prep = qconv.prepare_int8_weight(w, 0.05)
    nt = prep.nt
    assert nt == qconv.wgmma_width(O) and nt >= min(O, 256)
    assert nt % 16 == 0 and (O <= 256 or nt == 256)
    p = prep.packed_tma.numpy()
    tiles, chunks = -(-O // nt), -(-C // 32)
    assert p.shape == (tiles, chunks, k * k, nt // 8, 2, 8, 16)
    got = np.zeros((tiles * nt, chunks * 32, k, k), dtype=np.int8)
    for t, j, tap, ng, h, r, b in np.ndindex(*p.shape):
        got[t * nt + ng * 8 + r, j * 32 + h * 16 + b, tap // k,
            tap % k] = p[t, j, tap, ng, h, r, b]
    q = prep.q.numpy()
    assert np.array_equal(got[:O, :C], q)
    assert not got[O:].any() and not got[:, C:].any()


@pytest.mark.parametrize("k", [3, 5])
def test_int8_dp4a_weight_unpacks_to_q(k):
    """The depthwise route's packed weight: row ky of channel c is the
    kernel row's k taps, then zeros to a multiple of four bytes."""
    w = torch.randn((40, 1, k, k), generator=torch.Generator().manual_seed(k))
    prep = qconv.prepare_int8_weight(w, 0.05, groups=40)
    p = prep.packed_tma.numpy()
    assert p.shape == (40, k, 4 * -(-k // 4)) and prep.nt == 0
    assert np.array_equal(p[:, :, :k], prep.q.numpy()[:, 0])
    assert not p[:, :, k:].any()


def test_int8_conv_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.randn(1, 8, 6, 6, device=cuda)
    w = torch.randn(8, 4, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="dense or depthwise"):
        qconv.int8_conv(x, w, 1, 1, 2, 0.1)
    with pytest.raises(TypeError, match="f32 or bf16"):
        qconv.int8_conv(x.half(), torch.randn(8, 8, 3, 3, device=cuda),
                        1, 1, 1, 0.1)
    with pytest.raises(ValueError, match="not square"):
        qconv.int8_conv(x, torch.randn(8, 8, 3, 3, device=cuda), (1, 2), 1,
                        1, 0.1)
    with pytest.raises(RuntimeError, match="no backward"):
        qconv.int8_conv(x.requires_grad_(), torch.randn(8, 8, 3, 3,
                                                        device=cuda),
                        1, 1, 1, 0.1)


# ------------------------------------------ the served D-FINE's CUDA graphs


def _served_dfine(cuda):
    """The serving model of ``build_serving_model`` and a forward hook on
    its encoder class head that clones what it sees, in stream order."""
    from pautdx_torch.serve import throughput
    model = throughput.build_serving_model(device=cuda, batch=128).model
    seen = []
    model.model.enc_score_head.register_forward_hook(
        lambda module, args, out: seen.append(out.clone()))
    return model, seen


def _wire(cuda, batch, seed):
    from pautdx_torch.serve import throughput
    return throughput.make_uint8_slab((batch, 80, 80, 192), seed=seed,
                                      device=cuda)


def _leaves(out):
    from torch.utils import _pytree as pytree
    leaves, spec = pytree.tree_flatten(out)
    return leaves, spec


def _counts():
    return profiling.launch_counts()


def test_served_graph_replays_the_eager_forward_bit_for_bit(cuda):
    """At b128 and at b24 (a second capture in the same pool), the first
    call (warm-up, capture, replay) and a later replay give every output of
    the eager forward and the hooked encoder scores bit for bit. One
    capture a shape, one replay a call; the per-op counters count the
    warm-up and each replay: 1 attention and 3 one-hot gathers a forward."""
    from pautdx_torch.models.vision.dfine import DFine
    model, seen = _served_dfine(cuda)
    for n, (batch, seed) in enumerate(((128, 11), (24, 12))):
        x = _wire(cuda, batch, seed)
        with torch.inference_mode():
            eager = DFine.forward(model, x)
            eager_enc = seen.pop()
            c0 = _counts()
            first = model(x)
            first_enc = seen.pop()
            c1 = _counts()
            later = model(x)
            later_enc = seen.pop()
            c2 = _counts()
        torch.cuda.synchronize()
        assert len(model.graphs) == n + 1
        want, spec = _leaves(eager)
        for got in (first, later):
            leaves, got_spec = _leaves(got)
            assert got_spec == spec
            for a, b in zip(leaves, want):
                assert a.shape == b.shape and a.dtype == b.dtype
                assert torch.equal(a, b)
        assert tuple(first["logits"].shape) == (batch, 150, 2)
        assert torch.equal(first_enc, eager_enc)
        assert torch.equal(later_enc, eager_enc)
        d1 = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        d2 = {k: c2[k] - c1[k] for k in c2 if c2[k] != c1[k]}
        assert d1 == {"aifi_attention": 2, "onehot_gather": 6,
                      "dfine_graph_capture": 1, "dfine_graph_replay": 1}
        assert d2 == {"aifi_attention": 1, "onehot_gather": 3,
                      "dfine_graph_replay": 1}


def test_served_graph_outputs_and_hooks_follow_each_call(cuda):
    """A call's returned tensors are unchanged after a later call on other
    frames (the second under ``no_grad``, not ``inference_mode``), and the
    hook that clones the encoder scores sees each call's own."""
    from pautdx_torch.models.vision.dfine import DFine
    model, seen = _served_dfine(cuda)
    xa, xb = _wire(cuda, 32, 21), _wire(cuda, 32, 22)
    with torch.inference_mode():
        want_a = DFine.forward(model, xa)
        want_b = DFine.forward(model, xb)
    enc_a, enc_b = seen
    seen.clear()
    with torch.inference_mode():
        got_a = model(xa)
    with torch.no_grad():
        got_b = model(xb)
    torch.cuda.synchronize()
    assert len(model.graphs) == 1
    assert not torch.equal(want_a["logits"], want_b["logits"])
    for got, want in ((got_a, want_a), (got_b, want_b)):
        for a, b in zip(_leaves(got)[0], _leaves(want)[0]):
            assert torch.equal(a, b)
    assert torch.equal(seen[0], enc_a) and torch.equal(seen[1], enc_b)


def test_served_graph_replay_is_one_forward_span_on_the_card_trace(cuda):
    """Under the card-only profiler the benchmark uses, a replay is one
    ``dfine.forward`` span with no children, its launches a call the
    served forward's own, and the device trace names the port's kernels
    inside the graph: 1 attention and 3 one-hot gather kernels."""
    model, _ = _served_dfine(cuda)
    x = _wire(cuda, 32, 31)
    profiling.TRACER.prepare(cuda)
    with torch.inference_mode():
        model(x)
    torch.cuda.synchronize()

    def work():
        with torch.inference_mode():
            model(x)

    profiling.TRACER.reset()
    device = _card_only_trace(cuda, work)
    assert [r.name for r in profiling.TRACER.spans()] == ["dfine.forward"]
    assert profiling.TRACER.summary()["launches"]["dfine.forward"] == {
        "aifi_attention": 1.0, "onehot_gather": 3.0,
        "dfine_graph_replay": 1.0}
    names = [n for n, _, _ in device]
    assert sum("attn_bf16_kernel" in n for n in names) == 1, names
    assert sum("onehot_tile" in n for n in names) == 3, names


def test_served_model_with_a_pre_hook_runs_eagerly(cuda):
    """A forward pre-hook on a submodule (``device_profile``'s spans):
    every call runs the eager forward and nothing is captured."""
    from pautdx_torch.models.vision.dfine import DFine
    from pautdx_torch.serve import graphs
    model, _ = _served_dfine(cuda)
    calls = []
    model.model.encoder.register_forward_pre_hook(
        lambda module, args: calls.append(1))
    x = _wire(cuda, 16, 41)
    captures = graphs.CAPTURES
    with torch.inference_mode():
        assert graphs.eager_reason(model, x) == ("a forward pre-hook on a "
                                                 "submodule")
        got = model(x)
        want = DFine.forward(model, x)
    torch.cuda.synchronize()
    assert model.graphs == {} and graphs.CAPTURES == captures
    assert len(calls) == 2
    for a, b in zip(_leaves(got)[0], _leaves(want)[0]):
        assert torch.equal(a, b)


# ------------------------------------------- the tracer on the device axis


def _card_only_trace(cuda, work):
    """Run ``work`` under a profiler of the card alone, as the benchmark
    traces a window: the device events (name, start µs, end µs)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        work()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _warm_host(cuda):
    """A few launches and a short synchronize: the host's launch path warm,
    as it is inside a serving loop."""
    x = torch.zeros(16, device=cuda)
    for _ in range(8):
        x.add_(1)
    torch.cuda.synchronize()


def test_span_encloses_its_kernel_on_the_device_axis(cuda):
    """A span around a matmul and a synchronize, placed on the device
    trace's axis by the tracer's anchor, holds the matmul kernel within
    20 µs at each end, and ends at most 20 µs after it."""
    a = torch.randn(2048, 2048, device=cuda)
    b = torch.randn(2048, 2048, device=cuda)
    profiling.TRACER.prepare(cuda)
    a @ b
    _warm_host(cuda)

    def work():
        with profiling.span("test.matmul"):
            a @ b
            torch.cuda.synchronize()

    device = _card_only_trace(cuda, work)
    axis = profiling.TRACER.device_axis(device)
    (r,) = [r for r in profiling.TRACER.spans() if r.name == "test.matmul"]
    kernels = [(s, e) for n, s, e in device
               if profiling.ANCHOR_KERNEL not in n and n != "test.matmul"]
    assert axis is not None and kernels, device
    lo, hi = min(s for s, _ in kernels), max(e for _, e in kernels)
    start, end = axis(r.start_ns), axis(r.end_ns)
    print(f"span starts {lo - start:.2f} µs before the kernel, ends "
          f"{end - hi:.2f} µs after it")
    assert start <= lo + 20.0 and end >= hi - 20.0
    # after the synchronize the span's end follows the kernel's closely:
    # this is what holds the anchor's absolute offset
    assert 0.0 <= end - hi <= 20.0


def test_anchors_two_seconds_apart_agree(cuda):
    """Over a 2 s session of top-level spans, each a matmul and a
    synchronize, the anchors the tracer lays every ``ANCHOR_EVERY_NS``
    agree with the device trace at its start and at its end: on the device
    axis, the spans of the first and of the last 50 end a median within
    20 µs of their kernels' ends, and the two medians agree within 10 µs.
    The device trace's clock drifts against every host clock, at a rate
    that changes from session to session, so the anchors' raw offsets 2 s
    apart need not agree; the axis follows them."""
    a = torch.randn(2048, 2048, device=cuda)
    profiling.TRACER.prepare(cuda)
    _warm_host(cuda)

    def work():
        t_end = time.perf_counter() + 2.0
        while time.perf_counter() < t_end:
            with profiling.span("test.matmul"):
                a @ a
                torch.cuda.synchronize()

    device = _card_only_trace(cuda, work)
    axis = profiling.TRACER.device_axis(device)
    spans = sorted(profiling.TRACER.spans(), key=lambda r: r.start_ns)
    kernels = sorted((s, e) for n, s, e in device
                     if profiling.ANCHOR_KERNEL not in n)
    assert axis is not None and len(axis.at_us) >= 30, axis
    assert len(kernels) == len(spans) > 100, (len(kernels), len(spans))
    lags = [axis(r.end_ns) - e for r, (_, e) in zip(spans, kernels)]
    offsets = profiling.TRACER.device_offsets_us(device)
    first, last = float(np.median(lags[:50])), float(np.median(lags[-50:]))
    print(f"{len(spans)} spans, {len(axis.at_us)} of {len(offsets)} anchors "
          f"kept; raw offset 2 s on {offsets[-1] - offsets[1]:+.2f} µs; "
          f"median end lag {first:.2f} µs first, {last:.2f} µs last")
    assert abs(first) <= 20.0 and abs(last) <= 20.0
    assert abs(last - first) <= 10.0
