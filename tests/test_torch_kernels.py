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

from pautdx_torch.ops import _build, attention, gather

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


@pytest.mark.parametrize("dtype,N", [("float32", 400), ("bfloat16", 400),
                                     ("float32", 37), ("bfloat16", 37)])
def test_attention_kernel_matches_plain(cuda, dtype, N):
    """f32 with TF32 off: 1e-5. bf16: 2e-2, since the plain version rounds
    the probabilities to bf16 before P.V and the kernel keeps them f32.
    N=37 leaves a ragged query tile."""
    dt = getattr(torch, dtype)
    q, k, v = (_randn((3, 8, N, 16), s, cuda, dt) for s in range(3))
    q = q * 0.25
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
    want = attention.aifi_attention_reference(*x, 8)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_attention_kernel_refuses_what_it_cannot_take(cuda):
    q = _randn((2, 4, 8, 24), 0, cuda, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        attention.fused_attention(q, q, q)
    q = _randn((2, 8, 4, 16), 0, cuda, torch.float32).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.fused_attention(q, q, q)


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
