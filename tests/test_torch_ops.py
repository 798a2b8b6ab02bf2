"""pautdx_torch's kernel modules held to the JAX package on the CPU.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode. Inputs are made with numpy from a seed
and handed to both. The CUDA kernels themselves are held to the plain
versions on the card by tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pautdx.ops import deformable as jdeform
from pautdx.ops.pallas_attention import aifi_attention as j_aifi_attention
from pautdx.ops.pallas_attention import fused_attention as j_fused_attention
from pautdx.ops.pallas_gather import pallas_onehot_gather
from pautdx_torch.ops import attention, deformable, gather
from torch_threads import one_torch_thread  # noqa: F401


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("shape", [
    (2, 8, 400, 16), (2, 8, 400, 32), (2, 8, 400, 64),
    *((1, 2, 37, dh) for dh in (1, 8, 24, 48, 128, 256))])
def test_fused_attention_reference_matches_pallas(shape):
    """f32 at atol/rtol 1e-5, the gate of tests/test_pallas_ops.py (both sum
    in f32): (2, 8, 400, dh) is the AIFI head layout at 640px (dh 16:
    dfine_nano, 32: DFineConfig(), 64), and (1, 2, 37, dh) spans the head
    dims the kernel takes on the card, 1 to attention.MAX_HEAD_DIM (256)."""
    dh = shape[-1]
    q, k, v = _qkv(shape, dh)
    q *= dh ** -0.5
    want = j_fused_attention(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), interpret=True)
    before = attention.LAUNCHES
    got = attention.fused_attention(*map(torch.from_numpy, (q, k, v)))
    assert attention.LAUNCHES == before  # the CPU path launches nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert dh <= attention.MAX_HEAD_DIM == 256


def test_aifi_attention_matches_pallas():
    """(B, N, D) = (2, 40, 64), 4 heads, as tests/test_pallas_ops.py:210.
    f32 at 1e-5; bf16 at 1e-2, since both cast the probabilities to bf16
    but sum in different orders, and the output is rounded to bf16
    (2^-8 relative)."""
    q, k, v = _qkv((2, 40, 64), 1)
    want = j_aifi_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            num_heads=4, interpret=True)
    got = attention.aifi_attention(*map(torch.from_numpy, (q, k, v)), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    qb, kb, vb = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    want16 = j_aifi_attention(jnp.asarray(qb), jnp.asarray(kb),
                              jnp.asarray(vb), num_heads=4, interpret=True)
    got16 = attention.aifi_attention(
        *(torch.from_numpy(a.astype(np.float32)).bfloat16()
          for a in (qb, kb, vb)), 4)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_attention_wrappers_validate():
    q = torch.zeros(2, 4, 8, 16)
    with pytest.raises(ValueError, match="share one"):
        attention.fused_attention(q, q, q[:, :, :4])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention.fused_attention(q.half(), q.half(), q.half())
    x = torch.zeros(2, 8, 30)
    with pytest.raises(ValueError, match="not divisible"):
        attention.aifi_attention(x, x, x, 4)


# ------------------------------------------------------------------- gather


def _gather_inputs(seed, B=2, L=40, C=16, T=24):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(B, L, C)).astype(np.float32)
    idx = rng.integers(0, L, (B, T)).astype(np.int32)
    idx[0, :3] = (-3, L + 5, L)       # out of range: clipped to [0, L-1]
    return flat, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onehot_gather_matches_pallas(dtype):
    """Exact: a row copy, and the one-hot matmul selects one term."""
    flat, idx = _gather_inputs(2)
    if dtype == "bfloat16":
        flat = flat.astype(ml_dtypes.bfloat16).astype(np.float32)
    want = pallas_onehot_gather(jnp.asarray(flat, dtype), jnp.asarray(idx),
                                0, True)
    before = gather.LAUNCHES
    got = gather.onehot_gather(
        torch.from_numpy(flat).to(getattr(torch, dtype)),
        torch.from_numpy(idx))
    assert gather.LAUNCHES == before
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_onehot_gather_validates():
    flat = torch.zeros(2, 10, 4)
    with pytest.raises(ValueError, match="want flat"):
        gather.onehot_gather(flat, torch.zeros(3, 5, dtype=torch.int32))
    with pytest.raises(ValueError, match="want flat"):
        gather.onehot_gather(flat[0], torch.zeros(2, 5, dtype=torch.int32))


# --------------------------------------------------------------- deformable


def _deformable_inputs(seed, B=2, Q=7, h=4, d=8):
    rng = np.random.default_rng(seed)
    shapes = [(8, 10), (4, 5)]
    levels = [rng.normal(size=(B, H, W, h, d)).astype(np.float32)
              for H, W in shapes]
    loc = rng.uniform(-0.2, 1.2, (B, Q, 8, 2)).astype(np.float32)
    # on-grid points, loc * size + 0.5 = n + 0.5 exactly: truncation and
    # round-half-to-even part ways here
    loc[0, 0, :4, 0] = np.array([1, 3, 5, 7], np.float32) / 10
    loc[0, 0, :4, 1] = np.array([1, 3, 5, 7], np.float32) / 8
    loc[0, 1, 4:, 0] = np.array([1, 3, 0, 4], np.float32) / 5
    logits = rng.normal(size=(B, Q, h, 8)).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return levels, loc, w


def test_deformable_discrete_matches_reference():
    """Same locations and weights through both; atol 1e-6 (the rows are
    exact, only the f32 weighted sum over 8 points rounds)."""
    levels, loc, w = _deformable_inputs(3)
    want = jdeform.ms_deformable_attention_shared(
        [jnp.asarray(v) for v in levels], jnp.asarray(loc), jnp.asarray(w),
        [4, 4], method="discrete")
    got = deformable.ms_deformable_attention_shared(
        [torch.from_numpy(v) for v in levels], torch.from_numpy(loc),
        torch.from_numpy(w), [4, 4], method="discrete")
    assert got.shape == (2, 7, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_discrete_indices_truncate_and_clamp():
    """HF discrete index trunc(loc * size + 0.5), clamped into its level,
    plus the level's base row in the level-concat table."""
    loc = torch.tensor([[[[0.25, 0.15], [-0.3, 1.4],
                          [0.5, 0.5], [0.99, 0.0]]]])
    idx = deformable.discrete_indices([(4, 2), (2, 3)], loc, [2, 2])
    # level 0 (H=4, W=2): x=1, y=1 -> 3; x=0 (clamped), y=3 (clamped) -> 6
    # level 1 (H=2, W=3), base 8: x=int(2.0)=2, y=int(1.5)=1 -> 13;
    # x=int(3.47)->2, y=0 -> 10
    assert idx.dtype == torch.int32
    assert idx.tolist() == [[[3, 6, 13, 10]]]


def test_deformable_other_methods_raise():
    """'default' (bilinear) and 'discrete' are the methods; any other name
    raises."""
    levels, loc, w = _deformable_inputs(4)
    with pytest.raises(NotImplementedError, match="'default'"):
        deformable.ms_deformable_attention_shared(
            [torch.from_numpy(v) for v in levels], torch.from_numpy(loc),
            torch.from_numpy(w), [4, 4], method="bicubic")
