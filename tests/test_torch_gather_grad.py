"""The gradient of pautdx_torch's one-hot row gather, the bf16 forms of
both gathers' plain versions and backwards, held to the JAX package on the
CPU, and the tile plans of the gathers' forward and backward kernels.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas kernel runs in interpret mode. The backward kernel itself is held to
the plain version on the card by tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.ops import deformable as jdeform
from pautdx.ops.pallas_gather import (
    pallas_onehot_gather, pallas_weighted_gather,
)
from pautdx_torch.ops import deformable, gather
from torch_threads import one_torch_thread  # noqa: F401


def _onehot_inputs(seed, B=2, L=30, C=8, T=40, low=0, high=None):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(B, L, C)).astype(np.float32)
    idx = rng.integers(low, L if high is None else high, (B, T)).astype(
        np.int32)
    g = rng.normal(size=(B, T, C)).astype(np.float32)
    return flat, idx, g


def _torch_grad(flat, idx, g):
    tf = torch.from_numpy(flat).requires_grad_()
    before = gather.ONEHOT_BACKWARD_LAUNCHES
    out = gather.onehot_gather(tf, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g))
    assert gather.ONEHOT_BACKWARD_LAUNCHES == before  # the CPU path: none
    return out.detach().numpy(), tf.grad.numpy()


def test_onehot_gather_grad_matches_pallas():
    """In-range indices, rows hit many times: the output and the VJP of the
    Pallas kernel's custom_vjp (a scatter-add) at 1e-6 relative, since the
    sums over a row's taps run in another order."""
    flat, idx, g = _onehot_inputs(0)
    out, vjp = jax.vjp(
        lambda f: pallas_onehot_gather(f, jnp.asarray(idx), 0, True),
        jnp.asarray(flat))
    (want,) = vjp(jnp.asarray(g))
    got_out, got = _torch_grad(flat, idx, g)
    np.testing.assert_array_equal(got_out, np.asarray(out))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_onehot_gather_grad_clips_out_of_range():
    """Indices past both ends: the forward reads the clipped rows, so the
    gradient goes to them. The reference's backward is not the yardstick
    here: ``pallas_gather.py:111`` scatters at the raw index, so -3 wraps
    to row L-3 and L+2 is dropped, while its forward read rows 0 and L-1.
    The clipped definition is written out with numpy."""
    L = 30
    flat, idx, g = _onehot_inputs(1, L=L, low=-4, high=L + 4)
    idx[:, :2] = (-3, L + 2)
    want = np.zeros_like(flat)
    for b in range(flat.shape[0]):
        np.add.at(want[b], np.clip(idx[b], 0, L - 1), g[b])
    out, got = _torch_grad(flat, idx, g)
    np.testing.assert_array_equal(
        out, np.take_along_axis(flat, np.clip(idx, 0, L - 1)[..., None], 1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[:, 0].any() and got[:, L - 1].any()


@pytest.mark.parametrize("pile_up", [False, True])
def test_onehot_backward_reference_equals_autograd(pile_up):
    """The plain backward the kernel is held to on the card equals
    autograd of the plain forward; the pile-up sends every tap to one
    row."""
    flat, idx, g = _onehot_inputs(2, low=-3, high=33)
    if pile_up:
        idx[:] = 7
    tf = torch.from_numpy(flat).requires_grad_()
    gather.onehot_gather_reference(tf, torch.from_numpy(idx)).backward(
        torch.from_numpy(g))
    got = gather.onehot_gather_backward_reference(
        torch.from_numpy(g), torch.from_numpy(idx), flat.shape[1])
    np.testing.assert_allclose(got.numpy(), tf.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_deformable_discrete_grads_match_reference():
    """method="discrete" differentiates like the JAX function (the XLA
    gather on the CPU, whose Pallas branch is the one-hot kernel above):
    the gradients to the value levels and the attention weights at 1e-5.
    The locations get none in either (the nearest index is a step)."""
    from tests.test_torch_ops import _deformable_inputs

    levels, loc, w = _deformable_inputs(5)
    probe = np.random.default_rng(6).normal(size=(2, 7, 32)).astype(
        np.float32)

    def jloss(v0, v1, w_):
        out = jdeform.ms_deformable_attention_shared(
            [v0, v1], jnp.asarray(loc), w_, [4, 4], method="discrete")
        return jnp.sum(out * probe)

    grads = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (*levels, w)))
    tv = [torch.from_numpy(v).requires_grad_() for v in levels]
    tw = torch.from_numpy(w).requires_grad_()
    out = deformable.ms_deformable_attention_shared(
        tv, torch.from_numpy(loc), tw, [4, 4], method="discrete")
    (out * torch.from_numpy(probe)).sum().backward()
    for t, want in zip((*tv, tw), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", [8, 128])
@pytest.mark.parametrize("L", [1, 50, 2000, 8400, 20000])
def test_scatter_tiles_cover_the_table_once(L, C):
    """The backward kernels' d_flat tiles: each fits the 227 KB of shared
    memory a block may have, the (row range, channel slice) blocks cover
    every row and channel of a frame exactly once, and a table that fits
    is one range (its taps are walked once per slice)."""
    cs, rows = gather.scatter_tiles(L, C)
    assert cs % 4 == 0 and C % cs == 0 and 1 <= rows <= L
    assert rows * cs * 4 <= 227 * 1024
    hits = np.zeros((L, C), np.int32)
    for r0 in range(0, L, rows):           # the kernel's blockIdx.x
        for c0 in range(0, C, cs):         # blockIdx.y
            hits[r0:r0 + rows, c0:c0 + cs] += 1
    assert (hits == 1).all()
    assert (rows == L) == (L * cs * 4 <= 227 * 1024)


def _forward_hits(B, T, row_bytes, plan):
    """How often the one-hot forward's blocks take each (frame, tap, piece
    of the row), walking the tiles as the kernel does: block i takes tiles
    i, i + blocks, ..., tile (b * ceil(T / tt) + tile of T) * pieces +
    piece."""
    pieces = -(-row_bytes // plan.cb)
    per_frame = -(-T // plan.tt) * pieces
    assert plan.tiles == B * per_frame
    hits = np.zeros((B, T, pieces), np.int32)
    walks = -(-plan.tiles // plan.blocks)  # tiles of the longest walk
    ids = (np.arange(plan.blocks)[:, None]
           + plan.blocks * np.arange(walks)[None, :]).ravel()
    b, r = np.divmod(ids[ids < plan.tiles], per_frame)
    ti, piece = np.divmod(r, pieces)
    for db in range(plan.tt):              # every tap of each tile
        t = ti * plan.tt + db
        keep = t < T
        np.add.at(hits, (b[keep], t[keep], piece[keep]), 1)
    return hits


# (SMs, shared memory bytes of one): an H100 SXM and an H100 PCIe
_CARDS = [(132, 233472), (114, 233472)]


@pytest.mark.parametrize("sms,sm_smem", _CARDS)
@pytest.mark.parametrize("row_bytes", [256, 512])
@pytest.mark.parametrize("B,T", [(128, 1200), (4, 2736), (16, 1200),
                                 (50, 1200), (16, 2736), (3, 1), (3, 37),
                                 (4, 1201), (70000, 3)])
def test_forward_tiles_cover_every_tap_once(B, T, row_bytes, sms, sm_smem):
    """The one-hot forward's plan at the paths' (B, T) (serving b128, the
    denoising step's b4 and b16, training b16, a temporal b50), ragged T
    and more frames than a grid's 65,535, for bf16 and f32 rows of 128
    channels, on cards of 132 and 114 SMs: every (frame, tap) is one
    block's exactly once, the grid keeps CUDA's limits (one dimension of at
    most 2**31 - 1 blocks) and the SMs' room, a block's buffers fit its
    shared memory, and the launch has a few tiles for every SM wherever
    tiles can shrink."""
    plan = gather.forward_tiles(B, T, row_bytes, sms, sm_smem)
    assert plan.cb == row_bytes and 1 <= plan.tt <= gather.MAX_TILE_TAPS
    assert plan.tt * plan.cb <= gather.TILE_BYTES and plan.stages >= 1
    assert plan.smem == plan.stages * plan.tt * plan.cb
    assert plan.smem <= gather.SMEM_BYTES - 1024
    assert 1 <= plan.blocks <= min(plan.tiles, 2**31 - 1,
                                   sms * gather.BLOCKS_PER_SM)
    assert plan.blocks == plan.tiles or \
        plan.blocks // sms * (plan.smem + 1024) <= sm_smem
    assert (_forward_hits(B, T, row_bytes, plan) == 1).all()
    assert plan.tiles >= gather.FILL_PER_SM * sms or \
        plan.tt <= gather.MIN_TILE_TAPS


@pytest.mark.parametrize("row_bytes", [73744, 131072, 1048576])
def test_forward_tiles_cut_rows_that_outgrow_a_tile(row_bytes):
    """A row that alone outgrows ``TILE_BYTES`` (just past it, 128 KB, 1
    MB) is cut into pieces of 16 bytes' multiples that cover it once, one
    tap a tile; every block's buffers fit 227 KB."""
    B, T = 3, 37
    plan = gather.forward_tiles(B, T, row_bytes, *_CARDS[0])
    assert plan.cb % 16 == 0 and 0 < plan.cb < row_bytes
    assert plan.tt == 1 and plan.smem <= gather.SMEM_BYTES - 1024
    assert (_forward_hits(B, T, row_bytes, plan) == 1).all()
    starts = np.arange(0, row_bytes, plan.cb)   # the pieces tile the row
    assert starts[-1] < row_bytes <= starts[-1] + plan.cb


def _weighted_hits(B, T, plan):
    """How often the weighted forward's warps take each tap, and how many
    groups each block takes, walking the groups as the kernel does: warp w
    of block b takes groups w * blocks + b, that plus blocks * warps, ...,
    group g the taps g * group .. (g + 1) * group - 1 that exist."""
    taps = B * T
    assert plan.groups == -(-taps // plan.group)
    nwarps = plan.blocks * plan.warps
    hits = np.zeros(taps, np.int32)
    per_block = np.zeros(plan.blocks, np.int64)
    for b in range(plan.blocks):
        for w in range(plan.warps):
            for g in range(w * plan.blocks + b, plan.groups, nwarps):
                hits[g * plan.group:(g + 1) * plan.group] += 1
                per_block[b] += 1
    return hits, per_block


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("row_bytes", [256, 512])
@pytest.mark.parametrize("K", [1, 3, 4, 5, 9])
@pytest.mark.parametrize("B,T", [(16, 1200), (4, 2736), (50, 1200),
                                 (4, 1201), (70000, 3)])
def test_weighted_plan_covers_every_tap_once(B, T, K, row_bytes, sms):
    """The weighted forward's plan at the paths' (B, T) (training b16, the
    denoising step's b4, a temporal step's b50), a ragged T and 70,000
    frames, for K = 1, 3, 4 (the paths'), 5, 9 corners and bf16 and f32
    rows of 128 channels, on cards of 132 and 114 SMs: every tap is one
    warp's exactly once; a group's entries fit a warp's 32 lanes; the
    blocks keep the kernel's launch bounds (at most 8 warps, the SMs'
    resident warps) and come in whole rounds of the SMs (or one a group),
    each with a group, their shares of the groups within one of each
    other; a group holds a multiple of the taps a warp takes at a time
    where it can, and the groups fill at most ``WEIGHTED_FILL`` of one
    wave of those warps, or take the size nearest ``MANY_WAVES_GROUP``
    where none fits."""
    plan = gather.weighted_plan(B, T, K, row_bytes, sms)
    assert 1 <= plan.group and plan.group * K <= 32
    assert 1 <= plan.warps <= 8
    assert 1 <= plan.blocks <= sms * gather.SM_WARPS // plan.warps
    assert plan.blocks <= plan.groups
    assert plan.blocks % sms == 0 or plan.blocks == plan.groups
    hits, per_block = _weighted_hits(B, T, plan)
    assert (hits == 1).all()
    assert per_block.min() >= 1 and per_block.max() - per_block.min() <= 1
    most = min(gather.MAX_GROUP, 32 // K)
    sizes = [g for g in range(1, most + 1)
             if g % gather.taps_a_pass(row_bytes) == 0] or [most]
    assert plan.group in sizes
    assert plan.groups <= gather.WEIGHTED_FILL * sms * gather.SM_WARPS or \
        plan.group == min(sizes,
                          key=lambda g: abs(g - gather.MANY_WAVES_GROUP))


def test_weighted_plan_grid_follows_the_card():
    """The grid comes from the card's SM count: a temporal step's b50 fills
    every SM's resident warps on a card of 132, 114 or 66 SMs, a launch of
    a few taps takes one block a group, and a card of twice the SMs takes
    smaller groups at a denoising step's b4; K = 40 takes one tap a group;
    a 20-channel bf16 row (40 bytes, five 8-byte pieces, 8 lanes) takes 4
    taps at a time."""
    for sms in (132, 114, 66):
        plan = gather.weighted_plan(50, 1200, 4, 512, sms)
        assert plan.blocks * plan.warps == sms * gather.SM_WARPS
        assert gather.weighted_plan(2, 5, 4, 512, sms).blocks == 10
    assert gather.weighted_plan(4, 2736, 4, 512, 264).group < \
        gather.weighted_plan(4, 2736, 4, 512, 132).group
    assert gather.weighted_plan(4, 37, 40, 512, 132).group == 1
    assert gather.taps_a_pass(40) == 4 and gather.taps_a_pass(256) == 2
    assert gather.taps_a_pass(512) == 1 and gather.taps_a_pass(32768) == 1


def _bf16(a):
    """numpy f32 -> (torch bf16, the same values as numpy f32)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, t.float().numpy()


def _near(got, want, ulps):
    """|got - want| within ``ulps`` bf16 ulps of want's largest magnitude."""
    want = np.asarray(want, np.float64)
    tol = ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_weighted_gather_bf16_matches_pallas(w_dtype):
    """A bf16 table: the plain forward against ``pallas_weighted_gather``
    (w rounded to bf16, an f32 sum, a bf16 result) within one bf16 ulp of
    the output's largest magnitude; the plain backward (f32 sums, rounded
    once) against ``jax.vjp`` of the Pallas kernel (sums in bf16) within
    four, and against the exact sums of the same rounded operands within
    one. d_w comes back in w's dtype."""
    rng = np.random.default_rng(13)
    B, L, C, T, K = 2, 30, 8, 40, 4
    flat, flat_np = _bf16(rng.normal(size=(B, L, C)))
    idx = rng.integers(-3, L + 3, (B, T, K)).astype(np.int32)
    w = torch.from_numpy(rng.uniform(0, 1, (B, T, K)).astype(np.float32))
    w = w.to(getattr(torch, w_dtype))
    g, g_np = _bf16(rng.normal(size=(B, T, C)))
    jw = jnp.asarray(w.float().numpy(), w_dtype)
    want, vjp = jax.vjp(
        lambda f, w_: pallas_weighted_gather(f, jnp.asarray(idx), w_, 0,
                                             True),
        jnp.asarray(flat_np, jnp.bfloat16), jw)
    got = gather.weighted_gather(flat, torch.from_numpy(idx), w)
    assert got.dtype == torch.bfloat16
    _near(got.float().numpy(), np.asarray(want, np.float32), 1)
    d_flat, d_w = gather.weighted_gather_backward_reference(
        flat, torch.from_numpy(idx), w, g)
    assert d_flat.dtype == torch.bfloat16 and d_w.dtype == w.dtype
    j_flat, j_w = vjp(jnp.asarray(g_np, jnp.bfloat16))
    _near(d_flat.float().numpy(), np.asarray(j_flat, np.float32), 4)
    _near(d_w.float().numpy(), np.asarray(j_w, np.float32), 4)
    # the exact sums of the rounded operands, in float64
    j = np.clip(idx, 0, L - 1)
    w64 = w.bfloat16().double().numpy()
    e_flat = np.zeros((B, L, C))
    for b in range(B):
        np.add.at(e_flat[b], j[b].reshape(-1),
                  (w64[b][..., None] * g_np[b][:, None, :].astype(np.float64))
                  .reshape(-1, C))
    rows = np.take_along_axis(flat_np.astype(np.float64),
                              j.reshape(B, -1)[..., None], 1)
    e_w = (rows.reshape(B, T, K, C) * g_np[:, :, None, :]).sum(-1)
    _near(d_flat.float().numpy(), e_flat, 1)
    _near(d_w.float().numpy(), e_w, 1)


def test_onehot_backward_bf16_matches_pallas():
    """A bf16 gradient: the plain one-hot backward (an f32 sum, rounded
    once to bf16) against ``jax.vjp`` of ``pallas_onehot_gather`` (a bf16
    scatter-add) within four bf16 ulps of the largest magnitude, and
    against the exact sums within one; 100 taps a row on average, where
    the Pallas VJP's bf16 sums drift (2.6 ulps with this seed)."""
    flat, idx, g = _onehot_inputs(14, L=4, C=8, T=400)
    gt, g_np = _bf16(g)
    _, vjp = jax.vjp(lambda f: pallas_onehot_gather(f, jnp.asarray(idx), 0,
                                                    True),
                     jnp.asarray(flat, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(g_np, jnp.bfloat16))
    got = gather.onehot_gather_backward_reference(gt, torch.from_numpy(idx),
                                                  4)
    assert got.dtype == torch.bfloat16
    _near(got.float().numpy(), np.asarray(want, np.float32), 4)
    exact = np.zeros((2, 4, 8))
    for b in range(2):
        np.add.at(exact[b], idx[b], g_np[b].astype(np.float64))
    _near(got.float().numpy(), exact, 1)
