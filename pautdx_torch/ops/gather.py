"""Row gathers of the deformable attention: the CUDA kernels
``csrc/onehot_gather.cu`` and ``csrc/weighted_gather.cu``, their plain
PyTorch versions and their launch counters.

- :func:`onehot_gather` is the counterpart of
  ``pautdx/ops/pallas_gather.py::pallas_onehot_gather`` (discrete decoder)
  with its VJP. It is a ``torch.autograd.Function``: the forward launches
  ``csrc/onehot_gather.cu``, the backward (a scatter-add of g into the
  clipped rows) ``csrc/weighted_gather.cu``'s shared-memory scatter.
- :func:`weighted_gather` is the counterpart of
  ``pallas_gather.py::pallas_weighted_gather`` with its VJP (bilinear
  decoder). It is a ``torch.autograd.Function`` whose forward and backward
  both launch ``csrc/weighted_gather.cu`` on the card.

The one-hot forward cuts the taps into tiles of one frame's taps
(:func:`forward_tiles`), which a persistent grid walks: a block brings a
tile's rows into shared memory by Hopper's bulk asynchronous copies, all in
flight together, and writes the tile out from there by one bulk copy. The
weighted forward deals groups of a few taps to warps (:func:`weighted_plan`):
a warp loads its group's indices and weights once and keeps a tap's corner
rows in flight together, by plain loads. The backwards tile the table
instead (:func:`scatter_tiles`). Every grid is sized from the card's SMs.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. The kernels of ``weighted_gather.cu`` take
float32 and bfloat16 tables and gradients (w and d_w either on their own),
sum in f32 and round each output once; the plain versions repeat that
arithmetic. ``LAUNCHES`` (the one-hot gather),
``ONEHOT_BACKWARD_LAUNCHES``, ``WEIGHTED_LAUNCHES`` and
``WEIGHTED_BACKWARD_LAUNCHES`` count calls that launch a kernel and nothing
else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from pautdx_torch.ops import _build

LAUNCHES = 0
ONEHOT_BACKWARD_LAUNCHES = 0
WEIGHTED_LAUNCHES = 0
WEIGHTED_BACKWARD_LAUNCHES = 0

# the shared memory one block may opt into on sm_90 (227 KB), and the
# widest channel slice of a backward tile
SMEM_BYTES = 232448
MAX_SLICE = 16
# the one-hot forward's plan (:func:`forward_tiles`): the bytes of a tile's
# buffer at most, unless one row alone needs more; the most and the fewest
# taps of a tile; the tiles a launch should have for each SM at least, below
# which tiles are halved; the tiles a block keeps in flight and the blocks
# an SM holds at most (the best of ``kernel_ab.py tiles`` on an H100)
TILE_BYTES = 73728
MAX_TILE_TAPS = 32
MIN_TILE_TAPS = 4
FILL_PER_SM = 8
STAGES = 2
BLOCKS_PER_SM = 16
# the weighted forward's plan (:func:`weighted_plan`): warps a block, the
# warps an SM holds (the kernel's launch bounds: 4 blocks of 8 warps at 64
# registers a thread), the share of them the groups should fill, and the
# fewest and most taps of a warp's group (the best of ``kernel_ab.py
# wplans`` on an H100)
WEIGHTED_WARPS = 8
SM_WARPS = 32
WEIGHTED_FILL = 0.8
MIN_GROUP = 1
MAX_GROUP = 6
# the taps of a group where even ``MAX_GROUP`` leaves more groups than one
# wave takes: each warp then walks several groups, the next one's indices
# loaded during this one's rows
MANY_WAVES_GROUP = 4
# the element types of weighted_gather.cu's kernels, as their C codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# flat, idx, out, B, L, T, row bytes, tt, cb, stages, blocks, stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# flat, idx, w, out, B, L, T, K, C, dtype, wdtype, group, warps, blocks,
# stream
_WEIGHTED_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
    ctypes.c_void_p]
# flat, idx, w, g, d_flat, d_w, B, L, T, K, C, cs, rows, dtype, wdtype,
# sms, stream
_WEIGHTED_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
    ctypes.c_void_p]
# g, idx, d_flat, B, L, T, C, cs, rows, dtype, stream
_ONEHOT_BWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]


def scatter_tiles(L: int, C: int) -> Tuple[int, int]:
    """(cs, rows) of the backward kernels' d_flat tiles: one block owns
    ``rows`` rows by ``cs`` channels of a frame's (L, C) table in shared
    memory. cs is the widest multiple of 4 up to ``MAX_SLICE`` that divides
    C (a multiple of 4); the L rows split into as few equal ranges as fit
    ``SMEM_BYTES``, since a block walks all its frame's taps."""
    cs = max(c for c in range(4, min(C, MAX_SLICE) + 1, 4) if C % c == 0)
    ranges = -(-L // (SMEM_BYTES // (4 * cs)))
    return cs, -(-L // ranges)


class ForwardPlan(NamedTuple):
    """The launch of the one-hot forward: tiles of ``tt`` taps of one frame
    by ``cb`` bytes of each of their rows, ``tiles`` of them, walked by
    ``blocks`` blocks (block i takes tiles i, i + blocks, ...) that keep
    ``stages`` tiles each in flight in ``smem`` bytes of shared memory. Tile
    (b * ceil(T / tt) + tile of T) * pieces + piece of the row."""
    tt: int
    cb: int
    stages: int
    blocks: int
    tiles: int
    smem: int


def forward_tiles(B: int, T: int, row_bytes: int, sms: int,
                  sm_smem: int) -> ForwardPlan:
    """The plan of the one-hot forward for B frames of T taps of
    ``row_bytes``-byte rows (a multiple of 16) on a card of ``sms`` SMs
    with ``sm_smem`` bytes of shared memory each. A row is cut into pieces
    of cb bytes only where it alone outgrows ``TILE_BYTES``; a tile holds as
    many taps as fit it, at most ``MAX_TILE_TAPS``, halved while the launch
    has fewer than ``FILL_PER_SM`` tiles an SM, down to ``MIN_TILE_TAPS``;
    a block keeps ``STAGES`` tiles in flight where they fit, and the grid
    is as many blocks as the SMs hold, at most one a tile."""
    cb = min(row_bytes, TILE_BYTES)
    pieces = -(-row_bytes // cb)
    tt = max(1, min(MAX_TILE_TAPS, TILE_BYTES // cb))
    while tt > MIN_TILE_TAPS and B * -(-T // tt) * pieces < FILL_PER_SM * sms:
        tt = max(MIN_TILE_TAPS, tt // 2)
    tiles = B * -(-T // tt) * pieces
    stages = max(1, min(STAGES, (SMEM_BYTES - 1024) // (tt * cb)))
    smem = stages * tt * cb
    per_sm = min(BLOCKS_PER_SM, max(1, sm_smem // (smem + 1024)))
    return ForwardPlan(tt, cb, stages, min(tiles, sms * per_sm), tiles, smem)


class WeightedPlan(NamedTuple):
    """The launch of the weighted forward: groups of ``group`` consecutive
    taps, ``groups`` of them, one warp's each, walked by ``blocks`` blocks
    of ``warps`` warps (warp w of block b takes groups w * blocks + b, that
    plus blocks * warps, ...: the blocks take turns)."""
    group: int
    warps: int
    blocks: int
    groups: int


def taps_a_pass(row_bytes: int) -> int:
    """The taps a warp of the weighted forward takes at a time: a row's
    16-byte pieces (8-byte where ``row_bytes`` is not a multiple of 16)
    are walked by S lanes, S the pieces rounded up to a power of two, at
    most 32 (``launch_fwd`` in ``weighted_gather.cu``)."""
    pieces = row_bytes // (16 if row_bytes % 16 == 0 else 8)
    lanes = 1
    while lanes < min(pieces, 32):
        lanes *= 2
    return 32 // lanes


def weighted_plan(B: int, T: int, K: int, row_bytes: int,
                  sms: int) -> WeightedPlan:
    """The plan of the weighted forward for B frames of T taps of K
    corners, rows of ``row_bytes`` bytes, on a card of ``sms`` SMs. A
    group's K corners a tap fill at most a warp's 32 lanes (one tap where
    K > 32). Within that and [``MIN_GROUP``, ``MAX_GROUP``], a group takes
    the fewest taps (a multiple of the taps a warp takes at a time, where
    it can) with which the groups fill at most ``WEIGHTED_FILL`` of one
    wave of the card's resident warps, ``sms * SM_WARPS``: a small launch
    spreads over every SM, a larger one loads more taps' indices at once;
    where no group size fits, the one nearest ``MANY_WAVES_GROUP``. The
    grid is whole rounds of the SMs, blocks of ``WEIGHTED_WARPS`` warps,
    as few rounds as give every group a warp, at most as many as the SMs
    hold (then warps take several groups) and at most one block a group:
    the blocks take groups in turn, so every SM gets an equal share."""
    taps = B * T
    most = max(1, min(MAX_GROUP, 32 // K))
    step = taps_a_pass(row_bytes)
    sizes = [g for g in range(max(1, min(MIN_GROUP, most)), most + 1)
             if g % step == 0] or [most]
    fits = [g for g in sizes
            if -(-taps // g) <= WEIGHTED_FILL * sms * SM_WARPS]
    group = fits[0] if fits else min(
        sizes, key=lambda g: abs(g - MANY_WAVES_GROUP))
    groups = -(-taps // group)
    rounds = max(1, min(SM_WARPS // WEIGHTED_WARPS,
                        -(-groups // (sms * WEIGHTED_WARPS))))
    return WeightedPlan(group, WEIGHTED_WARPS, min(sms * rounds, groups),
                        groups)


@functools.lru_cache(maxsize=None)
def _sm_limits(index: int) -> Tuple[int, int]:
    """(SMs, shared memory bytes of one) of card ``index``."""
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count, p.shared_memory_per_multiprocessor


def onehot_gather_reference(flat: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """flat (B, L, C); idx (B, T) -> (B, T, C) = flat[b, clip(idx, 0, L-1)]."""
    L = flat.shape[1]
    i = idx.clamp(0, L - 1).long()
    return torch.take_along_dim(flat, i[..., None], dim=1)


def onehot_gather_backward_reference(g: torch.Tensor, idx: torch.Tensor,
                                     L: int) -> torch.Tensor:
    """g (B, T, C); idx (B, T) -> d_flat (B, L, C) in g's dtype: row j of
    frame b is the sum of g[b, t] over the taps t with clip(idx[b, t], 0,
    L-1) = j, the VJP of :func:`onehot_gather_reference`, summed in f32
    and rounded once, as the kernel sums."""
    B, T, C = g.shape
    rows = (idx.clamp(0, L - 1).long()
            + L * torch.arange(B, device=idx.device)[:, None])
    d_flat = torch.zeros((B * L, C), dtype=torch.float32, device=g.device)
    d_flat.index_add_(0, rows.reshape(-1), g.reshape(-1, C).float())
    return d_flat.reshape(B, L, C).to(g.dtype)


def onehot_gather_backward(g: torch.Tensor, idx: torch.Tensor,
                           L: int) -> torch.Tensor:
    """The backward kernel of :func:`onehot_gather`: d_flat (B, L, C) in
    g's dtype for the output gradient g (B, T, C), float32 or bfloat16,
    every element written by the kernel. Its f32 sums run in shared-memory
    atomics, in an order that changes from run to run."""
    global ONEHOT_BACKWARD_LAUNCHES
    if g.device.type != "cuda" or idx.device != g.device:
        raise RuntimeError(f"onehot_gather_backward: no kernel for "
                           f"{g.device} and {idx.device}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"onehot_gather_backward: the kernel takes a float32 "
                        f"or bfloat16 gradient, got {g.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"onehot_gather_backward: idx must be int32, got "
                        f"{idx.dtype}")
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("onehot_gather_backward: g and idx must be "
                         "contiguous")
    B, T, C = g.shape
    if C % 4 or g.data_ptr() % 16:
        raise ValueError(f"onehot_gather_backward: the kernel moves 4-element "
                         f"pieces; got C={C} or g off 16-byte alignment")
    d_flat = torch.empty((B, L, C), dtype=g.dtype, device=g.device)
    if d_flat.numel() == 0:
        return d_flat
    fn = _build.function("weighted_gather", "pautdx_onehot_gather_backward",
                         _ONEHOT_BWD_ARGTYPES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), idx.data_ptr(), d_flat.data_ptr(), B, L, T, C,
                *scatter_tiles(L, C), _DTYPES[g.dtype], stream)
        ONEHOT_BACKWARD_LAUNCHES += 1
    _build.check(rc, "onehot_gather_backward")
    return d_flat


def _onehot_forward(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if idx.dtype != torch.int32:
        raise TypeError(f"onehot_gather: idx must be int32, got {idx.dtype}")
    if flat.element_size() not in (2, 4) or flat.is_complex():
        raise TypeError(f"onehot_gather: unsupported dtype {flat.dtype}")
    if not (flat.is_contiguous() and idx.is_contiguous()):
        raise ValueError("onehot_gather: flat and idx must be contiguous")
    B, L, C = flat.shape
    T = idx.shape[1]
    row_bytes = C * flat.element_size()
    if row_bytes % 16 or flat.data_ptr() % 16:
        raise ValueError(f"onehot_gather: the kernel copies 16-byte pieces; "
                         f"got {row_bytes}-byte rows at an address "
                         f"{flat.data_ptr() % 16} bytes past 16-byte "
                         f"alignment")
    out = torch.empty((B, T, C), dtype=flat.dtype, device=flat.device)
    if out.numel() == 0:
        return out
    fn = _build.function("onehot_gather", "pautdx_onehot_gather",
                         _ARGTYPES)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        plan = forward_tiles(B, T, row_bytes, *_sm_limits(flat.device.index))
        rc = fn(flat.data_ptr(), idx.data_ptr(), out.data_ptr(), B, L, T,
                row_bytes, plan.tt, plan.cb, plan.stages, plan.blocks, stream)
        LAUNCHES += 1
    _build.check(rc, "onehot_gather")
    return out


class _OnehotGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.rows = flat.shape[1]
        return _onehot_forward(flat, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        # looked up in the module at every call, like the forward wrapper
        return onehot_gather_backward(g.contiguous(), idx, ctx.rows), None


def onehot_gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (B, L, C) of any 2- or 4-byte dtype; idx (B, T) int32 ->
    (B, T, C) rows, copied bit for bit. Indices are clipped to [0, L-1] as
    the TPU kernel clips them. The kernel moves rows by bulk copies of
    16-byte multiples, so on the card a row must be a multiple of 16 bytes
    and ``flat`` 16-byte aligned (C=128 on the serving path: 256-byte
    rows).

    Differentiable in ``flat``: the gradient of a row is the sum of the
    output gradients of the taps that read it, at the clipped index (on the
    card a float32 or bfloat16 gradient)."""
    if flat.dim() != 3 or idx.dim() != 2 or idx.shape[0] != flat.shape[0]:
        raise ValueError(f"onehot_gather: want flat (B, L, C) and idx (B, T),"
                         f" got {tuple(flat.shape)} and {tuple(idx.shape)}")
    if idx.device != flat.device:
        raise ValueError("onehot_gather: flat and idx on different devices")
    if flat.shape[1] == 0:
        raise ValueError("onehot_gather: empty table")
    if flat.device.type == "cpu":
        return onehot_gather_reference(flat, idx)
    if flat.device.type != "cuda":
        raise RuntimeError(f"onehot_gather: no kernel for {flat.device}")
    return _OnehotGather.apply(flat, idx)


# ------------------------------------------------------------------ weighted


def weighted_gather_reference(flat: torch.Tensor, idx: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """flat (B, L, C); idx (B, T, K); w (B, T, K) -> (B, T, C) in flat's
    dtype = sum_k w[..., k] * flat[b, clip(idx[..., k], 0, L-1)], with
    autograd's gradients to ``flat`` and ``w``. As the TPU kernel does, w
    is rounded to flat's dtype; the products and their sum are f32 and the
    result is rounded once."""
    B, T, K = idx.shape
    L = flat.shape[1]
    i = idx.clamp(0, L - 1).long().reshape(B, T * K, 1)
    rows = torch.take_along_dim(flat, i, dim=1).reshape(B, T, K, -1)
    wr = w.to(flat.dtype).float()[..., None]
    return (rows.float() * wr).sum(dim=2).to(flat.dtype)


def weighted_gather_backward_reference(
        flat: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The VJP of ``pallas_gather.py:196-210`` written out: d_flat is the
    scatter-add of w_k * g into the clipped rows (w rounded to g's dtype
    first), d_w[..., k] = <g, flat[clip(idx_k)]>; both summed in f32, as
    the kernels sum, and rounded once to flat's and w's dtype."""
    B, T, K = idx.shape
    L, C = flat.shape[1:]
    i = idx.clamp(0, L - 1).long()
    rows = i + L * torch.arange(B, device=idx.device)[:, None, None]
    gf = g.float()[:, :, None, :]
    d_flat = torch.zeros((B * L, C), dtype=torch.float32, device=g.device)
    d_flat.index_add_(0, rows.reshape(-1),
                      (w.to(g.dtype).float()[..., None] * gf).reshape(-1, C))
    picked = flat.reshape(B * L, C)[rows.reshape(-1)].reshape(B, T, K, C)
    d_w = (picked.float() * gf).sum(-1)
    return d_flat.reshape(B, L, C).to(flat.dtype), d_w.to(w.dtype)


def _validate_weighted(flat, idx, w) -> None:
    if (flat.dim() != 3 or idx.dim() != 3 or idx.shape != w.shape
            or idx.shape[0] != flat.shape[0]):
        raise ValueError(f"weighted_gather: want flat (B, L, C), idx and w "
                         f"(B, T, K), got {tuple(flat.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(w.shape)}")
    if idx.device != flat.device or w.device != flat.device:
        raise ValueError("weighted_gather: inputs on different devices")
    if flat.shape[1] == 0:
        raise ValueError("weighted_gather: empty table")


def _check_kernel_inputs(*tensors) -> None:
    flat, idx, w = tensors[:3]
    if flat.device.type != "cuda":
        raise RuntimeError(f"weighted_gather: no kernel for {flat.device}")
    if idx.dtype != torch.int32:
        raise TypeError(f"weighted_gather: idx must be int32, got {idx.dtype}")
    # flat and the gradient share one dtype; w has its own
    tables = (flat,) + tensors[3:]
    if flat.dtype not in _DTYPES or w.dtype not in _DTYPES or any(
            t.dtype != flat.dtype for t in tables):
        raise TypeError("weighted_gather: the kernel takes a float32 or "
                        "bfloat16 flat (its gradient alike) and w, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("weighted_gather: inputs must be contiguous")
    C = flat.shape[2]
    if C % 4 or any(t.data_ptr() % 16 for t in tables):
        raise ValueError(f"weighted_gather: the kernel moves 4-element "
                         f"pieces; got C={C} or a row table off 16-byte "
                         f"alignment")


def weighted_gather_backward(flat: torch.Tensor, idx: torch.Tensor,
                             w: torch.Tensor, g: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels: (d_flat, d_w) of :func:`weighted_gather` for
    the output gradient g (B, T, C) in flat's dtype; d_flat in flat's
    dtype, d_w in w's. Every element of both is written by the kernels;
    d_flat's f32 sums run in shared-memory atomics, in an order that
    changes from run to run, d_w's in a fixed order."""
    global WEIGHTED_BACKWARD_LAUNCHES
    _check_kernel_inputs(flat, idx, w, g)
    B, L, C = flat.shape
    T, K = idx.shape[1:]
    d_flat = torch.empty_like(flat)
    d_w = torch.empty_like(w)
    if flat.numel() == 0:
        return d_flat, d_w.zero_()
    fn = _build.function("weighted_gather", "pautdx_weighted_gather_backward",
                         _WEIGHTED_BWD_ARGTYPES)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = fn(flat.data_ptr(), idx.data_ptr(), w.data_ptr(), g.data_ptr(),
                d_flat.data_ptr(), d_w.data_ptr(), B, L, T, K, C,
                *scatter_tiles(L, C), _DTYPES[flat.dtype], _DTYPES[w.dtype],
                _sm_limits(flat.device.index)[0], stream)
        WEIGHTED_BACKWARD_LAUNCHES += 1
    _build.check(rc, "weighted_gather_backward")
    return d_flat, d_w


def _weighted_forward(flat, idx, w) -> torch.Tensor:
    global WEIGHTED_LAUNCHES
    _check_kernel_inputs(flat, idx, w)
    B, L, C = flat.shape
    T, K = idx.shape[1:]
    if max(B * L, B * T * K) >= 2**31:
        raise ValueError(f"weighted_gather: the kernel indexes rows and "
                         f"(tap, corner) entries in 32 bits; got {B * L} "
                         f"rows and {B * T * K} entries")
    out = torch.empty((B, T, C), dtype=flat.dtype, device=flat.device)
    if out.numel() == 0:
        return out
    fn = _build.function("weighted_gather", "pautdx_weighted_gather",
                         _WEIGHTED_ARGTYPES)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        plan = weighted_plan(B, T, K, C * flat.element_size(),
                             _sm_limits(flat.device.index)[0])
        rc = fn(flat.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                B, L, T, K, C, _DTYPES[flat.dtype], _DTYPES[w.dtype],
                plan.group, plan.warps, plan.blocks, stream)
        WEIGHTED_LAUNCHES += 1
    _build.check(rc, "weighted_gather")
    return out


class _WeightedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, idx, w):
        ctx.save_for_backward(flat, idx, w)
        return _weighted_forward(flat, idx, w)

    @staticmethod
    def backward(ctx, g):
        flat, idx, w = ctx.saved_tensors
        # looked up in the module at every call, like the forward wrapper
        d_flat, d_w = weighted_gather_backward(flat, idx, w, g.contiguous())
        return d_flat, None, d_w


def weighted_gather(flat: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """flat (B, L, C) f32 or bf16; idx (B, T, K) int32; w (B, T, K) f32 or
    bf16 -> (B, T, C) in flat's dtype = sum_k w[..., k] * flat[b,
    clip(idx[..., k], 0, L-1)], w rounded to flat's dtype, summed in f32.

    Differentiable in ``flat`` and ``w``. Any T and K; on the card C must
    be a multiple of 4 (C=128 on the training path) and every tensor
    contiguous."""
    _validate_weighted(flat, idx, w)
    if flat.device.type == "cpu":
        return weighted_gather_reference(flat, idx, w)
    return _WeightedGather.apply(flat, idx, w)
