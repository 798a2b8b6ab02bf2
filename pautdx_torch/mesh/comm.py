"""The collectives of the multi-device paths, as autograd functions.

The reference runs one program over the global batch, and XLA inserts
whatever collectives keep its result exact. Here each rank is a process
that sees its own rows (data parallelism, ``dp``) and its own slice of
the sharded weights (tensor parallelism, ``tp``), so the port states its
collectives. Only ``all_reduce`` and ``broadcast`` are used: gloo carries
CUDA tensors for those two alone, so every path here runs unchanged on
NCCL, on gloo with CUDA tensors (several ranks sharing one card) and on
gloo on the CPU.

- Megatron's pair: :func:`copy_to_tp` (identity forward, sum of the
  gradient over tp) at the input of a column-parallel layer, and
  :func:`reduce_from_tp` (sum forward, identity backward) at the output
  of a row-parallel one.
- :func:`gather_from_tp`: the full tensor from the tp ranks' slices of one
  dim, as an ``all_reduce`` of a zero-filled full-size buffer; its
  backward takes the rank's slice of the gradient.
- :func:`all_reduce`: a differentiable sum over a group (BatchNorm's
  moments over dp).
- :func:`dp_count`: a count of the global batch, without gradient, divided
  by the dp size. A loss that divides its local sum by ``dp_count(c)``
  is dp times this rank's share of the global-batch loss, and
  ``DistributedDataParallel`` averages the ranks' gradients, dividing by
  dp again: the sum is the gradient of the global-batch loss, as the
  reference's. A plain ``.mean()`` over equal shards is already dp times
  the share, so it needs nothing.

``dp_scope(group)`` names the dp group that a step runs under; the losses
and ``BatchNorm`` read it through :func:`dp_group`. Outside a scope (one
process, or an objective evaluated over the gathered global batch) every
function here is the identity.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
import torch.distributed as dist

_DP_GROUP = None


@contextlib.contextmanager
def dp_scope(group):
    """Run the block with ``group`` as the dp group (None: no dp)."""
    global _DP_GROUP
    prev, _DP_GROUP = _DP_GROUP, group
    try:
        yield
    finally:
        _DP_GROUP = prev


def dp_group():
    """The dp group of the enclosing :func:`dp_scope`, if it has more than
    one rank, else None."""
    if _DP_GROUP is None or dist.get_world_size(_DP_GROUP) == 1:
        return None
    return _DP_GROUP


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _reduced(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.rank, ctx.n = dim, group_rank(group), x.shape[dim]
        return gather_slices(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), \
            None, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``; the gradient is summed likewise."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _GatherFromTP.apply(x, group, dim % x.dim())


@torch.no_grad()
def gather_slices(x: torch.Tensor, group, dim: int = 0,
                  total: Optional[int] = None) -> torch.Tensor:
    """Every rank's equal slice of ``dim`` laid side by side in rank order
    (an ``all_reduce`` of a zero-filled buffer), cut to ``total`` rows of
    ``dim`` if given. Bool tensors travel as uint8."""
    n, size = x.shape[dim], group_size(group)
    if size == 1:
        return x if total is None else x.narrow(dim, 0, total)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    shape = list(x.shape)
    shape[dim] = n * size
    full = src.new_zeros(shape)
    full.narrow(dim, group_rank(group) * n, n).copy_(src)
    dist.all_reduce(full, group=group)
    if total is not None:
        full = full.narrow(dim, 0, total)
    return full.to(torch.bool) if x.dtype == torch.bool else full


def gather_rows(tree: Any, group, rows: int, total: int) -> Any:
    """The dp ranks' outputs over their ``rows`` rows each -> the outputs
    over the first ``total`` rows of the global batch, for every tensor of
    a nested dict/list whose leading dim is ``rows``; other leaves are the
    same on every rank and pass as they are."""
    if isinstance(tree, dict):
        return {k: gather_rows(v, group, rows, total) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_rows(v, group, rows, total) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() and \
            tree.shape[0] == rows:
        return gather_slices(tree, group, 0, total)
    return tree


@torch.no_grad()
def dp_count(x, floor: Optional[float] = None) -> torch.Tensor:
    """``x`` (counts over this rank's rows, a tensor on its device) summed
    over the dp group of the enclosing :func:`dp_scope`, clamped below at
    ``floor`` as the reference clamps its global count, and divided by the
    group's size; ``x`` clamped without a scope."""
    group = dp_group()
    x = torch.as_tensor(x).detach()
    if group is not None:
        x = _reduced(x, group)
    if floor is not None:
        x = x.clamp(min=floor)
    return x if group is None else x / dist.get_world_size(group)
