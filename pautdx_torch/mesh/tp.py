"""Tensor-parallel sharding rules (Megatron-style) and their modules.

Counterpart of ``pautdx/mesh/tp.py``: a 2-D ``(dp, tp)`` mesh where
``dp`` splits the batch and ``tp`` splits chosen weight matrices
column- or row-wise. The reference places shardings on its parameters and
lets XLA insert the collectives; the port states them: :func:`shard_params`
replaces each matched parameter by this rank's shard and switches its
module to a tensor-parallel class of this file, whose forward carries the
``mesh.comm`` functions.

The rules are the reference's, in the port's names and layouts. A Linear
weight is (out, in), so the reference's kernel spec ``P(None, tp)``
(column) is dim 0 here and ``P(tp, None)`` (row) dim 1; a conv weight is
OIHW, so its HWIO ``P(None, None, None, tp)`` is dim 0 and
``P(None, None, tp, None)`` dim 1; a bias shards on dim 0.

- ``q/k/v_proj`` and ``fc1``: column-parallel, biases too; ``out_proj``
  and ``fc2``: row-parallel, biases replicated. A column-parallel
  attention holds 1/tp of the heads (``dfine.TorchMHA`` counts its heads
  from its projections' width).
- HGNet ``aggregation.0`` (1x1, column on C_out) and ``aggregation.1``
  (row on C_in). The BatchNorm after the column conv keeps its full (C,)
  vectors and uses its slice (``hgnet.BatchNorm.tp_slice``); the
  row conv's partial sums are all-reduced BEFORE its BatchNorm, which then
  sees the full output. The learnable affine after the column conv is
  replicated and acts on a slice, so its gradient is summed over tp.
- ``MLPHead``: ``layers.0`` column, ``layers.1`` row. The anchoring
  keeps the reference's: a parameter matches only as ``layers.0.weight``
  itself, so ``decoder.layers.0.fc1.weight`` goes by the ``fc1`` rule.
- the decoder's ``gateway.gate``: column-parallel, gathered over tp before
  its sigmoid, which needs the full width.
- the encoder's CSP chain: ``bottlenecks.0`` (RepVgg 3x3 and 1x1) column,
  ``bottlenecks.1`` row (all-reduced before each BatchNorm);
  ``bottlenecks.2+`` stay replicated. Where a column layer has no row
  partner (a one-block chain, a one-layer head), its output is gathered.
- everything else is replicated. :func:`tp_coverage` gives the share of
  parameter bytes sharded.

A rule fires only where its dim divides by the tp size; otherwise the leaf
stays replicated, as the reference's does. Combining tp with int8
activations is no reference path: :func:`shard_params` raises on it.
Dropout under tp draws from (seed, step, dp rank), so the tp ranks of one
replica draw the same masks (``train.trainer``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.mesh import axis_group, axis_size, make_mesh, placements
from pautdx_torch.mesh import comm
from pautdx_torch.models.vision.dfine import (
    ConvNorm, CSPRepLayer, Dense, MLPHead,
)
from pautdx_torch.models.vision.hgnet import ConvLayer
from pautdx_torch.ops.qconv import Int8Site

_COL = ("q_proj", "k_proj", "v_proj", "fc1")
_ROW = ("out_proj", "fc2")

# (name regex, sharded dim), first match wins
_RULES = [
    (re.compile(rf"(?:^|\.)(?:{'|'.join(_COL)})\.(?:weight|bias)$"), 0),
    (re.compile(rf"(?:^|\.)(?:{'|'.join(_ROW)})\.weight$"), 1),
    (re.compile(r"aggregation\.0\.convolution\.weight$"), 0),
    (re.compile(r"aggregation\.1\.convolution\.weight$"), 1),
    (re.compile(r"(?:^|\.)layers\.0\.(?:weight|bias)$"), 0),
    (re.compile(r"(?:^|\.)layers\.1\.weight$"), 1),
    (re.compile(r"(?:^|\.)gateway\.gate\.(?:weight|bias)$"), 0),
    (re.compile(r"bottlenecks\.0\.conv[12]\.conv\.weight$"), 0),
    (re.compile(r"bottlenecks\.1\.conv[12]\.conv\.weight$"), 1),
]


def tp_spec_tree(model: nn.Module, tp_size: int) -> Dict[str, Optional[int]]:
    """{parameter name: the dim sharded over tp, or None (replicated)}."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = None
        for rx, dim in _RULES:
            if rx.search(name):
                if p.dim() > dim and p.shape[dim] % tp_size == 0:
                    out[name] = dim
                break
    return out


def tp_coverage(model: nn.Module, tp_size: int) -> float:
    """The share of parameter BYTES that the rules shard."""
    specs = tp_spec_tree(model, tp_size)
    sharded = total = 0
    for name, p in model.named_parameters():
        nbytes = p.numel() * p.element_size()
        total += nbytes
        if specs[name] is not None:
            sharded += nbytes
    return sharded / max(total, 1)


def tp_shardings(model: nn.Module, mesh, tp_axis: str = "tp") -> Dict:
    """{parameter name: its placements on ``mesh``} (``Shard(dim)`` on
    the tp axis, ``Replicate()`` elsewhere)."""
    specs = tp_spec_tree(model, axis_size(mesh, tp_axis))
    return {name: placements(mesh, None if d is None else tp_axis, d or 0)
            for name, d in specs.items()}


def mesh_2d_shape(n_devices: int, tp: int = 2) -> tuple:
    """(dp, tp) of :func:`mesh_2d`: ``tp`` clamped to a divisor of
    ``n_devices`` (1 at worst)."""
    while tp > 1 and n_devices % tp:
        tp -= 1
    return (n_devices // tp, tp)


def mesh_2d(n_devices: int, tp: int = 2, axis_names=("dp", "tp"),
            device=None):
    """A (dp, tp) mesh over ranks ``0 .. n-1`` (rank = dp index * tp + tp
    index); tp=2 can be asked always (:func:`mesh_2d_shape`)."""
    dp, tp = mesh_2d_shape(n_devices, tp)
    ranks = [[d * tp + t for t in range(tp)] for d in range(dp)]
    return make_mesh(devices=ranks, axis_names=axis_names, device=device)


# ---------------------------------------------------------------------------
# the tensor-parallel modules (shard_params switches a module's class)


class _TP:
    tp_group = None
    tp_gather = False     # a column layer without a row partner

    def _out(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        return (comm.gather_from_tp(y, self.tp_group, dim) if self.tp_gather
                else y)


def _no_int8(site: Int8Site) -> None:
    if site.int8_weight is not None:
        raise RuntimeError("tensor parallelism does not combine with int8 "
                           "activations (no reference path)")


class ColumnDense(_TP, Dense):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        x = comm.copy_to_tp(x, self.tp_group)
        return self._out(F.linear(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt)), -1)


class RowDense(_TP, Dense):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        y = comm.reduce_from_tp(F.linear(x.to(dt), self.weight.to(dt)),
                                self.tp_group)
        return y + self.bias.to(dt)


class ColumnConvNorm(_TP, ConvNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _no_int8(self)
        x = comm.copy_to_tp(x, self.tp_group)
        return self._out(self.act(self.norm(self.conv(x))), 1)


class RowConvNorm(_TP, ConvNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _no_int8(self)
        y = comm.reduce_from_tp(self.conv(x), self.tp_group)
        return self.act(self.norm(y))


class ColumnConvLayer(_TP, ConvLayer):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _no_int8(self)
        g = self.tp_group
        x = self.normalization(self.convolution(comm.copy_to_tp(x, g)))
        if self.act:
            x = F.relu(x)
            if self.lab is not None:
                x = comm.copy_to_tp(self.lab.scale, g) * x \
                    + comm.copy_to_tp(self.lab.bias, g)
        return self._out(x, 1)


class RowConvLayer(_TP, ConvLayer):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _no_int8(self)
        x = self.normalization(comm.reduce_from_tp(self.convolution(x),
                                                   self.tp_group))
        if self.act:
            x = F.relu(x)
            if self.lab is not None:
                x = self.lab(x)
        return x


_CLASSES = {(Dense, 0): ColumnDense, (Dense, 1): RowDense,
            (ConvNorm, 0): ColumnConvNorm, (ConvNorm, 1): RowConvNorm,
            (ConvLayer, 0): ColumnConvLayer, (ConvLayer, 1): RowConvLayer}


def _owner(model: nn.Module, name: str):
    """(module path, module) holding the weight ``name`` as its own
    ``weight`` or its conv's."""
    path = name.rpartition(".")[0]
    mod = model.get_submodule(path)
    if isinstance(mod, nn.Conv2d):
        path = path.rpartition(".")[0]
        mod = model.get_submodule(path)
    return path, mod


@torch.no_grad()
def _shard(p: nn.Parameter, dim: int, size: int, rank: int) -> nn.Parameter:
    n = p.shape[dim] // size
    q = nn.Parameter(p.narrow(dim, rank * n, n).clone(),
                     requires_grad=p.requires_grad)
    q.tp_dim = dim
    return q


def shard_params(model: nn.Module, mesh, tp_axis: str = "tp") -> nn.Module:
    """Shard ``model`` in place for this rank of ``mesh``'s tp axis:
    every weight the rules match becomes this rank's shard (its bias too
    for a column layer), its module a tensor-parallel class. Returns the
    model."""
    size = axis_size(mesh, tp_axis)
    if size == 1:
        return model
    if any(isinstance(m, Int8Site) and m.int8_weight is not None
           for m in model.modules()):
        raise RuntimeError("shard_params: the model has int8 sites set; "
                           "tensor parallelism does not combine with int8 "
                           "activations (no reference path)")
    group = axis_group(mesh, tp_axis)
    rank = comm.group_rank(group)
    specs = tp_spec_tree(model, size)
    for name, dim in specs.items():
        if dim is None or not name.endswith("weight"):
            continue
        path, mod = _owner(model, name)
        base = next((b for b in (Dense, ConvNorm, ConvLayer)
                     if isinstance(mod, b)), None)
        if base is None:
            raise NotImplementedError(f"shard_params: no tensor-parallel "
                                      f"form of {type(mod).__name__} "
                                      f"({path})")
        lin = mod if base is Dense else (mod.conv if base is ConvNorm
                                         else mod.convolution)
        lin.weight = _shard(lin.weight, dim, size, rank)
        if dim == 0 and getattr(lin, "bias", None) is not None:
            lin.bias = _shard(lin.bias, 0, size, rank)
        if dim == 0 and base is not Dense:
            bn = mod.norm if base is ConvNorm else mod.normalization
            n = lin.weight.shape[0]
            bn.tp_slice = (group, rank * n, (rank + 1) * n)
        mod.__class__ = _CLASSES[(base, dim)]
        mod.tp_group = group
    _gather_unpaired(model)
    return model


def _gather_unpaired(model: nn.Module) -> None:
    """A column layer whose row partner is missing gathers its output."""
    for m in model.modules():
        if isinstance(m, MLPHead) and isinstance(m.layers[0], ColumnDense):
            m.layers[0].tp_gather = not (
                len(m.layers) > 1 and isinstance(m.layers[1], RowDense))
        if isinstance(m, CSPRepLayer) and len(m.bottlenecks) and \
                isinstance(m.bottlenecks[0].conv1, ColumnConvNorm):
            paired = len(m.bottlenecks) > 1 and isinstance(
                m.bottlenecks[1].conv1, RowConvNorm)
            m.bottlenecks[0].conv1.tp_gather = not paired
            m.bottlenecks[0].conv2.tp_gather = not paired
        gate = getattr(m, "gateway", None)
        if gate is not None and isinstance(gate.gate, ColumnDense):
            gate.gate.tp_gather = True


def is_sharded(p: torch.Tensor) -> bool:
    return getattr(p, "tp_dim", None) is not None


def tp_group_of(model: nn.Module):
    """The tp group ``model`` was sharded over, or None."""
    return next((m.tp_group for m in model.modules()
                 if isinstance(m, _TP)), None)


def grad_norm(model: nn.Module, grads=None) -> torch.Tensor:
    """The global L2 norm of the FULL gradients of a sharded model: the
    sharded leaves' squares summed over tp, the replicated ones once.
    ``grads`` defaults to each parameter's ``.grad`` (zeros for none)."""
    params = [p for p in model.parameters() if p.requires_grad]
    grads = grads if grads is not None else [
        p.grad if p.grad is not None else torch.zeros_like(p)
        for p in params]
    group = tp_group_of(model)
    sq = {True: [], False: []}
    for p, g in zip(params, grads):
        sq[is_sharded(p)].append(g.float().pow(2).sum())
    dev = grads[0].device
    rep = torch.stack(sq[False]).sum() if sq[False] else \
        torch.zeros((), device=dev)
    shd = torch.stack(sq[True]).sum() if sq[True] else \
        torch.zeros((), device=dev)
    return (rep + comm.all_reduce(shd, group)).sqrt()


@torch.no_grad()
def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full state dict of a sharded model under the port's names (each
    shard gathered over tp, buffers as they are), CPU copies."""
    group = tp_group_of(model)
    out = {}
    for name, t in model.state_dict(keep_vars=True).items():
        if is_sharded(t):
            t = comm.gather_slices(t.detach(), group, t.tp_dim)
        out[name] = t.detach().cpu().clone()
    return out

