"""Model export for external hosts.

Counterpart of ``pautdx/serve/export.py``, with ``torch.export`` in place
of StableHLO: the reference ships its models to a C# host through an
export with dynamic (batch, num_signals) axes; here the artifact is an
``ExportedProgram`` saved as ``.pt2``, loadable without the model's
Python source (``torch.export.load``) and runnable from C++ through
AOTInductor.

A polymorphic batch is a ``torch.export.Dim`` on axis 0 of every input,
up to ``MAX_BATCH``. The export traces at the example's batch, and a
trace at batch 1 specialises the batch to 1 (``torch.export`` raises),
so the example needs a batch of at least 2. The program exported so
takes batch 1 as well (the CPU test holds batches 1, 2 and 5 to the
eager model). The bound is needed: on the card, torch 2.11 derives
``batch <= 1310`` for HybridBinary at (B, 50, 320) from its kernels'
32-bit indexing and refuses an unbounded ``Dim``; the largest batch
bucket the endpoint serves is 16.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from pautdx_torch.device import Device, resolve_device


MAX_BATCH = 1024


def export_forward(module: nn.Module, example_args: Tuple[torch.Tensor, ...],
                   path: Optional[str] = None,
                   polymorphic_batch: bool = False
                   ) -> torch.export.ExportedProgram:
    """``torch.export`` of ``module`` over ``example_args``, saved to
    ``path`` (a ``.pt2``) where given. With ``polymorphic_batch`` axis 0
    of every input is one symbolic batch of at most ``MAX_BATCH``."""
    dynamic_shapes = None
    if polymorphic_batch:
        if any(a.shape[0] < 2 for a in example_args):
            raise ValueError("export_forward: a polymorphic batch needs an "
                             "example batch of at least 2 (a trace at 1 "
                             "specialises it)")
        batch = torch.export.Dim("batch", max=MAX_BATCH)
        dynamic_shapes = tuple({0: batch} for _ in example_args)
    exported = torch.export.export(module, tuple(example_args),
                                   dynamic_shapes=dynamic_shapes)
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.export.save(exported, path)
    return exported


def load_exported(path: str) -> Callable:
    """A callable that runs the program saved at ``path``, on the device
    it was exported on."""
    return torch.export.load(path).module()


def export_signal_model(model: nn.Module, signal_shape: Sequence[int],
                        path: str, polymorphic_batch: bool = False,
                        device: Device = None
                        ) -> torch.export.ExportedProgram:
    """Export ``model``'s eval forward over (B, N, S) f32 signals of
    ``signal_shape`` on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    example = (torch.zeros(tuple(signal_shape), device=dev),)
    return export_forward(model, example, path, polymorphic_batch)
