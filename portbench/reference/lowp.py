"""The reference computed in a lower precision: the correctness controls.

:func:`lower_precision` rounds both operands of every convolution and
linear layer of a reference model (and of the space-to-depth stem's
matmul) on each call, to the precision and back, the products then summed
in f32: what a tensor core does with TF32 or fp8 operands. fp8 (e4m3) takes a per-tensor scale, its largest
magnitude over 448, as an fp8 deployment would; TF32 keeps 10 mantissa
bits, rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``).
TF32 is emulated rather than switched on in the backends, because cuDNN
may keep its FFMA kernels with TF32 allowed.
"""

from __future__ import annotations

from contextlib import contextmanager

import types

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` with its mantissa rounded to TF32's 10 bits."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a torch dtype or ``"tf32"``) and back
    to its own dtype; fp8 under a per-tensor scale."""
    if not x.is_floating_point():
        return x
    if dtype == "tf32":
        return round_tf32(x)
    if dtype == torch.float8_e4m3fn:
        scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
        return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)
    return x.to(dtype).to(x.dtype)


def _conv(mod, x):
    return mod._conv_forward(round_to(x, mod.lowp),
                             round_to(mod.weight, mod.lowp), mod.bias)


def _linear(mod, x):
    return F.linear(round_to(x, mod.lowp), round_to(mod.weight, mod.lowp),
                    mod.bias)


@torch.no_grad()
def lower_precision(model: nn.Module, dtype) -> nn.Module:
    """Round both operands of every convolution and linear layer to
    ``dtype`` on every call (the space-to-depth stem's matmul: its input,
    and its weight once)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.forward = types.MethodType(_conv, m)
        elif isinstance(m, nn.Linear):
            m.forward = types.MethodType(_linear, m)
        elif type(m).__name__ == "_S2DProj":
            m.weight.copy_(round_to(m.weight, dtype))
            m.register_forward_pre_hook(
                lambda mod, args: (round_to(args[0], dtype), *args[1:]))
        else:
            continue
        m.lowp = dtype
    return model


@contextmanager
def full_f32():
    """TF32 off in cuDNN and cuBLAS, the reference's precision."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
