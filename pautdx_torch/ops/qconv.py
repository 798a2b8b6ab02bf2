"""Activation-int8 convolution for serving: the CUDA kernel
``csrc/int8_conv.cu``, its plain PyTorch version, its launch counter, and
the int8 branch that the conv + BN layers share.

Counterpart of ``pautdx/ops/qconv.py``. A site quantizes its INPUT with one
calibrated per-tensor scale ``s`` (``serve.quantize`` collects them) and
its weight per output channel, convolves s8 x s8 -> s32 and dequantizes,
in the order the reference's compiled graph runs, so that the results are
bit-equal:

    xq      = clip(round(x.float() / s), -127, 127)     (half to even)
    m       = max(max|w| over (I, kh, kw), 1e-12)        (per O, f32)
    w_scale = m * R                                      (R = f32(1 / 127))
    q       = round(w.float() / w_scale)
    acc     = conv(xq, q)                                (exact int32)
    out     = (acc.float() * (m * (s * R))).to(promote(x.dtype, w.dtype))

The reference writes ``w_scale = m / 127.0`` and ``acc * (s * w_scale)``;
XLA's algebraic simplifier turns the division by the constant into a
product with its f32 reciprocal and folds it into ``s`` first (its
compiled HLO on the CPU), which moves the output by up to 4 ulps in f32,
so the port keeps the compiled order. Tensors are NCHW, weights OIHW (the
reference's NHWC / HWIO, reduced over its axes (0, 1, 2)). The weight
side is computed once per site, on the host in f32, when the scale is set
(:func:`prepare_int8_weight`), as the reference's trace hoists it out of
its serving scan. PyTorch has no int8
convolution that accumulates in int32 (``F.conv2d`` on int8 tensors wraps
at 8 bits on the CPU), so the plain version convolves the integer values
in float64, which is exact (every sum is below 2^53), with cuDNN off.

On a CPU tensor :func:`int8_conv` runs the plain version; on a CUDA tensor
it launches the kernel or raises: dense (``groups == 1``) and depthwise
(``groups == C == Cout``) convolutions of f32 or bf16 input with square
kernels, strides and padding. ``LAUNCHES`` counts kernel launches and
nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.ops import _build

LAUNCHES = 0

# f32(1 / 127), the constant XLA multiplies by where the reference divides
_R127 = torch.tensor(np.float32(1.0 / 127.0))
# the kernel's tile: output channels a block, int8 depth of a k-step
_BN, _BK = 64, 32
# output kinds of the C entry point
_OUT_F32, _OUT_BF16, _OUT_ACC = 0, 1, 2

# x, x_bf16, N, C, H, W, sN, sC, sH, sW, wq, out_scale, in_scale, out,
# out_kind, oN, oC, oH, oW, Cout, Ho, Wo, kh, kw, stride, pad, depthwise,
# vec, Kp, stream
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 4
             + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p,
                                        ctypes.c_int]
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])

Pair = Union[int, Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class Int8Weight:
    """One site's weight side, on the weight's device: ``q`` (O, I/g, kh,
    kw) int8, ``out_scale`` (O,) f32 (module docstring), ``in_scale`` 0-d
    f32, ``packed`` the kernel's layout of ``q`` (dense:
    (O rounded up to 64, K rounded up to 32) with k = (ky, kx, ci) and
    zeros past the ends; depthwise: (O, kh * kw)), and the dense weight's
    dtype, which the output promotes with."""

    q: torch.Tensor
    in_scale: torch.Tensor
    out_scale: torch.Tensor
    packed: torch.Tensor
    groups: int
    w_dtype: torch.dtype

    @property
    def scale(self) -> float:
        return float(self.in_scale)


def _pair(v: Pair, what: str) -> int:
    if isinstance(v, (tuple, list)):
        if len(v) != 2 or v[0] != v[1]:
            raise ValueError(f"int8_conv: {what} {tuple(v)} is not square")
        v = v[0]
    return int(v)


@torch.no_grad()
def prepare_int8_weight(weight: torch.Tensor, in_scale, groups: int = 1
                        ) -> Int8Weight:
    """The weight side of a site with input scale ``in_scale`` (a float or
    a tensor; rounded to f32 as the reference's ``jnp.asarray(in_scale,
    f32)``), computed on the host in f32 and moved to the weight's
    device."""
    if weight.dim() != 4:
        raise ValueError(f"int8_conv: want an OIHW weight, got "
                         f"{tuple(weight.shape)}")
    w = weight.detach().to("cpu", torch.float32)
    m = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12)
    w_scale = m * _R127
    q = torch.round(w / w_scale[:, None, None, None]).to(torch.int8)
    s = torch.as_tensor(np.float32(float(in_scale)), dtype=torch.float32)
    out_scale = m * (s * _R127)
    O, I, kh, kw = q.shape
    if groups > 1 and I == 1:                    # depthwise
        packed = q.reshape(O, kh * kw).contiguous()
    else:
        K = kh * kw * I
        packed = torch.zeros((-(-O // _BN) * _BN, -(-K // _BK) * _BK),
                             dtype=torch.int8)
        packed[:O, :K] = q.permute(0, 2, 3, 1).reshape(O, K)
    dev = weight.device
    return Int8Weight(q=q.to(dev), in_scale=s.to(dev),
                      out_scale=out_scale.to(dev),
                      packed=packed.to(dev), groups=int(groups),
                      w_dtype=weight.dtype)


def _prepared(weight, in_scale, groups, prepared) -> Int8Weight:
    if prepared is not None:
        return prepared
    if in_scale is None:
        raise ValueError("int8_conv: give in_scale or a prepared weight")
    return prepare_int8_weight(weight, in_scale, groups)


def int8_accumulators_reference(x: torch.Tensor, prep: Int8Weight,
                                stride: Pair = 1, padding: Pair = 0
                                ) -> torch.Tensor:
    """The exact int32 accumulators: the input quantized (the division by a
    tensor on the input's device, so that no backend replaces it by a
    product with the reciprocal) and convolved in float64 with cuDNN off
    (no Winograd or FFT)."""
    s = prep.in_scale.to(x.device)
    xq = torch.clamp(torch.round(x.float() / s), -127.0, 127.0)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.double(), prep.q.to(x.device, torch.float64),
                       stride=_pair(stride, "stride"),
                       padding=_pair(padding, "padding"), groups=prep.groups)
    return acc.to(torch.int32)


def int8_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                        stride: Pair = 1, padding: Pair = 0, groups: int = 1,
                        in_scale=None, prepared: Optional[Int8Weight] = None
                        ) -> torch.Tensor:
    """The plain version: the accumulators dequantized by ``out_scale``
    in f32 and rounded once to ``promote(x.dtype, w.dtype)``."""
    prep = _prepared(weight, in_scale, groups, prepared)
    acc = int8_accumulators_reference(x, prep, stride, padding)
    out = acc.float() * prep.out_scale.to(x.device)[:, None, None]
    return out.to(torch.promote_types(x.dtype, prep.w_dtype))


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """Channels-last when ``x``'s channels are its fastest dim (a
    channels-last tensor or a channel slice of one), as cuDNN lays out a
    convolution's output; else contiguous."""
    if x.shape[1] > 1 and x.stride(1) == 1:
        return torch.channels_last
    return torch.contiguous_format


def _launch(x: torch.Tensor, prep: Int8Weight, stride: Pair, padding: Pair,
            out_dtype: torch.dtype) -> torch.Tensor:
    """Check what the kernel takes, allocate the output in the input's
    memory format and launch."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_conv: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_conv: the kernel takes f32 or bf16 input, "
                        f"got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16, torch.int32):
        raise TypeError(f"int8_conv: no {out_dtype} output")
    if x.dim() != 4:
        raise ValueError(f"int8_conv: want (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if prep.packed.device != x.device:
        raise ValueError("int8_conv: input and weight on different devices")
    _build.refuse_grad("int8_conv", x)
    N, C, H, W = x.shape
    O, I, kh, kw = prep.q.shape
    st, pad = _pair(stride, "stride"), _pair(padding, "padding")
    depthwise = prep.groups > 1
    if depthwise and not (prep.groups == C == O and I == 1):
        raise ValueError(f"int8_conv: groups {prep.groups} over {C} -> {O} "
                         f"channels; the kernel takes dense or depthwise")
    if not depthwise and I != C:
        raise ValueError(f"int8_conv: weight {tuple(prep.q.shape)} for "
                         f"{C} input channels")
    if kh != kw or st < 1 or pad < 0:
        raise ValueError(f"int8_conv: kernel {kh}x{kw}, stride {st}, "
                         f"padding {pad}")
    Ho, Wo = (H + 2 * pad - kh) // st + 1, (W + 2 * pad - kw) // st + 1
    if Ho <= 0 or Wo <= 0 or N * Ho * Wo >= 2 ** 31 or x.numel() >= 2 ** 40:
        raise ValueError(f"int8_conv: output {N} x {Ho} x {Wo}")
    out = torch.empty((N, O, Ho, Wo), dtype=out_dtype, device=x.device,
                      memory_format=memory_format(x))
    if out.numel() == 0:
        return out
    elt = x.element_size()
    sN, sC, sH, sW = x.stride()
    vec = (not depthwise and C % 16 == 0 and sC == 1
           and x.data_ptr() % 16 == 0
           and all(s_ % (16 // elt) == 0 for s_ in (sN, sH, sW)))
    kind = {torch.float32: _OUT_F32, torch.bfloat16: _OUT_BF16,
            torch.int32: _OUT_ACC}[out_dtype]
    fn = _build.function("int8_conv", "pautdx_int8_conv", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), N, C, H, W,
                sN, sC, sH, sW, prep.packed.data_ptr(),
                prep.out_scale.data_ptr(), float(prep.in_scale), out.data_ptr(),
                kind, *out.stride(), O, Ho, Wo, kh, kw, st, pad,
                int(depthwise), int(vec), prep.packed.shape[1], stream)
        LAUNCHES += 1
    _build.check(rc, "int8_conv")
    return out


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride: Pair = 1,
              padding: Pair = 0, groups: int = 1, in_scale=None,
              prepared: Optional[Int8Weight] = None) -> torch.Tensor:
    """s8 x s8 -> s32 convolution of NCHW ``x`` (f32 or bf16) with the OIHW
    ``weight`` at the calibrated input scale ``in_scale``, dequantized to
    ``promote(x.dtype, weight.dtype)``; ``prepared`` (from
    :func:`prepare_int8_weight`) skips the weight side, as the layers'
    int8 branch does."""
    prep = _prepared(weight, in_scale, groups, prepared)
    out_dtype = torch.promote_types(x.dtype, prep.w_dtype)
    if x.device.type == "cpu":
        return int8_conv_reference(x, weight, stride, padding, groups,
                                   in_scale, prep)
    return _launch(x, prep, stride, padding, out_dtype)


def int8_accumulators(x: torch.Tensor, prep: Int8Weight, stride: Pair = 1,
                      padding: Pair = 0) -> torch.Tensor:
    """The kernel's int32 accumulators, undequantized (the checks hold
    them to :func:`int8_accumulators_reference`)."""
    if x.device.type == "cpu":
        return int8_accumulators_reference(x, prep, stride, padding)
    return _launch(x, prep, stride, padding, torch.int32)


# ------------------------------------------------------------ the int8 site


class Int8Site(nn.Module):
    """Base of the conv + BN layers that can serve int8 activations
    (``hgnet.ConvLayer``, ``dfine.ConvNorm``, ``yolo.ConvBnSiLU``): the
    counterpart of the reference's ``sow_calibration`` and ``wants_int8``.

    :meth:`site_conv` runs the layer's convolution: in eval mode with a
    scale set (:func:`set_int8_scale`) through :func:`int8_conv`, else the
    dense ``nn.Conv2d``; while ``serve.quantize.calibrate_int8`` records,
    it also keeps the running ``max|x|`` of its input in f32. The scale
    and the prepared weight are plain attributes, outside ``state_dict()``
    and ``buffers()``, so every strict load and cast of the module is the
    same with and without them."""

    int8_weight: Optional[Int8Weight] = None
    int8_absmax: Optional[torch.Tensor] = None   # while calibrating
    int8_recording: bool = False

    def site_conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        if self.int8_recording:
            m = x.detach().float().abs().amax()
            self.int8_absmax = (m if self.int8_absmax is None
                                else torch.maximum(self.int8_absmax, m))
        if not self.training and self.int8_weight is not None:
            return int8_conv(x, conv.weight, conv.stride, conv.padding,
                             conv.groups, None, self.int8_weight)
        return conv(x)


def _site_conv(site: Int8Site) -> nn.Conv2d:
    conv = getattr(site, "convolution", None)
    return conv if conv is not None else site.conv


def set_int8_scale(site: Int8Site, in_scale) -> None:
    """Give ``site`` its input scale (int8 from then on in eval mode),
    preparing its weight side once; ``None`` returns it to the dense
    convolution."""
    if in_scale is None:
        site.int8_weight = None
        return
    conv = _site_conv(site)
    site.int8_weight = prepare_int8_weight(conv.weight, in_scale,
                                           conv.groups)


def int8_sites(module: nn.Module) -> Dict[str, Int8Site]:
    """Every int8 site under ``module``, by its dotted module path."""
    return {name: m for name, m in module.named_modules()
            if isinstance(m, Int8Site)}


def int8_scales(module: nn.Module) -> Dict[str, float]:
    """The scales set on ``module``'s sites, by path."""
    return {name: s.int8_weight.scale
            for name, s in int8_sites(module).items()
            if s.int8_weight is not None}


def set_int8_scales(module: nn.Module, scales: Dict[str, float]) -> None:
    """Set exactly ``scales`` (site path -> input scale) on ``module``: the
    sites it names go int8, every other site dense. A path that names no
    site raises ``KeyError``."""
    sites = int8_sites(module)
    unknown = sorted(set(scales) - set(sites))
    if unknown:
        raise KeyError(f"set_int8_scales: {len(unknown)} scales name no "
                       f"int8 site, e.g. {unknown[:6]}")
    for name, site in sites.items():
        set_int8_scale(site, scales.get(name))
