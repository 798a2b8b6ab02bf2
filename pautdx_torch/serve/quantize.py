"""Int8 for serving: activation int8 at the conv sites, and weight-only
int8 of a state dict.

Counterpart of ``pautdx/serve/quantize.py``.

**Activation int8.** Every ``ops.qconv.Int8Site`` (``hgnet.ConvLayer``,
``dfine.ConvNorm``, ``yolo.ConvBnSiLU``) can quantize its input with one
calibrated scale and convolve s8 x s8 -> s32 (``ops.qconv.int8_conv``,
the ``csrc/int8_conv.cu`` kernel on the card). :func:`calibrate_int8`
runs dense eval forwards and records ``max|x|`` in f32 at every site that
runs, reduced by max over the batches; the scales are ``max(absmax, 1e-8)
/ 127``. A quant dict maps a site's dotted torch module path to its scale,
e.g. ``model.backbone.model.encoder.stages.2.blocks.0.layers.0.conv1``.
The reference keys the same site by its module names joined with ``/``
(``model.backbone.model/encoder.stages.2/blocks.0/layers.0/conv1``),
whose own names carry dots: its path with ``/`` replaced by ``.`` is the
port's. :func:`drop_quant_sites`' predicate sees the port's form.
``compat.jax_weights.load_jax_variables`` carries the reference's
``"quant"`` collection into the same sites. Scales live outside
``state_dict()``.

**Weight-only int8** (:func:`quantize_state_dict`): the entries the
reference's ``quantize_variables`` quantizes, its ``kernel`` and
``embedding`` leaves of 2 or more dims and at least ``min_size`` values,
are here the ``weight`` of every module with 2 or more dims and
``min_size`` values (a norm's is 1-d), per channel along the axis the
reference's "all axes but the last" means in its layout (HWIO kernels,
(in, out) dense kernels, (rows, features) tables): dim 0 of an OIHW conv
or a Linear weight, dim 1 of a ``ConvTranspose2d``'s (in, out, kh, kw),
the last dim of an ``nn.Embedding``. Recurrent cells' stacked weights stay
dense (the reference quantizes each gate's Dense kernel).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pautdx_torch.ops.qconv import int8_sites, set_int8_scales

Quant = Dict[str, float]


@torch.no_grad()
def calibrate_int8(model: nn.Module, batches: Iterable) -> Quant:
    """Scales of every int8 site that runs in ``model(batch)`` over
    ``batches``, in eval mode and dense (scales already set are left out of
    these forwards and put back after): ``max(absmax, 1e-8) / 127`` in f32,
    ``absmax`` the largest ``|x|`` of the site's input over all batches."""
    sites = int8_sites(model)
    saved = {name: s.int8_weight for name, s in sites.items()}
    was_training = model.training
    model.eval()
    for s in sites.values():
        s.int8_weight, s.int8_absmax, s.int8_recording = None, None, True
    try:
        n = 0
        for batch in batches:
            model(batch)
            n += 1
        if n == 0:
            raise ValueError("calibrate_int8: no calibration batches given")
        absmax = {name: float(s.int8_absmax) for name, s in sites.items()
                  if s.int8_absmax is not None}
    finally:
        for name, s in sites.items():
            s.int8_weight, s.int8_absmax, s.int8_recording = (
                saved[name], None, False)
        model.train(was_training)
    return scales_from_calib(absmax)


def scales_from_calib(absmax: Dict[str, float]) -> Quant:
    """``max|x|`` per site -> ``max(absmax, 1e-8) / 127``, in f32 (the
    floor keeps a dead site from dividing by zero: its convolution then
    sees all-zero int8 inputs, which is exact)."""
    return {name: float(np.maximum(np.float32(a), np.float32(1e-8))
                        / np.float32(127.0))
            for name, a in absmax.items()}


def drop_quant_sites(quant: Quant, predicate: Callable[[str], bool]
                     ) -> Quant:
    """Keep a site only when ``predicate(path)`` is true; the others serve
    dense (per-site accuracy triage without touching model code)."""
    return {name: s for name, s in quant.items() if predicate(name)}


def make_int8_apply(model: nn.Module, calib_batches: Iterable,
                    drop: Optional[Callable[[str], bool]] = None
                    ) -> Tuple[Callable, Quant]:
    """Activation-int8 serving in one call: calibrate on ``calib_batches``
    (shaped like the serving inputs), keep the sites ``drop`` accepts, set
    the scales on ``model`` in place and return ``(apply_fn, quant)``,
    ``apply_fn(images)`` the model's eval forward without autograd."""
    quant = calibrate_int8(model, calib_batches)
    if drop is not None:
        quant = drop_quant_sites(quant, drop)
    set_int8_scales(model, quant)
    model.eval()

    def apply_fn(images):
        with torch.inference_mode():
            return model(images)

    return apply_fn, quant


# ------------------------------------------------------ weight-only int8


@dataclasses.dataclass(frozen=True)
class Q8:
    """A weight stored as int8 ``q`` with f32 per-channel ``scale``, which
    broadcasts against ``q`` (size 1 on every dim but the channel's)."""

    q: torch.Tensor
    scale: torch.Tensor


def _channel_dims(model: nn.Module) -> Dict[str, int]:
    """``<module>.weight`` -> the dim its scales run along, for the
    weights the reference would quantize were they big enough."""
    dims = {}
    for name, m in model.named_modules():
        w = getattr(m, "weight", None)
        if not isinstance(w, torch.Tensor) or w.dim() < 2:
            continue
        key = f"{name}.weight" if name else "weight"
        if isinstance(m, nn.Embedding):
            dims[key] = w.dim() - 1
        elif isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
            dims[key] = 1
        else:
            dims[key] = 0
    return dims


@torch.no_grad()
def quantize_state_dict(model: nn.Module, min_size: int = 4096
                        ) -> Dict[str, object]:
    """``model.state_dict()`` with each weight the reference quantizes
    replaced by a :class:`Q8`: ``scale = max(max|w| over the other dims /
    127, 1e-12)``, ``q = clip(round(w / scale), -127, 127)``, computed on
    the host in f32 and put back on the weight's device."""
    dims = _channel_dims(model)
    out: Dict[str, object] = {}
    for key, t in model.state_dict().items():
        dim = dims.get(key)
        if dim is None or t.numel() < min_size:
            out[key] = t
            continue
        w = t.to("cpu", torch.float32)
        other = tuple(d for d in range(w.dim()) if d != dim)
        s = torch.clamp_min(torch.div(w.abs().amax(dim=other, keepdim=True),
                                      127.0), 1e-12)
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        out[key] = Q8(q=q.to(t.device), scale=s.to(t.device))
    return out


def dequantize_state_dict(qsd: Dict[str, object],
                          dtype: torch.dtype = torch.bfloat16
                          ) -> Dict[str, torch.Tensor]:
    """Inverse transform: ``(q.float() * scale).to(dtype)`` for every
    :class:`Q8`, every other entry as it is."""
    return {k: ((v.q.float() * v.scale).to(dtype) if isinstance(v, Q8)
                else v) for k, v in qsd.items()}


def quantized_bytes(qsd: Dict[str, object]) -> Tuple[int, int]:
    """(bytes as stored, bytes if everything were bf16): the reference's
    accounting, in which a quantized weight's dense baseline is the kernel
    alone and its scales are overhead."""
    stored = dense = 0
    for v in qsd.values():
        if isinstance(v, Q8):
            stored += (v.q.numel() * v.q.element_size()
                       + v.scale.numel() * v.scale.element_size())
            dense += v.q.numel() * 2
        else:
            stored += v.numel() * v.element_size()
            dense += v.numel() * 2
    return stored, dense


def make_quantized_apply(model: nn.Module, min_size: int = 4096,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> Tuple[Callable, Dict[str, object]]:
    """``(apply_fn, qsd)``: ``apply_fn(images)`` runs, in eval mode without
    autograd, a copy of ``model`` whose quantized weights were replaced by
    their dequantized ``dtype`` values (stored in each entry's own dtype,
    as ``load_state_dict`` casts)."""
    qsd = quantize_state_dict(model, min_size=min_size)
    served = copy.deepcopy(model)
    served.load_state_dict(dequantize_state_dict(qsd, dtype), strict=True)
    served.eval()

    def apply_fn(images, **kw):
        with torch.inference_mode():
            return served(images, **kw)

    return apply_fn, qsd
