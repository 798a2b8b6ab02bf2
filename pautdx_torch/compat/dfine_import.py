"""HF D-FINE checkpoints into the port's D-FINE and back, torch to torch.

Counterpart of ``pautdx/compat/dfine_import.py``. The port's modules mirror
the reference's module paths, which mirror ``transformers``'
``DFineForObjectDetection``, and the port keeps torch's layouts, so an HF
state-dict key IS the port's key and a conversion is a matching by name:

- :func:`convert_state_dict` fills every entry of the port module's
  ``state_dict()`` from the HF entry of the same key (same shape, cast to
  the port entry's dtype). A port entry without an HF source raises
  ``KeyError``, except the denoising embedding, which a checkpoint trained
  with ``num_denoising=0`` lacks (it keeps the module's value). The HF
  entries left over are returned: BatchNorm ``num_batches_tracked``, the
  config-derived buffers (``anchors``, ``valid_mask``,
  ``num_points_scale``, ``up``, ``reg_scale``: the port takes them from
  its config) and the tied head copies under ``model.decoder.*``.
- :func:`export_state_dict` is its inverse: each key of an HF template
  (``DFineForObjectDetection(config).state_dict()``) filled from the port
  entry of the same key, or, for the tied heads HF exposes again under
  ``model.decoder.``, of the key without that prefix; keys with no port
  counterpart keep the template's own values, which are config-derived
  constants of a model built from the same config. Without a template the
  export is the port's entries plus those tied aliases.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]

# HF exposes the detection heads twice: at the top and tied under here
_TIED = "model.decoder."
_HEADS = ("class_embed.", "bbox_embed.")


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(v)))


def convert_state_dict(hf_state_dict: Mapping, module: nn.Module
                       ) -> Tuple[StateDict, List[str]]:
    """HF ``state_dict`` (tensors or numpy arrays) -> (the port module's
    full state dict, the HF keys left unused). Raises ``KeyError`` for a
    port entry without an HF source (denoising embeddings excepted) and
    ``ValueError`` for a shape that differs."""
    out: StateDict = {}
    missing, used = [], set()
    for key, target in module.state_dict().items():
        if key not in hf_state_dict:
            missing.append(key)
            out[key] = target.detach().clone()
            continue
        src = _tensor(hf_state_dict[key])
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch at {key}: HF "
                             f"{tuple(src.shape)} vs port "
                             f"{tuple(target.shape)}")
        out[key] = src.detach().to(target.dtype).clone()
        used.add(key)
    hard = [k for k in missing if "denoising" not in k]
    if hard:
        raise KeyError(f"{len(hard)} port entries had no HF source, e.g. "
                       f"{hard[:8]}")
    return out, [k for k in hf_state_dict if k not in used]


def load_hf_state_dict(module: nn.Module, hf_state_dict: Mapping
                       ) -> List[str]:
    """Convert and load strictly into ``module``; returns the unused HF
    keys."""
    sd, unused = convert_state_dict(hf_state_dict, module)
    module.load_state_dict(sd, strict=True)
    return unused


def load_torch_model_state(model: nn.Module) -> StateDict:
    """A torch module's state dict, buffers included, detached on the
    host."""
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _port_key(key: str, sd: StateDict) -> Optional[str]:
    for k in (key, key[len(_TIED):] if key.startswith(_TIED) else None):
        if k is not None and k in sd:
            return k
    return None


def export_state_dict(module: nn.Module,
                      hf_template: Optional[Mapping] = None) -> StateDict:
    """The port module's weights as an HF state dict, on the host: every
    key of ``hf_template`` filled from the port (its dtype kept) or, where
    the port has no such entry, from the template; without a template,
    the port's entries and the heads' ``model.decoder.`` aliases."""
    sd = load_torch_model_state(module)
    if hf_template is None:
        out = {k: v.clone() for k, v in sd.items()}
        out.update({_TIED + k: v.clone() for k, v in sd.items()
                    if k.startswith(_HEADS)})
        return out
    out = {}
    for key, tval in hf_template.items():
        tval = _tensor(tval)
        src = _port_key(key, sd)
        if src is None:
            out[key] = tval.detach().clone()            # config-derived
            continue
        if tuple(sd[src].shape) != tuple(tval.shape):
            raise ValueError(f"shape mismatch at {key}: port "
                             f"{tuple(sd[src].shape)} vs HF "
                             f"{tuple(tval.shape)}")
        out[key] = sd[src].to(tval.dtype).clone()
    return out
