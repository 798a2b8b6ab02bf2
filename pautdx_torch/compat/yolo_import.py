"""Ultralytics YOLO state dict -> the port's ``YOLO``, strictly.

Counterpart of ``pautdx/compat/yolo_import.py``. The reference fine-tunes
Ultralytics checkpoints (``yolov5su.pt``, ``yolov8n-seg.pt``,
``yolov9c-seg.pt``, ``yolo11n.pt``); this loads their weights into
:class:`pautdx_torch.models.vision.yolo.YOLO`, whose module tree mirrors
Ultralytics' inside each layer.

The input is a flat torch state dict (``{key: tensor or ndarray}``), for
example ``torch.save(YOLO("yolov8n.pt").model.state_dict(), "sd.pt")``
where the ``ultralytics`` package is installed, read back with
:func:`load_yolo_pt`. The mapping is a key translation: Ultralytics'
``model.{layer_idx}.{submodule...}`` -> the port's module path, through the
per-flavour layer tables below (the yolov8 / yolov5 / yolov9c / yolo11
yaml layer indices); the rest of the key is the same on both sides. It is
a torch-to-torch copy, so every tensor goes over verbatim: no transpose,
and no flip of the proto ``upsample`` ``ConvTranspose2d`` kernel (the
flip belongs to the JAX -> port bridge, ``compat/jax_weights.py``).

- ``num_batches_tracked`` is skipped: the port's ``BatchNorm`` has none.
- The DFL's fixed conv weight (``...dfl.conv.weight``) must equal
  ``arange(reg_max)`` (``dfl_expectation`` computes with exactly that),
  then is skipped.
- Every entry of the port's ``state_dict()`` must get a value
  (``KeyError`` otherwise) of its own shape (``ValueError`` naming the
  path otherwise). Keys that reach no entry are returned as unused.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# layer index -> the port's module path (yolov8.yaml)
_V8_TABLE = {
    0: "backbone.stem", 1: "backbone.down1", 2: "backbone.c1",
    3: "backbone.down2", 4: "backbone.c2", 5: "backbone.down3",
    6: "backbone.c3", 7: "backbone.down4", 8: "backbone.c4",
    9: "backbone.sppf",
    12: "neck.td4", 15: "neck.td3", 16: "neck.d3", 18: "neck.bu4",
    19: "neck.d4", 21: "neck.bu5",
    22: "HEAD",
}

# yolov5.yaml (u-variant) indices: lateral convs + shifted head
_V5_TABLE = {
    0: "backbone.stem", 1: "backbone.down1", 2: "backbone.c1",
    3: "backbone.down2", 4: "backbone.c2", 5: "backbone.down3",
    6: "backbone.c3", 7: "backbone.down4", 8: "backbone.c4",
    9: "backbone.sppf",
    10: "neck.lat5", 13: "neck.td4", 14: "neck.lat4", 17: "neck.td3",
    18: "neck.d3", 20: "neck.bu4", 21: "neck.d4", 23: "neck.bu5",
    24: "HEAD",
}

# yolo11.yaml indices: C3k2 stages + C2PSA at 10, head shifted to 23
_V11_TABLE = {
    0: "backbone.stem", 1: "backbone.down1", 2: "backbone.c1",
    3: "backbone.down2", 4: "backbone.c2", 5: "backbone.down3",
    6: "backbone.c3", 7: "backbone.down4", 8: "backbone.c4",
    9: "backbone.sppf", 10: "backbone.psa",
    13: "neck.td4", 16: "neck.td3", 17: "neck.d3", 19: "neck.bu4",
    20: "neck.d4", 22: "neck.bu5",
    23: "HEAD",
}

# yolov9c(-seg).yaml's GELAN stages, ADown downsamplers and SPPELAN sit at
# yolov8.yaml's indices
TABLES = {"v8": _V8_TABLE, "v5": _V5_TABLE, "v9c": _V8_TABLE,
          "v11": _V11_TABLE}


def _normalize_keys(state_dict: Mapping) -> Tuple[Dict[str, str], List[str]]:
    """{key with leading non-digit segments ('model.') stripped: original
    key}, and the keys with no digit segment at all (e.g. a 'stride'
    buffer), which must surface as unused rather than vanish."""
    out, undigited = {}, []
    for k in state_dict:
        parts = k.split(".")
        while parts and not parts[0].isdigit():
            parts = parts[1:]
        if parts:
            out[".".join(parts)] = k
        else:
            undigited.append(k)
    return out, undigited


def _head_path(rest: str) -> Tuple[str, str]:
    """A Detect/Segment sub-key -> (the port's module path, remainder);
    ("", rest) for what the port has no module for (the DFL)."""
    if rest.startswith("proto."):
        return "proto", rest[len("proto."):]
    if rest.startswith("cv4."):
        m = re.match(r"(cv4\.\d+\.\d+)\.(.*)", rest)
        return f"mask_head.{m.group(1)}", m.group(2)
    m = re.match(r"(cv[23]\.\d+\.\d+)\.(.*)", rest)
    if m is None:
        return "", rest
    return f"head.{m.group(1)}", m.group(2)


def _tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(v))


@torch.no_grad()
def load_ultralytics_state_dict(model: nn.Module, state_dict: Mapping,
                                flavour: str) -> List[str]:
    """Fill the port's ``YOLO`` in place from an Ultralytics flat state
    dict of the same configuration, strictly; returns the keys that
    reached no entry of the model. Values are copied verbatim, cast to
    each entry's dtype on its device."""
    if flavour not in TABLES:
        raise ValueError(f"unsupported flavour {flavour!r} "
                         f"(known: {sorted(TABLES)})")
    table = TABLES[flavour]
    target = model.state_dict()
    keys, unused = _normalize_keys(state_dict)
    out: Dict[str, torch.Tensor] = {}
    for key, orig in keys.items():
        idx, _, rest = key.partition(".")
        base = table.get(int(idx))
        if base == "HEAD":
            if rest == "dfl.conv.weight":
                reg_max = model.cfg.reg_max
                w = _tensor(state_dict[orig]).float().cpu()
                want = torch.arange(reg_max, dtype=torch.float32).view(
                    1, reg_max, 1, 1)
                if w.shape != want.shape or not torch.equal(w, want):
                    raise ValueError(f"{orig}: the DFL conv weight must be "
                                     f"arange({reg_max}) of shape "
                                     f"{tuple(want.shape)}")
                continue
            base, rest = _head_path(rest)
        if rest.rpartition(".")[2] == "num_batches_tracked":
            continue
        path = f"{base}.{rest}"
        if not base or path not in target:
            unused.append(orig)
            continue
        t = _tensor(state_dict[orig])
        if tuple(t.shape) != tuple(target[path].shape):
            raise ValueError(f"shape mismatch at {path} ({orig}): "
                             f"Ultralytics {tuple(t.shape)} vs port "
                             f"{tuple(target[path].shape)}")
        out[path] = t
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} port entries had no Ultralytics "
                       f"source, e.g. {missing[:8]}")
    model.load_state_dict(out, strict=True)
    return unused


def load_yolo_pt(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pt`` file holding a raw state dict (or a dict with one under
    ``"state_dict"``) -> {key: float32 CPU tensor}. Loaded with
    ``weights_only=True``: a full Ultralytics pickle needs the
    ``ultralytics`` package to be saved as a raw state dict first (see the
    module docstring)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v.float() for k, v in sd.items()}
