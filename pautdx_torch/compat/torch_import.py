"""The reference's own torch ``.pth`` state dicts into the port's modules,
torch to torch.

Counterpart of ``pautdx/compat/torch_import.py``. The reference ships
trained torch checkpoints (``MultiSignalClassifier_model*.pth``, the
set transformer, the MLP classifiers, per-epoch trainer dicts); the port's
signal models keep the JAX package's module layout, so each importer
renames the reference's keys onto the port's and loads them strictly.
Linear, Conv1d and norm tensors keep their torch layout; a
``nn.MultiheadAttention``'s ``in_proj_weight`` / ``in_proj_bias`` split
into ``TinyMHA``'s ``q_proj`` / ``k_proj`` / ``v_proj`` (rows [0, d),
[d, 2d), [2d, 3d)), as the reference's own
``load_legacy_mha_checkpoint_into_tiny`` does.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


def load_state_dict(path: str) -> StateDict:
    """A torch checkpoint as a flat name -> CPU tensor dict: a raw state
    dict, a trainer dict with ``model_state_dict`` (the reference's
    per-epoch format) or a pickled module."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.detach().cpu() for k, v in obj.items()}


def affine(sd: StateDict, src: str, dst: str) -> StateDict:
    """A Linear (or LayerNorm) ``src.weight`` / ``src.bias`` under
    ``dst``."""
    return {f"{dst}.weight": sd[f"{src}.weight"],
            f"{dst}.bias": sd[f"{src}.bias"]}


def mha_to_tiny(sd: StateDict, src: str, dst: str) -> StateDict:
    """A torch ``nn.MultiheadAttention`` at ``src`` (or one already split
    into ``q``/``k``/``v`` Linears) -> ``TinyMHA`` entries under ``dst``."""
    if f"{src}.in_proj_weight" in sd:
        w, b = sd[f"{src}.in_proj_weight"], sd[f"{src}.in_proj_bias"]
        d = w.shape[1]
        out = {}
        for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{dst}.{name}.weight"] = w[i * d:(i + 1) * d]
            out[f"{dst}.{name}.bias"] = b[i * d:(i + 1) * d]
    else:
        out = {}
        for n in ("q", "k", "v"):
            out.update(affine(sd, f"{src}.{n}", f"{dst}.{n}_proj"))
    out.update(affine(sd, f"{src}.out_proj", f"{dst}.out_proj"))
    return out


@torch.no_grad()
def _load(model: nn.Module, state: StateDict) -> nn.Module:
    """Strict load: every entry of ``model`` filled, every one of
    ``state`` used; values are cast to each entry's dtype and device."""
    model.load_state_dict({k: v.contiguous() for k, v in state.items()},
                          strict=True)
    return model


def import_msc(sd: StateDict, model: nn.Module) -> nn.Module:
    """The gen-1 attention-MLP MultiSignalClassifier
    (``shared_layer.{0,2}`` Linear, ``attention`` MHA,
    ``classifier.{0,2}`` Linear) into ``models.signal.
    MultiSignalClassifier``."""
    return _load(model, {
        **affine(sd, "shared_layer.0", "embed.Dense_0"),
        **affine(sd, "shared_layer.2", "embed.Dense_1"),
        **mha_to_tiny(sd, "attention", "attn"),
        **affine(sd, "classifier.0", "head.Dense_0"),
        **affine(sd, "classifier.2", "head.Dense_1"),
    })


def import_set_transformer(sd: StateDict, model: nn.Module) -> nn.Module:
    """``set_transformer_model.pth`` (``encoder.0`` Linear, the attention
    blocks ``encoder.2`` and ``encoder.3`` with post-norms, ``decoder``
    MLP) into ``models.signal.SetTransformer``."""
    return _load(model, {
        **affine(sd, "encoder.0", "embed"),
        **mha_to_tiny(sd, "encoder.2.attention", "mab_0"),
        **affine(sd, "encoder.2.layer_norm", "norm_0"),
        **mha_to_tiny(sd, "encoder.3.attention", "mab_1"),
        **affine(sd, "encoder.3.layer_norm", "norm_1"),
        **affine(sd, "decoder.0", "head.Dense_0"),
        **affine(sd, "decoder.2", "head.Dense_1"),
    })


def import_mlp_classifier(sd: StateDict, model: nn.Module,
                          prefix: str = "shared_layer") -> nn.Module:
    """A ``nn.Sequential`` Linear/ReLU stack under ``prefix``
    (``signal_classifier_model2.pth``: "shared_layer";
    ``anomaly_detector_model.pth``: "network") into
    ``models.signal.SignalClassifierMLP``, its Linears in index order."""
    idxs = sorted({int(k.split(".")[1]) for k in sd
                   if k.startswith(prefix + ".") and k.endswith(".weight")})
    state = {}
    for i, j in enumerate(idxs):
        state.update(affine(sd, f"{prefix}.{j}", f"mlp.Dense_{i}"))
    return _load(model, state)
