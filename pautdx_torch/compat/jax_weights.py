"""Fill a port module from the JAX package's variables, strictly.

The variables are ``{"params": ..., "batch_stats": ...}`` as nested or
dotted-flat dicts of numpy arrays (bfloat16 arrays included). The port's
modules mirror the reference's module paths, so each JAX leaf maps to one
entry of the module's ``state_dict()`` by its leaf name:

- ``<p>.kernel``    -> ``<p>.weight``, transpose undone: a 4-d conv kernel
  (kh, kw, in, out) becomes (out, in, kh, kw), a 2-d dense kernel (in, out)
  becomes (out, in);
- the 4-d kernel of an ``nn.ConvTranspose2d`` is flipped in space as well:
  (kh, kw, in, out) becomes ``K[::-1, ::-1]`` as (in, out, kh, kw). The JAX
  ``ConvTranspose`` (``transpose_kernel=False``) correlates the dilated
  input with its kernel, torch's layer with the spatially flipped one;
- ``<p>.scale``     -> ``<p>.scale`` where the module has one
  (``LearnableAffine``), else ``<p>.weight`` (BatchNorm, LayerNorm);
- ``<p>.bias``      -> ``<p>.bias``;
- ``<p>.embedding`` -> ``<p>.weight``;
- batch_stats ``<p>.mean``/``<p>.var`` -> ``<p>.running_mean``/``running_var``;
- a JAX ``GRUCell`` (``<p>.GRUCell_0`` the forward cell, ``<p>.GRUCell_1``
  the backward one, as the reference's ``BiGRU`` names them) -> the
  ``torch.nn.GRU`` entries ``<p>.weight_ih_l0``, ``weight_hh_l0``,
  ``bias_ih_l0``, ``bias_hh_l0`` (``_reverse`` for the backward cell): the
  input Denses ``ir``/``iz``/``in`` stack as (r, z, n) rows into
  ``weight_ih`` and their biases into ``bias_ih``; the hidden Denses
  ``hr``/``hz``/``hn`` into ``weight_hh``, and ``bias_hh`` is
  ``[0, 0, b_hn]`` (``hr`` and ``hz`` have no bias). Both compute
  ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``.

Loading is strict: every parameter and buffer of the module is filled and
every JAX leaf is used, or a ``KeyError`` names what is missing and what
is left over.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from pautdx_torch.device import resolve_device


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested or dotted-flat mapping -> {dotted.path: array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: torch cannot read it
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _renamed(path: str, name: str) -> str:
    """``a.b.kernel`` -> ``a.b.<name>``; a root leaf is just ``name``."""
    prefix = path.rpartition(".")[0]
    return f"{prefix}.{name}" if prefix else name


_GRU_LEAF = re.compile(
    r"^(?:(.*)\.)?GRUCell_([01])\.(ir|iz|in|hr|hz|hn)\.(kernel|bias)$")
_GRU_LEAVES = ("ir.kernel", "ir.bias", "iz.kernel", "iz.bias", "in.kernel",
               "in.bias", "hr.kernel", "hz.kernel", "hn.kernel", "hn.bias")


def _gru_entries(params: Dict[str, np.ndarray]
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The GRU cells among flat params -> {each cell's JAX path: the four
    ``nn.GRU`` entries it fills}. Raises ``KeyError`` for a cell that
    lacks one of its ten leaves."""
    cells: Dict[tuple, Dict[str, torch.Tensor]] = {}
    for path, arr in params.items():
        m = _GRU_LEAF.match(path)
        if m:
            prefix, cell, gate, leaf = m.groups()
            cells.setdefault((prefix, cell), {})[f"{gate}.{leaf}"] = \
                _to_tensor(arr)
    out = {}
    for (prefix, cell), g in cells.items():
        src = f"{prefix}.GRUCell_{cell}" if prefix else f"GRUCell_{cell}"
        missing = [k for k in _GRU_LEAVES if k not in g]
        if missing:
            raise KeyError(f"load_jax_variables: GRU cell {src} lacks "
                           f"{missing}")
        base = f"{prefix}." if prefix else ""
        sfx = "_reverse" if cell == "1" else ""
        hn_b = g["hn.bias"]
        out[src] = {
            f"{base}weight_ih_l0{sfx}": torch.cat(
                [g[f"{k}.kernel"].t() for k in ("ir", "iz", "in")]),
            f"{base}weight_hh_l0{sfx}": torch.cat(
                [g[f"{k}.kernel"].t() for k in ("hr", "hz", "hn")]),
            f"{base}bias_ih_l0{sfx}": torch.cat(
                [g[f"{k}.bias"] for k in ("ir", "iz", "in")]),
            f"{base}bias_hh_l0{sfx}": torch.cat(
                [torch.zeros_like(hn_b), torch.zeros_like(hn_b), hn_b]),
        }
    return out


def port_state_dict(variables: Mapping, target_keys,
                    transposed_keys=()) -> Dict[str, torch.Tensor]:
    """JAX variables -> {state_dict key: tensor} keyed for a module whose
    state_dict keys are ``target_keys``; ``transposed_keys`` are the weight
    keys of its transposed convolutions. Raises ``KeyError`` unless the two
    key sets match exactly."""
    target_keys = set(target_keys)
    transposed_keys = set(transposed_keys)
    out: Dict[str, torch.Tensor] = {}
    unused = []
    params = flatten(variables.get("params", {}))
    for src, entries in _gru_entries(params).items():
        for key, t in entries.items():
            if key in target_keys:
                out[key] = t.contiguous()
            else:
                unused.append(f"{src} -> {key}")
    for path, arr in params.items():
        if _GRU_LEAF.match(path):
            continue
        leaf = path.rpartition(".")[2]
        t = _to_tensor(arr)
        if leaf == "kernel":
            key = _renamed(path, "weight")
            if t.dim() == 4 and key in transposed_keys:
                t = t.flip(0, 1).permute(2, 3, 0, 1)
            elif t.dim() == 4:
                t = t.permute(3, 2, 0, 1)
            elif t.dim() == 2:
                t = t.t()
        elif leaf == "scale":
            key = path if path in target_keys else _renamed(path, "weight")
        elif leaf == "embedding":
            key = _renamed(path, "weight")
        else:
            key = path
        if key in target_keys:
            out[key] = t.contiguous()
        else:
            unused.append(path)
    for path, arr in flatten(variables.get("batch_stats", {})).items():
        leaf = path.rpartition(".")[2]
        key = {"mean": _renamed(path, "running_mean"),
               "var": _renamed(path, "running_var")}.get(leaf, path)
        if key in target_keys:
            out[key] = _to_tensor(arr)
        else:
            unused.append(f"batch_stats:{path}")
    missing = sorted(target_keys - set(out))
    if missing or unused:
        raise KeyError(f"load_jax_variables: {len(missing)} port entries "
                       f"without a JAX leaf (e.g. {missing[:6]}), "
                       f"{len(unused)} JAX leaves unused (e.g. {unused[:6]})")
    return out


@torch.no_grad()
def load_jax_variables(module: nn.Module, variables: Mapping,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> nn.Module:
    """Fill ``module`` in place from the JAX variables, strictly, and move
    it to ``device`` (default ``"cuda"``). Values are cast to each port
    entry's dtype; a shape that differs raises."""
    dev = resolve_device(device)
    transposed = [f"{name}.weight" if name else "weight"
                  for name, m in module.named_modules()
                  if isinstance(m, nn.ConvTranspose2d)]
    module.load_state_dict(
        port_state_dict(variables, module.state_dict().keys(), transposed),
        strict=True)
    return module.to(dev)
