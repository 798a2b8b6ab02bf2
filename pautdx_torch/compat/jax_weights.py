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
- a 3-d (1-d conv) kernel (k, in, out) becomes ``nn.Conv1d``'s
  (out, in, k); a depthwise one, (k, 1, C), becomes (C, 1, k) by the same
  permutation;
- ``<p>.scale``     -> ``<p>.scale`` where the module has one
  (``LearnableAffine``, ``RMSNorm``), else ``<p>.weight`` (BatchNorm,
  GroupNorm, LayerNorm);
- ``<p>.bias``      -> ``<p>.bias``;
- ``<p>.embedding`` -> ``<p>.weight``;
- any other leaf (``RelativePositionEncoding.encoding``, the pattern
  models' ``background_reference`` and ``background_prototypes``) keeps
  its path;
- batch_stats ``<p>.mean``/``<p>.var`` -> ``<p>.running_mean``/``running_var``;
- a JAX ``GRUCell`` (``<p>.GRUCell_0`` the forward cell, ``<p>.GRUCell_1``
  the backward one, as the reference's ``BiGRU`` names them) -> the
  ``torch.nn.GRU`` entries ``<p>.weight_ih_l0``, ``weight_hh_l0``,
  ``bias_ih_l0``, ``bias_hh_l0`` (``_reverse`` for the backward cell): the
  input Denses ``ir``/``iz``/``in`` stack as (r, z, n) rows into
  ``weight_ih`` and their biases into ``bias_ih``; the hidden Denses
  ``hr``/``hz``/``hn`` into ``weight_hh``, and ``bias_hh`` is
  ``[0, 0, b_hn]`` (``hr`` and ``hz`` have no bias). Both compute
  ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``;
- a JAX ``OptimizedLSTMCell`` (``<p>.OptimizedLSTMCell_0`` forward,
  ``_1`` backward, as ``BiLSTM`` names them) -> the ``torch.nn.LSTM``
  entries likewise: the input Denses ``ii``/``if``/``ig``/``io`` (no
  bias) stack as (i, f, g, o) rows into ``weight_ih``, the hidden Denses
  ``hi``/``hf``/``hg``/``ho`` into ``weight_hh`` and their biases into
  ``bias_hh``; ``bias_ih`` is 0.

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


_CELL_LEAF = re.compile(
    r"^(?:(.*)\.)?(GRUCell|OptimizedLSTMCell)_([01])\."
    r"(ir|iz|in|hr|hz|hn|ii|if|ig|io|hi|hf|hg|ho)\.(kernel|bias)$")
# each cell kind: (input gates, hidden gates, the gates with a bias)
_CELL_GATES = {
    "GRUCell": (("ir", "iz", "in"), ("hr", "hz", "hn"),
                ("ir", "iz", "in", "hn")),
    "OptimizedLSTMCell": (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho"),
                          ("hi", "hf", "hg", "ho")),
}


def _cell_entries(params: Dict[str, np.ndarray]
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The GRU and LSTM cells among flat params -> {each cell's JAX path:
    the four ``nn.GRU`` / ``nn.LSTM`` entries it fills}. Raises
    ``KeyError`` for a cell that lacks one of its leaves."""
    cells: Dict[tuple, Dict[str, torch.Tensor]] = {}
    for path, arr in params.items():
        m = _CELL_LEAF.match(path)
        if m:
            prefix, kind, cell, gate, leaf = m.groups()
            cells.setdefault((prefix, kind, cell), {})[f"{gate}.{leaf}"] = \
                _to_tensor(arr)
    out = {}
    for (prefix, kind, cell), g in cells.items():
        src = f"{prefix}.{kind}_{cell}" if prefix else f"{kind}_{cell}"
        ins, hids, biased = _CELL_GATES[kind]
        want = [f"{k}.kernel" for k in ins + hids] + [f"{k}.bias"
                                                      for k in biased]
        missing = [k for k in want if k not in g]
        if missing or len(g) != len(want):
            raise KeyError(f"load_jax_variables: {kind} {src} lacks "
                           f"{missing} or has extra leaves {sorted(g)}")
        base = f"{prefix}." if prefix else ""
        sfx = "_reverse" if cell == "1" else ""

        zero = torch.zeros_like(g[f"{hids[0]}.kernel"][0])  # (hidden,)

        def bias(gates):
            return torch.cat([g.get(f"{k}.bias", zero) for k in gates])

        out[src] = {
            f"{base}weight_ih_l0{sfx}": torch.cat(
                [g[f"{k}.kernel"].t() for k in ins]),
            f"{base}weight_hh_l0{sfx}": torch.cat(
                [g[f"{k}.kernel"].t() for k in hids]),
            f"{base}bias_ih_l0{sfx}": bias(ins),
            f"{base}bias_hh_l0{sfx}": bias(hids),
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
    for src, entries in _cell_entries(params).items():
        for key, t in entries.items():
            if key in target_keys:
                out[key] = t.contiguous()
            else:
                unused.append(f"{src} -> {key}")
    for path, arr in params.items():
        if _CELL_LEAF.match(path):
            continue
        leaf = path.rpartition(".")[2]
        t = _to_tensor(arr)
        if leaf == "kernel":
            key = _renamed(path, "weight")
            if t.dim() == 4 and key in transposed_keys:
                t = t.flip(0, 1).permute(2, 3, 0, 1)
            elif t.dim() == 4:
                t = t.permute(3, 2, 0, 1)
            elif t.dim() == 3:
                t = t.permute(2, 1, 0)
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
