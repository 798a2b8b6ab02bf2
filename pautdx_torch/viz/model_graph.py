"""Model-structure diagram as Graphviz DOT text (dependency-free).

Counterpart of ``pautdx/viz/model_graph.py``, which derives the diagram
from the JAX parameter tree (the module tree). Here the tree comes from an
``nn.Module`` (:func:`param_tree`), or is given as nested dicts as the
reference takes it. The port's modules carry the reference's names: where
the reference names one submodule ``model.backbone.model`` or
``bbox_embed.0``, the port reaches the same module through plain
``nn.Module`` namespaces and ``nn.ModuleList``/``nn.Sequential``
containers. So a container's name joins its child's with a dot, every
other module is one node, and each level is taken in sorted key order,
the order in which a JAX variable tree holds its keys: the same weights
give the reference's DOT text.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Union

import numpy as np
import torch
from torch import nn

Params = Union[nn.Module, Mapping]

# containers that only name their children: no node of their own
_CONTAINERS = (nn.Module, nn.ModuleList, nn.Sequential, nn.ModuleDict)


def _fill(module: nn.Module, node: Dict, prefix: str) -> None:
    for name, p in module.named_parameters(recurse=False):
        node[prefix + name] = p
    for name, child in module.named_children():
        if type(child) in _CONTAINERS:
            _fill(child, node, f"{prefix}{name}.")
        else:
            sub: Dict = {}
            _fill(child, sub, "")
            if sub:
                node[prefix + name] = sub


def _sorted(tree: Dict) -> Dict:
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def param_tree(module: nn.Module) -> Dict:
    """A module's parameters (buffers left out, as the reference's
    ``params`` collection leaves its ``batch_stats``) as the nested tree of
    the reference's module names, keys sorted."""
    tree: Dict = {}
    _fill(module, tree, "")
    return _sorted(tree)


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    shape = tuple(tree.shape) if isinstance(tree, torch.Tensor) \
        else np.shape(tree)
    return int(np.prod(shape)) if shape else 1


def model_dot(params: Params, name: str = "model",
              max_depth: int = 2) -> str:
    """A module (:func:`param_tree`), or a nested dict of arrays or tensors
    taken as it is, -> DOT digraph of modules down to ``max_depth``,
    annotated with parameter counts."""
    tree = param_tree(params) if isinstance(params, nn.Module) \
        else dict(params)
    lines = [f'digraph "{name}" {{',
             "  rankdir=TB; node [shape=box, fontsize=10];",
             f'  root [label="{name}\\n{_count(tree):,} params"];']
    idx = [0]

    def walk(sub_tree, parent: str, depth: int):
        if depth >= max_depth or not isinstance(sub_tree, dict):
            return
        for key, sub in sub_tree.items():
            if not isinstance(sub, dict):
                continue
            idx[0] += 1
            node = f"n{idx[0]}"
            lines.append(
                f'  {node} [label="{key}\\n{_count(sub):,} params"];')
            lines.append(f"  {parent} -> {node};")
            walk(sub, node, depth + 1)

    walk(tree, "root", 0)
    lines.append("}")
    return "\n".join(lines)


def save_model_dot(params: Params, path: str, name: str = "model",
                   max_depth: int = 2) -> str:
    dot = model_dot(params, name=name, max_depth=max_depth)
    with open(path, "w") as f:
        f.write(dot)
    return dot
