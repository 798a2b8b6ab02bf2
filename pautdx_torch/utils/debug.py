"""Numerical safety: NaN debugging, sanitizers, finiteness checks, and the
guarded training objective.

Counterpart of ``pautdx/utils/debug.py``:
- :func:`enable_nan_debugging`: the reference's global ``jax_debug_nans``
  becomes ``torch.autograd.set_detect_anomaly``, which raises at the
  backward of the operation that made a NaN;
- :func:`sanitize`: ``nan_to_num`` + clamp as one call, on tensors;
- :func:`check_finite`: raise on non-finite leaves of a tensor, a module
  or a (nested) dict/list of tensors, naming them as the reference does;
- :func:`guarded`: a non-finite loss falls back to a constant.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn


def enable_nan_debugging(enable: bool = True) -> None:
    """Switch autograd's anomaly detection on or off for the process."""
    torch.autograd.set_detect_anomaly(enable)


def sanitize(x: torch.Tensor, clamp: Optional[float] = 20.0) -> torch.Tensor:
    """NaN -> 0, +-inf -> +-``clamp`` (+-1e4 where ``clamp`` is None or 0),
    then clipped to [-``clamp``, ``clamp``] unless ``clamp`` is None."""
    big = clamp or 1e4
    x = torch.nan_to_num(x, nan=0.0, posinf=big, neginf=-big)
    if clamp is not None:
        x = torch.clamp(x, -clamp, clamp)
    return x


def _leaves(tree, path: str, out: List) -> None:
    """(name, leaf) pairs in the order a JAX pytree flattens: dict keys
    sorted, list items in order (named ``[i]``), path parts joined by
    ``/``; None is an empty subtree."""
    if isinstance(tree, nn.Module):
        tree = {**dict(tree.named_parameters()), **dict(tree.named_buffers())}
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            _leaves(tree[k], f"{path}/{k}" if path else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _leaves(v, f"{path}/[{i}]" if path else f"[{i}]", out)
    elif tree is not None:
        out.append((path, tree))


def check_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming (the first ten of) the leaves
    that hold a NaN or an infinity. ``tree``: a tensor or array, a module
    (its parameters and buffers by dotted name), or nested dicts, lists
    and tuples of them, e.g. a state dict."""
    leaves: List = []
    _leaves(tree, "", leaves)
    bad = []
    for path, leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            ok = bool(torch.isfinite(leaf.detach()).all()) \
                if leaf.is_floating_point() or leaf.is_complex() else True
        else:
            ok = bool(np.isfinite(np.asarray(leaf)).all())
        if not ok:
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def guarded(objective: Callable, fallback_value: float = 1.0) -> Callable:
    """Wrap ``objective(...) -> (loss, aux)`` so that a non-finite loss is
    replaced by the constant ``fallback_value``; ``aux["loss_was_finite"]``
    (f32, 1 or 0) records which. The trainer applies no update for such a
    step."""

    def wrapped(*args, **kwargs):
        loss, aux = objective(*args, **kwargs)
        ok = torch.isfinite(loss)
        safe = torch.where(ok, loss, torch.full_like(loss, fallback_value))
        aux = dict(aux)
        aux["loss_was_finite"] = ok.to(torch.float32)
        return safe, aux

    return wrapped
