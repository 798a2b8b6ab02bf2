"""Numerical safety of the training objective.

Counterpart of ``guarded`` in ``pautdx/utils/debug.py``; the JAX module's
``jax_debug_nans`` switch, ``sanitize`` and ``check_finite`` are not ported
yet.
"""

from __future__ import annotations

from typing import Callable

import torch


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
