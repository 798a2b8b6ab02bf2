"""AdamW with global-norm clipping, param-group learning rates, schedules
and EMA.

Counterpart of ``pautdx/train/optim.py``. ``make_optimizer`` returns a
spec; ``spec.init(model)`` builds a :class:`ClippedAdamW` over the model's
parameters, grouped by ``label_params``' glob patterns over the port's
dotted parameter names (which mirror the reference's parameter tree). Two
places where PyTorch's own tools differ from optax's, and which this module
follows optax on:

- optax's ``clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no ``+ 1e-6`` in the denominator
  (``torch.nn.utils.clip_grad_norm_`` has one);
- optax's learning rate multiplies the whole AdamW update, weight decay
  included: each group's ``lr`` here is ``base_lr(count) * mult *
  lr_scale``, and ``torch.optim.AdamW`` multiplies its decay by ``lr``.

AdamW itself is ``torch.optim.AdamW`` at optax's defaults (b1 0.9, b2
0.999, eps 1e-8 outside the square root, decay on every parameter).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Union)

import torch
from torch import nn


def label_params(names: Iterable[str],
                 group_patterns: Mapping[str, Sequence[str]],
                 default: str = "default") -> Dict[str, str]:
    """Label each dotted parameter name by the first glob group that
    matches it (``fnmatch``, or a prefix match of the pattern without its
    trailing ``*``)."""
    labels = {}
    for name in names:
        lab = default
        for group, patterns in group_patterns.items():
            if any(fnmatch.fnmatch(name, pat)
                   or name.startswith(pat.rstrip("*")) for pat in patterns):
                lab = group
                break
        labels[name] = lab
    return labels


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0, final_scale: float = 0.01
                    ) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: a linear warmup from 0 to
    ``base_lr`` over ``warmup_steps``, then a cosine decay to
    ``base_lr * final_scale`` at ``total_steps`` (warmup included)."""
    decay_steps = max(total_steps, 1)
    end = base_lr * final_scale
    alpha = 0.0 if base_lr == 0.0 else end / base_lr
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"cosine_schedule: total_steps {total_steps} must "
                         f"exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if warmup_steps and count < warmup_steps:
            return base_lr * count / warmup_steps
        t = min(float(count - warmup_steps), float(cos_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * t / cos_steps))
        return base_lr * ((1 - alpha) * cosine + alpha)

    return schedule


class ReduceLROnPlateau:
    """Host-side plateau controller -> an lr scale for the train step
    (torch ``ReduceLROnPlateau`` semantics: factor, patience, min)."""

    def __init__(self, factor: float = 0.5, patience: int = 3,
                 min_scale: float = 1e-3, mode: str = "min"):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_scale
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        improved = (self.best is None
                    or (metric < self.best if self.mode == "min"
                        else metric > self.best))
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale


Tensors = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]


def scale_updates(updates: Tensors,
                  scale: Union[float, torch.Tensor]) -> Tensors:
    """Multiply every update by a scalar (lr scaling)."""
    if isinstance(updates, Mapping):
        return {k: u * scale for k, u in updates.items()}
    return [u * scale for u in updates]


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor],
               params: Mapping[str, torch.Tensor],
               decay: float = 0.999) -> Dict[str, torch.Tensor]:
    """``ema = decay * ema + (1 - decay) * params``, in place; returns
    ``ema_params``."""
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [params[k].detach() for k in keys],
                        alpha=1.0 - decay)
    return ema_params


@torch.no_grad()
def zero_frozen_grads(model: nn.Module,
                      trainable: Mapping[str, Union[bool, str]]) -> None:
    """Zero the gradients of frozen parameters in place, BEFORE the
    optimizer clips: frozen gradients must not inflate the global norm
    (torch's ``requires_grad=False`` semantics). ``trainable`` maps a
    dotted name to True/False or to a label, ``"frozen"`` meaning frozen;
    names it does not list train."""
    for name, p in model.named_parameters():
        m = trainable.get(name, True)
        keep = m is True or (isinstance(m, str) and m != "frozen")
        if not keep and p.grad is not None:
            p.grad.zero_()


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm of all the tensors together, f32, on their device."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class ClippedAdamW:
    """Clip by global norm, then AdamW per param group, on a model's
    parameters. ``count`` is the number of updates applied, which the
    schedule reads, as optax's count."""

    def __init__(self, spec: "OptimizerSpec",
                 named_params: Sequence[tuple]):
        self.spec = spec
        named_params = list(named_params)
        self.params = [p for _, p in named_params]
        mults = dict(spec.group_lr_mults or {})
        mults.setdefault("default", 1.0)
        if spec.group_lr_mults:
            labels = label_params([n for n, _ in named_params],
                                  spec.group_patterns or {})
        else:
            labels = {n: "default" for n, _ in named_params}
        groups: Dict[str, List[torch.Tensor]] = {}
        for name, p in named_params:
            groups.setdefault(labels[name], []).append(p)
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "label": lab, "mult": mults[lab]}
             for lab, ps in groups.items()],
            lr=spec.learning_rate, betas=(spec.b1, spec.b2), eps=1e-8,
            weight_decay=spec.weight_decay)
        self.count = 0

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def grads(self) -> List[torch.Tensor]:
        """Every parameter's gradient; a parameter that took none gets a
        zero one, so that AdamW still decays it, as optax does."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    @torch.no_grad()
    def step(self, lr_scale: float = 1.0,
             grad_norm: Optional[torch.Tensor] = None) -> None:
        """Clip the gradients by their global norm (``grad_norm`` if the
        caller has it) and apply one AdamW update at the scheduled lr
        times ``lr_scale``."""
        grads = self.grads()
        norm = global_norm(grads) if grad_norm is None else grad_norm
        clip = self.spec.clip_norm
        torch._foreach_mul_(grads, torch.where(
            norm < clip, torch.ones_like(norm), clip / norm))
        base = (self.spec.schedule(self.count) if self.spec.schedule
                else self.spec.learning_rate)
        for group in self.adamw.param_groups:
            group["lr"] = base * group["mult"] * lr_scale
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What ``make_optimizer`` returns: ``init(model)`` builds the
    optimizer over ``model``'s parameters."""
    learning_rate: float = 6e-4
    weight_decay: float = 0.015
    clip_norm: float = 1.0
    schedule: Optional[Callable[[int], float]] = None
    group_lr_mults: Optional[Mapping[str, float]] = None
    group_patterns: Optional[Mapping[str, Sequence[str]]] = None
    b1: float = 0.9
    b2: float = 0.999

    def init(self, model: nn.Module) -> ClippedAdamW:
        return ClippedAdamW(self, [(n, p) for n, p in model.named_parameters()
                                   if p.requires_grad])


def make_optimizer(learning_rate: float = 6e-4,
                   weight_decay: float = 0.015,
                   clip_norm: float = 1.0,
                   schedule: Optional[Callable[[int], float]] = None,
                   group_lr_mults: Optional[Mapping[str, float]] = None,
                   group_patterns: Optional[
                       Mapping[str, Sequence[str]]] = None,
                   b1: float = 0.9, b2: float = 0.999) -> OptimizerSpec:
    """AdamW + clip, optionally with per-group lr multipliers, which need
    ``group_patterns`` (glob patterns over dotted parameter names)."""
    if group_lr_mults and group_patterns is None:
        raise ValueError("make_optimizer: group_lr_mults needs "
                         "group_patterns")
    return OptimizerSpec(learning_rate, weight_decay, clip_norm, schedule,
                         group_lr_mults, group_patterns, b1, b2)
