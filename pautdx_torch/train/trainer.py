"""The training harness: one model on one device.

Counterpart of ``pautdx/train/trainer.py`` (``Trainer`` with ``init``,
``train_epoch``, ``evaluate`` and ``fit``; the same history rows, early
stopping, plateau logic and per-epoch checkpoints). The objective is
``objective(out, batch) -> (loss, aux)``; the model is an ``nn.Module``
whose ``forward(x, train=...)`` sets its own mode, as ``DFine`` does.
Batches are dicts of numpy arrays (or tensors) with at least
``input_key`` (``"images"``, which the port's detectors take).

PyTorch runs eagerly, so the parameters, BN statistics and optimizer
moments live in the model and the optimizer, and :class:`TrainState` is a
handle on them with the reference's ``step``.

The non-finite guard of ``trainer.py:109-145`` is kept whole and always on
(the objective is wrapped in ``utils.debug.guarded``, as there): when the
loss or the gradient norm is not finite, the step applies no update, so
the parameters, the optimizer's moments and count, and the BN running
statistics (snapshot before the forward) all stay as they were. Deciding
that takes one host sync per step, on top of the criterion's own (its
Hungarian solve runs on the host).

Not ported: ``mesh=`` (data parallelism, ROADMAP queue 1, item 14), the
reference's EMA of the parameters (``optim.ema_update`` is ported; no
entry point turns it on) and ``data/prefetch.py``'s threaded loader; the
input pipeline here keeps ``PREFETCH`` batches in flight, copied from
pinned host memory with ``non_blocking=True``. Dropout draws from torch's
global generator, so the reference's ``seed`` argument is not kept (the
nano preset has no dropout).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from pautdx_torch.train.checkpoint import CheckpointManager, load_model_state
from pautdx_torch.train.optim import (ClippedAdamW, OptimizerSpec,
                                      ReduceLROnPlateau, global_norm)
from pautdx_torch.utils.debug import guarded

PREFETCH = 2      # batches whose host-to-device copies run ahead of the step


def _cpu(tree):
    """A copy of a nested dict/list with every tensor detached on the CPU."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: ClippedAdamW

    def state_dict(self) -> Dict[str, Any]:
        """CPU copies of everything a checkpoint keeps."""
        return _cpu({
            "step": self.step,
            "params": dict(self.model.named_parameters()),
            "batch_stats": dict(self.model.named_buffers()),
            "opt_state": self.optimizer.state_dict(),
        })

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        load_model_state(self.model, state)
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])


class Trainer:
    def __init__(self, model: nn.Module, objective: Callable,
                 optimizer: OptimizerSpec,
                 *, mesh=None, checkpoint_dir: Optional[str] = None,
                 input_key: str = "images"):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): data-parallel training is not ported "
                "yet (ROADMAP.md, queue 1, item 14)")
        self.model = model
        self.objective = guarded(objective)
        self.optimizer = optimizer
        self.input_key = input_key
        self.ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir \
            else None
        self.history: Dict[str, list] = {}
        self._bn_snapshot: Optional[List[torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -- init -------------------------------------------------------------
    def init(self, example_batch: Dict[str, Any]) -> TrainState:
        """The train state over the model's current weights (the port's
        models are built with seeded weights). ``example_batch`` must hold
        ``input_key``, as the reference's init needs it for shapes."""
        if self.input_key not in example_batch:
            raise KeyError(f"Trainer.init: the batch has no "
                           f"'{self.input_key}'")
        return TrainState(step=0, model=self.model,
                          optimizer=self.optimizer.init(self.model))

    # -- steps ------------------------------------------------------------
    def _bn_buffers(self) -> List[torch.Tensor]:
        return [b for b in self.model.buffers() if b.is_floating_point()]

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   lr_scale: float = 1.0) -> Dict[str, float]:
        """One guarded step on a batch already on the device; returns the
        objective's aux plus ``update_was_finite`` and ``grad_norm``."""
        model, opt = state.model, state.optimizer
        bufs = self._bn_buffers()
        if bufs:
            if self._bn_snapshot is None:
                self._bn_snapshot = [torch.empty_like(b) for b in bufs]
            torch._foreach_copy_(self._bn_snapshot, bufs)
        out = model(batch[self.input_key], train=True)
        loss, aux = self.objective(out, batch)
        opt.zero_grad()
        loss.backward()
        grad_norm = global_norm(opt.grads())
        finite = torch.isfinite(grad_norm)
        if "loss_was_finite" in aux:
            finite = finite & (aux["loss_was_finite"] > 0)
        names = list(aux)
        dev = grad_norm.device
        values = torch.stack(
            [finite.float(), grad_norm]
            + [torch.as_tensor(aux[k], device=dev).float().reshape(())
               for k in names]).tolist()     # the step's one host sync
        if values[0] > 0:
            opt.step(lr_scale, grad_norm)
        elif bufs:
            torch._foreach_copy_(bufs, self._bn_snapshot)
        state.step += 1
        row = dict(zip(names, values[2:]))
        row["update_was_finite"] = values[0]
        row["grad_norm"] = values[1]
        return row

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        out = state.model(batch[self.input_key], train=False)
        loss, aux = self.objective(out, batch)
        aux = dict(aux)
        aux["loss"] = loss
        return {k: float(v) for k, v in aux.items()}, out

    # -- loops ------------------------------------------------------------
    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        dev = self.device
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if dev.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(dev, non_blocking=True)
        return out

    def _input_pipeline(self, batches: Iterable) -> Iterable:
        """Keep ``PREFETCH`` batches' host-to-device copies enqueued ahead
        of the step that uses them."""
        queue: collections.deque = collections.deque()
        for b in batches:
            queue.append(self._to_device(b))
            if len(queue) > PREFETCH:
                yield queue.popleft()
        while queue:
            yield queue.popleft()

    def train_epoch(self, state: TrainState, batches: Iterable,
                    lr_scale: float = 1.0):
        rows = [self.train_step(state, batch, lr_scale)
                for batch in self._input_pipeline(batches)]
        agg = {k: float(np.mean([r[k] for r in rows]))
               for k in rows[0]} if rows else {}
        return state, agg

    def evaluate(self, state: TrainState, batches: Iterable,
                 collect: Optional[Callable] = None):
        metrics, collected = [], []
        for batch in self._input_pipeline(batches):
            aux, out = self.eval_step(state, batch)
            metrics.append(aux)
            if collect is not None:
                collected.append(collect(out, batch))
        agg = {k: float(np.mean([m[k] for m in metrics]))
               for k in metrics[0]} if metrics else {}
        return agg, collected

    def fit(self, state: TrainState, train_batches_fn: Callable[[], Iterable],
            val_batches_fn: Optional[Callable[[], Iterable]] = None,
            *, epochs: int = 10, plateau: Optional[ReduceLROnPlateau] = None,
            early_stop_patience: Optional[int] = None,
            metadata: Optional[Dict] = None,
            log: Callable[[str], None] = print):
        best_val = float("inf")
        bad = 0
        lr_scale = 1.0
        for epoch in range(epochs):
            t0 = time.time()
            state, train_m = self.train_epoch(state, train_batches_fn(),
                                              lr_scale)
            row = {"epoch": epoch, **{f"train_{k}": v
                                      for k, v in train_m.items()}}
            val_loss = None
            if val_batches_fn is not None:
                val_m, _ = self.evaluate(state, val_batches_fn())
                row.update({f"val_{k}": v for k, v in val_m.items()})
                val_loss = val_m.get("loss")
                if val_m.get("loss_was_finite", 1.0) < 1.0:
                    # the guarded objective substitutes a constant for
                    # non-finite losses: a diverged epoch must not pass for
                    # 'best' or feed the plateau logic
                    val_loss = float("inf")
            row["lr_scale"] = lr_scale
            row["time_s"] = round(time.time() - t0, 3)
            for k, v in row.items():
                self.history.setdefault(k, []).append(v)
            log(f"[epoch {epoch}] " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()))

            is_best = val_loss is not None and val_loss < best_val
            if is_best:
                best_val = val_loss
                bad = 0
            elif val_loss is not None:
                bad += 1
            if self.ckpt is not None:
                self.ckpt.save(epoch, state.state_dict(), metadata=metadata,
                               history=self.history, is_best=is_best)
            if plateau is not None and val_loss is not None:
                lr_scale = plateau.step(val_loss)
            if (early_stop_patience is not None and val_loss is not None
                    and bad >= early_stop_patience):
                log(f"early stop at epoch {epoch}")
                break
        return state
