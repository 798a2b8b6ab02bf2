"""The training harness: one model on one device.

Counterpart of ``pautdx/train/trainer.py`` (``Trainer`` with ``init``,
``train_epoch``, ``evaluate`` and ``fit``; the same history rows, early
stopping, plateau logic and per-epoch checkpoints). The objective is
``objective(out, batch) -> (loss, aux)``; the model is an ``nn.Module``
whose ``forward(x, train=...)`` sets its own mode, as ``DFine`` does, or
whose ``forward(x)`` takes the input alone, as the signal models' does,
and then the trainer sets the mode (``train()`` for a step, ``eval()``
for an eval step). Batches are dicts of numpy arrays (or tensors) with at
least ``input_key``: ``"signals"`` by default, as in the reference; the
detectors' callers pass ``"images"``.

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

``ema_decay`` keeps the reference's EMA of the parameters (not of the BN
statistics) on the :class:`TrainState`: ``ema = d * ema + (1 - d) *
params`` after every step, a refused step included, where the parameters
did not move (``trainer.py:137-143``); the checkpoint saves and restores
it, and :func:`ema_weights` evaluates it with the live BN statistics.
``forward`` replaces the training forward ``model(batch[input_key],
train=True)`` by ``forward(model, batch)``, which is how the denoising
groups, drawn from the batch's boxes, reach the model.

The input pipeline (``data.prefetch.device_prefetch``) keeps
``PREFETCH`` batches in flight, copied from pinned host memory with
``non_blocking=True``; host-side batch assembly runs on a thread through
``data.prefetch.ThreadedHostLoader`` where the caller wraps its batches
in one.

Dropout: the reference draws a step's masks from ``fold_in(PRNGKey(seed),
step)`` (``trainer.py:110-111``). Here the trainer owns a
``torch.Generator`` on the model's device, hands it to every
``nn.blocks.Dropout`` of the model, and seeds it before each step from
(``seed``, step, dp rank), so a step's masks depend on those alone,
whatever ran before in the process. The streams are torch's, not JAX's.
The dp rank, never the global rank: two tp ranks of one replica must
draw the same mask over a replicated activation.

``mesh=`` (a ``mesh.make_mesh`` mesh; this process is one of its ranks)
is the reference's data parallelism, one program over the global batch,
rebuilt across processes:

- the model runs under ``DistributedDataParallel`` over the mesh's dp
  group (parameters broadcast from its rank 0 at init), and each rank
  copies only its rows of every batch; a training batch must divide by
  the dp size, as the reference's must;
- the step runs in ``mesh.comm.dp_scope``: every BatchNorm normalises
  with the global batch's moments and the losses divide by global counts
  (``mesh.comm.dp_count``), so the averaged gradient is the global
  batch's;
- the guard's flags are summed over the ranks, so every rank applies or
  refuses the same step; the aux values are averaged over them, so
  ``history`` is the global batch's;
- ``evaluate`` runs each rank's rows (a ragged batch padded), gathers the
  outputs and the rows over dp, drops the padding and evaluates the
  objective over the global batch, on every rank alike. The reference
  cannot place such a batch and raises (ROADMAP.md, its faults);
- checkpoints, ``history.json`` and the log are written by the process
  of global rank 0 only; the EMA is the same on every rank.

A mesh with a ``tp`` axis works on a model already sharded by
``mesh.tp.shard_params`` (the gradient norm then sums the shards' squares
over tp); checkpointing such a model is not supported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pautdx_torch.data.prefetch import device_prefetch
from pautdx_torch.mesh import (ROW_MASK, axis_group, axis_rank, axis_size,
                               batch_sharding, comm)
from pautdx_torch.mesh.tp import grad_norm as tp_grad_norm, tp_group_of
from pautdx_torch.nn.blocks import set_dropout_generator
from pautdx_torch.train.checkpoint import CheckpointManager, load_model_state
from pautdx_torch.train.optim import (ClippedAdamW, OptimizerSpec,
                                      ReduceLROnPlateau, ema_update,
                                      global_norm)
from pautdx_torch.utils.debug import guarded

PREFETCH = 2      # batches whose host-to-device copies run ahead of the step


def step_seed(seed: int, step: int, dp_rank: int = 0) -> int:
    """The dropout generator's seed for ``step`` of a run seeded ``seed``
    on dp rank ``dp_rank`` (the counterpart of ``fold_in(PRNGKey(seed),
    step)``; dp rank 0 draws what one process draws)."""
    key = [seed, step] + ([dp_rank] if dp_rank else [])
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


def data_parallel(model: nn.Module, group) -> nn.Module:
    """``model`` under ``DistributedDataParallel`` over ``group``: its
    parameters and buffers broadcast from the group's rank 0 now, its
    gradients averaged over the group in every backward. The buffers are
    not broadcast again (the BatchNorms keep them equal); parameters a
    step leaves unused are allowed (D-FINE's denoising embedding)."""
    import warnings

    from torch.nn.parallel import DistributedDataParallel

    with warnings.catch_warnings():     # newer torch renames the option
        warnings.simplefilter("ignore", FutureWarning)
        return DistributedDataParallel(model, process_group=group,
                                       broadcast_buffers=False,
                                       find_unused_parameters=True)


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
    ema: Optional[Dict[str, torch.Tensor]] = None   # parameter name -> EMA

    def state_dict(self) -> Dict[str, Any]:
        """CPU copies of everything a checkpoint keeps."""
        return _cpu({
            "step": self.step,
            "params": dict(self.model.named_parameters()),
            "batch_stats": dict(self.model.named_buffers()),
            "opt_state": self.optimizer.state_dict(),
            "ema_params": self.ema,
        })

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        load_model_state(self.model, state)
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        if state.get("ema_params") is not None:
            params = dict(self.model.named_parameters())
            self.ema = {k: v.to(params[k].device, params[k].dtype).clone()
                        for k, v in state["ema_params"].items()}


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """The model with its parameters replaced by the state's EMA for a
    while, BN statistics left as trained (the reference's harness evaluates
    the EMA so); the trained parameters come back afterwards, also on an
    exception."""
    if state.ema is None:
        raise ValueError("ema_weights: the trainer keeps no EMA "
                         "(Trainer(ema_decay=...))")
    params = dict(state.model.named_parameters())
    saved = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(state.ema[k])
    try:
        yield state.model
    finally:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])


class Trainer:
    def __init__(self, model: nn.Module, objective: Callable,
                 optimizer: OptimizerSpec,
                 *, mesh=None, checkpoint_dir: Optional[str] = None,
                 ema_decay: Optional[float] = None, seed: int = 0,
                 input_key: str = "signals",
                 forward: Optional[Callable] = None):
        self.model = model
        self.mesh = mesh
        self.dp_group = axis_group(mesh, "dp") if mesh is not None else None
        self.dp_size = axis_size(mesh, "dp") if mesh is not None else 1
        self.dp_rank = axis_rank(mesh, "dp") if mesh is not None else 0
        self.is_main = mesh is None or dist.get_rank() == 0
        self._tp_group = tp_group_of(model)
        if self._tp_group is not None and checkpoint_dir:
            raise NotImplementedError("Trainer: checkpoints of a "
                                      "tensor-parallel model")
        # what the training forward calls: the model, or its DDP wrapper
        self.net = (data_parallel(model, self.dp_group)
                    if self.dp_group is not None else model)
        self.objective = guarded(objective)
        self.optimizer = optimizer
        self.ema_decay = ema_decay
        self.input_key = input_key
        self.seed = seed
        # signal models take the input alone; DFine and YOLO take `train`
        self._sets_own_mode = "train" in inspect.signature(
            model.forward).parameters
        self.forward = forward or (
            lambda m, batch: self._call(m, batch[input_key], True))
        self.generator = torch.Generator(device=self.device)
        set_dropout_generator(model, self.generator)
        self.ckpt = CheckpointManager(checkpoint_dir) \
            if checkpoint_dir and self.is_main else None
        self.history: Dict[str, list] = {}
        self._bn_snapshot: Optional[List[torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _call(self, model: nn.Module, x: torch.Tensor, train: bool):
        if self._sets_own_mode:
            return model(x, train=train)
        return model.train(train)(x)

    # -- init -------------------------------------------------------------
    def init(self, example_batch: Dict[str, Any]) -> TrainState:
        """The train state over the model's current weights (the port's
        models are built with seeded weights). ``example_batch`` must hold
        ``input_key``, as the reference's init needs it for shapes."""
        if self.input_key not in example_batch:
            raise KeyError(f"Trainer.init: the batch has no "
                           f"'{self.input_key}'")
        ema = ({k: p.detach().clone()
                for k, p in self.model.named_parameters()}
               if self.ema_decay else None)
        return TrainState(step=0, model=self.model,
                          optimizer=self.optimizer.init(self.model), ema=ema)

    # -- steps ------------------------------------------------------------
    def _bn_buffers(self) -> List[torch.Tensor]:
        return [b for b in self.model.buffers() if b.is_floating_point()]

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   lr_scale: float = 1.0) -> Dict[str, float]:
        """One guarded step on a batch already on the device, then the
        EMA's; returns the objective's aux plus ``update_was_finite`` and
        ``grad_norm``."""
        if ROW_MASK in batch:
            raise ValueError(f"Trainer: a training batch must divide by the "
                             f"{self.dp_size} dp ranks (drop the remainder)")
        model, opt = state.model, state.optimizer
        bufs = self._bn_buffers()
        if bufs:
            if self._bn_snapshot is None:
                self._bn_snapshot = [torch.empty_like(b) for b in bufs]
            torch._foreach_copy_(self._bn_snapshot, bufs)
        self.generator.manual_seed(step_seed(self.seed, state.step,
                                             self.dp_rank))
        if not self._sets_own_mode:
            model.train()
        with comm.dp_scope(self.dp_group):
            out = self.forward(self.net, batch)
            loss, aux = self.objective(out, batch)
            opt.zero_grad()
            loss.backward()
        grads = opt.grads()
        grad_norm = (global_norm(grads) if self._tp_group is None
                     else tp_grad_norm(model, grads))
        loss_ok = aux.get("loss_was_finite", torch.ones(()))
        names = [k for k in aux if k != "loss_was_finite"]
        dev = grad_norm.device
        values = torch.stack(
            [(~torch.isfinite(grad_norm)).float(),
             (torch.as_tensor(loss_ok, device=dev) <= 0).float().reshape(()),
             grad_norm]
            + [torch.as_tensor(aux[k], device=dev).float().reshape(())
               for k in names])
        values = self._ranks_mean(values).tolist()  # the step's host sync
        refused, loss_bad = values[0] > 0 or values[1] > 0, values[1] > 0
        if not refused:
            opt.step(lr_scale, grad_norm)
        elif bufs:
            torch._foreach_copy_(bufs, self._bn_snapshot)
        if state.ema is not None:
            ema_update(state.ema, dict(model.named_parameters()),
                       self.ema_decay)
        state.step += 1
        means = dict(zip(names, values[3:]))
        row = {k: (0.0 if loss_bad else 1.0) if k == "loss_was_finite"
               else means[k] for k in aux}
        row["update_was_finite"] = 0.0 if refused else 1.0
        row["grad_norm"] = values[2]
        return row

    def _ranks_mean(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` averaged over every rank (the tp ranks of a replica
        hold the same values, so this is the mean over dp)."""
        if self.mesh is None or dist.get_world_size() == 1:
            return values
        values = values.contiguous()
        dist.all_reduce(values)
        return values / dist.get_world_size()

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """The objective over a batch; under a mesh, ``batch`` holds this
        rank's rows (``row_mask`` marking a ragged batch's padding), and
        the objective runs over the gathered global batch, padding
        dropped, on every rank alike."""
        out = self._call(state.model, batch[self.input_key], False)
        if self.dp_group is not None:
            out, batch = self._gathered(out, batch)
        loss, aux = self.objective(out, batch)
        aux = dict(aux)
        aux["loss"] = loss
        return {k: float(v) for k, v in aux.items()}, out

    def _gathered(self, out, batch: Dict[str, torch.Tensor]):
        rows = len(batch[self.input_key])
        mask = batch.get(ROW_MASK)
        total = rows * self.dp_size
        if mask is not None:
            total = int(comm.gather_slices(mask, self.dp_group).sum())
        batch = {k: v for k, v in batch.items() if k != ROW_MASK}
        return (comm.gather_rows(out, self.dp_group, rows, total),
                comm.gather_rows(batch, self.dp_group, rows, total))

    # -- loops ------------------------------------------------------------
    def _input_pipeline(self, batches: Iterable) -> Iterable:
        """Keep ``PREFETCH`` batches' host-to-device copies enqueued ahead
        of the step that uses them; under a mesh, this rank's rows."""
        sharding = (batch_sharding(self.mesh) if self.dp_group is not None
                    else None)
        return device_prefetch(batches, self.device, PREFETCH, sharding)

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
        if not self.is_main:
            log = lambda msg: None   # noqa: E731 (rank 0 logs)
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
