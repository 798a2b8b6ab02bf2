"""Training the signal domain's detectors from JSON PAUT volumes.

Counterpart of the reference CLI's ``train-signal`` and its checkpoint
loader (``pautdx/cli.py``, ``_cmd_train_signal`` and
``_load_signal_model``): :func:`train_signal` runs ``load_json_dir`` ->
``defect_focused`` (optional) -> ``train_val_split`` ->
``build_signal_model`` -> ``Trainer`` -> ``fit`` with the recipe's
plateau controller and early stop, checkpointing every epoch;
:func:`restore_signal_model` rebuilds the model of a checkpoint (its
``best`` epoch, else its ``latest``) in eval mode, for
``serve.endpoints.SignalEndpoint``, ``eval.report.SignalEvaluator`` and
``prediction_map``.

One difference, on purpose: the reference CLI builds its optimizer from
the recipe's lr, decay and clip alone, so the ``two_stage`` and
``seq_detector`` recipes train without the parameter groups and the
cosine decay that they declare (ROADMAP.md, queue 3). Here
:func:`recipe_optimizer` gives the optimizer both.

``dp=True`` is the reference's data-parallel training over every local
device (its ``make_mesh()``): one rank a card over NCCL, a world of 1
on a one-card machine; with ``device="cpu"``, one gloo rank, as the
reference's mesh over its one CPU device; under ``torchrun``
(``WORLD_SIZE`` set), that world. The ``Trainer`` runs under the mesh:
the global batch is split over the ranks (it must divide), each
BatchNorm and loss sees the global batch, and the ragged last validation
batch is padded and masked (``train.trainer``). Where the ranks are
processes of their own (more than one card), they keep their state: the
trainer and state returned are then one process's, restored from the
last checkpoint that rank 0 wrote under ``out`` (weights, BatchNorm
statistics, optimizer state, EMA and step) with the history it wrote.

The checkpoint's metadata adds ``signal_length`` to the reference's
``model``, ``recipe`` and ``seq_len``: the models that read raw samples
need it to be rebuilt. The ``train-signal`` subcommand (``cli.py``) draws
the training history with ``viz.plot_training_history``, as the
reference's does.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from pautdx_torch.data.datasets import (
    BatchIterator, defect_focused as focus_defects, load_json_dir,
    train_val_split,
)
from pautdx_torch.device import Device, resolve_device
from pautdx_torch.mesh import make_mesh, mesh_device
from pautdx_torch.mesh.launch import backend_for, launch
from pautdx_torch.models.signal import build_signal_model
from pautdx_torch.train.checkpoint import CheckpointManager, load_model_state
from pautdx_torch.train.optim import (
    OptimizerSpec, ReduceLROnPlateau, cosine_schedule, make_optimizer,
)
from pautdx_torch.train.recipes import RECIPES, Recipe
from pautdx_torch.train.trainer import Trainer, TrainState


def recipe_optimizer(recipe: Recipe, total_steps: int) -> OptimizerSpec:
    """AdamW + clip at the recipe's lr, decay and clip, with its parameter
    groups and, for ``scheduler == "cosine"``, ``cosine_schedule(lr,
    total_steps)``."""
    schedule = (cosine_schedule(recipe.learning_rate, total_steps)
                if recipe.scheduler == "cosine" else None)
    return make_optimizer(recipe.learning_rate, recipe.weight_decay,
                          recipe.clip_norm, schedule=schedule,
                          group_lr_mults=recipe.group_lr_mults,
                          group_patterns=recipe.group_patterns)


def train_signal(data_dir: str, out: str, model: str = "HybridBinary",
                 recipe: str = "detection", epochs: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 seq_len: Optional[int] = None,
                 defect_focused: bool = False,
                 signal_length: Optional[int] = 320,
                 seed: int = 0, dp: bool = False, device: Device = None,
                 log: Callable[[str], None] = print
                 ) -> Tuple[Trainer, TrainState]:
    """Train ``MODEL_ZOO[model]`` with ``RECIPES[recipe]`` on the ``*.json``
    volumes of ``data_dir``, checkpoints under ``out``, on ``device``
    (default ``"cuda"``). ``epochs``, ``batch_size`` and ``seq_len``
    default to the recipe's; ``seed`` draws the initial weights and the
    dropout masks. ``signal_length`` must be the volumes' samples a
    signal; None takes it from the volumes. Returns the trainer (its
    ``history``) and the trained state."""
    dev = resolve_device(device)
    kw = dict(data_dir=data_dir, out=out, model=model, recipe=recipe,
              epochs=epochs, batch_size=batch_size, seq_len=seq_len,
              defect_focused=defect_focused, signal_length=signal_length,
              seed=seed)
    if dp:
        return _train_dp(kw, dev, log)
    return _train(dev=dev, log=log, **kw)[:2]


def _train_dp(kw: Dict, dev: torch.device, log,
              n: Optional[int] = None) -> Tuple[Trainer, TrainState]:
    """``train_signal(dp=True)``: in a group that is up already (under
    ``torchrun``), this rank's run; else ``n`` ranks (every card; one on
    the CPU), a world of 1 in this process."""
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group(backend_for(dev.type, int(
            os.environ["WORLD_SIZE"])), init_method="env://")
    if dist.is_initialized():
        return _dp_rank(kw, dev.type, log)
    n = n or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    if n == 1:
        return launch(_dp_rank, 1, dev.type, args=(kw, dev.type, log))[0]
    threads = (max(1, torch.get_num_threads() // n) if dev.type == "cpu"
               else None)
    launch(_dp_spawned, n, dev.type, args=(kw, dev.type), threads=threads)
    trainer, state, _ = _train(dev=dev, log=log, fit=False, **kw)
    ckpt = CheckpointManager(kw["out"])
    state.load_state_dict(ckpt.restore("latest")[0])
    trainer.history = ckpt.load_history()
    return trainer, state


def _dp_rank(kw: Dict, device: str, log: Callable[[str], None] = print
             ) -> Tuple[Trainer, TrainState]:
    """This rank's run under a dp mesh over the whole world."""
    mesh = make_mesh(dist.get_world_size(), device=device)
    return _train(dev=mesh_device(mesh), mesh=mesh, log=log, **kw)[:2]


def _dp_spawned(kw: Dict, device: str) -> None:
    """A spawned rank: its state stays here (rank 0 checkpoints it)."""
    _dp_rank(kw, device)


def _train(data_dir: str, out: str, model: str, recipe: str,
           epochs: Optional[int], batch_size: Optional[int],
           seq_len: Optional[int], defect_focused: bool,
           signal_length: Optional[int], seed: int, dev: torch.device,
           log: Callable[[str], None], mesh=None, fit: bool = True
           ) -> Tuple[Trainer, TrainState, int]:
    """(trainer, state, signal length) of the run; ``fit=False`` stops
    before the first epoch."""
    rec = RECIPES[recipe]
    seq_len = seq_len or rec.seq_len
    ds = load_json_dir(data_dir, seq_len=seq_len)
    if defect_focused:
        ds = focus_defects(ds)
    if signal_length is None:
        signal_length = ds.signals.shape[-1] if len(ds) else 320
    if len(ds) and ds.signals.shape[-1] != signal_length:
        raise ValueError(f"train_signal: the volumes in {data_dir} have "
                         f"{ds.signals.shape[-1]} samples a signal, "
                         f"signal_length is {signal_length}")
    train_ds, val_ds = train_val_split(ds)
    bs = batch_size or rec.batch_size
    n_batches = len(BatchIterator(train_ds, bs))
    if n_batches == 0:
        raise ValueError(f"train_signal: {len(train_ds)} training sequences "
                         f"of {seq_len} signals make no batch of {bs}")
    n_epochs = epochs or rec.epochs
    net = build_signal_model(model, signal_length=signal_length, seed=seed,
                             device=dev)
    trainer = Trainer(net, rec.make_objective(),
                      recipe_optimizer(rec, n_epochs * n_batches),
                      mesh=mesh, checkpoint_dir=out, seed=seed)
    state = trainer.init(next(iter(BatchIterator(train_ds, bs))))
    if not fit:
        return trainer, state, signal_length
    state = trainer.fit(
        state,
        lambda: BatchIterator(train_ds, bs, seed=1),
        lambda: BatchIterator(val_ds, bs, shuffle=False,
                              drop_remainder=False),
        epochs=n_epochs,
        plateau=(ReduceLROnPlateau(patience=rec.plateau_patience)
                 if rec.scheduler == "plateau" else None),
        early_stop_patience=rec.early_stop_patience,
        metadata={"model": model, "recipe": recipe, "seq_len": seq_len,
                  "signal_length": signal_length},
        log=log)
    return trainer, state, signal_length


def restore_signal_model(ckpt_dir: str, device: Device = None
                         ) -> Tuple[nn.Module, Dict]:
    """(model, metadata) of a ``train_signal`` checkpoint: the ``best``
    epoch where one was marked, else the ``latest``, rebuilt from the
    metadata's ``model`` and ``signal_length`` in eval mode on ``device``
    (default ``"cuda"``)."""
    dev = resolve_device(device)
    state, meta = CheckpointManager(ckpt_dir).restore_best_or_latest()
    model = build_signal_model(meta["model"],
                               signal_length=meta.get("signal_length", 320),
                               device=dev)
    load_model_state(model, state)
    return model.eval(), meta
