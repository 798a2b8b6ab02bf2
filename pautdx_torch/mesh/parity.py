"""The rank side of the multi-device checks on the CPU.

``tests/test_torch_parallel.py`` starts four gloo ranks once
(``mesh.launch``) and runs :func:`parity_suite` on them; the files it
names hold the inputs, which the test made from the JAX reference's
variables. Everything here runs on every rank; rank 0 returns the tensors
the test compares, every rank the flags it asserts.

- ``dp``: a ``Trainer(mesh=make_mesh(world))`` over ``HybridBinaryModel``
  in float64 (BatchNorm), two steps of the ``detection`` recipe at the
  global batch of the file; the parameters, buffers and the epoch's aux;
- ``ragged``: ``Trainer.evaluate`` of a batch whose rows do not divide by
  the ranks;
- ``guard``: a step whose rows on rank 1 are NaN; every rank's weights,
  moments and BN statistics after it;
- ``checkpoint``: one epoch of ``fit`` with checkpoints, written by rank
  0 alone;
- ``dryrun``: ``mesh.dryrun.dryrun_rank`` (dp x tp) from the weights of
  the file, with the tp eval forward; ``placements``: ``tp_shardings`` of
  the same model on that mesh;
- ``sharding``: ``batch_sharding`` and ``replicated`` placements and
  ``shard_batch`` of a ragged 5-row batch, on the dp mesh and on the
  (dp, tp) mesh.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from pautdx_torch.mesh import (batch_sharding, make_mesh, replicated,
                               shard_batch)


def hybrid_binary():
    """The narrow HybridBinary of the dp check (BatchNorm, dropout 0)."""
    from pautdx_torch.models.signal import HybridBinaryModel

    return HybridBinaryModel(hidden_sizes=(64, 32, 16), num_heads=2,
                             dropout=0.0, num_transformer_layers=1,
                             pooled_len=32, norm="batch",
                             device="cpu").double()


def _batches(path: str):
    with np.load(path) as f:
        n = len({k.split("/")[0] for k in f.files})
        return [{k.split("/")[1]: f[k] for k in f.files
                 if k.startswith(f"{i}/")} for i in range(n)]


def _state(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _dims(placements) -> tuple:
    return tuple(p.dim if p.is_shard() else None for p in placements)


def _sharding(mesh) -> Dict[str, Any]:
    host = {"x": np.arange(10.0).reshape(5, 2)}
    return {"batch": _dims(batch_sharding(mesh).placements),
            "replicated": _dims(replicated(mesh).placements),
            "rows": {k: v.numpy() for k, v in
                     shard_batch(host, mesh).items()}}


def _same(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def parity_suite(files: Dict[str, str], total_steps: int) -> Dict[str, Any]:
    from pautdx_torch.mesh.dryrun import Spec, dryrun_rank, tiny_config
    from pautdx_torch.mesh.tp import mesh_2d, tp_shardings
    from pautdx_torch.models.vision.dfine import DFine
    from pautdx_torch.train.recipes import RECIPES
    from pautdx_torch.train.signal import recipe_optimizer
    from pautdx_torch.train.trainer import Trainer

    rank = dist.get_rank()
    rec = RECIPES["detection"]
    train = _batches(files["batches"])
    ragged = _batches(files["ragged"])[0]
    weights = torch.load(files["hb_weights"])
    mesh = make_mesh(dist.get_world_size(), device="cpu")
    out: Dict[str, Any] = {"rank": rank}

    model = hybrid_binary()
    model.load_state_dict(weights)
    trainer = Trainer(model, rec.make_objective(),
                      recipe_optimizer(rec, total_steps), mesh=mesh)
    state = trainer.init(train[0])
    _, agg = trainer.train_epoch(state, train)
    out["dp"] = {"agg": agg, "state": _state(model)}
    out["dp_checksum"] = float(sum(v.double().abs().sum()
                                   for v in model.state_dict().values()))

    aux, collected = trainer.evaluate(state, [ragged],
                                      collect=lambda o, b: o.detach())
    out["ragged"] = {"aux": aux, "prob": collected[0]}

    before = _state(model)
    moments = {id(p): {n: t.clone() for n, t in s.items()}
               for p, s in state.optimizer.adamw.state.items()}
    count = state.optimizer.count
    bad = {k: v.copy() for k, v in train[0].items()}
    rows = len(bad["signals"]) // dist.get_world_size()
    bad["signals"][rows:2 * rows] = np.nan
    _, row = trainer.train_epoch(state, [bad])
    kept = _same(before, _state(model)) and state.optimizer.count == count \
        and all(torch.equal(t, moments[id(p)][n])
                for p, s in state.optimizer.adamw.state.items()
                for n, t in s.items())
    out["guard"] = {"row": row, "kept": kept}

    model = hybrid_binary()
    model.load_state_dict(weights)
    trainer = Trainer(model, rec.make_objective(),
                      recipe_optimizer(rec, total_steps), mesh=mesh,
                      checkpoint_dir=files["ckpt"])
    state = trainer.fit(trainer.init(train[0]), lambda: train[:1],
                        lambda: [ragged], epochs=1, log=lambda m: None)
    out["checkpoint"] = {"writer": trainer.ckpt is not None,
                         "history": trainer.history,
                         "state": _state(model)}

    spec = Spec(weights=files["dfine_weights"], eval_forward=True,
                batch=dist.get_world_size())
    out["dryrun"] = dryrun_rank(spec, "cpu")
    mesh2 = mesh_2d(dist.get_world_size(), device="cpu")
    out["placements"] = {n: _dims(ps) for n, ps in tp_shardings(
        DFine(tiny_config(), device="cpu"), mesh2).items()}
    out["sharding"] = {"dp": _sharding(mesh), "dp_tp": _sharding(mesh2)}
    if rank:
        for k in ("dp", "ragged", "checkpoint"):
            out[k] = {kk: v for kk, v in out[k].items()
                      if kk not in ("state", "prob")}
    return out
