"""One training step of D-FINE on a (dp, tp) mesh: the multi-device dry run.

Counterpart of ``dryrun_multichip`` in the reference's entry points
(``__graft_entry__.py``): :func:`dryrun_multichip` starts ``n`` ranks
(``mesh.launch``) on a ``mesh_2d(n, tp=2)`` mesh and runs one step of the
D-FINE objective, the batch split over dp and the weights under
``mesh.tp.shard_params``: the gradients, clipped by their global norm to
1.0, then one AdamW update (lr 1e-4, weight decay 1e-4), as the
reference's grads-plus-update. It prints ``dryrun_multichip(n): train step
ok, loss=...``.

On the CPU the ranks are gloo processes; on the card they are NCCL ranks,
one a card, or gloo ranks sharing ``cuda:0`` where there are fewer cards
than ranks (the kernels are built before the spawn). The defaults are the
reference's: its tiny config (:func:`tiny_config`), 64px frames, one
frame a rank, two boxes a frame. ``cfg``, ``size`` and ``batch`` widen it
(``chip_smoke.py`` runs ``dfine_nano`` at 640px, 16 frames).

With ``eval_forward=True`` each rank first runs the tp eval forward of
its rows (the encoder's attention through the fused kernel) and the
ranks gather the outputs over dp. :func:`one_process_step` is the same
eval and step in one process over the whole batch, what the tests and
``chip_smoke.py`` hold the ranks to.

Run ``python -m pautdx_torch.mesh.dryrun 4`` for four ranks on the card
(gloo ranks sharing it where the machine has fewer than four cards), or
``python -m pautdx_torch.mesh.dryrun 4 cpu`` for four gloo ranks on the
CPU (no card needed).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from pautdx_torch.device import Device, resolve_device
from pautdx_torch.mesh import (axis_group, axis_rank, axis_size, comm,
                               local_rows, mesh_device)
from pautdx_torch.mesh.launch import launch
from pautdx_torch.models.vision.dfine import DFine, DFineConfig
from pautdx_torch.models.vision.hgnet import HGNetConfig

LR = 1e-4


def tiny_config() -> DFineConfig:
    """The reference's dry-run config (``__graft_entry__._tiny_cfg``)."""
    return DFineConfig(
        num_labels=2, d_model=64, encoder_hidden_dim=64, decoder_layers=2,
        decoder_attention_heads=4, encoder_attention_heads=4,
        decoder_ffn_dim=128, encoder_ffn_dim=128, num_queries=30,
        max_num_bins=16, hidden_expansion=0.5,
        backbone=HGNetConfig(
            stem_channels=(3, 8, 8), stage_in_channels=(8, 16, 32, 64),
            stage_mid_channels=(8, 8, 16, 32),
            stage_out_channels=(16, 32, 64, 128),
            stage_num_blocks=(1, 1, 1, 1), stage_num_layers=(1, 1, 2, 2),
        ),
    )


def dryrun_inputs(batch: int, size: int, boxes: int = 2
                  ) -> Dict[str, np.ndarray]:
    """The reference's dry-run batch: N(0, 1) frames from seed 0, the same
    two boxes on every frame (normalized cxcywh), class 0."""
    images = np.random.default_rng(0).normal(
        size=(batch, size, size, 3)).astype(np.float32)
    gt = np.asarray([[0.4, 0.4, 0.2, 0.2], [0.6, 0.6, 0.1, 0.1]],
                    np.float32)[:boxes]
    return {"images": images,
            "boxes": np.tile(gt[None], (batch, 1, 1)),
            "classes": np.zeros((batch, boxes), np.int64),
            "mask": np.ones((batch, boxes), np.float32)}


@dataclasses.dataclass(frozen=True)
class Spec:
    """What a dry run runs: the model's config (``tiny_config()`` when
    None), frame size, global batch, weights (a state-dict file, else
    ``seed``'s init), and whether to run the tp eval forward first."""
    cfg: Optional[DFineConfig] = None
    size: int = 64
    batch: Optional[int] = None
    weights: Optional[str] = None
    seed: int = 0
    eval_forward: bool = False


def _model(spec: Spec, dev: torch.device) -> DFine:
    cfg = spec.cfg or tiny_config()
    if spec.eval_forward:
        cfg = dataclasses.replace(cfg, encoder_fused_attn=True)
    model = DFine(cfg, device=dev, seed=spec.seed)
    if spec.weights:
        model.load_state_dict(torch.load(spec.weights, map_location=dev))
    return model


def _launches() -> Dict[str, int]:
    from pautdx_torch.ops import attention, gather

    return {"aifi_attention": attention.LAUNCHES,
            "weighted_gather": gather.WEIGHTED_LAUNCHES,
            "weighted_gather_backward": gather.WEIGHTED_BACKWARD_LAUNCHES}


def _zero_launches() -> None:
    from pautdx_torch.ops import attention, gather

    attention.LAUNCHES = gather.WEIGHTED_LAUNCHES = 0
    gather.WEIGHTED_BACKWARD_LAUNCHES = 0


def _run(spec: Spec, model: DFine, net, rows, dp_group,
         world_group) -> Dict[str, Any]:
    """The eval forward (if asked) and the step of this rank's ``rows``
    (a slice, or an index array); ``net`` is what the training forward
    calls (the model or its DDP wrapper)."""
    from pautdx_torch.losses.detr import dfine_criterion
    from pautdx_torch.mesh.tp import (gather_params, grad_norm, is_sharded,
                                      tp_group_of)
    from pautdx_torch.train.optim import make_optimizer

    cfg = model.cfg
    dev = next(model.parameters()).device
    host = dryrun_inputs(spec.batch, spec.size)
    batch = {k: torch.as_tensor(v[rows]).to(dev) for k, v in host.items()}
    n_rows = len(batch["images"])
    result: Dict[str, Any] = {}
    _zero_launches()
    if spec.eval_forward:
        with torch.no_grad():
            out = model(batch["images"], train=False)
        out = {k: comm.gather_rows(out[k], dp_group, n_rows, spec.batch)
               for k in ("logits", "pred_boxes")}
        result["eval"] = {k: v.cpu() for k, v in out.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    result["eval_launches"] = _launches()

    _zero_launches()
    opt = make_optimizer(LR, weight_decay=LR, clip_norm=1.0).init(model)
    with comm.dp_scope(dp_group):
        out = net(batch["images"], train=True)
        loss, _ = dfine_criterion(out, batch["boxes"], batch["classes"],
                                  batch["mask"], cfg.num_labels,
                                  cfg.max_num_bins)
        opt.zero_grad()
        loss.backward()
    grads = opt.grads()
    norm = grad_norm(model, grads)
    tp = tp_group_of(model)
    full = {}
    for (n, p), g in zip(((n, p) for n, p in model.named_parameters()
                          if p.requires_grad), grads):
        g = g.detach()
        if is_sharded(p):
            g = comm.gather_slices(g, tp, p.tp_dim)
        full[n] = g.cpu().clone()
    opt.step(1.0, norm)
    loss = loss.detach().reshape(1)
    if world_group is not None:
        loss = comm.gather_slices(loss, world_group).mean()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    result.update(loss=float(loss), grad_norm=float(norm),
                  launches=_launches(), grads=full,
                  params=gather_params(model))
    return result


def dryrun_rank(spec: Spec, device: Device = None) -> Dict[str, Any]:
    """A rank's side of :func:`dryrun_multichip` (the process group is
    up): ``mesh_2d(world, tp=2)`` on ``device`` (default ``"cuda"``), the
    model seeded alike on every rank and sharded, DDP over dp, the eval
    forward and the step. Ranks other than 0 return no tensors."""
    import torch.distributed as dist

    from pautdx_torch.mesh.tp import mesh_2d, shard_params
    from pautdx_torch.train.trainer import data_parallel

    world = dist.get_world_size()
    mesh = mesh_2d(world, tp=2, device=device)
    batch = spec.batch or world
    spec = dataclasses.replace(spec, batch=batch)
    model = shard_params(_model(spec, mesh_device(mesh)), mesh)
    dp_group = axis_group(mesh, "dp")
    dp, r = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
    if batch % dp:
        raise ValueError(f"dryrun: a batch of {batch} over {dp} dp ranks")
    result = _run(spec, model, data_parallel(model, dp_group),
                  local_rows(batch, dp, r), dp_group, dist.group.WORLD)
    result["mesh"] = tuple(mesh.mesh.shape)
    result["rank"] = dist.get_rank()
    if dist.get_rank():
        for k in ("params", "grads", "eval"):
            result.pop(k, None)
    return result


def dryrun_multichip(n_devices: int, device=None, spec: Spec = Spec(),
                     log=print, threads: Optional[int] = None
                     ) -> Dict[str, Any]:
    """One (dp, tp) training step of D-FINE on ``n_devices`` ranks on
    ``device`` (default ``"cuda"``). Returns rank 0's result (``loss``,
    ``grad_norm``, the gathered ``params`` and ``grads`` after the step,
    ``eval`` outputs if asked) with ``ranks``, every rank's kernel
    launches."""
    dev = resolve_device(device)
    results = launch(dryrun_rank, n_devices, dev.type,
                     args=(spec, dev.type), threads=threads)
    out = dict(results[0])
    out["ranks"] = [{k: r[k] for k in ("rank", "launches", "eval_launches",
                                       "loss")} for r in results]
    if not np.isfinite(out["loss"]):
        raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite "
                           f"loss {out['loss']}")
    log(f"dryrun_multichip({n_devices}): train step ok, "
        f"loss={out['loss']:.4f}")
    return out


def one_process_step(spec: Spec, device=None, order=None
                     ) -> Dict[str, Any]:
    """The same eval forward and step in this process over the whole
    batch (no group, no sharding); ``order``, a permutation of the rows,
    changes nothing but the order of the f32 sums (the checks measure the
    step's own rounding noise so)."""
    dev = resolve_device(device)
    batch = spec.batch or 1
    spec = dataclasses.replace(spec, batch=batch)
    model = _model(spec, dev)
    rows = slice(0, batch) if order is None else np.array(order)
    return _run(spec, model, model, rows, None, None)


def rounding_noise(spec: Spec, want: Dict[str, Any], device=None
                   ) -> Dict[str, float]:
    """{parameter: how far reordering the batch's rows moves its gradient
    from ``want``'s (the one-process step in order)}: the larger over the
    rows reversed and the rows rolled by half the batch."""
    batch = spec.batch or 1
    runs = [one_process_step(spec, device, order)["grads"] for order in (
        np.arange(batch)[::-1], np.roll(np.arange(batch), batch // 2))]
    return {n: max(float((r[n] - g).norm()) for r in runs)
            for n, g in want["grads"].items()}


def main(argv=None) -> None:
    """``[n [device]]``: n ranks (4) on the card, or on ``cpu`` if asked."""
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 4
    device = argv[1] if len(argv) > 1 else None
    dryrun_multichip(n, device, threads=1)


if __name__ == "__main__":
    main()
