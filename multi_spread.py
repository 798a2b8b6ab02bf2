"""How far f32 rounding moves the multi-device D-FINE step's gradients.

    python3 multi_spread.py [--leaves N]

One training step of ``dfine_nano(num_labels=2)`` at 640px over the
dry run's global batch of 16 (``mesh.dryrun``), on the card, TF32 off:
the step in one process with its rows in order is the reference, and
each arm below is held to it, leaf by leaf:

- ``dp x tp``: four gloo ranks sharing the card as a (2, 2) mesh
  (``chip_smoke.py`` phase 37 (b)), the batch's rows in order and in
  three seeded arrangements (the arrangement decides which rows each dp
  rank takes);
- ``dp 4`` and ``tp 2`` alone, rows in order and in one arrangement;
- one process with its rows in eight seeded orders.

Every arm computes the same gradient up to how its f32 sums round; the
spread of the one-process orders is what a correct arm may move a leaf.
It prints each arm's global relative error, then each arm's move (the
L2 norm of the difference) of the reference's two largest-norm leaves
and of the ``--leaves`` leaves that the (2, 2) arm in order moves most
against the largest move of the one-process orders. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 16


def rank_step(spec, order, tp: int):
    """A rank's step on ``mesh_2d(world, tp)``, the global batch's rows
    taken in ``order``; rank 0 returns the gathered gradients."""
    import torch.distributed as dist

    from pautdx_torch.mesh import (axis_group, axis_rank, axis_size,
                                   local_rows, mesh_device)
    from pautdx_torch.mesh.dryrun import _model, _run
    from pautdx_torch.mesh.tp import mesh_2d, shard_params
    from pautdx_torch.train.trainer import data_parallel

    mesh = mesh_2d(dist.get_world_size(), tp=tp, device="cuda")
    model = shard_params(_model(spec, mesh_device(mesh)), mesh)
    group = axis_group(mesh, "dp")
    dp = axis_size(mesh, "dp")
    rows = np.asarray(order)[local_rows(spec.batch, dp,
                                        axis_rank(mesh, "dp"))]
    net = data_parallel(model, group) if dp > 1 else model
    out = _run(spec, model, net, rows, group, dist.group.WORLD)
    return {"grads": out["grads"]} if dist.get_rank() == 0 else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leaves", type=int, default=4)
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        sys.exit("multi_spread.py needs a card")
    sys.path.insert(0, HERE)
    from pautdx_torch.mesh.dryrun import Spec, one_process_step
    from pautdx_torch.mesh.launch import launch
    from pautdx_torch.models.vision.dfine import dfine_nano
    from pautdx_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    spec = Spec(cfg=dfine_nano(num_labels=2), size=640, batch=BATCH)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    want = one_process_step(spec, dev)["grads"]
    rng = np.random.default_rng(7)
    orders = [np.arange(BATCH)] + [rng.permutation(BATCH) for _ in range(3)]
    arms = {}
    for i, order in enumerate(orders):
        arms[f"dp x tp, arrangement {i}"] = launch(
            rank_step, 4, "cuda", args=(spec, order, 2))[0]["grads"]
    for i, order in enumerate(orders[:2]):
        arms[f"dp 4, arrangement {i}"] = launch(
            rank_step, 4, "cuda", args=(spec, order, 1))[0]["grads"]
        arms[f"tp 2, arrangement {i}"] = launch(
            rank_step, 2, "cuda", args=(spec, order, 2))[0]["grads"]
    for i in range(8):
        order = np.random.default_rng(100 + i).permutation(BATCH)
        arms[f"one process, order {i}"] = one_process_step(
            spec, dev, order)["grads"]

    def move(grads, n):
        return float((grads[n] - want[n]).norm())

    total = sum(float(g.double().pow(2).sum()) for g in want.values()) ** .5
    first = arms["dp x tp, arrangement 0"]
    norm = {n: g.norm().item() for n, g in want.items()}
    spread = {n: max(move(g, n) for k, g in arms.items()
                     if k.startswith("one process")) for n in want}
    by_norm = sorted(want, key=lambda n: -norm[n])[:2]
    by_spread = sorted(want, key=lambda n: -move(first, n)
                       / max(spread[n], 1e-30))[:args.leaves]
    leaves = list(dict.fromkeys(by_spread + by_norm))
    for name, grads in arms.items():
        glob = sum(move(grads, n) ** 2 for n in want) ** .5 / total
        print(f"{name}: global {glob:.3g}", flush=True)
    for n in leaves:
        print(f"{n} (|g| {norm[n]:.4g}): " + "; ".join(
            f"{name} {move(grads, n):.3g}" for name, grads in arms.items()),
            flush=True)
    print(f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
