"""Device mesh over the ranks of a process group, and batch placements.

Counterpart of ``pautdx/mesh/__init__.py``. The reference is one process
that sees every device; here every rank is a process of its own
(:mod:`pautdx_torch.mesh.launch` starts them, or ``torchrun``), and a mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over the initialised
group: rank r sits at position r of the row-major device array, as the
reference's device r does. Batches are split on their leading axis over
``dp``; parameters are replicated (``mesh.tp`` shards some over ``tp``).

Several ranks may share one card: NCCL refuses two ranks on one device,
so on a machine with fewer cards than ranks they run over gloo
(``mesh.launch``), and ``mesh.comm`` keeps to the collectives that gloo
carries for CUDA tensors.

A ragged batch, whose rows do not divide by the dp size, is padded to
:func:`pad_to_multiple` rows by repeating its last row, and a ``row_mask``
(1 for the batch's rows, 0 for the padding) goes with it. The reference
defines ``pad_to_multiple`` but never calls it: its ``Trainer.evaluate``
places such a batch with ``batch_sharding`` and raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pautdx_torch.device import Device, resolve_device

ROW_MASK = "row_mask"


def mesh_shape(n: int, axis_names: Sequence[str] = ("dp",)
               ) -> Tuple[int, ...]:
    """The reference's shape rule: one axis holds all n; two axes take
    the balanced ``(n // minor, minor)``, ``minor`` the largest divisor of
    n that is at most sqrt(n) (8 -> (4, 2), 6 -> (3, 2), 7 -> (7, 1));
    more axes raise."""
    if len(axis_names) == 1:
        return (n,)
    if len(axis_names) == 2:
        minor = max(d for d in range(1, math.isqrt(n) + 1) if n % d == 0)
        return (n // minor, minor)
    raise ValueError(f"make_mesh cannot auto-shape {len(axis_names)} axes; "
                     f"pass `devices` pre-reshaped")


def _device_mesh(device_type: str, ranks: np.ndarray,
                 axis_names: Sequence[str]):
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialised; "
                           "start the ranks with pautdx_torch.mesh.launch "
                           "(or torchrun)")
    if ranks.size != dist.get_world_size():
        raise ValueError(f"make_mesh: a mesh of {ranks.size} ranks over a "
                         f"world of {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.as_tensor(ranks),
                      mesh_dim_names=tuple(axis_names))


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",),
              devices: Optional[Sequence] = None, device: Device = None):
    """A ``DeviceMesh`` over ranks ``0 .. n-1`` of the initialised group,
    shaped by :func:`mesh_shape` (``devices``, a pre-shaped array of
    ranks, overrides it). ``n_devices=None`` is every card of the machine
    (``device`` defaults to ``"cuda"``); a CPU caller passes it."""
    dev = resolve_device(device)
    if devices is not None:
        ranks = np.asarray(devices)
        if ranks.ndim != len(axis_names):
            ranks = ranks.reshape(mesh_shape(ranks.size, axis_names))
    else:
        if n_devices is None:
            n_devices = (torch.cuda.device_count() if dev.type == "cuda"
                         else dist.get_world_size())
        ranks = np.arange(n_devices).reshape(
            mesh_shape(n_devices, axis_names))
    return _device_mesh(dev.type, ranks, axis_names)


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 if the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 if the mesh has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0


def axis_group(mesh, axis: str):
    """The group of this rank along ``axis`` (None if the mesh has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_group(axis) if axis in names else None


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def placements(mesh, axis: Optional[str], dim: int = 0) -> tuple:
    """A tensor's placements on ``mesh`` in ``torch.distributed.tensor``
    terms: ``Shard(dim)`` on ``axis``, ``Replicate()`` on every other axis
    (every axis when ``axis`` is None)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dim) if n == axis else Replicate()
                 for n in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement of a batch on a mesh: its leading axis split over
    ``axis``, or replicated (``axis`` None); ``placements`` gives it in
    ``torch.distributed.tensor`` terms."""
    mesh: Any
    axis: Optional[str] = None

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.axis)


def batch_sharding(mesh, axis: str = "dp") -> Sharding:
    """Split the leading (batch) axis over ``axis``; replicate the rest."""
    return Sharding(mesh, axis)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, None)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_rows(batch: Dict[str, Any], m: int) -> Dict[str, Any]:
    """``batch`` with its rows padded to a multiple of ``m`` by repeating
    the last row, plus ``row_mask``; a batch that divides comes back
    unchanged (no mask)."""
    n = len(next(iter(batch.values())))
    total = pad_to_multiple(n, m)
    if total == n:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = torch.cat([v, v[-1:].expand(total - n, *v.shape[1:])])
        else:
            v = np.asarray(v)
            out[k] = np.concatenate(
                [v, np.repeat(v[-1:], total - n, axis=0)])
    out[ROW_MASK] = np.arange(total) < n
    return out


def local_rows(n: int, size: int, rank: int) -> slice:
    """Rank ``rank``'s rows of ``n`` (n divisible by ``size``)."""
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: Dict[str, Any], mesh, axis: str = "dp"
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global host ``batch`` (ragged batches
    padded, see :func:`pad_rows`), on its device."""
    from pautdx_torch.data.prefetch import to_device

    return to_device(batch, mesh_device(mesh), batch_sharding(mesh, axis))
