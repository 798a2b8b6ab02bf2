"""Start the ranks of a multi-device run and collect what they return.

The reference is single-controller: one process drives every device. A
PyTorch program is one process per rank, so the port adds this launcher:

- :func:`launch` spawns ``world_size`` ranks with the ``spawn`` start
  method (the parent may hold a CUDA context, which a fork cannot
  inherit). Each runs ``fn(*args)`` inside an initialised process group
  and the parent returns every rank's result, in rank order.
- The ranks meet through a ``FileStore`` in a temporary directory, not a
  TCP port, so launches that run side by side never collide.
- The backend is NCCL for ``cuda`` with one rank per card, gloo for
  ``cpu`` and for several ranks sharing a card (NCCL refuses two ranks on
  one device). A collective waits ``PG_TIMEOUT`` seconds for its peers.
- An exception in a rank is raised again in the parent with that rank's
  traceback; if a rank dies or ``timeout`` seconds pass, every rank is
  killed, so a hung collective cannot hang the caller.
- For ``cuda`` the parent builds the kernels before it spawns, so the
  ranks load them instead of compiling them side by side.
- A world of 1 runs in the calling process (no spawn): its group is set
  up around ``fn`` and torn down after it, unless one already exists.
- The ranks take the caller's numerics switches (TF32 for cuDNN and for
  GEMMs, cuDNN's and PyTorch's deterministic algorithms), so that a rank
  computes as the caller would.

The functions a rank runs must be importable by module name (they live in
this package, never in a test module or a script).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from pautdx_torch.device import Device, resolve_device

PG_TIMEOUT = 60.0       # seconds a collective may wait for its peers


def backend_for(device: str, world_size: int) -> str:
    if device == "cuda" and world_size <= max(torch.cuda.device_count(), 1):
        return "nccl"
    return "gloo"


@contextlib.contextmanager
def process_group(rank: int, world_size: int, device: str, store_path: str):
    """This process as rank ``rank`` of a group that meets in the file
    ``store_path``; for ``cuda``, its card is ``rank % cards``."""
    backend = backend_for(device, world_size)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _switches() -> Dict[str, bool]:
    return {"cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "deterministic": torch.are_deterministic_algorithms_enabled()}


def _set_switches(sw: Dict[str, bool]) -> None:
    torch.backends.cudnn.allow_tf32 = sw["cudnn_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = sw["matmul_tf32"]
    torch.backends.cudnn.deterministic = sw["cudnn_deterministic"]
    torch.use_deterministic_algorithms(sw["deterministic"])


def _rank_main(fn, rank, world_size, device, workdir, args, threads,
               switches):
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    _set_switches(switches)
    if threads:
        torch.set_num_threads(threads)
    out = os.path.join(workdir, f"rank{rank}.pkl")
    try:
        with process_group(rank, world_size, device,
                           os.path.join(workdir, "store")):
            result = ("ok", fn(*args))
    except BaseException:       # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)


def _read(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def launch(fn: Callable, world_size: int, device: Device = None,
           args: Sequence = (), timeout: float = 900.0,
           threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` on ranks ``0 .. world_size - 1`` of a new group
    on ``device`` (``"cpu"``, or ``"cuda"``, the default) and return their
    results in rank order; results travel by pickle (tensors as CPU
    tensors). ``threads`` sets each rank's torch thread count."""
    device = resolve_device(device).type
    if device == "cuda":
        from pautdx_torch.ops import _build

        _build.build()
    workdir = tempfile.mkdtemp(prefix="pautdx_ranks_")
    try:
        if world_size == 1 and not dist.is_initialized():
            with process_group(0, 1, device, os.path.join(workdir, "store")):
                return [fn(*args)]
        if world_size == 1:
            return [fn(*args)]
        return _spawn(fn, world_size, device, args, timeout, threads,
                      workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _spawn(fn, world_size, device, args, timeout, threads,
           workdir) -> List[Any]:
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, device, workdir,
                               tuple(args), threads, _switches()))
             for r in range(world_size)]
    for p in procs:
        p.start()
    paths = [os.path.join(workdir, f"rank{r}.pkl")
             for r in range(world_size)]
    deadline = time.monotonic() + timeout
    results: Dict[int, Any] = {}
    try:
        while True:
            for r, path in enumerate(paths):
                if r not in results and os.path.exists(path):
                    status, results[r] = _read(path)
                    if status == "error":
                        raise RuntimeError(f"rank {r} of {world_size} "
                                           f"failed:\n{results[r]}")
            if len(results) == world_size:
                return [results[r] for r in range(world_size)]
            for r, p in enumerate(procs):
                if not p.is_alive() and not os.path.exists(paths[r]):
                    raise RuntimeError(f"rank {r} of {world_size} died "
                                       f"(exit code {p.exitcode})")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks did not finish in "
                                   f"{timeout:.0f} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
