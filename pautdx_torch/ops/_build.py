"""Builds and loads the port's CUDA kernels (plain C interface + ctypes).

Each ``pautdx_torch/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a``
into its own shared library under ``build/pautdx_torch/`` at the root of the
checkout, at first use. The library's file name carries a hash of its
source, the ``csrc/*.cuh`` headers and the flags, so an edited source or
header is rebuilt and a stale one is never loaded. All missing libraries are compiled by parallel ``nvcc`` processes.
A failed build raises with the compiler's output; nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception. :func:`refuse_grad`
is the check of the wrappers whose kernels have no backward yet.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pautdx_torch"
SOURCES = ("aifi_attention", "onehot_gather", "nms_suppress",
           "assemble_masks", "weighted_gather", "int8_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, Callable] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("pautdx_torch: nvcc not found (set CUDA_HOME); the "
                       "CUDA kernels are built from source on first use")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # the headers beside the sources, which any of them may include
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, all at
    once. Returns the wall seconds spent; raises if any build fails."""
    todo = [n for n in names if not lib_path(n).is_file()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for n, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{n} (rc {rc}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("pautdx_torch: nvcc failed for "
                           + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.is_file():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: Sequence) -> Callable:
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` with its
    argument types set; it returns a ``cudaError_t`` as an int."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[symbol] = fn
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"pautdx_torch: {what} launch failed with "
                           f"cudaError {rc}")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise if grad mode is on and any input needs a gradient: ``what``'s
    kernel fills its output outside autograd and has no backward yet, so
    its result would silently cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward yet and would cut the "
            f"autograd graph; call it under torch.no_grad() or "
            f"torch.inference_mode(), or use {what}_reference for gradients")
