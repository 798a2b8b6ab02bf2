"""Row gather of the discrete deformable attention: the CUDA kernel
``csrc/onehot_gather.cu``, its plain PyTorch version and its launch counter.

Counterpart of the forward of
``pautdx/ops/pallas_gather.py::pallas_onehot_gather``. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises. ``LAUNCHES`` counts kernel launches and nothing else. The backward
(a scatter-add) belongs to the training path and is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from pautdx_torch.ops import _build

LAUNCHES = 0

# flat, idx, out, B, L, T, row bytes, stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_void_p])


def onehot_gather_reference(flat: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """flat (B, L, C); idx (B, T) -> (B, T, C) = flat[b, clip(idx, 0, L-1)]."""
    L = flat.shape[1]
    i = idx.clamp(0, L - 1).long()
    return torch.take_along_dim(flat, i[..., None], dim=1)


def onehot_gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (B, L, C) of any 2- or 4-byte dtype; idx (B, T) int32 ->
    (B, T, C) rows, copied bit for bit. Indices are clipped to [0, L-1] as
    the TPU kernel clips them. The kernel copies 16-byte pieces, so on the
    card a row must be a multiple of 16 bytes and ``flat`` 16-byte aligned
    (C=128 on the serving path: 256-byte rows)."""
    global LAUNCHES
    if flat.dim() != 3 or idx.dim() != 2 or idx.shape[0] != flat.shape[0]:
        raise ValueError(f"onehot_gather: want flat (B, L, C) and idx (B, T),"
                         f" got {tuple(flat.shape)} and {tuple(idx.shape)}")
    if idx.device != flat.device:
        raise ValueError("onehot_gather: flat and idx on different devices")
    if flat.device.type == "cpu":
        return onehot_gather_reference(flat, idx)
    if flat.device.type != "cuda":
        raise RuntimeError(f"onehot_gather: no kernel for {flat.device}")
    if idx.dtype != torch.int32:
        raise TypeError(f"onehot_gather: idx must be int32, got {idx.dtype}")
    if flat.element_size() not in (2, 4) or flat.is_complex():
        raise TypeError(f"onehot_gather: unsupported dtype {flat.dtype}")
    if not (flat.is_contiguous() and idx.is_contiguous()):
        raise ValueError("onehot_gather: flat and idx must be contiguous")
    B, L, C = flat.shape
    T = idx.shape[1]
    if L == 0:
        raise ValueError("onehot_gather: empty table")
    row_bytes = C * flat.element_size()
    if row_bytes % 16 or flat.data_ptr() % 16:
        raise ValueError(f"onehot_gather: the kernel copies 16-byte pieces; "
                         f"got {row_bytes}-byte rows at an address "
                         f"{flat.data_ptr() % 16} bytes past 16-byte "
                         f"alignment")
    out = torch.empty((B, T, C), dtype=flat.dtype, device=flat.device)
    if out.numel() == 0:
        return out
    fn = _build.function("onehot_gather", "pautdx_onehot_gather",
                         _ARGTYPES)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = fn(flat.data_ptr(), idx.data_ptr(), out.data_ptr(), B, L, T,
                row_bytes, stream)
        LAUNCHES += 1
    _build.check(rc, "onehot_gather")
    return out
