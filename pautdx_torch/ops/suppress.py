"""Greedy NMS suppression sweep: the CUDA kernel ``csrc/nms_suppress.cu``,
its plain PyTorch version and its launch counter.

Counterpart of ``pautdx/ops/pallas_nms.py::nms_suppress``, batched: the
JAX package sweeps one image per call, this sweeps (B, K, K) at once, as a
bitmask: the suppression words of every row are built in parallel, then
one warp per image walks the kept boxes (two CUDA launches, counted as
one). On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from pautdx_torch.ops import _build

LAUNCHES = 0
# the sweep warp's 32 lanes x 32-bit words; the TPU kernel's (K, K) f32
# IoU must fit its scoped VMEM, about K <= 1,400-2,000
MAX_K = 1024

# iou, valid, keep, mask scratch, B, K, thr, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_void_p])


def nms_suppress_reference(iou: torch.Tensor, valid: torch.Tensor,
                           iou_threshold: float = 0.45) -> torch.Tensor:
    """iou (B, K, K) of score-sorted boxes; valid (B, K) -> keep (B, K)
    float32: keep starts as valid, and in order each i with keep[i] > 0
    zeroes every j > i with iou[i, j] > iou_threshold (compared in f32)."""
    iou = iou.float()
    keep = valid.float().clone()
    K = iou.shape[-1]
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=iou.device)
    later = torch.arange(K, device=iou.device)
    for i in range(K):
        alive = keep[:, i:i + 1] > 0.0
        suppress = (iou[:, i, :] > thr) & (later > i) & alive
        keep = keep.masked_fill(suppress, 0.0)
    return keep


def nms_suppress(iou: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float = 0.45) -> torch.Tensor:
    """The greedy sweep over a batch: iou (B, K, K) of any float dtype and
    valid (B, K) of any dtype, both cast to f32 as the TPU kernel casts
    them -> keep (B, K) f32. The kernel takes K <= 1024."""
    global LAUNCHES
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2] or \
            tuple(valid.shape) != tuple(iou.shape[:2]):
        raise ValueError(f"nms_suppress: want iou (B, K, K) and valid "
                         f"(B, K), got {tuple(iou.shape)} and "
                         f"{tuple(valid.shape)}")
    if valid.device != iou.device:
        raise ValueError("nms_suppress: iou and valid on different devices")
    if iou.device.type == "cpu":
        return nms_suppress_reference(iou, valid, iou_threshold)
    if iou.device.type != "cuda":
        raise RuntimeError(f"nms_suppress: no kernel for {iou.device}")
    if not iou.is_floating_point():
        raise TypeError(f"nms_suppress: iou must be a float tensor, got "
                        f"{iou.dtype}")
    # cast to f32 as the TPU kernel's wrapper casts it (a no-op for f32)
    iou = iou.to(torch.float32)
    if not iou.is_contiguous():
        raise ValueError("nms_suppress: iou must be contiguous")
    B, K = valid.shape
    if K > MAX_K:
        raise ValueError(f"nms_suppress: K={K} candidates; the kernel's "
                         f"bitmask holds at most {MAX_K}")
    valid = valid.to(torch.float32).contiguous()
    keep = torch.empty((B, K), dtype=torch.float32, device=iou.device)
    if keep.numel() == 0:
        return keep
    # the suppression bitmask, 32 candidates a word: written by the first
    # of the kernel's two launches, read by the second
    mask = torch.empty((B, K, (K + 31) // 32), dtype=torch.int32,
                       device=iou.device)
    fn = _build.function("nms_suppress", "pautdx_nms_suppress", _ARGTYPES)
    with torch.cuda.device(iou.device):
        stream = torch.cuda.current_stream(iou.device).cuda_stream
        rc = fn(iou.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                mask.data_ptr(), B, K, iou_threshold, stream)
        LAUNCHES += 1
    _build.check(rc, "nms_suppress")
    return keep
