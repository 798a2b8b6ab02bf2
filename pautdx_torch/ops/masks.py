"""YOLO-seg prototype mask decode: the CUDA kernel ``csrc/assemble_masks.cu``,
its plain PyTorch version and its launch counter.

Counterpart of ``pautdx/ops/pallas_mask.py::pallas_assemble_masks`` and of
the XLA ``assemble_masks`` (``pautdx/models/vision/yolo.py``), with their
contract: protos (B, Hp, Wp, P), coeffs (B, K, P), boxes (B, K, 4) xyxy in
image pixels -> (B, K, Hp, Wp) float32 masks, ``sigmoid(coeffs . protos)``
inside each box scaled to proto pixels by ``[Wp/W, Hp/H, Wp/W, Hp/H]`` in
f32, ``[x1, x2) x [y1, y2)``, and 0 outside. On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pautdx_torch.ops import _build

LAUNCHES = 0
PROTO_DIM = 32                       # the kernel's P: Ultralytics' nm
MAX_SHARED_BYTES = 48 * 1024         # a block's default shared memory

# protos, coeffs, boxes, out, B, K, Hp, Wp, P, sx, sy, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _scales(protos: torch.Tensor, img_size: Tuple[int, int]):
    Hp, Wp = protos.shape[1:3]
    H, W = img_size
    return Wp / W, Hp / H


def assemble_masks_reference(protos: torch.Tensor, coeffs: torch.Tensor,
                             boxes: torch.Tensor,
                             img_size: Tuple[int, int]) -> torch.Tensor:
    """The three passes the kernel fuses: the einsum, the sigmoid and the
    box window, all in f32."""
    protos, coeffs = protos.float(), coeffs.float()
    m = torch.sigmoid(torch.einsum("bhwp,bkp->bkhw", protos, coeffs))
    Hp, Wp = m.shape[2:]
    sx, sy = _scales(protos, img_size)
    scale = torch.tensor([sx, sy, sx, sy], dtype=torch.float32,
                         device=boxes.device)
    pb = boxes.float() * scale
    ys = torch.arange(Hp, dtype=torch.float32, device=m.device)[:, None]
    xs = torch.arange(Wp, dtype=torch.float32, device=m.device)[None, :]
    x1, y1, x2, y2 = (pb[..., i, None, None] for i in range(4))
    inside = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    return torch.where(inside, m, torch.zeros((), device=m.device))


def assemble_masks(protos: torch.Tensor, coeffs: torch.Tensor,
                   boxes: torch.Tensor,
                   img_size: Tuple[int, int]) -> torch.Tensor:
    """protos (B, Hp, Wp, P); coeffs (B, K, P); boxes (B, K, 4) in image
    px -> (B, K, Hp, Wp) f32 masks in [0, 1], zero outside the boxes. The
    kernel takes f32 inputs, P = ``PROTO_DIM`` and K up to 341."""
    global LAUNCHES
    if protos.dim() != 4 or coeffs.dim() != 3 or boxes.dim() != 3 or \
            coeffs.shape[0] != protos.shape[0] or \
            coeffs.shape[2] != protos.shape[3] or \
            tuple(boxes.shape) != (*coeffs.shape[:2], 4):
        raise ValueError(f"assemble_masks: want protos (B, Hp, Wp, P), "
                         f"coeffs (B, K, P) and boxes (B, K, 4), got "
                         f"{tuple(protos.shape)}, {tuple(coeffs.shape)} and "
                         f"{tuple(boxes.shape)}")
    if coeffs.device != protos.device or boxes.device != protos.device:
        raise ValueError("assemble_masks: inputs on different devices")
    if protos.device.type == "cpu":
        return assemble_masks_reference(protos, coeffs, boxes, img_size)
    if protos.device.type != "cuda":
        raise RuntimeError(f"assemble_masks: no kernel for {protos.device}")
    for name, t in (("protos", protos), ("coeffs", coeffs), ("boxes", boxes)):
        if t.dtype != torch.float32:
            raise TypeError(f"assemble_masks: {name} must be float32, got "
                            f"{t.dtype}")
    B, Hp, Wp, P = protos.shape
    K = coeffs.shape[1]
    if P != PROTO_DIM:
        raise ValueError(f"assemble_masks: P={P} prototypes; the kernel is "
                         f"built for P={PROTO_DIM}")
    if K * (P + 4) * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"assemble_masks: K={K} detections at P={P} need "
                         f"{K * (P + 4) * 4} bytes of shared memory, over "
                         f"{MAX_SHARED_BYTES}")
    if Hp * Wp >= 2 ** 31:
        raise ValueError("assemble_masks: more than 2^31 proto pixels")
    if not (protos.is_contiguous() and coeffs.is_contiguous()
            and boxes.is_contiguous()):
        raise ValueError("assemble_masks: inputs must be contiguous")
    # the kernel reads each pixel's P values as float4
    if protos.data_ptr() % 16:
        raise ValueError("assemble_masks: protos must be 16-byte aligned")
    out = torch.empty((B, K, Hp, Wp), dtype=torch.float32,
                      device=protos.device)
    if out.numel() == 0:
        return out
    sx, sy = _scales(protos, img_size)
    fn = _build.function("assemble_masks", "pautdx_assemble_masks",
                         _ARGTYPES)
    with torch.cuda.device(protos.device):
        stream = torch.cuda.current_stream(protos.device).cuda_stream
        rc = fn(protos.data_ptr(), coeffs.data_ptr(), boxes.data_ptr(),
                out.data_ptr(), B, K, Hp, Wp, P, sx, sy, stream)
        LAUNCHES += 1
    _build.check(rc, "assemble_masks")
    return out
