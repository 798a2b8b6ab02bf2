"""Fused AIFI self-attention: the CUDA kernel ``csrc/aifi_attention.cu``,
its plain PyTorch version and its launch counter.

Counterpart of ``pautdx/ops/pallas_attention.py``. bf16 runs on the
tensor cores (``mma.sync``), f32 on them too, each product taken as three
TF32 products (3xTF32); the dtype alone picks the path. The kernel takes
any head dim from 1 to ``MAX_HEAD_DIM``. On a CPU tensor the wrappers run
the plain version; on a CUDA tensor they launch the kernel or raise.
``LAUNCHES`` counts kernel launches and nothing else. The kernel serves
inference and has no backward: the wrappers refuse inputs that need a
gradient while grad mode is on, whatever the device.
"""

from __future__ import annotations

import ctypes

import torch

from pautdx_torch.ops import _build

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the port's ceiling (the TPU kernel takes any head dim): the kernel pads
# dh up to 16, 32, 64, 128 or 256; dfine_nano's AIFI layer has 16 (128
# channels, 8 heads), DFineConfig()'s 32 (256, 8)
MAX_HEAD_DIM = 256
# q, k, v, o, dtype, B, H, N, dh, batch/head/token strides, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """q/k/v (B, h, N, dh), q pre-scaled -> (B, h, N, dh): scores and the
    PV sum in f32, probabilities cast to v's dtype first, as the TPU
    kernel does."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def aifi_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, D) projections -> (B, N, D): split heads, plain attention,
    merge heads."""
    B, N, D = q.shape
    dh = D // num_heads

    def split(t):
        return t.reshape(B, N, num_heads, dh).transpose(1, 2)

    o = fused_attention_reference(split(q), split(k), split(v))
    return o.transpose(1, 2).reshape(B, N, D)


def _validate(q, k, v, ndim: int) -> None:
    if q.dim() != ndim or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention: q/k/v must share one {ndim}-d shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: q/k/v must all be float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attention: q/k/v on different devices")


def _launch(q, k, v, B: int, H: int, N: int, dh: int,
            sb: int, sh: int, sn: int) -> torch.Tensor:
    global LAUNCHES
    if q.device.type != "cuda":
        raise RuntimeError(f"attention: no kernel for device {q.device}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"attention: head dim {dh}; the kernel takes 1 to "
                         f"{MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention: q/k/v must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("attention: bf16 q/k/v must start on a 16-byte "
                         "boundary (the kernel copies 16-byte row pieces)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _build.function("aifi_attention", "pautdx_aifi_attention",
                         _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, H, N, dh, sb, sh, sn, stream)
        LAUNCHES += 1
    _build.check(rc, "aifi_attention")
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q/k/v (B, h, N, dh), q pre-scaled -> context (B, h, N, dh).
    Inference only: no mask, no dropout."""
    _validate(q, k, v, 4)
    _build.refuse_grad("fused_attention", q, k, v)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v)
    B, H, N, dh = q.shape
    return _launch(q, k, v, B, H, N, dh, H * N * dh, N * dh, dh)


def aifi_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """Fused attention over (B, N, D) projections (q pre-scaled) ->
    (B, N, D). The kernel reads each head through strides, so no split or
    merge of heads is materialised."""
    _validate(q, k, v, 3)
    B, N, D = q.shape
    if D % num_heads:
        raise ValueError(f"attention: D={D} not divisible by "
                         f"num_heads={num_heads}")
    _build.refuse_grad("aifi_attention", q, k, v)
    if q.device.type == "cpu":
        return aifi_attention_reference(q, k, v, num_heads)
    dh = D // num_heads
    return _launch(q, k, v, B, num_heads, N, dh, N * D, dh, D)
