"""B-scan rendering as batched PyTorch ops on the card.

Counterpart of ``pautdx/data/bscan.py``, whose jitted render streams a
volume's scans through the device in one program. Here the same steps run
as batched tensor ops on ``device`` (``"cuda"`` unless the caller passes
the CPU): (scans, beams, samples) -> |signal| -> per-image max
normalisation -> bilinear resize with half-pixel centres -> rotation by 90°
clockwise, (scans, H, W) out. Annotations follow the rotation with the
x-axis inversion of :func:`adjust_annotations`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pautdx_torch.data.volume import ParsedVolume, volume_defect_boxes
from pautdx_torch.device import resolve_device


def _bilinear_resize_2d(img: torch.Tensor, out_h: int, out_w: int
                        ) -> torch.Tensor:
    """Bilinear resize of (..., H, W) -> (..., out_h, out_w), half-pixel
    centres clipped to the image (cv2.INTER_LINEAR), f32 coordinates; the
    leading axes are a batch."""
    h, w = img.shape[-2:]
    dev = img.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) \
        * (h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) \
        * (w / out_w) - 0.5
    y0 = torch.floor(ys).clamp(0, h - 1).long()
    x0 = torch.floor(xs).clamp(0, w - 1).long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (ys - y0).clamp(0.0, 1.0)[:, None]
    wx = (xs - x0).clamp(0.0, 1.0)[None, :]
    rows0 = img[..., y0, :]
    rows1 = img[..., y1, :]
    top = rows0[..., x0] * (1 - wx) + rows0[..., x1] * wx
    bot = rows1[..., x0] * (1 - wx) + rows1[..., x1] * wx
    return top * (1 - wy) + bot * wy


def rotate90_cw(img: torch.Tensor) -> torch.Tensor:
    """Rotate (..., H, W) 90° clockwise: out[i, j] = in[H-1-j, i]."""
    return img.transpose(-1, -2).flip(-1)


def render_bscans(scan_images: Union[np.ndarray, torch.Tensor],
                  out_h: int = 320, out_w: int = 320,
                  normalize: bool = True,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> torch.Tensor:
    """Batched B-scan render on ``device``: (T, beams, samples) ->
    (T, out_h, out_w) float32.

    Per frame: |signal| amplitude image -> (optionally) divided by its
    maximum, floored at 1e-8 -> bilinear resize to (out_w, out_h) -> rotate
    90° CW, so the rotated image is (out_h, out_w), as
    ``cv2.resize(img, (W, H))`` then ``ROTATE_90_CLOCKWISE``.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(scan_images).to(dev, torch.float32).abs()
    if normalize:
        mx = x.amax(dim=(-1, -2), keepdim=True)
        x = x / mx.clamp(min=1e-8)
    return rotate90_cw(_bilinear_resize_2d(x, out_w, out_h))


def adjust_annotations(ann: Dict[str, list], n_beams: int,
                       size: Tuple[int, int] = (320, 320)) -> Dict[str, list]:
    """Beam/depth bboxes -> pixel bboxes on the rendered image, with the
    **x-axis inversion** of the rotate-90-CW render: beam index i maps to
    pixel ``W - W*i/(n_beams-1)``; depth d (normalized) maps to ``d * H``.
    bbox stays [x1, x2, y1, y2] like the reference schema.
    """
    W, H = size
    span = max(n_beams - 1, 1)
    out: Dict[str, list] = {}
    for key, defects in ann.items():
        adj = []
        for d in defects:
            b0, b1, d0, d1 = d["bbox"]
            x1 = int(round(W - W * (b0 / span)))
            x2 = int(round(W - W * (b1 / span)))
            y1 = int(round(d0 * H))
            y2 = int(round(d1 * H))
            adj.append({"bbox": [x1, x2, y1, y2], "label": d["label"]})
        out[key] = adj
    return out


def render_volume(vol: ParsedVolume, out_h: int = 320, out_w: int = 320,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, list]]:
    """ParsedVolume -> (T, H, W) frames rendered on ``device`` and left
    there, and the pixel annotations."""
    frames = np.swapaxes(vol.beam_array(), 0, 1)  # (scans, beams, samples)
    imgs = render_bscans(frames, out_h, out_w, device=device)
    ann = adjust_annotations(volume_defect_boxes(vol), vol.n_beams,
                             (out_w, out_h))
    return imgs, ann


def render_volume_dataset(vol: ParsedVolume, out_h: int = 320,
                          out_w: int = 320,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Tuple[np.ndarray, Dict[str, list]]:
    """:func:`render_volume` with the frames returned as a host array."""
    imgs, ann = render_volume(vol, out_h, out_w, device)
    return imgs.cpu().numpy(), ann


def bbox_xyxy_from_schema(bbox: List[float]
                          ) -> Tuple[float, float, float, float]:
    """Schema [x1, x2, y1, y2] (x may be inverted) -> canonical (x1, y1, x2, y2)."""
    x1, x2, y1, y2 = bbox
    return (min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2))
