"""The one general generator of the benchmark's traffic.

A traffic mix is a JSON file beside this one, read by name. Its ``kind``
says what it makes:

- ``frame_ring``: ``ring_frames`` uint8 frames of ``size`` (H, W, C), made
  on the device from the seed in one call and held in pinned host memory,
  served in batches of ``batch`` frames, the ring taken in turn, with
  ``in_flight`` batches submitted ahead (a closed loop). The same seed gives
  the same frames.
"""

from __future__ import annotations

from pathlib import Path

import torch

from portbench.core.spec import check_name, load_json

HERE = Path(__file__).resolve().parent
KINDS = ("frame_ring",)


def load(name: str) -> dict:
    t = load_json(HERE / f"{check_name(name, 'traffic')}.json")
    if t.get("kind") not in KINDS:
        raise ValueError(f"traffic {name}: kind {t.get('kind')!r}; known: "
                         f"{', '.join(KINDS)}")
    return t


def frame_ring(traffic: dict, seed: int, device: torch.device
               ) -> torch.Tensor:
    """The mix's frame ring, (ring_frames, H, W, C) uint8 on the host,
    pinned when the device is a card."""
    H, W, C = traffic["size"]
    n = traffic["ring_frames"]
    if n % traffic["batch"]:
        raise ValueError("ring_frames must be a multiple of batch")
    gen = torch.Generator(device=device).manual_seed(seed)
    made = torch.randint(0, 256, (n, H, W, C), generator=gen, device=device,
                         dtype=torch.uint8)
    if device.type != "cuda":
        return made
    host = torch.empty(made.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(made)
    del made
    return host

