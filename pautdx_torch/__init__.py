"""pautdx_torch — the PyTorch/CUDA port of pautdx for one NVIDIA H100.

The JAX package ``pautdx`` is the reference; this package keeps its module
paths and class names so each counterpart is easy to find, and imports
nothing of it (nor of JAX). The serving path of the D-FINE-nano B-scan
detector runs through two hand-written CUDA kernels (``pautdx_torch.ops``),
built with ``nvcc`` on first use into ``build/pautdx_torch/``.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``;
without a card it raises unless the caller asks for ``device="cpu"``, where
each kernel wrapper runs its plain PyTorch version.
"""

from pautdx_torch.device import resolve_device
from pautdx_torch.version import __version__

__all__ = ["__version__", "resolve_device"]
