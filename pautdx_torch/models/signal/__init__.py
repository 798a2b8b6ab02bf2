"""The signal domain's (A-scan sequence) model zoo.

Counterpart of ``pautdx/models/signal``: the 21 models of ``MODEL_ZOO``,
``DenseAutoencoder``, ``SignalSequenceDetector`` and its Enhanced variant
(``seq_detector.py``) and ``Hybrid1DDetLoc`` (``detloc1d.py``), all at the
reference's published widths by default.
"""

from __future__ import annotations

import inspect
import torch
from torch import nn

from pautdx_torch.device import Device
from pautdx_torch.models.signal.detection_zoo import MODEL_ZOO  # noqa: F401
from pautdx_torch.models.signal.detloc1d import Hybrid1DDetLoc  # noqa: F401
from pautdx_torch.models.signal.enhanced_position import (  # noqa: F401
    EnhancedPositionMSC, FixedEnhancedPositionMSC, HybridModel,
)
from pautdx_torch.models.signal.hybrid_binary import (  # noqa: F401
    HybridBinaryModel,
)
from pautdx_torch.models.signal.msc import (  # noqa: F401
    ConvMultiSignalClassifier, DenseAutoencoder, MultiSignalClassifier,
    SetTransformer, SignalClassifierMLP,
)
from pautdx_torch.models.signal.msc_n import (  # noqa: F401
    MSC3Out, MSC_N, ImprovedMSC,
)
from pautdx_torch.models.signal.seq_detector import (  # noqa: F401
    EnhancedSignalSequenceDetector, SignalSequenceDetector,
)
from pautdx_torch.models.signal.two_stage import TwoStageDetector  # noqa: F401


def build_signal_model(name: str, *, signal_length: int = 320,
                       seed: int = 0,
                       device: Device = None,
                       **kwargs) -> nn.Module:
    """``MODEL_ZOO[name](**kwargs)`` with weights drawn from ``seed`` (the
    same on every device), in eval mode on ``device`` (default
    ``"cuda"``); ``signal_length`` goes to the models whose first layer
    reads the raw samples."""
    cls = MODEL_ZOO[name]
    if "signal_length" in inspect.signature(cls).parameters:
        kwargs.setdefault("signal_length", signal_length)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return cls(device=device, **kwargs)
