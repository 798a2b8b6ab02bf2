"""stdin/stdout JSON bridge: serving across a process boundary.

Counterpart of ``pautdx/serve/bridge.py``, with the same wire protocol:
- ``serve_frames``: read a ``[T][H][W]`` (or ``[T][H][W][3]``) float
  array from stdin, run a temporal detector over it, write
  ``[[{box, label, score}, ...], ...]``, one list per frame, to stdout;
- ``serve_signals``: read ``{"signals": [N][S]}`` (or ``[B][N][S]``),
  run a ``SignalEndpoint``, write ``{"prob": [[...]], "pred": [[...]]}``
  (and ``"positions"``), batch first.

    python -c "from pautdx_torch.serve.bridge import serve_frames; \\
        from pautdx_torch.serve.temporal_predict import *; \\
        m = build_temporal_model(); \\
        serve_frames(lambda f: predict_sequence(m, f))" < frames.json
    python -c "from pautdx_torch.serve.bridge import serve_signals; \\
        from pautdx_torch.serve.endpoints import SignalEndpoint; \\
        from pautdx_torch.models.signal import build_signal_model; \\
        serve_signals(SignalEndpoint(build_signal_model('HybridBinary')))" \\
        < signals.json
"""

from __future__ import annotations

import json
import sys
from typing import Callable

import numpy as np


def serve_frames(predict_sequence: Callable, stdin=None, stdout=None
                 ) -> None:
    """One-shot frame-sequence bridge: [T][H][W] -> [[{box,label,score}]];
    grayscale frames are repeated to three channels."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    frames = np.asarray(json.load(stdin), np.float32)
    if frames.ndim == 3:
        frames = np.repeat(frames[..., None], 3, axis=-1)
    json.dump(predict_sequence(frames), stdout)
    stdout.flush()


def serve_signals(endpoint, stdin=None, stdout=None) -> None:
    """One-shot signal bridge: {"signals": [N][S]} -> the endpoint's
    per-signal outputs as nested lists."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    signals = np.asarray(json.load(stdin)["signals"], np.float32)
    out = endpoint.predict(signals[None] if signals.ndim == 2 else signals)
    json.dump({k: v.tolist() for k, v in out.items()}, stdout)
    stdout.flush()
