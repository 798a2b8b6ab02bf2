"""stdin/stdout JSON bridge: serving across a process boundary.

Counterpart of ``pautdx/serve/bridge.py``, with the same wire protocol:
read a ``[T][H][W]`` (or ``[T][H][W][3]``) float array from stdin, run a
temporal detector over it, write ``[[{box, label, score}, ...], ...]``,
one list per frame, to stdout. ``serve_signals`` waits for the signal
models' endpoint (ROADMAP.md, queue 1, item 11).

    python -c "from pautdx_torch.serve.bridge import serve_frames; \\
        from pautdx_torch.serve.temporal_predict import *; \\
        m = build_temporal_model(); \\
        serve_frames(lambda f: predict_sequence(m, f))" < frames.json
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
