"""Host-side augmentations of signal sequences (numpy).

The port's own copy of ``pautdx/data/augment.py``, function for function,
so that one ``np.random.Generator`` gives the same arrays in both:

- ``pad_resample_sequence``: front zero padding (constant or varying
  linearly along the sequence), then a linear resample back to the
  signal length, the normalised defect positions rescaled with it (a
  variable water path in front of the part);
- ``RealisticNoise``: coloured 1/f noise, bursts, baseline drift, mains
  harmonics, quantisation or thermal noise at a drawn SNR, on a random
  subset of the signals;
- ``make_batch_augment``: both composed into a ``BatchIterator``
  ``augment``.

They run on the host before the batch is copied to the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def resample_1d(x: np.ndarray, new_len: int) -> np.ndarray:
    """Linear resample along the last axis (align_corners=True semantics)."""
    old_len = x.shape[-1]
    if old_len == new_len:
        return x
    src = np.linspace(0.0, old_len - 1.0, new_len)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, old_len - 1)
    w = (src - lo).astype(x.dtype)
    return x[..., lo] * (1.0 - w) + x[..., hi] * w


def pad_resample_sequence(signals: np.ndarray, positions: np.ndarray,
                          rng: np.random.Generator,
                          pad_range: Tuple[int, int] = (80, 320),
                          varying: bool = True
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Prepend zero padding (uniform or linearly varying across the sequence),
    then resample back to the original signal length; rescale normalized
    (start, end) defect positions accordingly.

    signals: (L, S); positions: (L, 2) normalized. Matches the effect of
    `defect_focused_dataset_aug.py:15-340` — simulating a variable water path
    in front of the part.
    """
    L, S = signals.shape
    p0 = int(rng.integers(pad_range[0], pad_range[1] + 1))
    if varying:
        p1 = int(rng.integers(pad_range[0], pad_range[1] + 1))
    else:
        p1 = p0
    pads = np.round(np.linspace(p0, p1, L)).astype(np.int64)
    out_sig = np.empty_like(signals)
    out_pos = positions.copy()
    for i in range(L):
        p = int(pads[i])
        padded = np.concatenate([np.zeros(p, signals.dtype), signals[i]])
        out_sig[i] = resample_1d(padded, S)
        scale = S / (S + p)
        off = p / (S + p)
        if out_pos[i, 0] != 0.0 or out_pos[i, 1] != 0.0:
            out_pos[i] = off + positions[i] * scale
    return out_sig, out_pos


def _colored_noise(n: int, exponent: float, rng: np.random.Generator) -> np.ndarray:
    """1/f^exponent noise via FFT filtering (pink=1, brown=2, blue=-1)."""
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    freqs = np.fft.rfftfreq(n)
    freqs[0] = freqs[1] if n > 1 else 1.0
    spec = spec / (freqs ** (exponent / 2.0))
    out = np.fft.irfft(spec, n=n)
    std = out.std()
    return (out / std if std > 0 else out).astype(np.float32)


class RealisticNoise:
    """Sensor-realistic noise model (`realistic_noise_augmentation.py:8-284`)."""

    def __init__(self, prob: float = 0.3, max_fraction: float = 1.0 / 3.0):
        self.prob = prob
        self.max_fraction = max_fraction

    def _one(self, sig: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        n = sig.shape[0]
        amp = float(np.abs(sig).max()) or 1.0
        out = sig.astype(np.float32).copy()
        kind = rng.integers(0, 6)
        if kind == 0:    # colored noise
            exponent = float(rng.choice([1.0, 2.0, -1.0]))  # pink/brown/blue
            out += 0.05 * amp * _colored_noise(n, exponent, rng)
        elif kind == 1:  # burst
            start = int(rng.integers(0, max(1, n - 16)))
            width = int(rng.integers(4, 16))
            t = np.arange(width)
            burst = np.exp(-t / 4.0) * rng.standard_normal(width)
            out[start:start + width] += 0.3 * amp * burst[: n - start]
        elif kind == 2:  # baseline drift
            t = np.linspace(0, 1, n)
            out += 0.1 * amp * np.sin(2 * np.pi * float(rng.uniform(0.2, 1.0)) * t
                                      + float(rng.uniform(0, 2 * np.pi)))
        elif kind == 3:  # mains harmonics (50/60/120 Hz at an arbitrary rate)
            f = float(rng.choice([50.0, 60.0, 120.0])) / 1000.0
            t = np.arange(n)
            out += 0.05 * amp * np.sin(2 * np.pi * f * t)
        elif kind == 4:  # quantization 10-14 bits
            bits = int(rng.integers(10, 15))
            q = amp / (2 ** (bits - 1))
            out = np.round(out / q) * q
        else:            # thermal noise at SNR 35-50 dB
            snr_db = float(rng.uniform(35.0, 50.0))
            p_sig = float((sig ** 2).mean()) or 1e-12
            p_noise = p_sig / (10 ** (snr_db / 10.0))
            out += np.sqrt(p_noise) * rng.standard_normal(n).astype(np.float32)
        return out.astype(np.float32)

    def __call__(self, signals: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """signals (L, S): augment a random subset (<= max_fraction) of rows."""
        out = signals.copy()
        L = signals.shape[0]
        n_aug = int(rng.integers(1, max(2, int(L * self.max_fraction) + 1)))
        for i in rng.choice(L, size=min(n_aug, L), replace=False):
            if rng.random() < self.prob:
                out[i] = self._one(signals[i], rng)
        return out


def make_batch_augment(pad_range: Optional[Tuple[int, int]] = (80, 320),
                       noise: Optional[RealisticNoise] = None,
                       pad_prob: float = 0.5):
    """Compose augmentations into a BatchIterator-compatible callable."""
    def _aug(batch: dict, rng: np.random.Generator) -> dict:
        sig = batch["signals"]
        pos = batch["positions"]
        sig = sig.copy()
        pos = pos.copy()
        for b in range(sig.shape[0]):
            if pad_range is not None and rng.random() < pad_prob:
                sig[b], pos[b] = pad_resample_sequence(sig[b], pos[b], rng,
                                                       pad_range)
            if noise is not None:
                sig[b] = noise(sig[b], rng)
        return {**batch, "signals": sig, "positions": pos}
    return _aug
