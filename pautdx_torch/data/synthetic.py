"""Seeded synthetic PAUT data generators — the framework's test fixtures.

The port's own copy of ``pautdx/data/synthetic.py``: the same numpy draws
from the same seed, so the volumes (and ``synth_dscan``'s D-scans) are
identical bit for bit.

The reference ships two synthetic generators used only for visualisation
(`signals/improved_multisignal/visualization/paut_data_generator.py:6-193`,
`visualization/autogates_func.py:6-84`). Here they are first-class: every
unit/integration test runs against these instead of the proprietary dataset.

A synthetic PAUT *volume* is ``beams x scans x samples`` float32. Each A-scan
has a front-wall echo, an exponentially decaying backscatter tail, optional
defect echoes (localized wave packets), and speckle noise. Defects span a
rectangle of (beam, scan) cells and a normalized depth range — exactly the
structure the reference's filename/key grammar encodes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from pautdx_torch.data.grammar import HEALTH_LABEL, make_scan_key


@dataclasses.dataclass
class SyntheticDefect:
    beam_start: int
    beam_end: int      # inclusive
    scan_start: int
    scan_end: int      # inclusive
    depth_start: float  # normalized [0, 1]
    depth_end: float
    label: str = "Delamination"
    amplitude: float = 0.9


# the accuracy harness's class ids of the synthetic defect labels
CLASS_MAP = {"Delamination": 0, "FO": 1}


@dataclasses.dataclass
class VolumeSpec:
    n_beams: int = 8
    n_scans: int = 120
    n_samples: int = 320
    noise: float = 0.03
    frontwall_pos: float = 0.06     # normalized depth of front-wall echo
    backwall_pos: float = 0.92
    seed: int = 0
    # per-(beam, scan) defect-echo fade: amplitude is scaled by
    # ``1 - flicker * u`` with u ~ U[0, 1] drawn per cell. At flicker>0
    # some frames carry a near-invisible echo while neighbors stay
    # strong — the regime the reference's temporal D-FINE targets
    # (50-frame fusion, `D-Fine/temporal_dfine.py:121-237`)
    amplitude_flicker: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.amplitude_flicker <= 1.0:
            # >1 would flip the echo's SIGN at full energy (a
            # phase-inverted packet), not fade it — a difficulty sweep
            # past 1.0 silently stops being a fade sweep
            raise ValueError(
                f"amplitude_flicker must be in [0, 1], got "
                f"{self.amplitude_flicker}")


def _wave_packet(n_samples: int, center: float, width: float,
                 amplitude: float, freq: float = 28.0) -> np.ndarray:
    """A gaussian-windowed sinusoid — the canonical ultrasonic echo shape."""
    t = np.linspace(0.0, 1.0, n_samples, dtype=np.float32)
    envelope = np.exp(-0.5 * ((t - center) / max(width, 1e-4)) ** 2)
    return (amplitude * envelope * np.sin(2 * np.pi * freq * (t - center))).astype(
        np.float32
    )


def synth_ascan(spec: VolumeSpec, rng: np.random.Generator,
                defect: Optional[Tuple[float, float]] = None,
                amplitude: float = 0.9) -> np.ndarray:
    """One synthetic A-scan; defect is a normalized (start, end) depth range."""
    n = spec.n_samples
    sig = _wave_packet(n, spec.frontwall_pos, 0.015, 1.0)
    sig += _wave_packet(n, spec.backwall_pos, 0.02, 0.55)
    # decaying backscatter
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)
    sig += 0.05 * np.exp(-3.0 * t) * rng.standard_normal(n).astype(np.float32)
    if defect is not None:
        d0, d1 = defect
        center = 0.5 * (d0 + d1)
        width = max(0.25 * (d1 - d0), 0.008)
        sig += _wave_packet(n, center, width, amplitude)
        # defects shadow the backwall
        sig -= _wave_packet(n, spec.backwall_pos, 0.02, 0.3 * amplitude)
    sig += spec.noise * rng.standard_normal(n).astype(np.float32)
    return sig.astype(np.float32)


def random_defects(spec: VolumeSpec, rng: np.random.Generator,
                   n_defects: int = 3) -> List[SyntheticDefect]:
    defects = []
    for _ in range(n_defects):
        b0 = int(rng.integers(0, spec.n_beams))
        b1 = min(spec.n_beams - 1, b0 + int(rng.integers(0, 3)))
        s0 = int(rng.integers(0, max(1, spec.n_scans - 12)))
        s1 = min(spec.n_scans - 1, s0 + int(rng.integers(4, 15)))
        d0 = float(rng.uniform(0.18, 0.7))
        d1 = min(0.88, d0 + float(rng.uniform(0.04, 0.16)))
        defects.append(
            SyntheticDefect(b0, b1, s0, s1, d0, d1,
                            amplitude=float(rng.uniform(0.5, 1.1)))
        )
    return defects


def generate_volume(spec: VolumeSpec,
                    defects: Optional[List[SyntheticDefect]] = None
                    ) -> Tuple[np.ndarray, List[SyntheticDefect]]:
    """Full ``(beams, scans, samples)`` volume + its ground-truth defects."""
    rng = np.random.default_rng(spec.seed)
    if defects is None:
        defects = random_defects(spec, rng)
    vol = np.zeros((spec.n_beams, spec.n_scans, spec.n_samples), np.float32)
    for b in range(spec.n_beams):
        for s in range(spec.n_scans):
            hit = None
            amp = 0.9
            for d in defects:
                if d.beam_start <= b <= d.beam_end and d.scan_start <= s <= d.scan_end:
                    hit = (d.depth_start, d.depth_end)
                    amp = d.amplitude
                    if spec.amplitude_flicker > 0.0:
                        amp *= 1.0 - spec.amplitude_flicker * float(
                            rng.uniform())
                    break
            vol[b, s] = synth_ascan(spec, rng, hit, amp)
    return vol, defects


def volume_to_json_dict(vol: np.ndarray, defects: List[SyntheticDefect],
                        beam_prefix: str = "beam") -> Dict[str, Dict[str, list]]:
    """Encode a volume in the reference's JSON-volume schema.

    ``{beam_key: {scan_key: [samples...]}}`` with the scan-key grammar
    ``<idx>_<label>[_<s>-<e>]`` (`json_dataset.py:44-79`).
    """
    n_beams, n_scans, _ = vol.shape
    out: Dict[str, Dict[str, list]] = {}
    for b in range(n_beams):
        beam_key = f"{beam_prefix}_{float(b):.1f}"
        scans: Dict[str, list] = {}
        for s in range(n_scans):
            label, rng_ = HEALTH_LABEL, None
            for d in defects:
                if d.beam_start <= b <= d.beam_end and d.scan_start <= s <= d.scan_end:
                    label, rng_ = d.label, (d.depth_start, d.depth_end)
                    break
            scans[make_scan_key(s, label, rng_)] = vol[b, s].tolist()
        out[beam_key] = scans
    return out


def write_json_volume(path: str, spec: Optional[VolumeSpec] = None,
                      defects: Optional[List[SyntheticDefect]] = None
                      ) -> List[SyntheticDefect]:
    spec = spec or VolumeSpec()
    vol, defects = generate_volume(spec, defects)
    with open(path, "w") as f:
        json.dump(volume_to_json_dict(vol, defects), f)
    return defects


def write_txt_tree(root: str, spec: Optional[VolumeSpec] = None,
                   defects: Optional[List[SyntheticDefect]] = None,
                   file_folder: str = "file0") -> List[SyntheticDefect]:
    """Materialize a volume as the reference's txt tree
    ``root/<file_folder>/<i>_<angle>/<scan>_<label>[_<s>-<e>].txt``
    (`DS_preprocessing.py` header comment / :53-97`).
    """
    spec = spec or VolumeSpec()
    vol, defects = generate_volume(spec, defects)
    base = os.path.join(root, file_folder)
    for b in range(spec.n_beams):
        beam_dir = os.path.join(base, f"{b}_{float(b):.1f}")
        os.makedirs(beam_dir, exist_ok=True)
        for s in range(spec.n_scans):
            label, rng_ = HEALTH_LABEL, None
            for d in defects:
                if d.beam_start <= b <= d.beam_end and d.scan_start <= s <= d.scan_end:
                    label, rng_ = d.label, (d.depth_start, d.depth_end)
                    break
            if rng_ is None:
                name = f"{s}_{HEALTH_LABEL}.txt"
            else:
                name = f"{s}_{label}_{rng_[0]:.4f}-{rng_[1]:.4f}.txt"
            np.savetxt(os.path.join(beam_dir, name), vol[b, s])
    return defects


def synth_dscan(n_scans: int = 200, n_samples: int = 320, n_bands: int = 2,
                n_defects: int = 3, seed: int = 0) -> Tuple[np.ndarray, list]:
    """Parametric D-scan image (scans x samples) with horizontal bands,
    defect blobs, and speckle — analogue of `autogates_func.py:6-84`.

    Returns (image, defect interval list in sample units).
    """
    rng = np.random.default_rng(seed)
    img = np.zeros((n_scans, n_samples), np.float32)
    t = np.linspace(0.0, 1.0, n_samples, dtype=np.float32)
    for i in range(n_bands):
        pos = 0.12 + 0.75 * i / max(1, n_bands - 1)
        img += np.exp(-0.5 * ((t - pos) / 0.02) ** 2)[None, :] * (1.0 - 0.3 * i)
    intervals = []
    for _ in range(n_defects):
        s0 = int(rng.integers(0, n_scans - 20))
        s1 = s0 + int(rng.integers(8, 20))
        c = float(rng.uniform(0.25, 0.7))
        w = float(rng.uniform(0.015, 0.04))
        blob = np.exp(-0.5 * ((t - c) / w) ** 2)[None, :]
        img[s0:s1] += 0.8 * blob
        intervals.append((s0, s1, int((c - 2 * w) * n_samples), int((c + 2 * w) * n_samples)))
    img += 0.05 * rng.standard_normal(img.shape).astype(np.float32)
    return img, intervals
