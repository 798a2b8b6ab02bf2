"""Filename / key grammar of raw PAUT datasets.

The port's own copy of ``pautdx/data/grammar.py``, with the same rules.

The reference encodes labels inside file and key names
(`BscanBased/DS_preprocessing.py:87-97`,
`signals/improved_multisignal/json_dataset.py:69-79`):

- A-scan txt file:   ``<scanKey>_<label>[_<start>-<end>].txt``
  where ``label == "Health"`` means no defect, anything else is a defect
  type with normalized depth range ``start-end`` in [0, 1].
- JSON volume scan key: ``<scanIdx>_<label>[_<start>-<end>]``.
- Beam directory / key: ``<prefix>_<angle>`` sorted by float angle.

This module is the single source of truth for that grammar.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

HEALTH_LABEL = "Health"


@dataclasses.dataclass(frozen=True)
class ScanInfo:
    """Parsed scan-file / scan-key metadata."""

    scan_key: str              # leading index token (kept as string)
    label: str                 # "Health" or defect type name
    defect_range: Optional[Tuple[float, float]]  # normalized [0,1], None if healthy

    @property
    def is_defect(self) -> bool:
        return self.label != HEALTH_LABEL

    @property
    def position(self) -> Tuple[float, float]:
        """Defect position with the reference's (0, 0) fallback for healthy scans."""
        if self.defect_range is None:
            return (0.0, 0.0)
        return self.defect_range


_RANGE_RE = re.compile(r"^(-?\d+(?:\.\d+)?)-(-?\d+(?:\.\d+)?)$")


def parse_scan_key(key: str) -> ScanInfo:
    """Parse a JSON scan key ``<idx>_<label>[_<start>-<end>]``.

    Mirrors `json_dataset.py:69-79`: token[1] == "Health" -> healthy;
    otherwise defect with range from token[2] (``(0, 0)`` if malformed).
    """
    parts = key.split("_")
    scan_key = parts[0]
    label = parts[1] if len(parts) > 1 else HEALTH_LABEL
    if label == HEALTH_LABEL:
        return ScanInfo(scan_key, HEALTH_LABEL, None)
    rng: Tuple[float, float] = (0.0, 0.0)
    if len(parts) > 2:
        m = _RANGE_RE.match(parts[2])
        if m:
            rng = (float(m.group(1)), float(m.group(2)))
    return ScanInfo(scan_key, label, rng)


def parse_scan_filename(filename: str) -> ScanInfo:
    """Parse an A-scan txt filename ``<scanKey>_<label>[_<start>-<end>].txt``.

    Mirrors `DS_preprocessing.py:87-97`: the defect range is taken from the
    *last* underscore-separated token (stripped of the ``.txt`` suffix).
    """
    stem = filename
    if stem.endswith(".txt"):
        stem = stem[:-4]
    parts = stem.split("_")
    scan_key = parts[0]
    label = parts[1] if len(parts) > 1 else HEALTH_LABEL
    if label == HEALTH_LABEL:
        return ScanInfo(scan_key, HEALTH_LABEL, None)
    rng: Tuple[float, float] = (0.0, 0.0)
    if len(parts) > 2:
        m = _RANGE_RE.match(parts[-1])
        if m:
            rng = (float(m.group(1)), float(m.group(2)))
    return ScanInfo(scan_key, label, rng)


def beam_angle(beam_name: str) -> float:
    """Beam sort key: the float after the first ``_`` (`DS_preprocessing.py:64`)."""
    return float(beam_name.split("_")[1])


def sort_beams(beam_names) -> list:
    return sorted(beam_names, key=beam_angle)


def sort_scan_keys(keys) -> list:
    """Sort scan keys by their integer leading index (`json_dataset.py:49`)."""
    return sorted(keys, key=lambda k: int(k.split("_")[0]))


def make_scan_key(idx: int, label: str,
                  rng: Optional[Tuple[float, float]] = None) -> str:
    """Inverse of :func:`parse_scan_key`, used by the synthetic generator."""
    if label == HEALTH_LABEL or rng is None:
        return f"{idx}_{HEALTH_LABEL}"
    return f"{idx}_{label}_{rng[0]:.4f}-{rng[1]:.4f}"
