"""Raw PAUT volume parsers: txt trees and JSON volumes -> numpy arrays.

The port's own copy of ``pautdx/data/volume.py``. With ``use_native=True``
(the default, as the reference's) a path goes through the C++ reader
(``pautdx_torch.native``), which gives the numpy path's arrays; where no
C++ compiler exists the numpy path runs, and a failed build raises.

Both parsers produce a :class:`ParsedVolume`:
- ``signals``: dict ``beam_key -> (n_scans, n_samples) float32`` (scan-sorted)
- ``scan_infos``: dict ``beam_key -> [ScanInfo...]`` aligned with rows
- plus beam ordering/angle metadata for B-scan rendering.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

import numpy as np

from pautdx_torch import native
from pautdx_torch.data import grammar
from pautdx_torch.data.grammar import ScanInfo


@dataclasses.dataclass
class ParsedVolume:
    """A PAUT volume with per-beam signals and per-scan labels."""

    beam_keys: List[str]                       # sorted by angle / order found
    beam_angles: List[float]
    signals: Dict[str, np.ndarray]             # beam_key -> (n_scans, n_samples)
    scan_infos: Dict[str, List[ScanInfo]]      # beam_key -> per-scan metadata

    @property
    def n_beams(self) -> int:
        return len(self.beam_keys)

    def beam_array(self) -> np.ndarray:
        """Stack beams -> (beams, scans, samples); requires rectangular volume."""
        return np.stack([self.signals[k] for k in self.beam_keys])

    def scan_image(self, scan_idx: int) -> np.ndarray:
        """B-scan image for one scan position: (beams, samples)."""
        return np.stack([self.signals[k][scan_idx] for k in self.beam_keys])


def parse_json_volume(path_or_dict, use_native: bool = True
                      ) -> ParsedVolume:
    """Parse the reference JSON-volume schema ``{beam: {scan_key: signal}}``
    from a path or an already-loaded dict.

    Scan values may be raw lists or ``{"signal": [...]}`` dicts. Scan keys
    are sorted by integer index; ragged beams are right-padded with zeros
    to the beam's longest scan. A path goes through the C++ one-pass
    scanner (``native.parse_json_volume_fast``) when ``use_native`` and a
    compiler exists; a dict, and ``use_native=False``, through json and
    numpy.
    """
    if isinstance(path_or_dict, (str, os.PathLike)):
        if use_native and _native_ok():
            return native.parse_json_volume_fast(os.fspath(path_or_dict))
        with open(path_or_dict) as f:
            data = json.load(f)
    else:
        data = path_or_dict

    beam_keys = list(data.keys())
    try:
        beam_keys = grammar.sort_beams(beam_keys)
        angles = [grammar.beam_angle(k) for k in beam_keys]
    except (IndexError, ValueError):
        angles = list(range(len(beam_keys)))

    signals: Dict[str, np.ndarray] = {}
    infos: Dict[str, List[ScanInfo]] = {}
    for bk in beam_keys:
        beam = data[bk]
        keys = grammar.sort_scan_keys(list(beam.keys()))
        rows, row_infos = [], []
        for sk in keys:
            v = beam[sk]
            if isinstance(v, dict) and "signal" in v:
                v = v["signal"]
            rows.append(np.asarray(v, dtype=np.float32))
            row_infos.append(grammar.parse_scan_key(sk))
        if rows:
            max_len = max(r.shape[0] for r in rows)
            rows = [
                r if r.shape[0] == max_len
                else np.pad(r, (0, max_len - r.shape[0]))
                for r in rows
            ]
            signals[bk] = np.stack(rows)
        else:
            signals[bk] = np.zeros((0, 0), np.float32)
        infos[bk] = row_infos
    return ParsedVolume(beam_keys, [float(a) for a in angles], signals, infos)


def _native_ok() -> bool:
    """The C++ reader builds here; without a compiler, False. A compiler
    whose build fails raises with its output: no silent numpy path."""
    if native.compiler() is None:
        return False
    native.load()
    return True


def _scan_index(filename: str):
    """Integer scan-index prefix of ``<int>_<label>.txt``, else None."""
    try:
        return int(filename.split("_")[0])
    except ValueError:
        return None


def parse_txt_tree(root: str, file_folder: str,
                   use_native: bool = True) -> ParsedVolume:
    """Parse ``root/<file_folder>/<beam>_<angle>/<scan>_<label>[_s-e].txt``:
    beams sorted by float angle, one float column per txt file, labels from
    the filename grammar. Only ``.txt`` files with an integer scan-index
    prefix are read; a beam folder whose every ``.txt`` misses that grammar
    raises. With ``use_native`` and a compiler, the files are read and
    parsed by the C++ reader's thread pool
    (``native.parse_ascan_tree_fast``), else one ``np.loadtxt`` each."""
    base = os.path.join(root, file_folder)
    beams = grammar.sort_beams(os.listdir(base))
    angles = [grammar.beam_angle(b) for b in beams]
    tree = (native.parse_ascan_tree_fast(base)
            if use_native and _native_ok() else {})

    signals: Dict[str, np.ndarray] = {}
    infos: Dict[str, List[ScanInfo]] = {}
    for beam in beams:
        beam_dir = os.path.join(base, beam)
        listing = os.listdir(beam_dir)
        indexed = sorted(
            (idx, f) for f in listing
            if f.endswith(".txt") and (idx := _scan_index(f)) is not None)
        files = [f for _, f in indexed]
        if not files and any(f.endswith(".txt") for f in listing):
            raise ValueError(
                f"no scan files in {beam_dir} match the "
                f"'<int>_<label>.txt' grammar (example present: "
                f"{next(f for f in listing if f.endswith('.txt'))!r})")
        rows = [tree[f"{beam}/{fn}"] if f"{beam}/{fn}" in tree
                else np.loadtxt(os.path.join(beam_dir, fn), dtype=np.float32)
                for fn in files]
        signals[beam] = np.stack(rows) if rows else np.zeros((0, 0),
                                                             np.float32)
        infos[beam] = [grammar.parse_scan_filename(fn) for fn in files]
    return ParsedVolume(beams, angles, signals, infos)


def volume_defect_boxes(vol: ParsedVolume) -> Dict[str, list]:
    """Per-scan defect bboxes in (beam, depth) space with adjacent-beam merge.

    Walking beams in angle order, a defect on the next beam with identical
    depth range extends the previous bbox's beam end. bbox =
    [beam_idx_start, beam_idx_end, depth_start, depth_end] with beam indices
    as *positions in the sorted beam list* and depths normalized [0, 1].
    Key: ``"<scanKey>.png"``.
    """
    n_scans = max((len(v) for v in vol.scan_infos.values()), default=0)
    ann: Dict[str, list] = {}
    for s in range(n_scans):
        key = f"{s}.png"
        ann[key] = []
        for b_idx, bk in enumerate(vol.beam_keys):
            infos = vol.scan_infos[bk]
            if s >= len(infos) or not infos[s].is_defect:
                continue
            d0, d1 = infos[s].position
            prev = ann[key][-1] if ann[key] else None
            if (prev is not None and prev["bbox"][2] == d0
                    and prev["bbox"][3] == d1 and prev["bbox"][1] == b_idx - 1):
                prev["bbox"][1] = b_idx
            else:
                ann[key].append(
                    {"bbox": [b_idx, b_idx, d0, d1], "label": infos[s].label}
                )
    return ann
