"""Dataset collection summarizer.

The port's own copy of ``pautdx/data/summary.py`` over its own volume
parsers; an entry read as a volume without beams is reported as an error,
where the reference's summary raises. Equivalent of `D-Fine/ds_manipulations/DS_collection_fix.py:17-54`: walk a
collection of raw datasets, extract the depth-limit convention from file
names (``_D<min>-<max>`` suffix) and the scan index ranges actually
present, and write a ``compiled_summary`` JSON for bookkeeping.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

_DEPTH_RE = re.compile(r"_D(\d+(?:\.\d+)?)-(\d+(?:\.\d+)?)")


def depth_limits_from_name(name: str) -> Optional[Tuple[float, float]]:
    m = _DEPTH_RE.search(name)
    if not m:
        return None
    return float(m.group(1)), float(m.group(2))


def summarize_collection(data_dir: str,
                         out_path: Optional[str] = None) -> Dict:
    """Per dataset entry: depth limits (from the name) + scan index range
    + beam/scan counts. Handles both JSON volumes and txt trees."""
    from pautdx_torch.data.volume import parse_json_volume, parse_txt_tree

    summary: Dict[str, Dict] = {}
    for entry in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, entry)
        try:
            if entry.endswith(".json"):
                vol = parse_json_volume(path)
                name = entry[:-5]
            elif os.path.isdir(path):
                vol = parse_txt_tree(data_dir, entry)
                name = entry
            else:
                continue
        except Exception as e:
            summary[entry] = {"error": str(e)}
            continue
        if not vol.scan_infos:
            # "{}", or a malformed file as the C++ reader reads it: the
            # reference's summary fails on a volume without beams
            summary[entry] = {"error": f"no beams in {entry}"}
            continue
        scan_indices = []
        n_defects = 0
        for infos in vol.scan_infos.values():
            for i, info in enumerate(infos):
                scan_indices.append(int(info.scan_key)
                                    if info.scan_key.isdigit() else i)
                n_defects += int(info.is_defect)
        summary[name] = {
            "depth_limits": depth_limits_from_name(name),
            "n_beams": vol.n_beams,
            "n_scans": max(len(v) for v in vol.scan_infos.values()),
            "scan_index_range": [min(scan_indices), max(scan_indices)]
            if scan_indices else None,
            "n_defect_scans": n_defects,
        }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=1)
    return summary
