"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names the cells; each cell's
configuration, traffic mix, workload and per-layer metrics sit in files of
their own, found here by name, so that a later change adds a cell or a
metric with new files and new entries and edits none:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix's parameters, read by
  ``traffic/generator.py``;
- ``workloads/<cell>.json``: the entry adapter (``entries/<entry>.py``),
  the correctness sample and the limits of the comparison;
- ``metrics/<metric>.py``: one reader of the traced run's record a metric.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]          # portbench/
CHECKOUT = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r}: a name is 1-64 letters, digits, "
                         f"'_', '.' and '-', starting with a letter, digit "
                         f"or '_'")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Optional[Path] = None) -> dict:
    return load_json((root or CHECKOUT) / "BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """A Python file by path; metric files carry dots in their names."""
    name = "portbench_file_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    bench_entry: dict          # the cell's entry in BENCHMARK.json
    config: dict               # configs/<config>.json
    traffic: dict              # traffic/<traffic>.json
    workload: dict             # workloads/<cell>.json
    end_to_end: List[dict]     # the cell's end-to-end metrics
    per_layer: List[dict]      # the cell's per-layer metrics


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or
    without that key wherever the metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def cell(name: str, bench: Optional[dict] = None,
         root: Path = ROOT) -> Cell:
    bench = bench if bench is not None else benchmark(root.parent)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; known: {', '.join(entries)}")
    w = entries[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root.parent / cfg_entry["file"])
    traffic = load_json(root / "traffic" / f"{check_name(w['traffic'], 'traffic')}.json")
    workload = load_json(root / "workloads" / f"{check_name(name, 'workload')}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, w, config, traffic, workload, e2e, per_layer)


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "metrics" / f"{check_name(name, 'metric')}.py")


def entry_module(entry: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "entries" / f"{check_name(entry, 'entry')}.py")
