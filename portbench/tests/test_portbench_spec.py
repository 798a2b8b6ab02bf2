"""BENCHMARK.json and the files it names: the contract's shapes, every
file loads, and a cell added as new files is found by name."""

import json
import re
import shutil

import pytest

from portbench.core import spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") \
            and ".." not in word
    assert isinstance(BENCH["run_seconds"], int) \
        and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_and_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and LINE.match(entry["source"])
    assert LINE.match(entry["why"]) and entry["reduced"] == []
    assert entry["file"].startswith("portbench/")
    cfg = spec.load_json(spec.CHECKOUT / entry["file"])
    assert cfg["name"] == entry["name"]
    assert cfg["flops"]["per_frame"] > 0 and cfg["assumed"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entry_and_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert NAME.match(w[k])
    assert w["chips"] == 1 and LINE.match(w["why"])
    c = spec.cell(w["name"], BENCH)
    assert c.workload["entry"] and set(c.workload["check"]["limits"])
    assert (ROOT / "entries" / f"{c.workload['entry']}.py").is_file()
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names


def test_names_unique_and_metrics_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["bound"] for m in BENCH["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_its_reader(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert LINE.match(m["layer"])
    reader = spec.metric_reader(m["name"])
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == \
        (m["layer"], m["unit"], m["moves"])
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


@pytest.mark.parametrize("path", sorted((ROOT / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_traffic_files_load(path):
    from portbench.traffic import generator
    t = generator.load(path.stem)
    assert NAME.match(path.stem) and t["kind"] in generator.KINDS


def test_a_cell_added_as_new_files_is_found_by_name(tmp_path):
    """A later change adds a traffic mix, a workload and a per-layer
    metric as new files plus new entries, and edits no file."""
    root = tmp_path / "portbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads(json.dumps(spec.benchmark()))
    (root / "traffic" / "volume-b8.json").write_text(json.dumps(
        {**spec.load_json(ROOT / "traffic" / "volume-b32.json"),
         "batch": 8}))
    (root / "workloads" / "yolov8n-seg.volume-b8.json").write_text(
        json.dumps(spec.load_json(
            ROOT / "workloads" / "yolov8n-seg.volume-b32.json")))
    (root / "metrics" / "launches.serve.py").write_text(
        'LAYER = "device"\nUNIT = "launches"\nMOVES = "frames_per_s"\n\n\n'
        'def read(rec):\n    return len(rec.device) / rec.batches or None\n')
    bench["workloads"].append({"name": "yolov8n-seg.volume-b8",
                               "config": "yolov8n-seg",
                               "traffic": "volume-b8", "chips": 1,
                               "why": "small batches"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "yolov8n-seg.volume-b32" in m["workloads"]:
            m["workloads"].append("yolov8n-seg.volume-b8")
    bench["per_layer"].append({"name": "launches.serve", "unit": "launches",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "frames_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("yolov8n-seg.volume-b8", spec.benchmark(tmp_path), root)
    assert c.traffic["batch"] == 8
    assert "launches.serve" in {m["name"] for m in c.per_layer}
    assert spec.metric_reader("launches.serve", root).UNIT == "launches"
    # the cells already there are unchanged
    assert spec.cell("yolov8n-seg.volume-b32", spec.benchmark(tmp_path),
                     root).traffic["batch"] == 32


def test_names_are_checked():
    with pytest.raises(ValueError):
        spec.check_name("a b", "workload")
    with pytest.raises(KeyError):
        spec.cell("no-such-cell", BENCH)
