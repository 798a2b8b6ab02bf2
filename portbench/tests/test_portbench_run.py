"""Whole runs of each cell at a small size on the CPU (the port's plain
versions, the harness's look for a card skipped), and on the card at the
cell's own size: the last line's schema, the import guard, the control
and each fault the cell can have coming out not correct."""

import json

import pytest
import torch

from portbench import run
from portbench.core import guard, spec
from portbench.tests import plant

# each cell cut to a size the CPU holds, merged over its traffic and
# workload files
SMALL = {
    "dfine-nano.volume-b128": {
        "traffic": {"size": [64, 64, 3], "ring_frames": 4, "batch": 2},
        "workload": {"check": {"batches": 1, "block": 2}}},
    "yolov8n-seg.volume-b32": {
        "traffic": {"size": [128, 128, 3], "ring_frames": 4, "batch": 2},
        "workload": {"check": {"batches": 2, "block": 2}}},
}
FAULTS = {
    "dfine-nano.volume-b128": ["serve_half_batch", "dfine_gather_altered",
                               "dfine_scores_altered"],
    "yolov8n-seg.volume-b32": ["serve_half_batch", "yolo_nms_altered",
                               "yolo_masks_altered"],
}
SEED = 3_000_000_017      # past 32 signed bits, as a benchmark's seeds may be


def merge(into: dict, over: dict) -> dict:
    """``over`` merged into ``into``, dict by dict."""
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            merge(into[k], v)
        else:
            into[k] = v
    return into


def small(cell: str) -> spec.Cell:
    c = spec.cell(cell)
    merge(c.traffic, SMALL[cell]["traffic"])
    merge(c.workload, SMALL[cell]["workload"])
    return c


def _run(capsys, cell, program="port", fault=None, device="cpu",
         seconds=0.5):
    """One run of ``cell``: on the CPU cut to its ``SMALL`` size, with the
    look for a card skipped; on the card at its own size."""
    c = small(cell) if device == "cpu" else spec.cell(cell)
    if fault:
        with plant.planted(fault):
            rc = run.run(c, SEED, seconds, 0, torch.device(device), program)
    else:
        rc = run.run(c, SEED, seconds, 0, torch.device(device), program)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct_and_its_line_keeps_the_schema(capsys, cell):
    rc, line, err = _run(capsys, cell)
    assert rc == 0
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["correct"] is True and line["attempted"] > 0
    assert line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # a CPU run names its platform and claims no card
    assert line["device"]["platform"] == "cpu"
    assert set(line["metrics"]) == {m["name"] for m in
                                    spec.cell(cell).end_to_end}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(capsys, cell):
    rc, line, _ = _run(capsys, cell, program="control")
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]])
def test_a_planted_fault_is_not_correct(capsys, cell, fault):
    rc, line, _ = _run(capsys, cell, fault=fault)
    assert rc == 0 and line["correct"] is False


def test_the_guard_compares_top_level_names_whole():
    assert guard.forbidden_modules(["pautdx_torch", "pautdx_torch.ops",
                                    "jaxtyping", "numpy"]) == []
    assert guard.forbidden_modules(["pautdx.ops", "jax", "flax.linen",
                                    "optax"]) == ["flax.linen", "jax",
                                                  "optax", "pautdx.ops"]


def test_the_command_takes_only_the_four_options():
    with pytest.raises(SystemExit):
        run.parse(["--workload", "x", "--seed", "1", "--seconds", "1",
                   "--device", "cpu"])


def test_without_a_card_a_run_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "yolov8n-seg.volume-b32", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    out, err = capsys.readouterr()
    assert out.strip() == "" and "no card" in err


def test_a_run_with_jax_loaded_prints_no_result(capsys, monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.run(small("yolov8n-seg.volume-b32"), 1, 0.2, 0,
                   torch.device("cpu")) != 0
    out, err = capsys.readouterr()
    assert out.strip() == "" and "jax" in err


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_on_the_card_sound_runs_are_correct_and_controls_not(
        capsys, card, cell):
    """At the cell's own size: one sound run, and the control."""
    rc, line, _ = _run(capsys, cell, device="cuda", seconds=2)
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    rc, line, _ = _run(capsys, cell, program="control", device="cuda",
                       seconds=1)
    assert rc == 0 and line["correct"] is False
