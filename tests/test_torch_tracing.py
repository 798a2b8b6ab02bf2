"""The port's tracer (``pautdx_torch.utils.profiling``): spans off without a
profiler session, the span tree of the two served paths under one, the
session's buffer, and the anchor's offset onto a device trace's axis.

CPU only, tiny shapes; the card tests of the clock are in
``tests/test_torch_kernels.py``.
"""

import os
import re
from collections import deque

import pytest
import torch

from pautdx_torch.losses import detr
from pautdx_torch.models.vision import dfine
from pautdx_torch.ops import attention
from pautdx_torch.serve import device_profile, throughput, yolo_predict
from pautdx_torch.utils import profiling
from pautdx_torch.utils.profiling import TRACER, Tracer, span
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DFINE_SPANS = {"dfine.prepatchify": None, "dfine.forward": None,
               "dfine.backbone": "dfine.forward",
               "dfine.encoder": "dfine.forward",
               "dfine.select": "dfine.forward",
               "dfine.decoder": "dfine.forward",
               "dfine.post_process": None}
YOLO_SPANS = {"yolo.predict": None, "yolo.forward": "yolo.predict",
              "yolo.decode": "yolo.predict", "yolo.nms": "yolo.predict",
              "yolo.masks": "yolo.predict"}


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def served():
    """One tiny D-FINE serving call (the port's serving preset on 64 px
    uint8 frames: prepatchify, forward, post-process) and one tiny YOLO
    predict (128 px, enough anchors for its 300 candidates)."""
    sm = throughput.build_serving_model(device="cpu", batch=1)
    pred = yolo_predict.build_yolo_predictor(device="cpu", seed=5)
    gen = torch.Generator().manual_seed(0)
    small = torch.randint(0, 256, (1, 64, 64, 3), generator=gen,
                          dtype=torch.uint8)
    large = torch.randint(0, 256, (1, 128, 128, 3), generator=gen,
                          dtype=torch.uint8)

    def dfine_call():
        with torch.inference_mode():
            out = sm.model(throughput.prepatchify_uint8(
                small, sm.cfg.backbone.stem_patch))
            return dfine.post_process(out["logits"], out["pred_boxes"],
                                      (64, 64))

    return dfine_call, lambda: pred(large)


@pytest.fixture(scope="module")
def session(served):
    """Both calls under one CPU profiler session: the tracer's spans and
    the profiler's events."""
    dfine_call, yolo_call = served
    dfine_call()
    yolo_call()
    TRACER.reset()
    with cpu_profile() as prof:
        dfine_call()
        yolo_call()
    return TRACER.spans(), prof.events()


# ------------------------------------------------------------------ off


def test_off_path_records_opens_and_launches_nothing(served, monkeypatch):
    opened, launched = [], []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    monkeypatch.setattr(torch.cuda, "_sleep", launched.append)
    before = list(TRACER.records)
    for call in served:
        call()
    with span("test.off"):
        pass
    assert TRACER.begin("test.off") is None
    TRACER.end(None)
    assert list(TRACER.records) == before
    assert opened == [] and launched == []
    assert span("a") is span("b")


# ------------------------------------------------------------------- on


@pytest.mark.parametrize("path", ["dfine", "yolo"])
def test_span_tree_of_the_served_paths(session, path):
    """The span names and parents of each path, one call id a top-level
    call shared by its children."""
    recs, _ = session
    want = DFINE_SPANS if path == "dfine" else YOLO_SPANS
    got = [r for r in recs if r.name in want]
    assert sorted(r.name for r in got) == sorted(want)
    by_id = {r.id: r for r in recs}
    for r in got:
        parent = by_id[r.parent].name if r.parent is not None else None
        assert parent == want[r.name], r.name
        top = r if r.parent is None else by_id[r.parent]
        assert r.call == top.id
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            assert top.start_ns <= r.start_ns and r.end_ns <= top.end_ns
    tops = [r for r in got if r.parent is None]
    assert len({r.call for r in tops}) == len(tops)


def test_self_time_is_duration_less_children(session):
    recs, _ = session
    summary = TRACER.summary()["spans"]
    for parent in ("dfine.forward", "yolo.predict"):
        (p,) = [r for r in recs if r.name == parent]
        kids = sum(r.end_ns - r.start_ns for r in recs if r.parent == p.id)
        s = summary[parent]
        assert s["calls"] == 1
        assert s["total_ms"] == pytest.approx((p.end_ns - p.start_ns) / 1e6)
        assert s["self_ms"] == pytest.approx(
            (p.end_ns - p.start_ns - kids) / 1e6)
        assert 0 <= s["self_ms"] < s["total_ms"]
    assert summary["dfine.backbone"]["self_ms"] == pytest.approx(
        summary["dfine.backbone"]["total_ms"])


def test_spans_are_profiler_annotations_in_order(session):
    recs, events = session
    names = set(DFINE_SPANS) | set(YOLO_SPANS)
    seen = [e.name for e in sorted(events, key=lambda e: e.time_range.start)
            if e.name in names]
    opened = [r.name for r in sorted(recs, key=lambda r: r.start_ns)
              if r.name in names]
    assert seen == opened
    assert seen[:2] == ["dfine.prepatchify", "dfine.forward"]


@pytest.mark.parametrize("between", ["read", "off span", "reset"])
def test_a_new_session_starts_with_an_empty_buffer(between):
    with cpu_profile():
        with span("test.first"):
            pass
    if between == "read":
        assert [r.name for r in TRACER.spans()] == ["test.first"]
    elif between == "off span":
        with span("test.off"):
            pass
    else:
        TRACER.reset()
    with cpu_profile():
        with span("test.second"):
            pass
        with span("test.second"):
            pass
    assert [r.name for r in TRACER.spans()] == ["test.second"] * 2
    assert [r.id for r in TRACER.spans()] == [0, 1]


def test_begin_end_pairs_from_forward_hooks():
    """``device_profile.module_spans`` opens a span a part through the
    tracer's begin/end pair: nested calls nest."""
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU(),
                                torch.nn.Linear(4, 2))
    parts = {"test.all": ("",), "test.first": ("0",), "test.last": ("2",)}
    TRACER.reset()
    with device_profile.module_spans(model, parts), cpu_profile():
        model(torch.ones(1, 4))
    recs = {r.name: r for r in TRACER.spans()}
    assert set(recs) == set(parts)
    assert recs["test.first"].parent == recs["test.all"].id
    assert recs["test.last"].parent == recs["test.all"].id
    assert recs["test.all"].parent is None


def test_hungarian_solve_is_a_span():
    cost = torch.rand(2, 5, 3, generator=torch.Generator().manual_seed(1))
    TRACER.reset()
    with cpu_profile() as prof:
        detr.hungarian_match(cost)
    assert [r.name for r in TRACER.spans()] == [detr.SOLVE_SPAN]
    assert detr.SOLVE_SPAN in {e.name for e in prof.events()}


def test_summary_counts_launches_a_top_level_call(monkeypatch):
    monkeypatch.setattr(attention, "LAUNCHES", attention.LAUNCHES)
    TRACER.reset()
    with cpu_profile():
        for _ in range(2):
            with span("test.batch"):
                with span("test.inner"):
                    attention.LAUNCHES += 3
        with span("test.idle"):
            pass
    s = TRACER.summary()
    assert s["launches"] == {"test.batch": {"aifi_attention": 3.0},
                             "test.idle": {}}
    assert s["spans"]["test.batch"]["calls"] == 2
    assert profiling.launch_counts()["aifi_attention"] == attention.LAUNCHES


def test_the_buffer_is_bounded():
    t = Tracer()
    t.records = deque(maxlen=4)
    with cpu_profile():
        for i in range(10):
            with t.span(f"test.{i}"):
                pass
    assert [r.name for r in t.spans()] == [f"test.{i}" for i in range(6, 10)]


def test_no_anchor_without_cuda(monkeypatch):
    launched = []
    monkeypatch.setattr(torch.cuda, "_sleep", launched.append)
    TRACER.prepare("cpu")
    TRACER.reset()
    with cpu_profile():
        with span("test.cpu"):
            pass
    assert TRACER.anchors == [] and launched == []
    assert TRACER.device_axis([("spin_kernel(long)", 5.0, 6.0)]) is None


# --------------------------------------------------------------- anchor


ANCHOR_NAME = "at::cuda::(anonymous namespace)::spin_kernel(long)"
STAMP = 1_792_000_000_123_456_000


def test_offset_maps_a_span_onto_the_device_interval():
    """Two anchors stamped 1 s apart, their kernels found by name among the
    device events out of order: each offset is the kernel's start less the
    stamp, and a span 500 µs after the first stamp lands 500 µs after the
    first anchor's kernel on the device axis."""
    t = Tracer()
    t.anchors = [STAMP, STAMP + 1_000_000_000]
    device = [("gemm", 1600.0, 1700.0),
              (ANCHOR_NAME, 1_001_000.5, 1_001_002.0),
              (ANCHOR_NAME, 1000.5, 1002.0), ("copy", 10.0, 20.0)]
    assert t.device_offsets_us(device) == [1000.5, 1000.5]
    axis = t.device_axis(device)
    assert axis(STAMP + 500_000) == pytest.approx(1500.5)
    assert axis(STAMP + 800_000) == pytest.approx(1800.5)
    # an anchor whose kernel is missing from the trace is left out
    t.anchors.append(STAMP + 2_000_000_000)
    assert len(t.device_offsets_us(device)) == 2


@pytest.mark.parametrize("ppm", [(-300.0, -300.0), (-300.0, 300.0),
                                 (4000.0, 4000.0)],
                         ids=["steady", "turning", "fast"])
def test_device_axis_follows_drift_past_slow_anchors(ppm):
    """Anchors 50 ms apart on a clock that drifts against the device
    trace's (ppm before and after the window's middle), the first anchor
    and one in the middle launched 2 ms late: the axis follows the drift,
    between anchors too, and leaves the slow anchors out."""
    t = Tracer()
    device, start = [], 5000.0
    for k in range(40):
        t.anchors.append(STAMP + k * 50_000_000)
        late = 2000.0 if k in (0, 25) else 0.0
        device.append((ANCHOR_NAME, start + late, start + late + 2.0))
        start += 50_000 * (1 + 1e-6 * ppm[k >= 20])
    axis = t.device_axis(device)
    late = {0.0, 25 * 50_000.0}
    assert not late & set(axis.at_us) and len(axis.at_us) == 38
    for k in (1, 7, 19, 20, 24, 26, 33, 39):
        assert axis(STAMP + k * 50_000_000) == pytest.approx(
            device[k][1], abs=1e-3)
    mid = axis(STAMP + 75_000_000)
    assert mid == pytest.approx((device[1][1] + device[2][1]) / 2, abs=1e-3)


def test_anchor_kernel_is_launched_nowhere_else():
    """A reader finds the anchors by the kernel's name, so no other launch
    of the port may carry it."""
    pattern = re.compile(r"_sleep\(|" + profiling.ANCHOR_KERNEL)
    hits = []
    for base, _, files in os.walk(os.path.join(ROOT, "pautdx_torch")):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(base, f)
                with open(path) as fh:
                    if pattern.search(fh.read()):
                        hits.append(os.path.relpath(path, ROOT))
    assert hits == [os.path.join("pautdx_torch", "utils", "profiling.py")]


def test_one_span_mechanism():
    """No ``record_function`` range is opened outside the tracer."""
    hits = []
    for base, _, files in os.walk(os.path.join(ROOT, "pautdx_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                with open(path) as fh:
                    if "record_function(" in fh.read():
                        hits.append(os.path.relpath(path, ROOT))
    assert hits == [os.path.join("pautdx_torch", "utils", "profiling.py")]
