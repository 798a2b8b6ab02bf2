"""The readers of the port's spans (``core/spans.py`` and the six metric
files that name it) on a synthetic record and span buffer: each reads what
the timeline holds, nothing where the program has no tracer or the session
no span, and the launch-idle share stays inside the idle share."""

import pytest

from portbench.core import readers, spans, spec
from portbench.core.trace import Record

profiling = pytest.importorskip("pautdx_torch.utils.profiling")

STAMP = 1_792_000_000_000_000_000       # the anchor's stamp, ns
ANCHOR = "at::cuda::(anonymous namespace)::spin_kernel(long)"
BATCHES = 4
PERIOD = 1000                            # µs a batch on the device axis
DFINE = "dfine-nano.volume-b128"
YOLO = "yolov8n-seg.volume-b32"


def timeline(family: str):
    """Four batches: the port's spans (µs on the device axis, the anchor's
    kernel at 0) and the device's kernels and copies."""
    tops, kids, device = [], [], [(ANCHOR, 0.0, 2.0)]
    for k in range(BATCHES):
        b = 100 + PERIOD * k
        device += [("copy", b + 20, b + 200), ("gemm", b + 260, b + 680),
                   ("masks_kernel", b + 690, b + 900)]
        if family == "dfine":
            tops += [("dfine.prepatchify", b, b + 50, []),
                     ("dfine.forward", b + 50, b + 700,
                      [("dfine.backbone", b + 60, b + 300),
                       ("dfine.encoder", b + 300, b + 400),
                       ("dfine.select", b + 400, b + 450),
                       ("dfine.decoder", b + 450, b + 690)]),
                     ("dfine.post_process", b + 700, b + 750, [])]
        else:
            tops += [("yolo.predict", b, b + 900,
                      [("yolo.forward", b + 10, b + 600),
                       ("yolo.decode", b + 600, b + 650),
                       ("yolo.nms", b + 650, b + 800),
                       ("yolo.masks", b + 800, b + 890)])]
    return tops, device


def tracer_of(tops) -> "profiling.Tracer":
    t = profiling.Tracer()
    i = 0
    for name, s, e, children in tops:
        top = i
        for cname, cs, ce in children:
            i += 1
            t.records.append(profiling.SpanRecord(
                i, cname, top, top, STAMP + int(cs * 1e3),
                STAMP + int(ce * 1e3), None))
        t.records.append(profiling.SpanRecord(
            top, name, None, top, STAMP + int(s * 1e3), STAMP + int(e * 1e3),
            {}))
        i += 1
    t.anchors = [STAMP]
    return t


def record(device, call_ms: float) -> Record:
    return Record(window_s=(BATCHES * PERIOD + 300) / 1e6, device=device,
                  host_spans={"serve.call": [call_ms / 1e3] * BATCHES},
                  batches=BATCHES, frames=BATCHES * 8, config={},
                  workload={}, traffic={})


def brute_idle_inside_us(device, tops) -> int:
    """The idle µs inside the top-level spans, counted on a 1 µs grid."""
    lo = min(s for _, s, _ in device)
    hi = max(e for _, _, e in device)
    n = 0
    for t in range(int(lo), int(hi)):
        c = t + 0.5
        busy = any(s <= c < e for _, s, e in device)
        inside = any(s <= c < e for _, s, e, _ in tops)
        n += (not busy) and inside
    return n


@pytest.fixture
def program(monkeypatch):
    def install(family: str):
        tops, device = timeline(family)
        t = tracer_of(tops)
        monkeypatch.setattr(spans, "tracer", lambda: t)
        return tops, device
    return install


CASES = [
    ("forward_host_ms.dfine", "dfine", 0.65),
    ("postprocess_host_ms.dfine", "dfine", 0.05),
    ("forward_host_ms.serve", "yolo", 0.59),
    ("postprocess_host_ms.serve", "yolo", 0.05 + 0.15 + 0.09),
]


@pytest.mark.parametrize("name,family,want", CASES,
                         ids=[c[0] for c in CASES])
def test_host_ms_readers(program, name, family, want):
    _, device = program(family)
    got = spec.metric_reader(name).read(record(device, 0.95))
    assert got == pytest.approx(want, abs=1e-9)


@pytest.mark.parametrize("name,family", [
    ("launch_idle_share.dfine", "dfine"),
    ("launch_idle_share.serve", "yolo")])
def test_launch_idle_share_readers(program, name, family):
    tops, device = program(family)
    rec = record(device, 0.95)
    got = spec.metric_reader(name).read(rec)
    want = 100.0 * brute_idle_inside_us(device, tops) / 1e6 / rec.window_s
    assert got == pytest.approx(want, abs=1e-6)
    assert 0 < got <= readers.idle_share(rec)


def test_the_host_readers_fit_inside_the_harness_call(program):
    for family, fwd, post, host in (
            ("dfine", "forward_host_ms.dfine", "postprocess_host_ms.dfine",
             "host_ms.dfine"),
            ("yolo", "forward_host_ms.serve", "postprocess_host_ms.serve",
             "host_ms.serve")):
        _, device = program(family)
        rec = record(device, 0.95)
        total = sum(spec.metric_reader(n).read(rec) for n in (fwd, post))
        assert total <= spec.metric_reader(host).read(rec)


def test_spans_misaligned_past_the_trace_stay_inside_the_idle_share(
        program):
    """Spans put 5 ms late (a wrong anchor) reach past the last device
    event; the share still counts only gaps inside the device's span."""
    tops, device = program("dfine")
    t = spans.tracer()
    t.anchors = [STAMP - 5_000_000]
    rec = record(device, 0.95)
    got = spec.metric_reader("launch_idle_share.dfine").read(rec)
    assert 0 <= got <= readers.idle_share(rec)


NAMES = ["forward_host_ms.dfine", "postprocess_host_ms.dfine",
         "launch_idle_share.dfine", "forward_host_ms.serve",
         "postprocess_host_ms.serve", "launch_idle_share.serve"]


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_without_a_tracer(monkeypatch, name):
    _, device = timeline("dfine")
    monkeypatch.delattr(profiling, "TRACER")
    assert spans.tracer() is None
    assert spec.metric_reader(name).read(record(device, 0.95)) is None


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_without_spans(monkeypatch, name):
    _, device = timeline("yolo")
    empty = profiling.Tracer()
    monkeypatch.setattr(spans, "tracer", lambda: empty)
    assert spec.metric_reader(name).read(record(device, 0.95)) is None


def test_launch_idle_share_needs_an_anchor_in_the_trace(program):
    _, device = program("yolo")
    rec = record([d for d in device if d[0] != ANCHOR], 0.95)
    assert spec.metric_reader("launch_idle_share.serve").read(rec) is None
    assert spec.metric_reader("forward_host_ms.serve").read(rec) \
        == pytest.approx(0.59)
