"""The operations and bytes the bounds count, on shapes whose numbers are
known, and the model FLOPs the configuration files record."""

import json

import pytest
import torch

from portbench.core import arith, peaks, spec
from portbench.core.trace import Record, busy_us, gaps


def test_attention_bound_at_the_serving_shape():
    """Kernel 1 at (128, 8, 400, 16) bf16: 52,428,800 bytes, 2.62 GFLOP and
    163.84 M exponentials; the exponentials bind, 0.0392 ms on 132 SMs (the
    bound PERF.md's kernel table gives)."""
    t = arith.attention_terms(128, 8, 400, 16, "bfloat16", 132)
    assert t["bytes"] == pytest.approx(4 * 128 * 400 * 128 * 2 / 3.35e12)
    assert t["operations"] == pytest.approx(
        4 * 128 * 8 * 400 ** 2 * 16 / 989e12)
    assert t["exp"] == pytest.approx(128 * 8 * 400 ** 2
                                     / (16 * 132 * 1.98e9))
    assert arith.bound_s(t) == t["exp"]
    assert 1e3 * arith.bound_s(t) == pytest.approx(0.0392, abs=5e-5)


def test_attention_f32_counts_the_faster_of_cuda_cores_and_3xtf32():
    t = arith.attention_terms(1, 1, 10, 4, "float32", 1)
    flops = 4 * 100 * 4
    assert t["operations"] == pytest.approx(min(flops / 67e12,
                                                3 * flops / 495e12))


def test_onehot_gather_bytes():
    t = arith.onehot_gather_terms(128, 1200, 128, 50_000, "bfloat16")
    want = 128 * 1200 * 128 * 2 + 128 * 1200 * 4 + 50_000 * 128 * 2
    assert t == {"bytes": pytest.approx(want / 3.35e12)}


def test_nms_and_masks_bytes_and_flops():
    assert arith.nms_suppress_terms(32, 300, 1000)["bytes"] == \
        pytest.approx((4 * 1000 + 8 * 32 * 300) / 3.35e12)
    t = arith.assemble_masks_terms(32, 100, 160, 160, 32, 10_000)
    assert t["bytes"] == pytest.approx(4 * (32 * 160 * 160 * 32
                                            + 32 * 100 * 32 + 32 * 100 * 4
                                            + 32 * 100 * 160 * 160)
                                       / 3.35e12)
    assert t["operations"] == pytest.approx(2 * 32 * 10_000 / 67e12)


def test_union_of_intervals_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert busy_us(iv) == 4.0
    assert gaps(iv, 0.0, 7.0) == [(3.0, 5.0), (6.0, 7.0)]


def _record(**kw):
    base = dict(window_s=1.0, device=[], host_spans={}, batches=10,
                frames=1280, config={}, workload={}, traffic={"batch": 128},
                sms=132)
    return Record(**{**base, **kw})


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (spec.ROOT / "metrics").glob("*.py")))
def test_readers_return_nothing_without_something_to_read(name):
    assert spec.metric_reader(name).read(_record()) is None


def test_roofline_reader_counts_matching_kernels():
    cfg = spec.load_json(spec.CHECKOUT / "portbench/configs/dfine-nano.json")
    # ten launches at twice the bound each: 50 %
    per = arith.bound_s(arith.attention_terms(128, 8, 400, 16, "bfloat16",
                                              132))
    dev = [("void attn_bf16_kernel<16>(bf16 const*)", i * 1e3,
            i * 1e3 + 2e6 * per) for i in range(10)]
    dev.append(("attn_other", 0.0, 1e9))
    rec = _record(device=dev, config=cfg)
    got = spec.metric_reader("aifi_attention_roofline").read(rec)
    assert got == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["dfine-nano", "yolov8n-seg"])
def test_recorded_flops_are_the_reference_count(name):
    """The FLOPs a frame recorded in each configuration file are
    FlopCounterMode's over the frozen reference at one frame."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = spec.load_json(spec.CHECKOUT / f"portbench/configs/{name}.json")
    if name == "dfine-nano":
        from portbench.entries.dfine_serve import reference_config
        from portbench.reference.dfine import DFine
        model = DFine(reference_config(cfg["model"]), device="cpu")
    else:
        from portbench.entries.yolo_serve import reference_config
        from portbench.reference.yolo import YOLO
        model = YOLO(reference_config(cfg["model"]), device="cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(torch.rand(1, 640, 640, 3))
    assert fc.get_total_flops() == cfg["flops"]["per_frame"]


def test_peaks_table():
    assert peaks.PEAK_FLOP_PER_S["bfloat16"] == 989e12
    assert peaks.PEAK_FLOP_PER_S["float32"] == 67e12
    assert peaks.PEAK_BYTES_PER_S == 3.35e12
    json.dumps(peaks.PEAK_FLOP_PER_S)
