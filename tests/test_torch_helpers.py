"""pautdx_torch's helpers inside files already ported (``utils/debug.py``'s
``enable_nan_debugging``, ``sanitize`` and ``check_finite``,
``data/synthetic.py::synth_dscan``, ``DetectionFrames.image_size`` and
``normalized_cxcywh``, ``ParsedVolume.scan_image``) against the JAX
package's. No model runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.data import synthetic as jsynth
from pautdx.data import vision as jvision
from pautdx.data import volume as jvolume
from pautdx.utils import debug as jdebug
from pautdx_torch.data import synthetic as tsynth
from pautdx_torch.data import vision as tvision
from pautdx_torch.data import volume as tvolume
from pautdx_torch.utils import debug as tdebug
from torch_threads import one_torch_thread  # noqa: F401


def _nonfinite():
    x = np.random.default_rng(0).normal(0, 30, (4, 9)).astype(np.float32)
    x[0, :3] = [np.nan, np.inf, -np.inf]
    x[2, 5:] = [np.inf, np.nan, -np.inf, 1e30]
    return x


@pytest.mark.parametrize("clamp", [20.0, None, 0.0])
def test_sanitize_matches_reference(clamp):
    x = _nonfinite()
    want = np.asarray(jdebug.sanitize(jnp.asarray(x), clamp))
    got = tdebug.sanitize(torch.from_numpy(x), clamp)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_check_finite_names_the_reference_leaves():
    x = _nonfinite()
    tree = {"params": {"b": {"kernel": x}, "a": {"bias": np.ones(3)}},
            "stats": [np.zeros(2), x[:1]], "step": 3}
    with pytest.raises(FloatingPointError) as want:
        jdebug.check_finite(tree, "state")
    ttree = {"params": {"b": {"kernel": torch.from_numpy(x)},
                        "a": {"bias": torch.ones(3)}},
             "stats": [torch.zeros(2), torch.from_numpy(x[:1])], "step": 3}
    with pytest.raises(FloatingPointError) as got:
        tdebug.check_finite(ttree, "state")
    assert str(got.value) == str(want.value)
    assert "params/b/kernel" in str(got.value)
    tdebug.check_finite({"w": torch.ones(2), "i": torch.arange(3)})
    with pytest.raises(FloatingPointError, match="conv.weight"):
        m = torch.nn.Sequential(torch.nn.Linear(2, 2))
        m.conv = torch.nn.Conv2d(1, 1, 1)
        with torch.no_grad():
            m.conv.weight[0, 0, 0, 0] = float("nan")
        tdebug.check_finite(m, "model")


def test_enable_nan_debugging_switches_anomaly_detection():
    try:
        tdebug.enable_nan_debugging(True)
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).sum().backward()
    finally:
        tdebug.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synth_dscan_bit_equal(seed):
    want_img, want_iv = jsynth.synth_dscan(n_scans=60, n_samples=96,
                                           seed=seed)
    got_img, got_iv = tsynth.synth_dscan(n_scans=60, n_samples=96,
                                         seed=seed)
    assert got_img.dtype == want_img.dtype
    np.testing.assert_array_equal(got_img, want_img)
    assert got_iv == want_iv


def test_version_matches_reference():
    import pautdx
    import pautdx_torch

    assert pautdx_torch.__version__ == pautdx.__version__


def test_frames_and_volume_helpers_match_reference(tmp_path):
    path = str(tmp_path / "v.json")
    jsynth.write_json_volume(path, jsynth.VolumeSpec(
        n_beams=4, n_scans=10, n_samples=48, seed=9))
    jvol = jvolume.parse_json_volume(path)
    tvol = tvolume.parse_json_volume(path)
    for s in (0, 4, 9):
        np.testing.assert_array_equal(tvol.scan_image(s),
                                      jvol.scan_image(s))
    want = jvision.detection_frames_from_volume(jvol, out_size=48,
                                                max_boxes=4)
    rng = np.random.default_rng(2)
    boxes = np.sort(rng.uniform(0, 48, (10, 4, 4)), -1).astype(np.float32)
    boxes = boxes[..., [0, 2, 1, 3]]
    images = rng.uniform(0, 1, (10, 40, 48, 3)).astype(np.float32)
    frames = [
        (cls(images=images, boxes=boxes, classes=want.classes,
             mask=want.mask))
        for cls in (tvision.DetectionFrames, jvision.DetectionFrames)]
    assert frames[0].image_size == frames[1].image_size == (40, 48)
    got, ref = (f.normalized_cxcywh() for f in frames)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
