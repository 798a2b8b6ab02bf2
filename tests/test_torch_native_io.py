"""pautdx_torch's C++ volume reader (``native/``) against the JAX package's
(``pautdx.native``) and against the port's numpy path, bit for bit, on
synthetic volumes. Skips where no g++ builds the library, as
``tests/test_native_io.py`` does.
"""

import numpy as np
import pytest

from pautdx import native as jnative
from pautdx_torch import native
from pautdx_torch.data import synthetic
from pautdx_torch.data.volume import parse_json_volume, parse_txt_tree


@pytest.fixture
def built():
    if not native.native_available():
        pytest.skip(f"the C++ reader does not build here: "
                    f"{native.native_error()}")
    if not jnative.native_available():
        pytest.skip("the reference's C++ reader does not build here")


def _same_volume(a, b):
    assert a.beam_keys == b.beam_keys
    assert a.beam_angles == b.beam_angles
    for bk in b.beam_keys:
        assert a.signals[bk].dtype == b.signals[bk].dtype == np.float32
        np.testing.assert_array_equal(a.signals[bk], b.signals[bk])
        assert a.scan_infos[bk] == b.scan_infos[bk]


def test_json_volume_native_matches_numpy_and_reference(built, tmp_path):
    spec = synthetic.VolumeSpec(n_beams=5, n_scans=30, n_samples=96, seed=9)
    path = str(tmp_path / "vol.json")
    synthetic.write_json_volume(path, spec)
    before = native.NATIVE_PARSES
    fast = parse_json_volume(path)
    assert native.NATIVE_PARSES == before + 1
    _same_volume(fast, parse_json_volume(path, use_native=False))
    ref = jnative.parse_json_volume_fast(path)
    assert fast.beam_keys == ref.beam_keys
    for bk in ref.beam_keys:
        np.testing.assert_array_equal(fast.signals[bk], ref.signals[bk])


def test_json_volume_with_signal_objects_takes_numpy(built, tmp_path):
    """``{"signal": [...]}`` scans: the scanner sees their keys, so the
    numpy parser answers, with the same result."""
    import json

    path = tmp_path / "obj.json"
    path.write_text(json.dumps({"beam_0_40": {
        "1_Health": {"signal": [0.5, -1.25]},
        "0_FO_0.25-0.5": {"signal": [2.0, 3.0, 4.0]}}}))
    before = native.NATIVE_PARSES
    got = parse_json_volume(str(path))
    assert native.NATIVE_PARSES == before
    _same_volume(got, parse_json_volume(str(path), use_native=False))


def _write_txt_tree(base, n_beams=4, n_scans=10, n_samples=64, seed=3):
    rng = np.random.default_rng(seed)
    for b in range(n_beams):
        d = base / f"beam_{b}_{40 + b}"
        d.mkdir(parents=True)
        for s in range(n_scans):
            name = (f"{s}_Health.txt" if (s + b) % 3 else
                    f"{s}_FO_0.25-0.5.txt")
            np.savetxt(str(d / name),
                       rng.normal(size=n_samples).astype(np.float32))


def test_txt_tree_native_matches_numpy_and_reference(built, tmp_path):
    _write_txt_tree(tmp_path / "volA", n_beams=3, n_scans=7)
    before = native.NATIVE_PARSES
    fast = parse_txt_tree(str(tmp_path), "volA")
    assert native.NATIVE_PARSES == before + 1
    _same_volume(fast, parse_txt_tree(str(tmp_path), "volA",
                                      use_native=False))
    tree = native.parse_ascan_tree_fast(str(tmp_path / "volA"))
    ref = jnative.parse_ascan_tree_fast(str(tmp_path / "volA"))
    assert tree.keys() == ref.keys() and len(tree) == 21
    for rel, arr in ref.items():
        np.testing.assert_array_equal(tree[rel], arr)
        np.testing.assert_array_equal(
            native.load_ascan_txt(str(tmp_path / "volA" / rel)), arr)


def test_synthetic_txt_tree_matches_numpy(built, tmp_path):
    """The synthetic writer's own txt tree, the layout the training path
    reads."""
    spec = synthetic.VolumeSpec(n_beams=4, n_scans=12, n_samples=80, seed=2)
    synthetic.write_txt_tree(str(tmp_path), spec)
    folder = next(p.name for p in tmp_path.iterdir() if p.is_dir())
    _same_volume(parse_txt_tree(str(tmp_path), folder),
                 parse_txt_tree(str(tmp_path), folder, use_native=False))


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """No silent numpy path: a compiler that fails makes the parse raise
    with its output, and ``native_available`` keeps it."""
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'error: broken toolchain' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.native_available()
    assert "broken toolchain" in native.native_error()
    path = str(tmp_path / "v.json")
    synthetic.write_json_volume(path, synthetic.VolumeSpec(n_scans=4))
    with pytest.raises(RuntimeError, match="broken toolchain"):
        parse_json_volume(path)
    assert parse_json_volume(path, use_native=False).n_beams > 0


def test_build_lands_in_the_build_dir_by_hash():
    assert native.lib_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "pautdx_torch")
    assert "-march=native" not in native.FLAGS
