"""pautdx_torch's volume-to-frames pipeline held to the JAX package on the
CPU, from the same seeds: synthesis, the JSON and txt-tree parsers, the
B-scan render (at 1e-5 against the jitted JAX render), annotations,
detection frames, letterbox, batching and augmentation."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.data import augment_vision as j_aug
from pautdx.data import bscan as j_bscan
from pautdx.data import synthetic as j_syn
from pautdx.data import vision as j_vision
from pautdx.data import volume as j_volume
from pautdx_torch.data import augment_vision as t_aug
from pautdx_torch.data import bscan as t_bscan
from pautdx_torch.data import synthetic as t_syn
from pautdx_torch.data import vision as t_vision
from pautdx_torch.data import volume as t_volume
from pautdx_torch.data.prefetch import ThreadedHostLoader
from torch_threads import one_torch_thread  # noqa: F401

SPEC = dict(n_beams=6, n_scans=12, n_samples=96, seed=7)


def _same_volume(a, b):
    assert a.beam_keys == b.beam_keys and a.beam_angles == b.beam_angles
    assert a.scan_infos.keys() == b.scan_infos.keys()
    for k in a.scan_infos:
        assert [dataclasses.astuple(i) for i in a.scan_infos[k]] == \
            [dataclasses.astuple(i) for i in b.scan_infos[k]]
    for k in a.beam_keys:
        np.testing.assert_array_equal(a.signals[k], b.signals[k])


def _same_frames(a, b, atol):
    np.testing.assert_allclose(a.images, b.images, atol=atol, rtol=0)
    np.testing.assert_array_equal(a.boxes, b.boxes)
    np.testing.assert_array_equal(a.classes, b.classes)
    np.testing.assert_array_equal(a.mask, b.mask)


@pytest.mark.parametrize("flicker", [0.0, 0.5])
def test_synthetic_volume_and_json_parse_match(flicker, tmp_path):
    """The same seed gives the same volume bit for bit; the JSON schema and
    the parsed volume (the reference's default reader for a path, the
    numpy one for a dict) are equal."""
    j_spec = j_syn.VolumeSpec(amplitude_flicker=flicker, **SPEC)
    t_spec = t_syn.VolumeSpec(amplitude_flicker=flicker, **SPEC)
    j_vol, j_def = j_syn.generate_volume(j_spec)
    t_vol, t_def = t_syn.generate_volume(t_spec)
    np.testing.assert_array_equal(j_vol, t_vol)
    assert [vars(d) for d in j_def] == [vars(d) for d in t_def]
    j_dict = j_syn.volume_to_json_dict(j_vol, j_def)
    assert t_syn.volume_to_json_dict(t_vol, t_def) == j_dict
    path = str(tmp_path / "v.json")
    t_syn.write_json_volume(path, t_spec)
    _same_volume(t_volume.parse_json_volume(path),
                 j_volume.parse_json_volume(path))
    _same_volume(t_volume.parse_json_volume(j_dict),
                 j_volume.parse_json_volume(j_dict, use_native=False))


def test_txt_tree_parse_matches(txt_tree_dir, tmp_path):
    """The shared txt-tree fixture parses alike, and the port's writer
    writes the reference's files."""
    root, _ = txt_tree_dir
    _same_volume(t_volume.parse_txt_tree(root, "fileA"),
                 j_volume.parse_txt_tree(root, "fileA"))
    spec = dict(n_beams=3, n_scans=5, n_samples=16, seed=3)
    t_syn.write_txt_tree(str(tmp_path / "t"), t_syn.VolumeSpec(**spec))
    j_syn.write_txt_tree(str(tmp_path / "j"), j_syn.VolumeSpec(**spec))
    _same_volume(t_volume.parse_txt_tree(str(tmp_path / "t"), "file0"),
                 j_volume.parse_txt_tree(str(tmp_path / "j"), "file0"))
    vol = t_volume.parse_txt_tree(root, "fileA")
    assert t_volume.volume_defect_boxes(vol) == \
        j_volume.volume_defect_boxes(vol)


@pytest.mark.parametrize("shape,out", [((3, 6, 96), (64, 64)),
                                       ((2, 8, 320), (640, 640)),
                                       ((2, 5, 37), (48, 80))])
def test_render_bscans_matches_jax(shape, out):
    """Abs, per-frame max normalisation, half-pixel bilinear resize with
    clipped borders and the 90° rotation: within 1e-5 of the jitted JAX
    render, also unnormalised and with an all-zero frame."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    x[0] = 0.0
    for normalize in (True, False):
        want = np.asarray(j_bscan.render_bscans(jnp.asarray(x), *out,
                                                normalize=normalize))
        got = t_bscan.render_bscans(x, *out, normalize=normalize,
                                    device="cpu")
        assert got.shape == (shape[0],) + out and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(
        t_bscan.rotate90_cw(torch.from_numpy(img)).numpy(),
        np.rot90(img, k=-1))


def test_detection_frames_match(json_volume_dir):
    """Annotations (the x inversion), pixel boxes, classes and masks equal,
    images within 1e-5; a box under one pixel is filtered; ``max_boxes``
    cuts; a class map applies."""
    vol = t_volume.parse_json_volume(os.path.join(json_volume_dir,
                                                  "vol0.json"))
    ann = {"0.png": [{"bbox": [0, 2, 0.25, 0.5], "label": "FO"},
                     {"bbox": [1, 1, 0.3, 0.4], "label": "Delamination"}]}
    assert t_bscan.adjust_annotations(ann, 5, (320, 200)) == \
        j_bscan.adjust_annotations(ann, 5, (320, 200))
    assert t_bscan.bbox_xyxy_from_schema([9, 3, 1, 5]) == \
        j_bscan.bbox_xyxy_from_schema([9, 3, 1, 5])
    for kw in (dict(out_size=64, max_boxes=8),
               dict(out_size=96, max_boxes=1, rgb=False,
                    class_map={"Delamination": 1})):
        got = t_vision.detection_frames_from_volume(vol, device="cpu", **kw)
        want = j_vision.detection_frames_from_volume(vol, **kw)
        _same_frames(got, want, 1e-5)
    assert got.mask.sum() > 0


def test_letterbox_batch_and_split_match():
    rng = np.random.default_rng(2)
    for shape in ((2, 30, 50, 3), (1, 40, 20)):
        x = rng.uniform(size=shape).astype(np.float32)
        got, want = t_vision.letterbox(x, 64), j_vision.letterbox(x, 64)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
        assert got[1:] == want[1:]
    frames = j_vision.DetectionFrames(
        rng.uniform(size=(5, 8, 8, 3)).astype(np.float32),
        rng.uniform(size=(5, 2, 4)).astype(np.float32),
        rng.integers(0, 2, (5, 2)).astype(np.int32),
        rng.integers(0, 2, (5, 2)).astype(np.float32))
    t_frames = t_vision.DetectionFrames(frames.images, frames.boxes,
                                        frames.classes, frames.mask)
    idx = np.asarray([4, 0, 2])
    got = t_vision.batch_frames(t_vision.split_frames(t_frames), idx)
    want = j_vision.batch_frames(j_vision.split_frames(frames), idx)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_augment_detection_batch_matches():
    """The same generator state gives the same augmented batch (mosaic,
    flips and jitter all drawn at probability 0.5 over 6 frames)."""
    rng = np.random.default_rng(3)
    batch = {"images": rng.uniform(size=(6, 16, 16, 3)).astype(np.float32),
             "boxes": np.tile(np.asarray([[2, 3, 9, 12], [0, 0, 0, 0]],
                                         np.float32), (6, 1, 1)),
             "classes": np.tile(np.asarray([1, 0], np.int32), (6, 1)),
             "mask": np.tile(np.asarray([1, 0], np.float32), (6, 1))}
    for seed in range(3):
        got = t_aug.augment_detection_batch(batch,
                                            np.random.default_rng(seed))
        want = j_aug.augment_detection_batch(batch,
                                             np.random.default_rng(seed))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_threaded_loader_yields_in_order_and_raises():
    assert list(ThreadedHostLoader(range(10), capacity=2)) == list(range(10))

    def bad():
        yield 1
        raise ValueError("boom")

    it = iter(ThreadedHostLoader(bad()))
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)
    # a consumer that stops early stops the thread
    it = iter(ThreadedHostLoader(iter(range(100)), capacity=1))
    assert next(it) == 0
    it.close()
