"""pautdx_torch's host tooling (``viz``, ``data/summary.py``,
``utils/profiling.py``) against the JAX package's on the same inputs.

The reference modules are numpy and matplotlib; the port's copies must
give byte-equal pages and PNG bytes, pixel-equal plots and equal text.
No model runs: the DOT check builds its JAX variables from
``jax.eval_shape`` with seeded leaves.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx import viz as jviz
from pautdx.data import summary as jsummary
from pautdx.data import synthetic as jsynth
from pautdx.models.vision import dfine as jdf
from pautdx.models.vision.hgnet import HGNetConfig as JHGNetConfig
from pautdx.viz import explain as jexplain
from pautdx.viz import inspect as jinspect
from pautdx.viz import model_graph as jgraph
from pautdx_torch import viz as tviz
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.data import summary as tsummary
from pautdx_torch.models.vision import dfine as tdf
from pautdx_torch.utils import profiling
from pautdx_torch.viz import explain as texplain
from pautdx_torch.viz import inspect as tinspect
from pautdx_torch.viz import model_graph as tgraph
from torch_threads import one_torch_thread  # noqa: F401


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------ inspectors


@pytest.mark.parametrize("kind", ["gray_u8", "gray_float", "rgb_float",
                                  "rgb_u8"])
def test_png_bytes_equal(kind):
    rng = np.random.default_rng(len(kind))
    shape = (13, 17, 3) if kind.startswith("rgb") else (13, 17)
    img = rng.uniform(-0.2, 1.2, shape)
    if kind.endswith("u8"):
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    else:
        img = img.astype(np.float32)
    assert tinspect.png_bytes(img) == jinspect.png_bytes(img)
    assert tinspect.png_data_uri(img) == jinspect.png_data_uri(img)


def _bscan_sequences(rng):
    seqs = []
    for s in range(2):
        imgs = rng.uniform(0, 1, (3, 24, 20)).astype(np.float32)
        gt = [[{"box": [1.0, 2.0, 9.0 + t, 11.0], "label": "Delamination"}]
              for t in range(3)]
        pred = [[{"box": [1.5, 2.5, 8.0, 10.0 + t], "label": 0,
                  "score": 0.25 * t}] for t in range(3)] if s else None
        seqs.append({"name": f"seq{s}", "images": imgs, "gt": gt,
                     "pred": pred})
    return seqs


def _signal_sequences(rng):
    seqs = []
    for s in range(2):
        n = 6 + s
        seqs.append({
            "name": f"vol/{s}",
            "signals": rng.normal(size=(n, 40)).astype(np.float32),
            "labels": rng.integers(0, 2, n),
            "positions": rng.uniform(0, 1, (n, 2)),
            "probs": rng.uniform(0, 1, n) if s else None,
            "pred_positions": rng.uniform(0, 1, (n, 2)) if s else None,
            "label_names": [f"l{i}" for i in range(n)],
        })
    return seqs


@pytest.mark.parametrize("page", ["bscan", "signal"])
def test_inspector_pages_equal(page, tmp_path):
    rng = np.random.default_rng(3)
    if page == "bscan":
        seqs = _bscan_sequences(rng)
        build = (tinspect.build_bscan_inspector,
                 jinspect.build_bscan_inspector)
    else:
        seqs = _signal_sequences(rng)
        build = (tinspect.build_signal_inspector,
                 jinspect.build_signal_inspector)
    got, want = str(tmp_path / "port.html"), str(tmp_path / "ref.html")
    assert build[0](seqs, got) == got
    build[1](seqs, want)
    assert _read(got) == _read(want)


def test_explainer_pages_equal(tmp_path):
    got = texplain.build_explainers(str(tmp_path / "port"))
    want = jexplain.build_explainers(str(tmp_path / "ref"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert len(got) == 7
    for g, w in zip(got, want):
        assert _read(g) == _read(w), os.path.basename(g)


# ------------------------------------------------------------ plots


def _plot_args(rng, which):
    if which == "history":
        return ({"train_loss": [1.0, 0.5, 0.25], "val_loss": [1.2, 0.7, 0.6],
                 "lr_scale": [1.0, 0.5, 0.5], "epoch": [0, 1, 2],
                 "time_s": [0.1, 0.1, 0.1]},), {}
    if which == "heatmap":
        return (rng.uniform(0, 1, (5, 30)).astype(np.float32),), {}
    if which == "boxes":
        img = rng.uniform(0, 1, (48, 40)).astype(np.float32)
        return (img, [[2, 3, 20, 30], [10, 5, 35, 44]]), {
            "labels": [0, 1], "scores": [0.9, 0.35]}
    return (rng.normal(size=(4, 64)).astype(np.float32),
            np.array([0.9, 0.2, 0.6, 0.1], np.float32),
            np.array([[0.1, 0.3], [0.2, 0.4], [0.5, 0.9], [0.0, 0.1]],
                     np.float32)), {}


_PLOTS = {"history": "plot_training_history",
          "heatmap": "plot_prediction_heatmap",
          "boxes": "draw_boxes_on_image",
          "signals": "plot_signal_predictions"}


@pytest.mark.parametrize("which", list(_PLOTS))
def test_plots_equal_pixel_for_pixel(which, tmp_path):
    import matplotlib.image as mpimg

    args, kw = _plot_args(np.random.default_rng(7), which)
    got, want = str(tmp_path / "port.png"), str(tmp_path / "ref.png")
    pos = args if which != "boxes" else args[:2]
    getattr(tviz, _PLOTS[which])(*pos, got, **kw)
    getattr(jviz, _PLOTS[which])(*pos, want, **kw)
    a, b = mpimg.imread(got), mpimg.imread(want)
    assert a.shape == b.shape and a.shape[0] > 10
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ DOT


def test_model_dot_equal_for_carried_dfine(tmp_path):
    """The tiny D-FINE of ``tests/test_torch_quant.py``: the reference's DOT
    of its parameter tree equals the port's of the module the same
    weights were carried into; a nested dict is taken as it is, as the
    reference takes it."""
    cfg = jdf.DFineConfig(
        num_labels=2, d_model=32, encoder_hidden_dim=32, decoder_layers=2,
        decoder_attention_heads=4, encoder_attention_heads=4,
        decoder_ffn_dim=64, encoder_ffn_dim=64, num_queries=20,
        max_num_bins=16, hidden_expansion=0.5,
        backbone=JHGNetConfig(
            stem_channels=(3, 8, 8), stage_in_channels=(8, 16, 32, 64),
            stage_mid_channels=(8, 8, 16, 32),
            stage_out_channels=(16, 32, 64, 128),
            stage_num_blocks=(1, 1, 1, 1), stage_num_layers=(1, 1, 2, 2)))
    shapes = jax.eval_shape(lambda k: jdf.DFine(cfg).init(
        {"params": k}, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.1, s.shape).astype(np.float32),
        dict(shapes))
    port = load_jax_variables(
        tdf.DFine(tdf.config_from_dict(jdf.config_to_dict(cfg)),
                  device="cpu"), variables, device="cpu")
    for depth in (2, 4):
        want = jgraph.model_dot(variables["params"], name="dfine",
                                max_depth=depth)
        assert tgraph.model_dot(port, name="dfine", max_depth=depth) == want
        assert tgraph.model_dot(variables["params"], name="dfine",
                                max_depth=depth) == want
    path = str(tmp_path / "m.dot")
    assert tviz.save_model_dot(port, path, name="dfine") == _read(
        path).decode()


# ------------------------------------------------------------ summary


def test_summarize_collection_equal(tmp_path):
    d = tmp_path / "collection"
    d.mkdir()
    jsynth.write_json_volume(str(d / "plate_D0.5-12.json"),
                             jsynth.VolumeSpec(n_beams=3, n_scans=9,
                                               n_samples=32, seed=4))
    jsynth.write_txt_tree(str(d), jsynth.VolumeSpec(n_beams=2, n_scans=7,
                                                    n_samples=32, seed=5),
                          file_folder="weld_D1-3")
    (d / "notes.txt").write_text("skipped")
    got = tsummary.summarize_collection(str(d), str(tmp_path / "a.json"))
    want = jsummary.summarize_collection(str(d), str(tmp_path / "b.json"))
    assert list(got) == ["plate_D0.5-12", "weld_D1-3"]
    assert got == want
    assert _read(tmp_path / "a.json") == _read(tmp_path / "b.json")
    for name in ("x_D2-4.5_y", "no_depth", "a_D10-20"):
        assert tsummary.depth_limits_from_name(name) == \
            jsummary.depth_limits_from_name(name)


def test_summarize_collection_reports_a_volume_without_beams(tmp_path):
    """A volume without beams (``{}``, and what the C++ reader makes of
    some malformed files): the reference's summary raises, the port's
    reports it."""
    (tmp_path / "broken.json").write_text("{}")
    with pytest.raises(ValueError):
        jsummary.summarize_collection(str(tmp_path))
    assert tsummary.summarize_collection(str(tmp_path)) == {
        "broken.json": {"error": "no beams in broken.json"}}


# ------------------------------------------------------------ profiling


def test_trace_and_step_timer(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "tr" / profiling.TRACE_FILE
    assert path.is_file() and path.stat().st_size > 0
    assert "traceEvents" in path.read_text()
    assert prof.key_averages()
    timer = profiling.StepTimer(sync=True)
    for i in range(4):
        x = torch.full((8,), float(i))
        with timer.step({"x": x}):
            x.sum()
    s = timer.summary()
    assert s["steps"] == 3 and s["total_s"] >= s["mean_s"] * 3
    assert set(s) == {"steps", "mean_s", "p50_s", "p90_s", "p99_s",
                      "total_s"}
    timer.save(str(tmp_path / "t" / "timing.json"))
    assert (tmp_path / "t" / "timing.json").is_file()
