"""``python -m pautdx_torch.cli`` against ``pautdx.cli`` on the CPU.

The slice as a whole: the same weights go into both CLIs. The JAX
variables (``jax.eval_shape`` shapes, seeded leaves) are saved through
``pautdx.train.CheckpointManager`` and carried by
``compat.jax_weights.load_jax_variables`` into a checkpoint of the port's
``CheckpointManager`` with the same metadata. Two runs of the JAX CLI
run a model (``predict-bscan`` D-FINE and YOLO); the int8 run is held to
the reference's int8 forward at the port's scales, and the signal
subcommands to the reference's ``_load_signal_model`` path on the JAX
checkpoint. The trainings and ``export`` run on the port alone.
Torch runs on one thread.
"""

import argparse
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from pautdx import cli as jcli
from pautdx.data import datasets as jdatasets
from pautdx.data import synthetic as jsynth
from pautdx.data import volume as jvolume
from pautdx.eval import report as jreport
from pautdx.models.signal.detection_zoo import MODEL_ZOO as JZOO
from pautdx.models.vision import dfine as jdf
from pautdx.models.vision import yolo as jyolo
from pautdx.train import CheckpointManager as JCheckpointManager
from pautdx_torch import cli as tcli
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.data import volume as tvolume
from pautdx_torch.data.bscan import render_volume
from pautdx_torch.models.signal import build_signal_model
from pautdx_torch.models.vision import dfine as tdf
from pautdx_torch.models.vision import yolo as tyolo
from pautdx_torch.models.vision.temporal_dfine import TemporalDFine
from pautdx_torch.serve.export import load_exported
from pautdx_torch.train import temporal as ttemporal
from pautdx_torch.train.checkpoint import (
    CheckpointManager, load_model_state, restore_dfine,
)
from torch_threads import one_torch_thread  # noqa: F401

SIZE = 64
SIGNAL_MODEL, SEQ_LEN, SAMPLES = "HybridBinary", 30, 160


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(tree, rng):
    """Seeded values for the shapes of a JAX init: kernels ~ N(0,
    1/fan_in), BN statistics, scales and biases random."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _variables(v, rng)
            continue
        if len(v.shape) >= 2:
            a = rng.normal(0.0, np.prod(v.shape[:-1]) ** -0.5, v.shape)
        elif k == "scale":
            a = 1.0 + rng.normal(0.0, 0.1, v.shape)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            a = rng.normal(0.0, 0.1, v.shape)
        out[k] = a.astype(np.float32)
    return out


def _checkpoints(root, name, jmodel, port, shape, meta, seed):
    """The JAX and the port checkpoint directories of the same seeded
    weights, with the same metadata."""
    shapes = jax.eval_shape(lambda k: jmodel.init(
        {"params": k}, jnp.zeros(shape, jnp.float32), train=False),
        jax.random.PRNGKey(0))
    variables = _variables(dict(shapes), np.random.default_rng(seed))
    jdir, tdir = str(root / f"{name}_jax"), str(root / f"{name}_port")
    JCheckpointManager(jdir).save(0, variables, metadata=meta, is_best=True)
    load_jax_variables(port, variables, device="cpu")
    CheckpointManager(tdir).save(
        0, {"params": dict(port.named_parameters()),
            "batch_stats": dict(port.named_buffers())},
        metadata=meta, is_best=True)
    return jdir, tdir


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    raw, sig = root / "raw", root / "sig"
    raw.mkdir()
    sig.mkdir()
    jsynth.write_json_volume(str(raw / "v.json"), jsynth.VolumeSpec(
        n_beams=5, n_scans=12, n_samples=96, seed=51))
    jsynth.write_json_volume(str(sig / "volA.json"), jsynth.VolumeSpec(
        n_beams=5, n_scans=60, n_samples=SAMPLES, seed=21))
    dcfg = jdf.dfine_nano(num_labels=2)
    ycfg = jyolo.YoloConfig(num_classes=2, scale="n", flavour="v8")
    bmeta = {"num_classes": 2, "size": SIZE, "scale": "n", "flavour": "v8"}
    ckpt = {
        "dfine": _checkpoints(
            root, "dfine", jdf.DFine(dcfg),
            tdf.DFine(tdf.config_from_dict(jdf.config_to_dict(dcfg)),
                      device="cpu"),
            (1, SIZE, SIZE, 3),
            {"detector": "dfine", **bmeta,
             "dfine_config": jdf.config_to_dict(dcfg)}, 1),
        "yolo": _checkpoints(
            root, "yolo", jyolo.YOLO(ycfg),
            tyolo.YOLO(tyolo.YoloConfig(num_classes=2, scale="n",
                                        flavour="v8"), device="cpu"),
            (1, SIZE, SIZE, 3), {"detector": "yolo", **bmeta}, 2),
        "signal": _checkpoints(
            root, "signal", JZOO[SIGNAL_MODEL](),
            build_signal_model(SIGNAL_MODEL, signal_length=SAMPLES,
                               device="cpu"),
            (1, SEQ_LEN, SAMPLES),
            {"model": SIGNAL_MODEL, "recipe": "detection",
             "seq_len": SEQ_LEN, "signal_length": SAMPLES}, 3),
    }
    return {"root": root, "raw": str(raw), "sig": str(sig), "ckpt": ckpt}


def _detections(out_dir):
    with open(os.path.join(out_dir, "detections.json")) as f:
        return json.load(f)


def _predict(setup, main, which, side, tag, *extra):
    out = str(setup["root"] / f"pred_{tag}")
    argv = ["predict-bscan", "--data", setup["raw"], "--out", out,
            "--detector", which.split("_")[0], "--size", str(SIZE),
            "--threshold", "0.0",
            "--checkpoint", setup["ckpt"][which][side], *extra]
    if main is tcli.main:
        argv += ["--device", "cpu"]
    main(argv)
    return _detections(out)


def _assert_same_detections(got, want, pair=2e-3, median=1e-3, outliers=4):
    """``tests/test_torch_dfine.py::_assert_same_detections`` on the
    detections of each frame: features [box / size, score], a bijection
    by assignment; all but at most 4 pairs within 2e-3, the median below
    1e-3, labels equal for the pairs within 2e-3 (the rule's defaults)."""
    assert got.keys() == want.keys()
    for seq in want:
        assert len(got[seq]) == len(want[seq])
        for g, w in zip(got[seq], want[seq]):
            assert len(g) == len(w) > 0

            def feats(dets):
                return np.array([[*(np.array(d["box"]) / SIZE), d["score"]]
                                 for d in dets])

            cost = np.linalg.norm(feats(g)[:, None] - feats(w)[None], axis=-1)
            r, c = linear_sum_assignment(cost)
            matched = cost[r, c]
            assert (matched < pair).sum() >= len(matched) - outliers, \
                np.sort(matched)[-6:]
            assert np.median(matched) < median
            for i, j in zip(r, c):
                if cost[i, j] < pair:
                    assert g[i]["label"] == w[j]["label"]


@pytest.fixture(scope="module")
def port_dfine(setup):
    return _predict(setup, tcli.main, "dfine", 1, "port_dfine")


# ------------------------------------------------------------ predict-bscan


def test_predict_bscan_dfine_matches_reference(setup, port_dfine):
    want = _predict(setup, jcli.main, "dfine", 0, "jax_dfine")
    assert len(port_dfine["v"]) == 12
    _assert_same_detections(port_dfine, want)


def test_predict_bscan_yolo_matches_reference(setup):
    """Held as ``tests/test_torch_yolo.py`` holds the YOLO predict chain:
    detections matched by assignment per frame, box L1 below 1e-2 px and
    score within 1e-4, at most one unmatched detection a frame, labels
    equal."""
    got = _predict(setup, tcli.main, "yolo", 1, "port_yolo")
    want = _predict(setup, jcli.main, "yolo", 0, "jax_yolo")
    assert got.keys() == want.keys() and len(got["v"]) == 12
    n = 0
    for g, w in zip(got["v"], want["v"]):
        if not (g or w):
            continue
        gb, wb = (np.array([d["box"] for d in x]).reshape(-1, 4)
                  for x in (g, w))
        gs, ws = (np.array([d["score"] for d in x]) for x in (g, w))
        cost = (np.abs(gb[:, None] - wb[None]).sum(-1)
                + np.abs(gs[:, None] - ws[None]))
        r, c = linear_sum_assignment(cost)
        ok = [(i, j) for i, j in zip(r, c)
              if np.abs(gb[i] - wb[j]).sum() < 1e-2
              and abs(gs[i] - ws[j]) < 1e-4]
        assert max(len(g), len(w)) - len(ok) <= 1, (len(g), len(w), len(ok))
        for i, j in ok:
            assert g[i]["label"] == w[j]["label"]
        n += len(ok)
    assert n > 12


def test_predict_bscan_dfine_int8_matches_reference(setup):
    """``--quant int8``: the port's CLI run against the reference's int8
    forward and ``post_process`` as its CLI runs them, at the same scales.

    - Each CLI calibrates on its own f32 forward of the first request: the
      69 scales agree within 1e-6 relative, not bit for bit; so the
      reference runs at the scales the port calibrated.
    - In float64 the port's int8 model and the reference's agree within
      1e-6 at every query (the D-FINE rule's median, 1e-3, a thousand
      times over): the int8 arithmetic is the same.
    - In f32, the frameworks' 1e-6 drift moves a few inputs a site across
      a rounding boundary, one int8 step each, and the detections' median
      distance reads up to about 2e-3 where the dense f32 runs read below
      1e-3. The CLI's f32 detections are held to every pair within 1e-2
      and the median below 5e-3."""
    from pautdx.data.bscan import render_volume_dataset
    from pautdx.serve import quantize as jquant
    from pautdx_torch.ops.qconv import set_int8_scales
    from pautdx_torch.serve.quantize import calibrate_int8

    got = _predict(setup, tcli.main, "dfine", 1, "port_int8", "--quant",
                   "int8")
    vol = jvolume.parse_json_volume(os.path.join(setup["raw"], "v.json"))
    imgs, _ = render_volume_dataset(vol, SIZE, SIZE)
    frames = np.repeat(imgs[..., None], 3, axis=-1).astype(np.float32)
    model, _, _ = restore_dfine(setup["ckpt"]["dfine"][1], device="cpu")
    timgs, _ = render_volume(tvolume.parse_json_volume(
        os.path.join(setup["raw"], "v.json")), SIZE, SIZE, "cpu")
    with torch.inference_mode():
        tq = calibrate_int8(model, [tcli._frames(timgs)])
    state, meta = JCheckpointManager(setup["ckpt"]["dfine"][0]).restore()
    jmodel = jdf.DFine(jdf.config_from_dict(meta["dfine_config"]))
    calib = jax.jit(lambda b: jmodel.apply(state, b, train=False,
                                           mutable=["calib"]))
    jq_tree = jquant.calibrate_int8(calib, [jnp.asarray(frames)])

    def site(path):
        return ".".join(p.key for p in path[:-1])

    jq = {site(path): float(v) for path, v in
          jax.tree_util.tree_flatten_with_path(jq_tree)[0]}
    assert tq.keys() == jq.keys() and len(tq) == 69
    rel = max(abs(tq[k] - jq[k]) / jq[k] for k in jq)
    assert rel < 1e-6, rel
    quant = jax.tree_util.tree_map_with_path(
        lambda path, v: np.float32(tq[site(path)]), jq_tree)
    out = jax.jit(lambda b: jmodel.apply({**state, "quant": quant}, b,
                                         train=False))(jnp.asarray(frames))
    det = jax.tree_util.tree_map(np.asarray, jdf.post_process(
        out["logits"], out["pred_boxes"], (SIZE, SIZE), threshold=0.0,
        max_det=16))
    want = {"v": [[{"box": [float(x) for x in det["boxes"][t][i]],
                    "label": int(det["classes"][t][i]),
                    "score": float(det["scores"][t][i])}
                   for i in np.nonzero(det["valid"][t])[0]]
                  for t in range(frames.shape[0])]}
    _assert_same_detections(got, want, pair=1e-2, median=5e-3, outliers=0)
    # the same int8 model in float64 on both sides
    set_int8_scales(model, tq)
    with torch.inference_mode():
        t64 = model.double()(torch.from_numpy(frames).double())
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     state)
        j64 = jax.jit(lambda b: jmodel.apply({**v64, "quant": quant}, b,
                                             train=False))(
            jnp.asarray(frames, jnp.float64))
        j64 = jax.tree_util.tree_map(np.asarray, j64)
    for t in range(frames.shape[0]):
        def feats(boxes, logits):
            return np.concatenate([boxes, 1 / (1 + np.exp(-logits))], -1)

        cost = np.linalg.norm(
            feats(t64["pred_boxes"][t].numpy(), t64["logits"][t].numpy())
            [:, None] - feats(j64["pred_boxes"][t], j64["logits"][t])[None],
            axis=-1)
        r, c = linear_sum_assignment(cost)
        assert cost[r, c].max() < 1e-6, cost[r, c].max()


@pytest.mark.parametrize("flag", ["--fused-attn", "--prepatch"])
def test_predict_bscan_options_match_the_default_run(setup, port_dfine,
                                                     flag):
    """As ``tests/test_cli_bscan.py`` holds the reference's: the fused
    attention within 1e-5 in score and 1e-3 in box, the prepatched stem
    exactly."""
    got = _predict(setup, tcli.main, "dfine", 1, f"port{flag}", flag)
    atol = (0.0, 0.0) if flag == "--prepatch" else (1e-5, 1e-3)
    for fg, fb in zip(got["v"], port_dfine["v"]):
        assert len(fg) == len(fb)
        for dg, db in zip(fg, fb):
            assert dg["label"] == db["label"]
            np.testing.assert_allclose(dg["score"], db["score"], atol=atol[0],
                                       rtol=0)
            np.testing.assert_allclose(dg["box"], db["box"], atol=atol[1],
                                       rtol=0)


def test_predict_bscan_overlays_and_inspect(setup, port_dfine):
    out = str(setup["root"] / "overlay")
    tcli.main(["predict-bscan", "--data", setup["raw"], "--out", out,
               "--size", str(SIZE), "--threshold", "0.0", "--overlays",
               "--checkpoint", setup["ckpt"]["dfine"][1], "--device", "cpu"])
    assert _detections(out) == port_dfine
    assert any(n.endswith(".png") for n in os.listdir(out))
    page = str(setup["root"] / "inspect.html")
    tcli.main(["inspect", "--data", setup["raw"], "--out", page,
               "--size", str(SIZE), "--threshold", "0.0",
               "--checkpoint", setup["ckpt"]["dfine"][1], "--device", "cpu"])
    text = open(page).read()
    first = port_dfine["v"][0][0]
    assert json.dumps(first["box"])[1:-1] in text.replace(" ", "").replace(
        ",", ", ")


# ------------------------------------------------------------ build-dataset


def test_build_dataset_matches_reference(setup):
    outs = {}
    for side, main in (("port", tcli.main), ("jax", jcli.main)):
        outs[side] = str(setup["root"] / f"ds_{side}")
        argv = ["build-dataset", "--data", setup["sig"], "--out",
                outs[side], "--size", str(SIZE), "--yolo"]
        main(argv + (["--device", "cpu"] if side == "port" else []))
    got, want = outs["port"], outs["jax"]
    assert json.load(open(os.path.join(got, "annotations.json"))) == \
        json.load(open(os.path.join(want, "annotations.json")))
    for d, _, names in os.walk(want):
        rel = os.path.relpath(d, want)
        assert sorted(os.listdir(os.path.join(got, rel))) == sorted(names + [
            x for x in os.listdir(d) if os.path.isdir(os.path.join(d, x))])
        for n in names:
            a, b = os.path.join(got, rel, n), os.path.join(d, n)
            if n.endswith(".npy"):
                np.testing.assert_allclose(np.load(a), np.load(b), atol=1e-5,
                                           rtol=0)
            elif n.endswith((".txt", ".yaml")):
                assert open(a).read() == open(b).read().replace(want, got), n


# ------------------------------------------------------------ signals


@pytest.fixture(scope="module")
def jax_signal(setup):
    predict, meta = jcli._load_signal_model(setup["ckpt"]["signal"][0])
    return predict, meta


def test_eval_signal_matches_reference(setup, jax_signal, capsys):
    predict, meta = jax_signal
    out = str(setup["root"] / "eval")
    tcli.main(["eval-signal", "--data", setup["sig"], "--checkpoint",
               setup["ckpt"]["signal"][1], "--out", out, "--device", "cpu"])
    got = json.load(open(os.path.join(out, "metrics.json")))
    ds = jdatasets.load_json_dir(setup["sig"], seq_len=meta["seq_len"])
    want = jreport.SignalEvaluator(predict).run(ds)
    assert set(got) == set(want)
    for k, v in want.items():
        if v != v:
            assert got[k] is None, k
        else:
            assert abs(got[k] - v) <= 1e-6, (k, got[k], v)
    assert 0.0 <= got["accuracy"] <= 1.0


def test_predict_signal_matches_reference(setup, jax_signal):
    predict, meta = jax_signal
    out = str(setup["root"] / "psig")
    tcli.main(["predict-signal", "--data", setup["sig"], "--checkpoint",
               setup["ckpt"]["signal"][1], "--out", out, "--heatmaps",
               "--device", "cpu"])
    got = json.load(open(os.path.join(out, "predictions.json")))
    vol = jvolume.parse_json_volume(os.path.join(setup["sig"], "volA.json"))
    heat = np.nan_to_num(jreport.prediction_map(predict, vol,
                                                meta["seq_len"]))
    assert list(got) == ["volA.json"]
    assert got["volA.json"]["beams"] == vol.beam_keys
    np.testing.assert_allclose(np.array(got["volA.json"]["probabilities"]),
                               heat, atol=1e-5, rtol=0)
    assert os.path.exists(os.path.join(out, "volA.png"))


def test_bridge_answers_each_request_at_its_own_shape(setup, jax_signal,
                                                      monkeypatch, capsys):
    """Two requests on one stdin, (N, S) and (B, N, S) at other N than the
    checkpoint's seq_len: both answered, each at its own shape, against
    the reference's model at that shape; the checkpoint loaded once."""
    predict, _ = jax_signal
    rng = np.random.default_rng(5)
    reqs = [rng.normal(size=(7, SAMPLES)).astype(np.float32),
            rng.normal(size=(2, 13, SAMPLES)).astype(np.float32)]
    stdin = json.dumps({"signals": reqs[0].tolist()}) + "\n" + json.dumps(
        {"signals": reqs[1].tolist()}, indent=1)
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    tcli.main(["bridge", "--checkpoint", setup["ckpt"]["signal"][1],
               "--device", "cpu"])
    captured = capsys.readouterr()
    answers = [json.loads(line) for line in captured.out.splitlines()]
    assert len(answers) == 2
    assert captured.err.count("loaded") == 1
    for req, ans in zip(reqs, answers):
        x = req[None] if req.ndim == 2 else req
        out = predict(jnp.asarray(x))
        want = np.asarray(out["prob"] if isinstance(out, dict) else out)
        got = np.array(ans["prob"])
        assert got.shape == want.shape == x.shape[:2]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(np.array(ans["pred"]),
                                      (got >= 0.5).astype(float))


def test_signal_inspector_page(setup):
    page = str(setup["root"] / "sig.html")
    tcli.main(["inspect", "--data", setup["sig"], "--mode", "signal",
               "--out", page, "--checkpoint", setup["ckpt"]["signal"][1],
               "--device", "cpu"])
    text = open(page).read()
    assert text.count('"name": "volA/') == 5 and '"probs": [' in text


def test_train_signal_and_export_round_trip(setup):
    out = str(setup["root"] / "train_signal")
    tcli.main(["train-signal", "--data", setup["sig"], "--out", out,
               "--model", "MLP", "--epochs", "1", "--batch-size", "4",
               "--seq-len", str(SEQ_LEN), "--device", "cpu"])
    meta = json.load(open(os.path.join(out, "metadata.json")))
    assert {"model": "MLP", "recipe": "detection",
            "seq_len": SEQ_LEN}.items() <= meta.items()
    hist = json.load(open(os.path.join(out, "history.json")))
    assert {"epoch", "val_loss", "lr_scale", "time_s"} <= set(hist)
    assert all(np.isfinite(v).all() for k, v in hist.items()
               if k.startswith(("train_", "val_")))
    assert os.path.exists(os.path.join(out, "history.png"))
    art = str(setup["root"] / "export" / "mlp.pt2")
    tcli.main(["export", "--checkpoint", out, "--out", art, "--polymorphic",
               "--num-signals", str(SEQ_LEN), "--signal-length",
               str(SAMPLES), "--device", "cpu"])
    from pautdx_torch.train.signal import restore_signal_model

    model, _ = restore_signal_model(out, device="cpu")
    run = load_exported(art)
    for b in (1, 3):
        x = torch.randn(b, SEQ_LEN, SAMPLES)
        with torch.no_grad():
            want = model(x)
        got = run(x)
        for g, w in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    # --dp on the CPU: one gloo rank, the same history as the run above
    dp_out = str(setup["root"] / "train_signal_dp")
    tcli.main(["train-signal", "--data", setup["sig"], "--out", dp_out,
               "--model", "MLP", "--epochs", "1", "--batch-size", "4",
               "--seq-len", str(SEQ_LEN), "--dp", "--device", "cpu"])
    dp_hist = json.load(open(os.path.join(dp_out, "history.json")))
    assert {k: v for k, v in dp_hist.items() if k != "time_s"} == \
        {k: v for k, v in hist.items() if k != "time_s"}


# ------------------------------------------------------------ training


@pytest.mark.parametrize("detector", ["dfine", "yolo"])
def test_train_bscan_writes_reference_checkpoints(setup, detector):
    out = str(setup["root"] / f"train_{detector}")
    tcli.main(["train-bscan", "--data", setup["raw"], "--out", out,
               "--detector", detector, "--size", str(SIZE), "--epochs", "1",
               "--batch-size", "4", "--device", "cpu"])
    meta = json.load(open(os.path.join(out, "metadata.json")))
    want = {"detector": detector, "num_classes": 1, "size": SIZE,
            "scale": "n", "flavour": "v8"}
    assert want.items() <= meta.items()
    assert set(meta) == set(want) | ({"dfine_config"} if detector == "dfine"
                                     else set())
    hist = json.load(open(os.path.join(out, "history.json")))
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in hist.values())
    if detector == "dfine":
        model, _, _ = restore_dfine(out, device="cpu")
        assert model.cfg.num_labels == 1
        tcli.main(["predict-bscan", "--data", setup["raw"], "--out",
                   out + "_pred", "--checkpoint", out, "--size", str(SIZE),
                   "--device", "cpu"])
        assert len(_detections(out + "_pred")["v"]) == 12
    else:
        state, _ = CheckpointManager(out).restore("latest")
        load_model_state(tyolo.YOLO(tyolo.YoloConfig(num_classes=1),
                                    device="cpu"), state)


def test_train_temporal_tiny(setup):
    out = str(setup["root"] / "temporal")
    tcli.main(["train-temporal", "--data", setup["raw"], "--out", out,
               "--variant", "v3", "--size", str(SIZE), "--seq-len", "4",
               "--epochs", "1", "--temporal-layers", "1", "--tiny",
               "--lr", "1e-4", "--device", "cpu"])
    meta = json.load(open(os.path.join(out, "metadata.json")))
    assert meta == {"variant": "v3", "seq_len": 4, "num_classes": 2,
                    "defect_classes": 2, "num_temporal_labels": 3,
                    "size": SIZE}
    losses = json.load(open(os.path.join(out, "history.json")))["loss"]
    assert losses and all(np.isfinite(losses))
    state, _ = CheckpointManager(out).restore("latest")
    model = TemporalDFine(ttemporal.tiny_temporal_config(2), variant="v3",
                          num_temporal_labels=3, num_temporal_layers=1,
                          temporal_heads=4, device="cpu")
    load_model_state(model, state)


# ------------------------------------------------------------ the parser


def _reference_parser(monkeypatch):
    """The parser ``pautdx.cli.main`` builds, caught at its parse."""
    seen = {}

    def catch(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(SystemExit):
            jcli.main([])
    return seen["parser"]


def _options(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.choices,
                            a.type, a.required)
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


def test_same_subcommands_flags_and_defaults(monkeypatch):
    want = _options(_reference_parser(monkeypatch))
    got = _options(tcli.build_parser())
    assert list(got) == list(want) and len(got) == 11
    for name in want:
        extra = {"device": (("--device",), "cuda", None, None, False)}
        assert got[name] == (want[name] if name == "explain"
                             else {**want[name], **extra}), name


def test_cuda_without_a_card_raises(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["predict-bscan", "--data", setup["raw"], "--out",
                   str(setup["root"] / "nocard"), "--size", str(SIZE)])
