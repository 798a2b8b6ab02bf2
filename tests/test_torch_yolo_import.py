"""pautdx_torch's Ultralytics loader held to torch replicas of the
Ultralytics module tree (``tests/test_yolo_import.py`` builds them; the
repo ships no ``.pt`` and nothing is downloaded).

The replicas' weights are redrawn N(0, 1/fan_in), BN weights 1 +- 0.1,
after ``_randomize`` has drawn their biases and BN statistics: at the
reference test's uniform(+-0.12) weights the activations shrink until a
mirrored proto upsample kernel hides under its tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.compat.yolo_import import convert_yolo_state_dict
from pautdx.models.vision import yolo as jyolo
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.compat.yolo_import import (
    load_ultralytics_state_dict, load_yolo_pt,
)
from pautdx_torch.models.vision import yolo as tyolo
from pautdx_torch.serve.yolo_predict import yolo_config
from tests.test_yolo_import import TYolo, TYoloV11, TYoloV9C, _randomize
from torch_threads import one_torch_thread  # noqa: F401

IMG = 64
NC = 3
ATOL = RTOL = 1e-5          # torch against torch: the same math
REF_ATOL = 2e-4             # tests/test_yolo_import.py's tolerance
NAMES = ("yolov8n-seg", "yolov5su", "yolov9c-seg", "yolo11n")


def _redraw(tm: torch.nn.Module, seed: int) -> torch.nn.Module:
    _randomize(tm, seed)
    g = torch.Generator().manual_seed(seed + 1000)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.ConvTranspose2d):
                # (in, out, kh, kw): a 2x2/s2 output pixel sees one tap
                # of every input channel
                m.weight.normal_(0.0, m.weight.shape[0] ** -0.5,
                                 generator=g)
            elif isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                 generator=g)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.9, 1.1, generator=g)
    return tm


def _cfg(name):
    return dataclasses.replace(yolo_config(name), num_classes=NC)


@functools.lru_cache(maxsize=None)
def _replica(name):
    """The replica of ``name`` (NC classes, redrawn weights), 64px NHWC
    inputs, and its outputs on them."""
    cfg = _cfg(name)
    cls = {"v9c": TYoloV9C, "v11": TYoloV11}.get(cfg.flavour, TYolo)
    rep = _redraw(cls(cfg, NC).eval(), NAMES.index(name))
    x = np.random.default_rng(7).uniform(
        size=(2, IMG, IMG, 3)).astype(np.float32)
    with torch.no_grad():
        want = rep(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    return cfg, rep, x, want


def _outputs(port, x):
    """The port's raw outputs on NHWC ``x``, laid out as the replica's:
    [(box, cls)] per level, protos and coefficients NCHW."""
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    out = {"levels": [(lvl["box"].permute(0, 3, 1, 2),
                       lvl["cls"].permute(0, 3, 1, 2))
                      for lvl in got["levels"]]}
    if "protos" in got:
        out["protos"] = got["protos"].permute(0, 3, 1, 2)
        out["coeffs"] = [c.permute(0, 3, 1, 2) for c in got["mask_coeffs"]]
    return out


def _close(got, want, atol=ATOL, rtol=RTOL, protos=True):
    pairs = [(g, w) for gl, wl in zip(got["levels"], want["levels"])
             for g, w in zip(gl, wl)]
    assert len(pairs) == 6
    assert ("protos" in got) == ("protos" in want)
    if "protos" in want:
        pairs += list(zip(got["coeffs"], want["coeffs"]))
        if protos:
            pairs.append((got["protos"], want["protos"]))
    for g, w in pairs:
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol,
                                   rtol=rtol)


def _loaded(cfg, sd):
    port = tyolo.YOLO(cfg, device="cpu", seed=99)
    unused = load_ultralytics_state_dict(port, sd, cfg.flavour)
    return port, unused


@pytest.mark.parametrize("name", NAMES)
def test_loader_matches_replica(name):
    """Each replica's state dict loads strictly, nothing left unused, and
    the port then gives the replica's outputs."""
    cfg, rep, x, want = _replica(name)
    port, unused = _loaded(cfg, rep.state_dict())
    assert unused == []
    _close(_outputs(port, x), want)
    if cfg.seg:
        # the weights are large enough that the protos carry signal
        assert want["protos"].abs().max() > 0.05


def _flipped_upsample(sd):
    return {k: v.flip(-2, -1) if k.endswith("proto.upsample.weight") else v
            for k, v in sd.items()}


@pytest.mark.parametrize("name", ["yolov8n-seg", "yolov9c-seg"])
def test_mirrored_upsample_shows(name):
    """Control: the proto upsample kernel loaded flipped in space moves the
    protos by more than 10x the reference test's tolerance; the levels,
    which do not pass through it, stay put."""
    cfg, rep, x, want = _replica(name)
    port, _ = _loaded(cfg, _flipped_upsample(rep.state_dict()))
    got = _outputs(port, x)
    delta = (got["protos"] - want["protos"]).abs().max().item()
    print(f"{name}: mirrored upsample, protos max |delta| {delta:.4g}")
    assert delta > 10 * REF_ATOL, delta
    _close(got, want, protos=False)


def test_reference_transpose_mirrors_a_lone_layer():
    """A torch ``ConvTranspose2d`` (k 2, s 2) in a flax ``ConvTranspose``:
    the reference importer's transpose alone, (I, O, kh, kw) -> (kh, kw,
    I, O), gives another output; with the kernel also flipped in space the
    two agree."""
    from flax import linen as fnn

    rng = np.random.default_rng(21)
    layer = torch.nn.ConvTranspose2d(8, 6, 2, 2)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            rng.normal(size=(8, 6, 2, 2)).astype(np.float32)))
    x = rng.normal(size=(2, 5, 7, 8)).astype(np.float32)
    with torch.no_grad():
        want = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    w = layer.weight.detach().numpy().transpose(2, 3, 0, 1)
    flax_layer = fnn.ConvTranspose(6, (2, 2), strides=(2, 2))
    outs = [np.asarray(flax_layer.apply(
        {"params": {"kernel": k, "bias": layer.bias.detach().numpy()}}, x))
        for k in (w, w[::-1, ::-1])]
    delta = np.abs(outs[0] - want).max()
    print(f"lone ConvTranspose2d, the reference's transpose: max |delta| "
          f"{delta:.4g}")
    assert delta > 1.0
    np.testing.assert_allclose(outs[1], want, atol=ATOL, rtol=RTOL)


def test_reference_weights_hide_the_mirror():
    """Why the redraw: at ``tests/test_yolo_import.py``'s own weights and
    input (v8n-seg, two classes, ``_randomize`` seed 3, N(0, 1) pixels)
    the mirrored upsample kernel moves the protos by less than that test's
    atol, so its seg parity passes with the mirror in place."""
    cfg = tyolo.YoloConfig(num_classes=2, scale="n", flavour="v8", seg=True)
    rep = TYolo(cfg, 2).eval()
    _randomize(rep, 3)
    x = np.random.default_rng(3).normal(
        size=(1, 3, IMG, IMG)).astype(np.float32)
    with torch.no_grad():
        want = rep(torch.from_numpy(x))["protos"]
    port, _ = _loaded(cfg, _flipped_upsample(rep.state_dict()))
    got = _outputs(port, x.transpose(0, 2, 3, 1).copy())["protos"]
    delta = (got - want).abs().max().item()
    print(f"reference weights: mirrored protos max |delta| {delta:.4g}")
    assert 0 < delta < REF_ATOL


@pytest.fixture(scope="module")
def v8n_seg_jax_target():
    cfg = _cfg("yolov8n-seg")
    jcfg = jyolo.YoloConfig(num_classes=NC, scale=cfg.scale,
                            flavour=cfg.flavour, seg=True)
    return jax.jit(lambda k: jyolo.YOLO(jcfg).init(
        {"params": k}, jnp.zeros((1, IMG, IMG, 3)), train=False))(
        jax.random.PRNGKey(0))


def test_reference_importer_mirrors_the_upsample(v8n_seg_jax_target):
    """The same replica through the reference's ``convert_yolo_state_dict``
    (a transpose without the spatial flip a flax ``ConvTranspose`` needs)
    and the port's JAX bridge: the detect levels and coefficients agree
    with the replica, the protos come out as with the kernel mirrored,
    more than 10x the reference test's tolerance from the replica's."""
    cfg, rep, x, want = _replica("yolov8n-seg")
    sd = {k: v.numpy() for k, v in rep.state_dict().items()}
    variables, unused = convert_yolo_state_dict(
        sd, jax.tree_util.tree_map(np.asarray, dict(v8n_seg_jax_target)),
        cfg.flavour)
    assert unused == []
    via_jax = load_jax_variables(tyolo.YOLO(cfg, device="cpu"), variables,
                                 device="cpu")
    got = _outputs(via_jax, x)
    _close(got, want, atol=REF_ATOL, rtol=1e-3, protos=False)
    delta = (got["protos"] - want["protos"]).abs().max().item()
    print(f"reference importer + JAX bridge: protos max |delta| {delta:.4g}")
    assert delta > 10 * REF_ATOL, delta
    mirrored, _ = _loaded(cfg, _flipped_upsample(rep.state_dict()))
    np.testing.assert_allclose(got["protos"].numpy(),
                               _outputs(mirrored, x)["protos"].numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["yolov8n-seg", "yolo11n"])
def test_pt_round_trip(name, tmp_path):
    """``torch.save`` of the state dict, read back by ``load_yolo_pt``,
    raw and under ``"state_dict"``, loads to the same outputs."""
    cfg, rep, x, want = _replica(name)
    raw = tmp_path / "raw.pt"
    wrapped = tmp_path / "wrapped.pt"
    torch.save(rep.state_dict(), raw)
    torch.save({"state_dict": rep.state_dict()}, wrapped)
    for path in (raw, wrapped):
        sd = load_yolo_pt(str(path))
        assert set(sd) == set(rep.state_dict())
        assert all(v.dtype == torch.float32 for v in sd.values())
        port, unused = _loaded(cfg, sd)
        assert unused == []
        _close(_outputs(port, x), want)


def _v11n_state_dict():
    cfg, rep, _, _ = _replica("yolo11n")
    return cfg, dict(rep.state_dict())


def test_loader_is_strict():
    cfg, sd = _v11n_state_dict()
    key = "model.10.m.0.attn.qkv.conv.weight"
    with pytest.raises(KeyError, match="no Ultralytics source"):
        _loaded(cfg, {k: v for k, v in sd.items() if k != key})
    with pytest.raises(ValueError, match="backbone.psa.m.0.attn.qkv"):
        _loaded(cfg, {**sd, key: sd[key][:, :-1]})
    with pytest.raises(ValueError, match="unsupported flavour 'v9'"):
        load_ultralytics_state_dict(tyolo.YOLO(cfg, device="cpu"), sd, "v9")
    # a key past the layer table, one no module takes and one without a
    # layer index come back unused
    extra = {"model.11.foo.weight": torch.zeros(1),
             "model.23.cv9.0.0.conv.weight": torch.zeros(1),
             "stride": torch.zeros(3)}
    _, unused = _loaded(cfg, {**sd, **extra})
    assert sorted(unused) == sorted(extra)


def test_loader_checks_the_dfl_weight():
    """Ultralytics' DFL conv holds arange(reg_max), fixed; the port computes
    with exactly that, so the loader takes it only if it is."""
    cfg, sd = _v11n_state_dict()
    key = "model.23.dfl.conv.weight"
    dfl = torch.arange(16, dtype=torch.float32).view(1, 16, 1, 1)
    _, unused = _loaded(cfg, {**sd, key: dfl,
                              "model.1.bn.num_batches_tracked":
                              torch.tensor(7)})
    assert unused == []
    bad = dfl.clone()
    bad[0, 3] = 2.5
    for wrong in (bad, dfl.view(1, 16)):
        with pytest.raises(ValueError, match="arange"):
            _loaded(cfg, {**sd, key: wrong})
