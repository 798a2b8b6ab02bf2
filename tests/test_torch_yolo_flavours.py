"""pautdx_torch's YOLO flavours v5u, v9c and v11 held to the JAX reference
on the CPU: the same numpy weights and inputs go through both packages.

One module-scoped, jitted JAX init per configuration (YOLOv5su,
YOLOv9c-seg and YOLO11n at their published widths and depths, one class),
with every BN statistic, scale and bias then randomised as in
``tests/test_torch_yolo.py``; 64px batch 2 for the raw outputs, 128px for
the decode and NMS chain at each configuration's served settings.

At those weights the activations shrink layer by layer (a small input
comes out of SiLU at half its size) until the biases carry the deep
trunks' outputs, and a 2 % change in ADown or a wrong PSA scale stays
under the tolerance. So the raw outputs are also compared at calibrated
statistics: each BN's running mean and variance are its input's over the
batch (the variance plus ``FLOOR``), as in a trained network, so every
layer passes on a signal that neither fades nor blows up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.models.vision import yolo as jyolo
from pautdx.ops import dense_to_detections as j_dense_to_detections
from pautdx_torch.compat.jax_weights import flatten, load_jax_variables
from pautdx_torch.models.vision import yolo as tyolo
from pautdx_torch.serve import yolo_predict
from tests.test_torch_yolo import _jcfg, _randomise
from torch_threads import one_torch_thread  # noqa: F401

IMG = 64
# added to each calibrated running variance: a channel of small spread
# then passes at a gain near one (1 / sqrt(0.25) times SiLU's 1/2 near 0)
# instead of amplifying f32 rounding until both packages stray from a
# float64 run by 0.2 at v9c's P5 (without it, at 64px, P5's statistics
# come from 8 values a channel)
FLOOR = 0.25
CHAIN_IMG = 128         # 336 anchors: over the seg chain's top_k 300
# the reference's NMS settings for each model: nms()'s defaults for the
# seg chain, the CLI's YOLO head's (pautdx/cli.py:346-350) for detectors
REFERENCE_NMS = {
    "yolov9c-seg": {},
    "yolo11n": {"score_threshold": 0.3, "top_k": 64, "max_det": 16},
    "yolov5su": {"score_threshold": 0.3, "top_k": 64, "max_det": 16},
}
NAMES = ("yolov5su", "yolov9c-seg", "yolo11n")
# the GELAN trunk is about 3x deeper: conv-order drift accumulates, as in
# tests/test_yolo_import.py's v9c-seg case
TOL = {"yolov5su": (2e-4, 1e-3), "yolov9c-seg": (2e-3, 5e-3),
       "yolo11n": (2e-4, 1e-3)}
# Ultralytics' model summaries at nc = 80, less the DFL's 16 fixed weights
PARAMS_NC80 = {"yolov9c-seg": 27_897_104, "yolo11n": 2_624_064,
               "yolov5su": 9_153_136}


def _with_stats(tree, stats, prefix=""):
    """``tree`` with each leaf whose dotted path is in ``stats`` replaced."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out[k] = (_with_stats(v, stats, path) if isinstance(v, dict)
                  else stats.get(path, v))
    return out


def _calibrated(cfg, variables, x):
    """``variables`` with every BN's running mean and (biased) variance
    set to its input's over the batch of ``x``, layer after layer in one
    forward of the port."""
    port = load_jax_variables(tyolo.YOLO(cfg, device="cpu"), variables,
                              device="cpu")
    names = {m: n for n, m in port.named_modules()}
    stats = {}

    def calibrate(bn, args):
        h = args[0]
        bn.running_mean.copy_(h.mean((0, 2, 3)))
        bn.running_var.copy_(h.var((0, 2, 3), unbiased=False) + FLOOR)
        stats[f"{names[bn]}.mean"] = bn.running_mean.numpy().copy()
        stats[f"{names[bn]}.var"] = bn.running_var.numpy().copy()

    for m in names:
        if isinstance(m, tyolo.BatchNorm):
            m.register_forward_pre_hook(calibrate)
    with torch.no_grad():
        port(torch.from_numpy(x))
    assert len(stats) == len(flatten(variables["batch_stats"]))
    return {**variables,
            "batch_stats": _with_stats(variables["batch_stats"], stats)}


@pytest.fixture(scope="module", params=NAMES)
def flavour(request):
    """(name, cfg, the JAX variables randomised and calibrated, the JAX
    outputs at 64px with each and at 128px as numpy, the 64px images)."""
    name = request.param
    cfg = yolo_predict.yolo_config(name)
    model = jyolo.YOLO(_jcfg(cfg))
    variables = jax.jit(lambda k: model.init(
        {"params": k}, jnp.zeros((1, IMG, IMG, 3)), train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(NAMES.index(name))
    variables = _randomise(jax.tree_util.tree_map(np.asarray,
                                                  dict(variables)), rng)
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
    x64 = rng.uniform(size=(2, IMG, IMG, 3)).astype(np.float32)
    x128 = rng.uniform(size=(2, CHAIN_IMG, CHAIN_IMG, 3)).astype(np.float32)
    calibrated = _calibrated(cfg, variables, x64)
    out64, out128, cal64 = (
        jax.tree_util.tree_map(np.asarray, apply(v, x))
        for v, x in ((variables, x64), (variables, x128),
                     (calibrated, x64)))
    return (name, cfg, {"randomised": variables, "calibrated": calibrated},
            {"randomised": out64, "calibrated": cal64}, out128, x64)


def _pairs(got, want):
    pairs = [(g[k], w[k]) for g, w in zip(got["levels"], want["levels"])
             for k in ("box", "cls")]
    assert len(pairs) == 6
    assert ("protos" in got) == ("protos" in want)
    if "protos" in want:
        pairs.append((got["protos"], want["protos"]))
        pairs += list(zip(got["mask_coeffs"], want["mask_coeffs"]))
    return pairs


@pytest.mark.parametrize("stats", ["randomised", "calibrated"])
def test_model_matches_reference(flavour, stats):
    """Every level's box and cls logits, and for seg the protos and the
    mask coefficients, at 64px batch 2 in f32."""
    name, cfg, variables, outs, _, x = flavour
    want = outs[stats]
    port = load_jax_variables(tyolo.YOLO(cfg, device="cpu"),
                              variables[stats], device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    atol, rtol = TOL[name]
    for g, w in _pairs(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=rtol)


def _to_torch(out):
    raw = {"levels": [{k: torch.from_numpy(np.array(v))
                       for k, v in lvl.items()} for lvl in out["levels"]]}
    if "protos" in out:
        raw["protos"] = torch.from_numpy(np.array(out["protos"]))
        raw["mask_coeffs"] = [torch.from_numpy(np.array(c))
                              for c in out["mask_coeffs"]]
    return raw


def test_chain_matches_reference(flavour):
    """``yolo_predict.postprocess`` (decode, NMS at the configuration's
    served settings and, for seg, the kept anchors' masks) on the same raw
    outputs at 128px: the JAX chain's detections at the reference's own
    settings for that model."""
    name, cfg, _, _, out, _ = flavour
    jcfg = _jcfg(cfg)
    size = (CHAIN_IMG, CHAIN_IMG)
    jd = jyolo.decode_boxes(jax.tree_util.tree_map(jnp.asarray, out), size,
                            jcfg)
    want = j_dense_to_detections(jd, **REFERENCE_NMS[name])
    if cfg.seg:
        coeffs = jnp.take_along_axis(jd["coeffs"], want["indices"][..., None],
                                     axis=1)
        want["masks"] = jyolo.assemble_masks(jnp.asarray(out["protos"]),
                                             coeffs, want["boxes"], size)
    got = yolo_predict.postprocess(_to_torch(out), size, cfg)
    want = {k: np.asarray(v) for k, v in want.items()}
    max_det = REFERENCE_NMS[name].get("max_det", 100)
    assert got["boxes"].shape == (2, max_det, 4)
    assert set(got) == set(want)
    assert want["valid"].sum(1).min() > 3
    for k in ("valid", "classes", "indices"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("boxes", "scores") + (("masks",) if cfg.seg else ()):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", sorted(PARAMS_NC80))
def test_parameter_count_at_80_classes(name):
    """The port's parameter count at nc = 80 is the JAX tree's (from
    ``jax.eval_shape``, nothing computed) and Ultralytics' published one
    less the DFL's fixed conv."""
    cfg = tyolo.YoloConfig(**{**yolo_predict.yolo_config(name).__dict__,
                              "num_classes": 80})
    port = sum(p.numel() for p in tyolo.YOLO(cfg, device="cpu").parameters())
    shapes = jax.eval_shape(lambda k: jyolo.YOLO(_jcfg(cfg)).init(
        {"params": k}, jnp.zeros((1, IMG, IMG, 3)), train=False),
        jax.random.PRNGKey(0))
    ref = sum(int(np.prod(s.shape))
              for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert port == ref == PARAMS_NC80[name]


def test_psa_attention_matches_reference():
    """``PSAAttention`` alone on a non-square 3x5 map, two heads of 64
    (key dim 32): the head-major qkv layout, the spatial softmax and the
    depthwise positional branch on v."""
    C, heads = 128, 2
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 3, 5, C)).astype(np.float32)
    jmod = jyolo.PSAAttention(heads)
    variables = jax.jit(lambda k: jmod.init(k, jnp.zeros((1, 3, 5, C))))(
        jax.random.PRNGKey(1))
    variables = _randomise(jax.tree_util.tree_map(np.asarray,
                                                  dict(variables)), rng)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    port = load_jax_variables(tyolo.PSAAttention(C, heads).eval(),
                              variables, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-4, rtol=1e-4)
