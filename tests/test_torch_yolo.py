"""pautdx_torch's YOLOv8n-seg predict slice held to the JAX reference on the
CPU: the same numpy weights and inputs go through both packages.

One module-scoped JAX init of the seg model (the det model's variables are
its subset); every BN statistic, scale and bias is then randomised so that
a wrong leaf mapping shows in the outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from scipy.optimize import linear_sum_assignment

from pautdx.models.vision import yolo as jyolo
from pautdx.ops import dense_to_detections as j_dense_to_detections
from pautdx_torch.compat.jax_weights import flatten, load_jax_variables
from pautdx_torch.models.vision import yolo as tyolo
from pautdx_torch.serve import yolo_predict
from pautdx_torch.serve.endpoints import DetectorEndpoint
from torch_threads import one_torch_thread  # noqa: F401

IMG = 64
CHAIN_IMG = 128         # 16x16 + 8x8 + 4x4 = 336 anchors, over top_k 300


def _randomise(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise(v, rng)
            continue
        v = np.asarray(v)
        if k in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, v.shape)
        elif k == "scale":
            v = 1.0 + rng.normal(0.0, 0.1, v.shape)
        elif k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_model():
    cfg = yolo_predict.yolo_serving_config()
    variables = jax.jit(lambda k: jyolo.YOLO(_jcfg(cfg)).init(
        {"params": k}, jnp.zeros((1, IMG, IMG, 3)), train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    variables = _randomise(jax.tree_util.tree_map(np.asarray,
                                                  dict(variables)), rng)
    img = rng.integers(0, 256, size=(2, CHAIN_IMG, CHAIN_IMG, 3)
                       ).astype(np.uint8)
    return cfg, variables, img


def _jcfg(cfg):
    return jyolo.YoloConfig(num_classes=cfg.num_classes, scale=cfg.scale,
                            flavour=cfg.flavour, reg_max=cfg.reg_max,
                            num_protos=cfg.num_protos, seg=cfg.seg)


def _det_only(variables):
    return {c: {k: v for k, v in variables[c].items()
                if k not in ("proto", "mask_head")} for c in variables}


def _port(cfg, variables):
    return load_jax_variables(tyolo.YOLO(cfg, device="cpu"), variables,
                              device="cpu")


def test_config_matches_reference():
    cfg = yolo_predict.yolo_serving_config()
    j = _jcfg(cfg)
    assert cfg == tyolo.YoloConfig(num_classes=1, scale="n", seg=True)
    for w in (64, 128, 256, 512, 1024):
        assert cfg.width(w) == j.width(w)
    for d in (1, 3, 6, 9):
        assert cfg.depth(d) == j.depth(d)
    assert cfg.proto_channels == j.proto_channels == 64
    assert cfg.stage_depths == j.stage_depths


def test_width_matches_ultralytics_yaml_tables():
    """The table of tests/test_yolo.py:194-214, through the port's copy."""
    expected = {
        ("v8", "n", 1024): 256,
        ("v8", "s", 1024): 512,
        ("v8", "m", 1024): 576,     # min(1024, 768) * 0.75
        ("v5u", "m", 1024): 576,
        ("v11", "n", 1024): 256,
        ("v11", "s", 1024): 512,
        ("v11", "m", 1024): 512,    # min(1024, 512) * 1.0
        ("v8", "n", 256): 64,
        ("v11", "m", 256): 256,
    }
    for (flavour, scale, w), want in expected.items():
        got = tyolo.YoloConfig(num_classes=1, scale=scale,
                               flavour=flavour).width(w)
        assert got == want, (flavour, scale, w, got, want)
        assert got == jyolo.YoloConfig(num_classes=1, scale=scale,
                                       flavour=flavour).width(w)


@pytest.mark.parametrize("flavour", ["v9", "v5u", "yolo11"])
def test_unknown_flavour_raises(flavour):
    with pytest.raises(ValueError, match="known: v8, v5, v9c, v11"):
        tyolo.YOLO(tyolo.YoloConfig(flavour=flavour), device="cpu")


def test_input_must_be_a_multiple_of_32():
    model = tyolo.YOLO(tyolo.YoloConfig(), device="cpu")
    with pytest.raises(ValueError, match="multiple of 32"):
        model(torch.zeros(1, 68, 68, 3))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_transpose_rule(stride):
    """A lone flax ConvTranspose against the port's layer loaded through
    load_jax_variables: the kernel is flipped in space, at 1e-6. A non-square
    3x5 kernel shows a flip of either axis alone (stride 1, VALID)."""
    rng = np.random.default_rng(stride)
    kernel = (2, 2) if stride == 2 else (3, 5)
    padding = "SAME" if stride == 2 else "VALID"
    layer = fnn.ConvTranspose(6, kernel, strides=(stride, stride),
                              padding=padding)
    x = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
    variables = layer.init(jax.random.PRNGKey(stride), jnp.asarray(x))
    # weights at 0.1 scale: f32 rounding of the 60-term sums stays far
    # under 1e-6, while a kernel loaded unflipped moves outputs by ~0.1
    variables = jax.tree_util.tree_map(
        lambda a: 0.1 * rng.normal(size=a.shape).astype(np.float32),
        dict(variables))
    want = layer.apply(variables, jnp.asarray(x))

    port = torch.nn.Sequential()
    port.up = torch.nn.ConvTranspose2d(4, 6, kernel, stride)
    load_jax_variables(port, {"params": {"up": variables["params"]}},
                       device="cpu")
    with torch.no_grad():
        got = port.up(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6, rtol=1e-6)


def test_load_jax_variables_is_strict(jax_model):
    cfg, variables, _ = jax_model
    model = _port(cfg, variables)
    n_jax = len(flatten(variables["params"])) + len(
        flatten(variables["batch_stats"]))
    assert n_jax == len(model.state_dict())
    w = variables["params"]["proto"]["upsample"]["kernel"]
    np.testing.assert_array_equal(
        model.proto.upsample.weight.detach().numpy(),
        w[::-1, ::-1].transpose(2, 3, 0, 1))
    with pytest.raises(KeyError, match="unused"):
        _port(tyolo.YoloConfig(), variables)        # det model, seg leaves


def _images(img, side=IMG):
    return img[:, :side, :side].astype(np.float32) / 255.0


@pytest.mark.parametrize("seg", [False, True])
def test_model_matches_reference(jax_model, seg):
    """v8n at 64px, batch 2, f32: every level's box/cls, the protos and the
    mask coefficients at atol = rtol = 1e-4."""
    cfg, variables, img = jax_model
    cfg = tyolo.YoloConfig(**{**cfg.__dict__, "seg": seg})
    variables = variables if seg else _det_only(variables)
    x = _images(img)
    want = jyolo.YOLO(_jcfg(cfg)).apply(variables, jnp.asarray(x),
                                        train=False)
    with torch.no_grad():
        got = _port(cfg, variables)(torch.from_numpy(x))
    assert len(got["levels"]) == len(want["levels"]) == 3
    pairs = [(g[k], w[k]) for g, w in zip(got["levels"], want["levels"])
             for k in ("box", "cls")]
    assert ("protos" in got) == seg
    if seg:
        pairs.append((got["protos"], want["protos"]))
        pairs += list(zip(got["mask_coeffs"], want["mask_coeffs"]))
    for g, w in pairs:
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_decode_boxes_matches_reference(jax_model):
    cfg, variables, img = jax_model
    x = _images(img)
    jout = jyolo.YOLO(_jcfg(cfg)).apply(variables, jnp.asarray(x),
                                        train=False)
    want = jyolo.decode_boxes(jout, (IMG, IMG), _jcfg(cfg))
    # the port decodes the same raw outputs, handed over as numpy
    raw = {"levels": [{k: torch.from_numpy(np.array(v))
                       for k, v in lvl.items()} for lvl in jout["levels"]],
           "mask_coeffs": [torch.from_numpy(np.array(c))
                           for c in jout["mask_coeffs"]]}
    got = tyolo.decode_boxes(raw, (IMG, IMG), cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def chains(jax_model):
    """The predict chain at 128px on both sides, nms() defaults."""
    cfg, variables, img = jax_model
    jcfg = _jcfg(cfg)
    x = jnp.asarray(img.astype(np.float32) / 255.0)
    out = jyolo.YOLO(jcfg).apply(variables, x, train=False)
    d = jyolo.decode_boxes(out, (CHAIN_IMG, CHAIN_IMG), jcfg)
    det = j_dense_to_detections(d)
    coeffs = jnp.take_along_axis(d["coeffs"], det["indices"][..., None],
                                 axis=1)
    det["masks"] = jyolo.assemble_masks(out["protos"], coeffs, det["boxes"],
                                        (CHAIN_IMG, CHAIN_IMG))
    want = {k: np.asarray(v) for k, v in det.items()}
    predictor = yolo_predict.build_yolo_predictor(variables, device="cpu")
    got = {k: v.numpy() for k, v in predictor(torch.from_numpy(img)).items()}
    return predictor, got, want


def test_predict_chain_matches_reference(chains):
    """Detections matched by assignment per frame: box L1 < 1e-2 px and
    score within 1e-4, at most one unmatched detection per frame; the
    matched detections' masks at 1e-4."""
    _, got, want = chains
    assert set(got) == set(want)
    assert got["masks"].shape == (2, 100, CHAIN_IMG // 4, CHAIN_IMG // 4)
    for b in range(2):
        gi = np.nonzero(got["valid"][b])[0]
        wi = np.nonzero(want["valid"][b])[0]
        assert len(gi) > 3
        gb, wb = got["boxes"][b][gi], want["boxes"][b][wi]
        gs, ws = got["scores"][b][gi], want["scores"][b][wi]
        cost = (np.abs(gb[:, None] - wb[None]).sum(-1)
                + np.abs(gs[:, None] - ws[None]))
        r, c = linear_sum_assignment(cost)
        ok = [(i, j) for i, j in zip(gi[r], wi[c])
              if np.abs(got["boxes"][b, i] - want["boxes"][b, j]).sum() < 1e-2
              and abs(got["scores"][b, i] - want["scores"][b, j]) < 1e-4]
        assert max(len(gi), len(wi)) - len(ok) <= 1, (len(gi), len(wi),
                                                      len(ok))
        for i, j in ok:
            assert got["classes"][b, i] == want["classes"][b, j]
            np.testing.assert_allclose(got["masks"][b, i],
                                       want["masks"][b, j], atol=1e-4,
                                       rtol=1e-4)


def test_detector_endpoint_schema(chains, jax_model):
    """The bridge schema per frame, [{box, label, score}], from the
    predictor's detections at the endpoint's threshold."""
    predictor, got, _ = chains
    _, _, img = jax_model
    ep = DetectorEndpoint(predictor.forward, threshold=0.3, device="cpu")
    frames = ep.predict(img)
    assert len(frames) == 2
    for b, frame in enumerate(frames):
        keep = got["valid"][b] & (got["scores"][b] >= 0.3)
        assert len(frame) == keep.sum()
        for det, i in zip(frame, np.nonzero(keep)[0]):
            assert set(det) == {"box", "label", "score"}
            assert det["label"] == got["classes"][b, i]
            np.testing.assert_allclose(det["box"], got["boxes"][b, i],
                                       rtol=1e-6)
            assert det["score"] == pytest.approx(float(got["scores"][b, i]))


def test_forward_takes_any_image_layout(monkeypatch):
    """Images laid out NCHW in memory (``x_nchw.permute(0, 2, 3, 1)``, the
    usual PyTorch form) give the predictions of dense NHWC ones, and the
    mask kernel's wrapper gets dense protos either way, as the card's
    kernel needs them."""
    predictor = yolo_predict.build_yolo_predictor(device="cpu", seed=5)
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(2, CHAIN_IMG, CHAIN_IMG, 3)).astype(np.float32))
    seen = []
    assemble = yolo_predict.mask_ops.assemble_masks

    def checked(protos, *args):
        seen.append(protos.is_contiguous())
        return assemble(protos, *args)

    monkeypatch.setattr(yolo_predict.mask_ops, "assemble_masks", checked)
    dense = predictor.forward(x)
    permuted = predictor.forward(x.permute(0, 3, 1, 2).contiguous()
                                 .permute(0, 2, 3, 1))
    assert seen == [True, True]
    assert dense["valid"].any()
    for k in ("valid", "indices", "classes"):
        assert torch.equal(permuted[k], dense[k]), k
    for k in ("boxes", "scores", "masks"):
        torch.testing.assert_close(permuted[k], dense[k], atol=1e-4,
                                   rtol=1e-4)


def test_forward_owns_its_precision(monkeypatch):
    """The model runs with TF32 off in cuDNN and in GEMMs whatever the
    caller set, and the caller's settings come back after."""
    predictor = yolo_predict.build_yolo_predictor(device="cpu", seed=5)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    run = predictor.model.forward

    def recorded(images):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return run(images)

    monkeypatch.setattr(predictor.model, "forward", recorded)
    predictor(torch.zeros(1, CHAIN_IMG, CHAIN_IMG, 3, dtype=torch.uint8))
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_yolo_stream_runs_every_step():
    predictor = yolo_predict.build_yolo_predictor(device="cpu", seed=3)
    slab = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 1, CHAIN_IMG, CHAIN_IMG, 3)).astype(np.uint8))
    out, finite = yolo_predict.make_yolo_stream(predictor)(slab)
    assert bool(finite)
    assert out["masks"].shape == (1, 100, CHAIN_IMG // 4, CHAIN_IMG // 4)
    with pytest.raises(TypeError, match="uint8"):
        predictor(slab[0].float())
