"""pautdx_torch's D-FINE-nano serving slice held to the JAX reference on the
CPU: the same numpy weights and inputs go through both packages.

One module-scoped set of weights, drawn over ``jax.eval_shape``'s tree as
the JAX init draws them (no JAX init runs); every BN statistic, scale and
bias is randomised so that a wrong leaf mapping shows in the outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from pautdx.models.vision import dfine as jdf
from pautdx.models.vision.hgnet import HGNetV2 as JHGNetV2
from pautdx.serve import throughput as jthr
from pautdx_torch.compat.jax_weights import flatten, load_jax_variables
from pautdx_torch.models.vision import dfine as tdf
from pautdx_torch.models.vision.hgnet import HGNetConfig, HGNetV2
from pautdx_torch.serve import throughput as tthr
from torch_threads import one_torch_thread  # noqa: F401

# 224px: 14x14 + 7x7 = 245 anchors, so all 150 queries are selected
IMG = 224
PATCH = 8


def _jax_cfg():
    cfg = dataclasses.replace(jdf.dfine_nano(num_labels=2),
                              decoder_method="discrete",
                              encoder_fused_attn=True)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, stem_pre_patchified=True))


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


def random_variables(model, x, rng):
    """Variables of ``model``'s tree, from ``jax.eval_shape`` of its init
    on ``x`` (nothing of the init runs), drawn as that init draws them:
    kernels N(0, 1 / fan_in) (flax's lecun_normal, fan_in the product of
    all but the last axis), embeddings N(0, 1 / features); then every BN
    statistic, scale and bias randomised as ``_randomise`` does, so that a
    wrong leaf mapping shows."""
    shapes = jax.eval_shape(lambda k: model.init({"params": k}, x,
                                                 train=False),
                            jax.random.PRNGKey(0))

    def draw(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = draw(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = rng.normal(0.0, fan_in ** -0.5, v.shape)
            elif k == "embedding":
                out[k] = rng.normal(0.0, v.shape[-1] ** -0.5, v.shape)
            else:
                out[k] = np.zeros(v.shape, np.float32)
        return out

    return _randomise(draw(dict(shapes)), rng)


@pytest.fixture(scope="module")
def jax_model():
    cfg = _jax_cfg()
    side = IMG // PATCH
    rng = np.random.default_rng(0)
    variables = random_variables(
        jdf.DFine(cfg),
        jnp.zeros((1, side, side, PATCH * PATCH * 3), jnp.float32), rng)
    img = rng.integers(0, 256, size=(2, IMG, IMG, 3)).astype(np.uint8)
    return cfg, variables, img


def _port_model(variables):
    model = tdf.DFine(tthr.serving_config(), device="cpu")
    return load_jax_variables(model, variables, device="cpu")


def _assert_same_detections(t_logits, t_boxes, j_logits, j_boxes):
    """tests/test_dfine_parity.py:194-202: a bijection between the two
    query sets with tiny cost; a few queries at the top-k boundary may
    differ under float divergence."""
    def feats(boxes, logits):
        return np.concatenate([boxes, 1 / (1 + np.exp(-logits))], axis=-1)

    for b in range(t_logits.shape[0]):
        ft, fj = feats(t_boxes[b], t_logits[b]), feats(j_boxes[b], j_logits[b])
        cost = np.linalg.norm(ft[:, None, :] - fj[None, :, :], axis=-1)
        r, c = linear_sum_assignment(cost)
        matched = cost[r, c]
        assert (matched < 2e-3).sum() >= matched.shape[0] - 4, \
            np.sort(matched)[-6:]
        assert np.median(matched) < 1e-3


def test_config_copy_matches_reference():
    assert tdf.config_to_dict(tthr.serving_config()) == \
        jdf.config_to_dict(_jax_cfg())
    cfg = tdf.config_from_dict(tdf.config_to_dict(tthr.serving_config()))
    assert cfg == tthr.serving_config()


def test_closed_forms_match_reference():
    np.testing.assert_allclose(
        tdf.weighting_function(32, 0.5, 4.0).numpy(),
        np.asarray(jdf.weighting_function(32, 0.5, 4.0)), rtol=1e-6)
    np.testing.assert_array_equal(
        tdf.sincos_position_embedding(7, 5, 128),
        jdf.sincos_position_embedding(7, 5, 128))
    rng = np.random.default_rng(1)
    pts = rng.uniform(0.1, 0.9, (2, 6, 4)).astype(np.float32)
    dist = rng.normal(size=(2, 6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tdf.distance2bbox(torch.from_numpy(pts), torch.from_numpy(dist),
                          4.0).numpy(),
        np.asarray(jdf.distance2bbox(jnp.asarray(pts), jnp.asarray(dist),
                                     4.0)), rtol=1e-6, atol=1e-6)
    x = rng.uniform(-0.2, 1.2, (50,)).astype(np.float32)
    np.testing.assert_allclose(
        tdf.inverse_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jdf.inverse_sigmoid(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)


def test_post_process_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 150, 2)).astype(np.float32)
    boxes = rng.uniform(0, 1, (2, 150, 4)).astype(np.float32)
    want = jdf.post_process(jnp.asarray(logits), jnp.asarray(boxes),
                            (640, 480))
    got = tdf.post_process(torch.from_numpy(logits), torch.from_numpy(boxes),
                           (640, 480))
    for k in ("scores", "boxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-5)
    for k in ("classes", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_load_jax_variables_is_strict(jax_model):
    _, variables, _ = jax_model
    model = _port_model(variables)
    n_jax = len(flatten(variables["params"])) + len(
        flatten(variables["batch_stats"]))
    assert n_jax == len(model.state_dict())
    # dotted-flat input loads the same values as the nested tree
    flat = {"params": flatten(variables["params"]),
            "batch_stats": flatten(variables["batch_stats"])}
    other = _port_model(flat)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], v, rtol=0, atol=0)
    # a missing and an unused leaf both raise
    missing = dict(flat, params=dict(flat["params"]))
    missing["params"].pop("model.enc_score_head.bias")
    with pytest.raises(KeyError, match="without a JAX leaf"):
        _port_model(missing)
    extra = dict(flat, params=dict(flat["params"]))
    extra["params"]["model.extra.kernel"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="unused"):
        _port_model(extra)


def test_load_jax_variables_leaf_rules():
    """kernel -> transposed weight, also at the root; a shape that differs
    raises."""
    lin = torch.nn.Linear(2, 3)
    kernel = np.arange(6, dtype=np.float32).reshape(2, 3)
    load_jax_variables(lin, {"params": {"kernel": kernel,
                                        "bias": np.ones(3, np.float32)}},
                       device="cpu")
    np.testing.assert_array_equal(lin.weight.detach().numpy(), kernel.T)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_jax_variables(lin, {"params": {
            "kernel": np.zeros((3, 3), np.float32),
            "bias": np.ones(3, np.float32)}}, device="cpu")


def test_fold_uint8_stem_matches_reference(jax_model):
    _, variables, _ = jax_model
    model = tthr.fold_uint8_stem(_port_model(variables))
    want = jthr.fold_uint8_stem(variables)["params"][
        "model.backbone.model"]["patch_embedder"]["proj"]["kernel"]
    got = model.model.backbone.model.patch_embedder.proj.weight
    np.testing.assert_array_equal(got.detach().permute(2, 3, 1, 0).numpy(),
                                  np.asarray(want))


def test_prepatchify_matches_reference():
    img = np.random.default_rng(3).integers(
        0, 256, size=(2, 3, 32, 48, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tthr.prepatchify_uint8(img, 8),
                                  jthr.prepatchify_uint8(img, 8))


@pytest.mark.parametrize("pre_patchified,s2d", [(True, True), (False, True),
                                                (False, False)])
def test_backbone_matches_reference(jax_model, pre_patchified, s2d):
    """HGNet alone, f32, atol/rtol 1e-4: the space-to-depth stem on
    prepatchified slabs and on images, and the conv stem, which takes the
    same weights."""
    cfg, variables, img = jax_model
    bb = dataclasses.replace(cfg.backbone, stem_s2d=s2d,
                             stem_pre_patchified=pre_patchified)
    sub = {"params": variables["params"]["model.backbone.model"],
           "batch_stats": variables["batch_stats"]["model.backbone.model"]}
    x = img.astype(np.float32) / 255.0
    if pre_patchified:
        x = tthr.prepatchify_uint8(x, PATCH)
    want = JHGNetV2(bb).apply(sub, jnp.asarray(x), train=False)
    port = HGNetV2(HGNetConfig(**dataclasses.asdict(bb)), device="cpu")
    load_jax_variables(port, sub, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_hgnet_config_is_stricter_than_reference():
    """The reference takes any other stem name for the HF stem and any
    other lowering for "transpose"; the port raises."""
    with pytest.raises(ValueError, match="patchify stem"):
        HGNetConfig(stem="hgnet", stem_s2d=True, stem_pre_patchified=True)
    with pytest.raises(ValueError, match="the stems are"):
        HGNetV2(HGNetConfig(stem="hgnet2"), device="cpu")
    with pytest.raises(ValueError, match="lowerings"):
        HGNetV2(HGNetConfig(stem="patchify", stem_s2d=True,
                            stem_s2d_impl="gather"), device="cpu")


def test_serving_slice_matches_reference(jax_model):
    """The bench config end to end: prepatchified uint8 input, folded
    stem, fused AIFI attention (interpreted Pallas on the JAX side),
    discrete deformable decoder; f32 on both sides."""
    cfg, variables, img = jax_model
    xp = jthr.prepatchify_uint8(img, PATCH)
    jout = jdf.DFine(cfg).apply(jthr.fold_uint8_stem(variables),
                                jnp.asarray(xp), train=False)
    model = tthr.fold_uint8_stem(_port_model(variables))
    with torch.inference_mode():
        tout = model(torch.from_numpy(tthr.prepatchify_uint8(img, PATCH)))
    assert tout["logits"].shape == (2, 150, 2)
    assert tout["pred_boxes"].dtype == torch.float32
    _assert_same_detections(tout["logits"].numpy(),
                            tout["pred_boxes"].numpy(),
                            np.asarray(jout["logits"]),
                            np.asarray(jout["pred_boxes"]))
    with pytest.raises(KeyError, match="class_ids"):
        model(torch.from_numpy(xp), denoising={})
