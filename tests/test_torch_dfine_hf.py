"""pautdx_torch's HF-architecture D-FINE eval slice held to the JAX reference
on the CPU: the HGNetV2 ``Embeddings`` stem, ``stem_s2d_impl="slices"``,
the per-head ``ms_deformable_attention`` and the whole model with its
predict chain. The same numpy weights and inputs go through both packages.

The model config is small, like ``parity_small`` of
``tools/bench_accuracy.py:112-126``, with the HF defaults that matter here:
the ``hgnet`` stem, per-head sampling points, 3 levels, ``query_topk=
"exact"``, and 2 encoder heads of d_model 64, so that the fused AIFI
attention runs at head dim 32 (interpreted Pallas on the JAX side). One
module-scoped JAX forward per config, from seeded numpy weights in the
shapes of its init.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from pautdx.models.vision import dfine as jdf
from pautdx.models.vision.hgnet import Embeddings as JEmbeddings
from pautdx.models.vision.hgnet import HGNetV2 as JHGNetV2
from pautdx.ops import deformable as jdeform
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.models.vision import dfine as tdf
from pautdx_torch.models.vision.hgnet import HGNetConfig, HGNetV2
from pautdx_torch.ops import attention, deformable
from pautdx_torch.serve.dfine_predict import build_dfine_predictor
from torch_threads import one_torch_thread  # noqa: F401

IMG = 128


def _hf_small(num_labels=2):
    from pautdx.models.vision.hgnet import HGNetConfig as JHGNetConfig

    return jdf.DFineConfig(
        num_labels=num_labels, d_model=64, encoder_hidden_dim=64,
        decoder_layers=2, decoder_attention_heads=4,
        encoder_attention_heads=2, decoder_ffn_dim=128, encoder_ffn_dim=128,
        num_queries=30, max_num_bins=16, hidden_expansion=0.5,
        lqe_hidden_dim=64, query_topk="exact", encoder_fused_attn=True,
        backbone=JHGNetConfig(
            stem_channels=(3, 8, 8), stage_in_channels=(8, 16, 32, 64),
            stage_mid_channels=(8, 8, 16, 32),
            stage_out_channels=(16, 32, 64, 128),
            stage_num_blocks=(1, 1, 1, 1), stage_num_layers=(1, 1, 2, 2),
            stage_downsample=(False, True, True, True),
            stage_light_block=(False, False, True, True),
            stage_kernel_size=(3, 3, 5, 5)))


CONFIGS = {"hf_small": _hf_small,
           "nano_3_levels": lambda: jdf.dfine_nano(num_labels=2, levels=3)}


def _port_cfg(jcfg):
    return tdf.config_from_dict(jdf.config_to_dict(jcfg))


def _variables(tree, rng):
    """Seeded numpy values for the shapes of the JAX init (no init is run):
    kernels and embeddings ~ N(0, 1/fan_in), every BN statistic, scale and
    bias random, so that a wrong leaf mapping shows in the outputs."""
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


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_model(request):
    cfg = CONFIGS[request.param]()
    model = jdf.DFine(cfg)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, IMG, IMG, 3), jnp.float32),
        train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    variables = _variables(dict(shapes), rng)
    img = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jout = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(img))
    return request.param, cfg, variables, img, jout


def _same_detections(t_logits, t_boxes, j_logits, j_boxes):
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


def _sub(variables, path):
    return {"params": variables["params"][path],
            "batch_stats": variables["batch_stats"][path]}


def test_embeddings_stem_and_backbone_match_reference(jax_model):
    """The HGNetV2 backbone, f32, 1e-5 of each map's largest magnitude; on
    the HF config also the ``Embeddings`` stem alone (conv, the two 2x2
    VALID convs, the stride-1 max pool, concat pool first, stem3, stem4)."""
    name, cfg, variables, img, _ = jax_model
    sub = _sub(variables, "model.backbone.model")
    port = HGNetV2(HGNetConfig(**dataclasses.asdict(cfg.backbone)),
                   device="cpu")
    load_jax_variables(port, sub, device="cpu")
    x = jnp.asarray(img)
    pairs = list(zip(port(torch.from_numpy(img)),
                     JHGNetV2(cfg.backbone).apply(sub, x, train=False)))
    if cfg.backbone.stem == "hgnet":
        stem = {k: v["embedder"] for k, v in sub.items()}
        want = JEmbeddings(cfg.backbone).apply(stem, x, train=False)
        got = port.embedder(torch.from_numpy(img).permute(0, 3, 1, 2))
        assert got.shape[2:] == (IMG // 4, IMG // 4)
        pairs.append((got.permute(0, 2, 3, 1), want))
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("patch,pre", [(4, False), (8, False), (4, True)])
def test_s2d_slices_equal_transpose(patch, pre):
    """``stem_s2d_impl="slices"`` is accepted and gives the transpose
    lowering's output bit for bit, and the reference's slices lowering
    (p*p strided slices concatenated in (ki, kj, c) order) within 1e-5; a
    pre-patchified slab skips both; an unknown name raises."""
    from pautdx.models.vision.hgnet import _S2DProj as JS2DProj
    from pautdx_torch.models.vision.hgnet import _S2DProj

    rng = np.random.default_rng(patch)
    x = rng.normal(size=(2, 4 * patch, 2 * patch, 3)).astype(np.float32)
    if pre:
        x = x.reshape(2, 4, patch, 2, patch, 3).transpose(
            0, 1, 3, 2, 4, 5).reshape(2, 4, 2, patch * patch * 3)
    kernel = rng.normal(size=(patch, patch, 3, 16)).astype(np.float32)
    outs = {}
    for impl in ("transpose", "slices"):
        proj = _S2DProj(patch, 3, 16, pre_patchified=pre, impl=impl)
        load_jax_variables(proj, {"params": {"kernel": kernel}},
                           device="cpu")
        with torch.no_grad():
            outs[impl] = proj(torch.from_numpy(x))
    assert torch.equal(outs["slices"], outs["transpose"])
    want = JS2DProj(patch=patch, features=16, impl="slices",
                    pre_patchified=pre).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    np.testing.assert_allclose(outs["slices"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="lowerings"):
        _S2DProj(patch, 3, 16, impl="gather")


def _per_head_inputs(seed, B=2, Q=6, h=3, d=8):
    """Three levels (one with a power-of-two width, so that its ties are
    exact in float), locations in [-0.3, 1.3] and some exactly on the
    ties: loc * W - 0.5 an integer (bilinear weight 0, the discrete index
    its edge)."""
    rng = np.random.default_rng(seed)
    shapes = [(8, 10), (4, 8), (2, 3)]
    levels = [rng.normal(size=(B, H, W, h, d)).astype(np.float32)
              for H, W in shapes]
    P = 2
    loc = rng.uniform(-0.3, 1.3, (B, Q, h, 3 * P, 2)).astype(np.float32)
    for lvl, (H, W) in enumerate(shapes):
        k = np.arange(Q * h * P).reshape(Q, h, P) % (W + 2) - 1
        loc[0, :, :, lvl * P:(lvl + 1) * P, 0] = (
            (k + np.float32(0.5)) / np.float32(W)).astype(np.float32)
        k = np.arange(Q * h * P).reshape(Q, h, P) % (H + 2) - 1
        loc[1, :, :, lvl * P:(lvl + 1) * P, 1] = (
            (k + np.float32(0.5)) / np.float32(H)).astype(np.float32)
    logits = rng.normal(size=(B, Q, h, 3 * P)).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return levels, loc, w.astype(np.float32), [P] * 3


@pytest.mark.parametrize("method", ["default", "discrete"])
def test_per_head_deformable_matches_reference(method):
    """``ms_deformable_attention`` (a set of points for every head), f32,
    at 1e-5: locations outside [0, 1] read the zero padding (bilinear) or
    the clamped edge (discrete), and locations on the ties take the
    reference's side."""
    levels, loc, w, pts = _per_head_inputs(7)
    want = jdeform.ms_deformable_attention(
        [jnp.asarray(v) for v in levels], jnp.asarray(loc), jnp.asarray(w),
        pts, method=method)
    got = deformable.ms_deformable_attention(
        [torch.from_numpy(v) for v in levels], torch.from_numpy(loc),
        torch.from_numpy(w), pts, method=method)
    assert got.shape == (2, 6, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(NotImplementedError, match="'default'"):
        deformable.ms_deformable_attention(
            [torch.from_numpy(v) for v in levels], torch.from_numpy(loc),
            torch.from_numpy(w), pts, method="bicubic")


@pytest.mark.parametrize("method", ["default", "discrete"])
def test_samplers_match_reference(method):
    """``bilinear_sample_nhwc`` / ``nearest_sample_nhwc`` alone in f32 at
    1e-6, on pixel coordinates from far outside the grid to its far side,
    integers (the ties) included."""
    rng = np.random.default_rng(11)
    value = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
    x = rng.uniform(-3, 9, (2, 30)).astype(np.float32)
    y = rng.uniform(-3, 7, (2, 30)).astype(np.float32)
    x[:, :10] = np.arange(-2, 8)
    y[:, 10:20] = np.arange(-3, 7) - 0.5
    jfn = (jdeform.nearest_sample_nhwc if method == "discrete"
           else jdeform.bilinear_sample_nhwc)
    tfn = (deformable.nearest_sample_nhwc if method == "discrete"
           else deformable.bilinear_sample_nhwc)
    want = jfn(jnp.asarray(value), jnp.asarray(x), jnp.asarray(y))
    got = tfn(*map(torch.from_numpy, (value, x, y)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_model_matches_reference(jax_model):
    """The whole eval forward, f32, detection sets matched by assignment;
    the HF config's forward launches nothing on the CPU and holds the head
    dim 32 the attention kernel takes on the card."""
    name, cfg, variables, img, jout = jax_model
    model = load_jax_variables(tdf.DFine(_port_cfg(cfg), device="cpu"),
                               variables, device="cpu")
    before = attention.LAUNCHES
    with torch.inference_mode():
        tout = model(torch.from_numpy(img))
    assert attention.LAUNCHES == before
    if name == "hf_small":
        assert cfg.encoder_hidden_dim // cfg.encoder_attention_heads == 32
        assert cfg.encoder_hidden_dim // cfg.encoder_attention_heads <= \
            attention.MAX_HEAD_DIM
        n_off = model.model.decoder.layers[0].encoder_attn.sampling_offsets
        assert n_off.out_features == 4 * 3 * 4 * 2   # heads x levels x pts
    assert tout["logits"].shape == np.asarray(jout["logits"]).shape
    _same_detections(tout["logits"].numpy(), tout["pred_boxes"].numpy(),
                     np.asarray(jout["logits"]),
                     np.asarray(jout["pred_boxes"]))


def test_predictor_matches_reference_post_process(jax_model):
    """``build_dfine_predictor`` on float images against the JAX
    ``post_process`` of the JAX forward (threshold 0.3, 16 detections):
    the top scores within 1e-4, their boxes within 0.05 px, the classes
    and the validity mask equal."""
    name, cfg, variables, img, jout = jax_model
    predict = build_dfine_predictor(_port_cfg(cfg), size=IMG, device="cpu",
                                    variables=variables)
    got = predict(torch.from_numpy(img))
    want = jdf.post_process(jout["logits"], jout["pred_boxes"], (IMG, IMG),
                            threshold=0.3, max_det=16)
    assert got["boxes"].shape == (2, 16, 4)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=0, atol=5e-2)
    for k in ("classes", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="images"):
        predict(torch.zeros(1, IMG, IMG // 2, 3))


def test_hf_default_config_builds_and_runs_at_640():
    """``DFineConfig(num_labels=2, encoder_fused_attn=True)`` at its own
    defaults (HGNet stem, d_model 256, 8 heads, per-head points, 3 levels,
    6 decoder layers, 300 queries) builds and runs one 640px frame on the
    CPU: 8,400 anchors, finite outputs."""
    model = tdf.DFine(tdf.DFineConfig(num_labels=2, encoder_fused_attn=True),
                      device="cpu")
    with torch.inference_mode():
        out = model(torch.rand(1, 640, 640, 3,
                               generator=torch.Generator().manual_seed(0)))
    assert out["logits"].shape == (1, 300, 2)
    assert torch.isfinite(out["logits"]).all()
    assert torch.isfinite(out["pred_boxes"]).all()
    offsets = model.model.decoder.layers[0].encoder_attn.sampling_offsets
    assert tuple(offsets.weight.shape) == (8 * 3 * 4 * 2, 256)


def test_model_matches_transformers():
    """A second oracle: ``transformers``' ``DFineForObjectDetection`` at
    random weights, in the small config of ``tests/test_dfine_parity.py``
    at 128px,
    its weights carried into the port through the JAX package's importer
    (``convert_state_dict``) and ``load_jax_variables``. f32, detection
    sets matched by assignment; the port runs its AIFI layer through the
    fused attention's plain version."""
    from pautdx.compat.dfine_import import (
        convert_state_dict, load_torch_model_state,
    )
    from tests.test_dfine_parity import _small_hf_configs
    from transformers.models.d_fine.modeling_d_fine import (
        DFineForObjectDetection,
    )

    hf_cfg, jcfg = _small_hf_configs()
    torch.manual_seed(0)
    hf = DFineForObjectDetection(hf_cfg).eval()
    # re-randomized as the JAX side's weights are above (HF's std-0.01
    # init ties every anchor score): weights ~ N(0, 1/fan_in), norm scales
    # near 1, biases small; the BN statistics stay 0 and 1, and so do the
    # FDR constants HF keeps as parameters (`up`, `reg_scale`), which the
    # config carries on the other side
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith(("up", "reg_scale")):
                continue
            if p.dim() >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
            elif name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=g)
            else:
                p.normal_(1.0, 0.1, generator=g)
    side = 128
    shapes = jax.eval_shape(lambda k: jdf.DFine(jcfg).init(
        {"params": k}, jnp.zeros((1, side, side, 3), jnp.float32),
        train=False), jax.random.PRNGKey(0))
    # the importer keeps the target's value where HF has no leaf: the BN
    # statistics, 0 and 1 at init on both sides
    target = jax.tree_util.tree_map_with_path(
        lambda path, s: np.full(s.shape, 1.0 if path[-1].key == "var"
                                else 0.0, np.float32), dict(shapes))
    variables, _ = convert_state_dict(load_torch_model_state(hf), target)
    cfg = dataclasses.replace(_port_cfg(jcfg), encoder_fused_attn=True)
    port = load_jax_variables(tdf.DFine(cfg, device="cpu"), variables,
                              device="cpu")
    x = np.random.default_rng(0).normal(size=(1, side, side, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    _same_detections(got["logits"].numpy(), got["pred_boxes"].numpy(),
                     want.logits.numpy(), want.pred_boxes.numpy())
