"""pautdx_torch's int8 serving (``ops/qconv.py``, ``serve/quantize.py``, the
int8 branches of ``ConvLayer``, ``ConvNorm`` and ``ConvBnSiLU``, the
``"quant"`` collection of ``load_jax_variables``) against the JAX package
on the CPU.

The JAX variables are seeded numpy values for the shapes of
``jax.eval_shape`` (no JAX init runs); reference calls are jitted. The
kernel's plain version runs here; the kernel itself is held to it on the
card (``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from scipy.optimize import linear_sum_assignment

from pautdx.models.vision import dfine as jdf
from pautdx.models.vision import yolo as jyolo
from pautdx.models.vision.hgnet import HGNetConfig as JHGNetConfig
from pautdx.ops import qconv as jq
from pautdx.serve import quantize as jquant
from pautdx_torch.compat.jax_weights import flatten, load_jax_variables
from pautdx_torch.models.vision import dfine as tdf
from pautdx_torch.models.vision import yolo as tyolo
from pautdx_torch.ops import qconv
from pautdx_torch.serve import quantize

IMG = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: the suite runs in several worker
    processes at once."""
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


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


# ------------------------------------------------------------ the conv


def _jax_accumulators(x, k, s, stride, pad, groups):
    """The reference's int32 accumulators: ``pautdx/ops/qconv.py``'s own
    arithmetic up to its convolution (lines 47-62), in NHWC/HWIO."""
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / s), -127.0,
                  127.0).astype(jnp.int8)
    kf = k.astype(jnp.float32)
    w_scale = jnp.maximum(jnp.max(jnp.abs(kf), axis=(0, 1, 2)),
                          1e-12) / 127.0
    kq = jnp.round(kf / w_scale).astype(jnp.int8)
    return jax.lax.conv_general_dilated(
        xq, kq, (stride, stride), ((pad, pad), (pad, pad)),
        feature_group_count=groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)


@jax.jit
def _jax_conv_s1(x, k, s):
    return jq.int8_conv(x, k, strides=(1, 1), padding=((1, 1), (1, 1)),
                        groups=1, in_scale=s)


def test_int8_conv_exact_on_representable_inputs():
    """``tests/test_quant_int8.py``'s case: input and kernel exact at their
    scales, so the int8 path reproduces the reference bit for bit."""
    rng = np.random.default_rng(0)
    s_in = 0.5
    x = (rng.integers(-100, 100, (2, 8, 8, 4)) * s_in).astype(np.float32)
    k = (rng.integers(-127, 128, (3, 3, 4, 8)) * (3.0 / 127.0)
         ).astype(np.float32)
    k[0, 0, 0, :] = 3.0
    want = np.asarray(_jax_conv_s1(jnp.asarray(x), jnp.asarray(k),
                                   jnp.float32(s_in)))
    got = qconv.int8_conv(_nchw(x), _oihw(k), stride=1, padding=1, groups=1,
                          in_scale=s_in)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)


# (name, kernel, stride, groups): dense 3x3 and 1x1, dense stride 2, the
# HGNet light block's depthwise k5 and its downsample's depthwise k3 s2
CONV_CASES = [("dense3", 3, 1, 1), ("dense1", 1, 1, 1),
              ("dense3_s2", 3, 2, 1), ("dw5", 5, 1, 16),
              ("dw3_s2", 3, 2, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,ksize,stride,groups", CONV_CASES)
def test_int8_conv_matches_reference(name, ksize, stride, groups, dtype):
    """Random inputs: the same int32 accumulators, and the output within
    one ulp of its dtype."""
    rng = np.random.default_rng([c[0] for c in CONV_CASES].index(name))
    C, O = 16, 16 if groups > 1 else 24
    x = rng.normal(size=(2, 11, 13, C)).astype(np.float32)
    k = rng.normal(size=(ksize, ksize, C // groups, O)).astype(np.float32)
    pad = (ksize - 1) // 2
    s = np.float32(np.abs(x).max() / 127.0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj, kj = jnp.asarray(x, jdt), jnp.asarray(k, jdt)
    fn = jax.jit(lambda a, b, c: (
        jq.int8_conv(a, b, strides=(stride, stride),
                     padding=((pad, pad), (pad, pad)), groups=groups,
                     in_scale=c),
        _jax_accumulators(a, b, c, stride, pad, groups)))
    want, acc_want = (np.asarray(t.astype(jnp.float32))
                      if t.dtype == jnp.bfloat16 else np.asarray(t)
                      for t in fn(xj, kj, jnp.float32(s)))
    tdt = getattr(torch, dtype)
    xt = _nchw(x).to(tdt)
    wt = _oihw(k).to(tdt)
    prep = qconv.prepare_int8_weight(wt, s, groups)
    acc = qconv.int8_accumulators(xt, prep, stride, pad)
    np.testing.assert_array_equal(acc.numpy().transpose(0, 2, 3, 1),
                                  acc_want)
    got = qconv.int8_conv(xt, wt, stride=stride, padding=pad, groups=groups,
                          in_scale=s)
    assert got.dtype == tdt
    got = got.float().numpy().transpose(0, 2, 3, 1)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    if dtype == "bfloat16":
        ulp = ulp * 2.0 ** 16
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


def test_int8_conv_reference_rounds_half_to_even():
    """x / s at exact halves: 0.5, 1.5, 2.5 and -2.5 round to 0, 2, 2, -2."""
    x = torch.tensor([0.5, 1.5, 2.5, -2.5]).reshape(1, 4, 1, 1)
    w = torch.eye(4).reshape(4, 4, 1, 1) * 127.0
    acc = qconv.int8_accumulators(x, qconv.prepare_int8_weight(w, 1.0))
    assert acc.flatten().tolist() == [0, 254, 254, -254]


# ------------------------------------------------- D-FINE, calibrated


def _tiny_dfine():
    """``tests/test_quant_int8.py``'s tiny D-FINE, discrete decoder."""
    return jdf.DFineConfig(
        num_labels=2, d_model=32, encoder_hidden_dim=32, decoder_layers=2,
        decoder_attention_heads=4, encoder_attention_heads=4,
        decoder_ffn_dim=64, encoder_ffn_dim=64, num_queries=20,
        max_num_bins=16, hidden_expansion=0.5, decoder_method="discrete",
        query_topk="exact",
        backbone=JHGNetConfig(
            stem_channels=(3, 8, 8), stage_in_channels=(8, 16, 32, 64),
            stage_mid_channels=(8, 8, 16, 32),
            stage_out_channels=(16, 32, 64, 128),
            stage_num_blocks=(1, 1, 1, 1), stage_num_layers=(1, 1, 2, 2)))


@pytest.fixture(scope="module")
def dfine_int8():
    """The tiny D-FINE's seeded variables, two calibration batches, the
    reference's quant collection and its int8 outputs."""
    cfg = _tiny_dfine()
    model = jdf.DFine(cfg)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, IMG, IMG, 3), jnp.float32),
        train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    variables = _variables(dict(shapes), rng)
    images = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    # calibrated in float64 (in f32 the two frameworks' activations drift
    # apart by 2e-6 at the deepest encoder sites)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                     variables)
        calib = jax.jit(lambda v, b: model.apply(v, b, train=False,
                                                 mutable=["calib"]))
        quant = jquant.calibrate_int8(
            lambda b: calib(v64, b), [jnp.asarray(images[:1], jnp.float64),
                                      jnp.asarray(images[1:], jnp.float64)])
    quant = jax.tree_util.tree_map(np.asarray, quant)
    out = jax.jit(lambda v, b: model.apply(v, b, train=False))(
        {**variables, "quant": quant}, jnp.asarray(images))
    return cfg, variables, images, quant, jax.tree_util.tree_map(
        np.asarray, out)


def _port_dfine(cfg, variables):
    port = tdf.DFine(tdf.config_from_dict(jdf.config_to_dict(cfg)),
                     device="cpu")
    return load_jax_variables(port, variables, device="cpu")


def _jax_sites(quant):
    """The reference's site paths, flax names joined with "/"."""
    paths = jax.tree_util.tree_flatten_with_path(quant)[0]
    return {"/".join(p.key for p in path[:-1]): float(v)
            for path, v in paths}


def test_calibrated_scales_match_reference(dfine_int8):
    """Both calibrations over the same two batches in float64: every
    site's scale within 1e-6 (relative)."""
    cfg, variables, images, quant, _ = dfine_int8
    port = _port_dfine(cfg, variables).double()
    x = torch.from_numpy(images).double()
    got = quantize.calibrate_int8(port, [x[:1], x[1:]])
    want = {p.replace("/", "."): s for p, s in _jax_sites(quant).items()}
    assert set(got) == set(want) and len(got) >= 20
    for site, s in want.items():
        assert abs(got[site] - s) <= 1e-6 * s, (site, got[site], s)
    # calibration leaves the module dense and its state dict as it was
    assert qconv.int8_scales(port) == {}


@pytest.mark.parametrize("prefix", ["model.backbone", "model.encoder",
                                    "model.encoder.fpn_blocks"])
def test_drop_quant_sites_selects_the_reference_sites(dfine_int8, prefix):
    """A predicate on the port's dotted paths selects the sites the same
    predicate selects among the reference's paths with "/" read as "."."""
    _, _, _, quant, _ = dfine_int8
    ref = jquant.drop_quant_sites(
        quant, lambda p: p.replace("/", ".").startswith(prefix))
    port_quant = {p.replace("/", "."): s
                  for p, s in _jax_sites(quant).items()}
    got = quantize.drop_quant_sites(port_quant,
                                    lambda p: p.startswith(prefix))
    want = {p.replace("/", ".") for p in _jax_sites(ref)}
    assert set(got) == want and 0 < len(want) < len(port_quant)


def test_dfine_int8_carried_from_jax_matches_reference(dfine_int8):
    """The reference's quant collection carried in by
    ``load_jax_variables``: the same detection sets, matched by
    assignment; the state dict is the one a dense load gives."""
    cfg, variables, images, quant, want = dfine_int8
    dense = _port_dfine(cfg, variables)
    port = _port_dfine(cfg, {**variables, "quant": quant})
    assert port.state_dict().keys() == dense.state_dict().keys()
    assert len(qconv.int8_scales(port)) == len(_jax_sites(quant))
    with torch.inference_mode():
        got = port(torch.from_numpy(images))
    for b in range(images.shape[0]):
        def feats(boxes, logits):
            return np.concatenate([boxes, 1 / (1 + np.exp(-logits))], -1)

        ft = feats(got["pred_boxes"][b].numpy(), got["logits"][b].numpy())
        fj = feats(want["pred_boxes"][b], want["logits"][b])
        cost = np.linalg.norm(ft[:, None] - fj[None], axis=-1)
        r, c = linear_sum_assignment(cost)
        assert (cost[r, c] < 2e-3).sum() >= cost.shape[0] - 4
        assert np.median(cost[r, c]) < 1e-3


def test_unknown_quant_site_raises(dfine_int8):
    cfg, variables, _, quant, _ = dfine_int8
    bad = {**quant, "no_such_module": {"in_scale": np.float32(0.1)}}
    with pytest.raises(KeyError, match="no_such_module"):
        _port_dfine(cfg, {**variables, "quant": bad})


def test_make_int8_apply_and_reset(dfine_int8):
    """``make_int8_apply`` sets the scales in place; dropping every site
    gives back the dense outputs exactly; the strict state dict load is
    unchanged by the scales."""
    cfg, variables, images, _, _ = dfine_int8
    port = _port_dfine(cfg, variables)
    x = torch.from_numpy(images)
    with torch.inference_mode():
        dense = port(x)
    apply_fn, quant = quantize.make_int8_apply(port, [x[:1]])
    assert quant == qconv.int8_scales(port) and len(quant) >= 20
    port.load_state_dict(port.state_dict(), strict=True)
    assert np.isfinite(apply_fn(x)["logits"].numpy()).all()
    apply_fn, quant = quantize.make_int8_apply(port, [x[:1]],
                                               drop=lambda p: False)
    assert quant == {} and qconv.int8_scales(port) == {}
    np.testing.assert_array_equal(apply_fn(x)["logits"].numpy(),
                                  dense["logits"].numpy())


# ------------------------------------------------- weight-only int8


def test_quantize_state_dict_matches_reference(dfine_int8):
    """The same leaves quantized, the same int8 values and scales after
    the layout mapping, the same byte counts."""
    cfg, variables, _, _, _ = dfine_int8
    port = _port_dfine(cfg, variables)
    min_size = 512
    qv = jquant.quantize_variables(variables, min_size=min_size)
    want = {k[:-len(".__q8__")]: (v, flatten(qv)[k[:-len("__q8__")]
                                                 + "__s8__"])
            for k, v in flatten(qv).items() if k.endswith(".__q8__")}
    qsd = quantize.quantize_state_dict(port, min_size=min_size)
    got = {k: v for k, v in qsd.items() if isinstance(v, quantize.Q8)}
    assert len(got) == len(want) > 10
    for path, (q, s) in want.items():
        key = path[len("params."):].rpartition(".")[0] + ".weight"
        q8 = got[key]
        q, s = np.asarray(q), np.asarray(s)
        if q.ndim == 4:
            q, s = q.transpose(3, 2, 0, 1), s.transpose(3, 2, 0, 1)
        elif path.endswith("kernel"):
            q, s = q.T, s.T
        np.testing.assert_array_equal(q8.q.numpy(), q)
        np.testing.assert_array_equal(q8.scale.numpy(), s)
    assert quantize.quantized_bytes(qsd) == jquant.quantized_bytes(qv)
    deq = quantize.dequantize_state_dict(qsd, torch.bfloat16)
    key = next(iter(got))
    np.testing.assert_array_equal(
        deq[key].float().numpy(),
        (got[key].q.float() * got[key].scale).to(torch.bfloat16)
        .float().numpy())
    apply_fn, _ = quantize.make_quantized_apply(port, min_size=min_size)
    with torch.inference_mode():
        out = apply_fn(torch.zeros(1, IMG, IMG, 3))
    assert np.isfinite(out["logits"].numpy()).all()


# ------------------------------------------------- YOLO ConvBnSiLU


class _JStack(fnn.Module):
    """Three reference ``ConvBnSiLU``: a stride-2 3x3, a depthwise 3x3 and
    a 1x1 without activation."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = jyolo.ConvBnSiLU(16, 3, 2, name="0")(x, train)
        x = jyolo.ConvBnSiLU(16, 3, groups=16, name="1")(x, train)
        return jyolo.ConvBnSiLU(24, 1, act=False, name="2")(x, train)


def test_yolo_convbnsilu_stack_int8_matches_reference():
    """The reference's calibration and int8 outputs against the port's on
    the same weights, in float64 (the int8 convolutions are exact on
    both sides; float64 keeps the next site's f32 quantization from
    rounding a value across a step): within 1e-5."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, 8))
    stack = _JStack()
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda k: stack.init(
            {"params": k}, jnp.zeros((1, 16, 16, 8), jnp.float64)),
            jax.random.PRNGKey(0))
        variables = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64),
            _variables(dict(shapes), np.random.default_rng(8)))
        calib = jax.jit(lambda v, b: stack.apply(v, b, mutable=["calib"]))
        quant = jquant.calibrate_int8(lambda b: calib(variables, b),
                                      [jnp.asarray(x)])
        want = np.asarray(jax.jit(lambda v, b: stack.apply(v, b))(
            {**variables, "quant": quant}, jnp.asarray(x)))
    port = torch.nn.Sequential(
        tyolo.ConvBnSiLU(8, 16, 3, 2), tyolo.ConvBnSiLU(16, 16, 3,
                                                        groups=16),
        tyolo.ConvBnSiLU(16, 24, 1, act=False)).double()
    load_jax_variables(port, variables, device="cpu")
    got_q = quantize.calibrate_int8(port, [_nchw(x)])
    assert got_q == pytest.approx(
        {k: float(v) for k, v in _jax_sites(quant).items()}, rel=1e-6)
    port = load_jax_variables(port, {**variables, "quant": quant},
                              device="cpu")
    port.eval()
    with torch.inference_mode():
        got = port(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
