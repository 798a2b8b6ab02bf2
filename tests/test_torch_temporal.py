"""pautdx_torch's temporal D-FINE serving slice held to the JAX reference on
the CPU: windowing and chunking, the temporal encoder's parts, the weight
bridge's GRU rule, ``init_heads_from_trunk``, the v1/v2/v3 heads on the
JAX trunk's own outputs, the whole v3 model, the chunked runner, the
frames bridge, and a drive of the serving module at 128px.

The trunk is the JAX tests' ``TINY`` (``tests/test_dfine_train.py``) with
the serving decoder: discrete sampling at head-shared points, the path of
the one-hot gather. One module-scoped JAX init; every bias and LayerNorm
scale is then randomised so that a wrong leaf mapping shows.
"""

import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from pautdx.data import vision as jvision
from pautdx.data import windowing as jwin
from pautdx.models.vision import dfine as jdf
from pautdx.models.vision import temporal_dfine as jtd
from pautdx.models.vision.hgnet import HGNetConfig as JHGNetConfig
from pautdx.nn.attention import TinyMHA as JTinyMHA
from pautdx.nn.recurrent import BiGRU as JBiGRU
from pautdx.nn.transformer import Encoder as JEncoder
from pautdx.serve.bridge import serve_frames as jserve_frames
from pautdx.serve.endpoints import chunked_sequence_runner as jrunner
from pautdx_torch.compat.jax_weights import flatten, load_jax_variables
from pautdx_torch.data import vision as tvision
from pautdx_torch.data import windowing as twin
from pautdx_torch.models.vision import dfine as tdf
from pautdx_torch.models.vision import temporal_dfine as ttd
from pautdx_torch.nn.attention import TinyMHA
from pautdx_torch.nn.recurrent import BiGRU
from pautdx_torch.nn.transformer import Encoder
from pautdx_torch.serve import temporal_predict as tp
from pautdx_torch.serve.bridge import serve_frames
from pautdx_torch.serve.endpoints import chunked_sequence_runner
from torch_threads import one_torch_thread  # noqa: F401

IMG = 64
T = 4
LAYERS = 2
HEADS = 8
NUM_T = 3           # defects + 1, as the serving configuration

TINY = dataclasses.replace(
    jdf.DFineConfig(
        num_labels=2, d_model=64, encoder_hidden_dim=64, decoder_layers=2,
        decoder_attention_heads=4, encoder_attention_heads=4,
        decoder_ffn_dim=128, encoder_ffn_dim=128, num_queries=20,
        max_num_bins=16, hidden_expansion=0.5,
        backbone=JHGNetConfig(
            stem_channels=(3, 8, 8), stage_in_channels=(8, 16, 32, 64),
            stage_mid_channels=(8, 8, 16, 32),
            stage_out_channels=(16, 32, 64, 128),
            stage_num_blocks=(1, 1, 1, 1), stage_num_layers=(1, 1, 2, 2))),
    decoder_method="discrete", decoder_shared_points=True)


def _port_cfg():
    return tdf.config_from_dict(jdf.config_to_dict(TINY))


def _randomise(tree, rng):
    """Biases N(0, 0.1), LayerNorm/BN scales 1 + N(0, 0.1), BN running
    statistics moved off 0/1; kernels as initialised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, v.shape)
        elif k == "scale":
            v = 1.0 + rng.normal(0.0, 0.1, v.shape)
        elif k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        out[k] = v.astype(np.float32)
    return out


def _jax_model(variant):
    return jtd.TemporalDFine(TINY, variant=variant, num_temporal_labels=NUM_T,
                             num_temporal_layers=LAYERS,
                             temporal_heads=HEADS)


def _port_model(variant, variables):
    model = ttd.TemporalDFine(_port_cfg(), variant=variant,
                              num_temporal_labels=NUM_T,
                              num_temporal_layers=LAYERS,
                              temporal_heads=HEADS, device="cpu")
    return load_jax_variables(model, variables, device="cpu")


@pytest.fixture(scope="module")
def temporal():
    """One JAX init of v3 (its tree holds v2's, and v1's but for the
    class head's width), randomised; per variant the reference's outputs
    and the trunk's own last hidden state and initial references of the
    same call."""
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 1, (T, IMG, IMG, 3)).astype(np.float32)
    v3 = jax.jit(_jax_model("v3").init)(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(frames))
    v3 = _randomise(jax.tree_util.tree_map(np.asarray, dict(v3)), rng)
    params = {}
    params["v3"] = v3["params"]
    params["v2"] = {k: v for k, v in v3["params"].items()
                    if k not in ("temporal_attention.0",
                                 "temporal_attention.2", "context_aggregator",
                                 "context_projector", "anomaly_detector.0",
                                 "anomaly_detector.2", "anomaly_detector.4")}
    d = TINY.d_model
    params["v1"] = dict(params["v2"], class_head={
        "kernel": rng.normal(0, d ** -0.5, (d, 2)).astype(np.float32),
        "bias": rng.normal(0, 0.1, (2,)).astype(np.float32)})
    out = {}
    for variant in ttd.VARIANTS:
        variables = {"params": params[variant],
                     "batch_stats": v3["batch_stats"]}

        def run(v, x, variant=variant):
            res, state = _jax_model(variant).apply(
                v, x, capture_intermediates=lambda m, _: isinstance(
                    m, jdf.DFine), mutable=["intermediates"])
            trunk = state["intermediates"]["trunk"]["__call__"][0]
            return res, trunk["last_hidden_state"], \
                trunk["initial_references"][-1]

        res, hidden, refs = jax.jit(run)(variables, jnp.asarray(frames))
        out[variant] = (variables, jax.tree_util.tree_map(np.asarray, res),
                        np.asarray(hidden), np.asarray(refs))
    return frames, out


def _assert_same_detections(t_logits, t_boxes, j_logits, j_boxes):
    """tests/test_dfine_parity.py:194-202: per frame, a bijection between
    the two query sets with tiny cost."""
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


# ---------------------------------------------------------------------------
# windowing and chunking


@pytest.mark.parametrize("seq_len", [1, 7, 50])
@pytest.mark.parametrize("name", ["chunked_windows", "overlapping_windows",
                                  "padded_window"])
def test_windowing_matches_reference(name, seq_len):
    got_fn, want_fn = getattr(twin, name), getattr(jwin, name)
    for n in range(0, 201):
        assert got_fn(n, seq_len) == want_fn(n, seq_len), (n, seq_len)


@pytest.mark.parametrize("require_gt", [True, False])
def test_sequence_chunks_match_reference(require_gt):
    rng = np.random.default_rng(1)
    n, m = 123, 3
    mask = (rng.uniform(size=(n, m)) < 0.02).astype(np.float32)
    mask[:50] = 0.0                        # the first window has no boxes
    args = (rng.uniform(size=(n, 4, 4, 1)).astype(np.float32),
            rng.uniform(size=(n, m, 4)).astype(np.float32),
            rng.integers(0, 2, (n, m)).astype(np.int32), mask)
    got = tvision.sequence_chunks(tvision.DetectionFrames(*args), 50,
                                  require_gt)
    want = jvision.sequence_chunks(jvision.DetectionFrames(*args), 50,
                                   require_gt)
    assert len(got) == len(want) == (2 if require_gt else 3)
    for g, w in zip(got, want):
        for f in ("images", "boxes", "classes", "mask"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


# ---------------------------------------------------------------------------
# the temporal encoder's parts against flax, f32, 1e-5


def _torch(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_tiny_mha_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(6, 5, 32)).astype(np.float32)
    ref = JTinyMHA(4)
    variables = _randomise(jax.tree_util.tree_map(np.asarray, ref.init(
        jax.random.PRNGKey(1), jnp.asarray(q))), rng)
    port = load_jax_variables(TinyMHA(32, 4), variables, device="cpu")
    want = jax.jit(ref.apply)(variables, jnp.asarray(q))
    with torch.no_grad():
        got = port(_torch(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        TinyMHA(30, 4)


def test_encoder_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 5, 32)).astype(np.float32)
    ref = JEncoder(2, 4, 64)
    variables = _randomise(jax.tree_util.tree_map(np.asarray, ref.init(
        jax.random.PRNGKey(2), jnp.asarray(x))), rng)
    port = load_jax_variables(Encoder(2, 32, 4, 64), variables,
                              device="cpu").eval()
    assert port.layer_1.norm2.eps == 1e-6          # flax's default LayerNorm
    want = jax.jit(ref.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_torch(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the signal models' flavours build too (their parity:
    # tests/test_torch_signal_nn.py)
    for flavour, layer in (("hybrid", "HybridEncoderLayer"),
                           ("cross_shift", "CrossShiftEncoderLayer")):
        built = Encoder(1, 32, 4, 64, flavour=flavour).layer_0
        assert type(built).__name__ == layer


def _bigru_case(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(6, 5, 32)).astype(np.float32)
    ref = JBiGRU(24)
    variables = _randomise(jax.tree_util.tree_map(np.asarray, ref.init(
        jax.random.PRNGKey(seed), jnp.asarray(x))), rng)
    return x, ref, variables


def test_bigru_matches_reference():
    """The weight bridge's GRU rule: GRUCell_0 is the forward cell,
    GRUCell_1 the backward one, keep_order outputs."""
    x, ref, variables = _bigru_case(4)
    assert set(variables["params"]) == {"GRUCell_0", "GRUCell_1"}
    port = load_jax_variables(BiGRU(32, 24), variables, device="cpu")
    want = jax.jit(ref.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_torch(x))
    assert got.shape == (6, 5, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(port.bias_hh_l0[:48].detach().numpy(), 0)
    # strict: a cell without one of its ten leaves raises
    flat = {"params": flatten(variables["params"])}
    flat["params"].pop("GRUCell_1.hz.kernel")
    with pytest.raises(KeyError, match="GRUCell_1 lacks"):
        load_jax_variables(BiGRU(32, 24), flat, device="cpu")


def test_bigru_bf16_weights_run_in_float32_as_the_reference():
    """flax's GRU carry is float32, so with bf16 weights the reference's
    recurrence and output are float32; the port's too. Within bf16 input
    rounding (the reference rounds W_i x to bf16, the port does not)."""
    x, ref, variables = _bigru_case(5)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                variables)
    want = jax.jit(ref.apply)(bf, jnp.asarray(x, jnp.bfloat16))
    port = load_jax_variables(BiGRU(32, 24), variables, device="cpu").to(
        torch.bfloat16)
    with torch.no_grad():
        got = port(_torch(x).to(torch.bfloat16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)


# ---------------------------------------------------------------------------
# the temporal model


@pytest.mark.parametrize("variant", ttd.VARIANTS)
def test_init_heads_from_trunk_matches_reference(temporal, variant):
    _, out = temporal
    variables = out[variant][0]
    want = jtd.init_heads_from_trunk(variables, variant)
    model = ttd.init_heads_from_trunk(_port_model(variant, variables))
    ref = _port_model(variant, jax.tree_util.tree_map(np.asarray, want))
    got_sd, want_sd = model.state_dict(), ref.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k, v in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)
    # v1 took the trunk's class head, v2/v3 (3 labels against 2) did not
    copied = torch.equal(model.class_head.weight,
                         model.trunk.class_embed[-1].weight)
    assert copied == (variant == "v1")
    assert torch.equal(model.bbox_head.layers[2].weight,
                       model.trunk.bbox_embed[-1].layers[2].weight)
    std = model.temporal_encoder.layer_0.Dense_0.weight.detach().std(
        correction=0)
    assert abs(float(std) - 1e-3) < 1e-9


@pytest.mark.parametrize("variant", ttd.VARIANTS)
def test_fuse_on_the_reference_trunk_outputs(temporal, variant):
    """The heads alone, fed the JAX trunk's last_hidden_state and
    initial_references[-1] from the same call: logits, boxes and v3's
    anomaly within 1e-4, slot by slot."""
    _, out = temporal
    variables, want, hidden, refs = out[variant]
    model = _port_model(variant, variables)
    with torch.no_grad():
        got = model.fuse(torch.from_numpy(hidden), torch.from_numpy(refs))
    keys = ("logits", "pred_boxes") + (("anomaly",) if variant == "v3"
                                       else ())
    assert set(got) == set(keys)
    assert got["logits"].shape == (T, TINY.num_queries, model.head_labels)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_whole_v3_model_matches_reference(temporal):
    frames, out = temporal
    variables, want, _, _ = out["v3"]
    model = _port_model("v3", variables)
    with torch.no_grad():
        got = model(torch.from_numpy(frames))
        for logits, boxes in (("logits", "pred_boxes"),
                              ("trunk_logits", "trunk_boxes")):
            _assert_same_detections(got[logits].numpy(), got[boxes].numpy(),
                                    want[logits], want[boxes])
        # in training mode the trunk still runs in eval
        model.train()
        trained = model(torch.from_numpy(frames))
    assert model.temporal_encoder.training and not model.trunk.training
    for k in ("trunk_logits", "trunk_boxes"):
        torch.testing.assert_close(trained[k], got[k], rtol=0, atol=0)


def test_variant_is_checked():
    with pytest.raises(ValueError, match="variant"):
        ttd.TemporalDFine(_port_cfg(), variant="v4", device="cpu")


# ---------------------------------------------------------------------------
# the chunked runner and the frames bridge


def _tagging_predict(calls):
    def predict(frames):
        calls.append(frames.shape[0])
        return [f"f{float(frames[i, 0, 0, 0]):.0f}"
                for i in range(frames.shape[0])]
    return predict


def test_chunked_sequence_runner_covers_all_frames():
    """tests/test_serve.py's cases."""
    calls = []
    frames = np.arange(120, dtype=np.float32)[:, None, None, None] * np.ones(
        (1, 2, 2, 3), np.float32)
    results = chunked_sequence_runner(_tagging_predict(calls), frames, 50)
    assert len(results) == 120 and all(r is not None for r in results)
    assert results[0] == "f0" and results[119] == "f119"
    assert calls == [50, 50, 50]
    res = chunked_sequence_runner(_tagging_predict(calls), frames[:7], 50)
    assert len(res) == 7 and res[6] == "f6"
    assert calls[-1] == 50                         # padded up to 50


@pytest.mark.parametrize("n", [7, 50, 51, 120])
def test_chunked_sequence_runner_matches_reference(n):
    """Each frame's result comes from the same window as the reference's:
    the predictor's answer depends on the whole window it sees."""
    rng = np.random.default_rng(n)
    frames = rng.uniform(size=(n, 2, 2, 3)).astype(np.float32)

    def predict(window):
        s = float(window.sum())
        return [(s, float(window[i].sum())) for i in range(window.shape[0])]

    assert chunked_sequence_runner(predict, frames, 50) == \
        jrunner(predict, frames, 50)


def test_frames_bridge_matches_reference():
    """tests/test_serve.py's protocol case, and the same bytes as the
    reference bridge."""
    def fake_predict(frames):
        assert frames.shape[-1] == 3 and frames.dtype == np.float32
        return [[{"box": [0, 0, 1, float(frames[t].mean())], "label": 0,
                  "score": 0.9}] for t in range(frames.shape[0])]

    frames = np.random.default_rng(2).normal(size=(3, 8, 8)).astype(
        np.float32)
    wire = json.dumps(frames.tolist())
    outs = []
    for fn in (serve_frames, jserve_frames):
        stdout = io.StringIO()
        fn(fake_predict, stdin=io.StringIO(wire), stdout=stdout)
        outs.append(stdout.getvalue())
    assert outs[0] == outs[1]
    out = json.loads(outs[0])
    assert len(out) == 3 and out[0][0]["label"] == 0


# ---------------------------------------------------------------------------
# the serving module on the CPU, 128px


@pytest.fixture(scope="module")
def served():
    return tp.build_temporal_model(device="cpu", seed=0)


def test_serving_model_is_the_reference_configuration(served):
    assert served.variant == "v3" and served.head_labels == 3
    cfg = served.cfg
    assert cfg.decoder_method == "discrete" and cfg.num_queries == 150
    assert not cfg.encoder_fused_attn and cfg.d_model == 128
    assert served.temporal_encoder.num_layers == 4
    assert served.temporal_encoder.layer_0.self_attn.num_heads == 8
    assert served.temporal_encoder.layer_0.Dense_0.out_features == 512
    assert {p.dtype for p in served.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in served.buffers()} == {torch.bfloat16}


def test_temporal_predict_drive(served):
    """predict_sequence over 51 uint8 frames (windows (0, 50) and the
    re-anchored (1, 51)) and 7 frames (padded), the chunk predictor on
    uint8 and on the same frames as floats, the stream, and the bridge."""
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (51, 128, 128, 3)).astype(np.uint8)
    res = tp.predict_sequence(served, frames)
    assert len(res) == 51
    for frame in res:
        for det in frame:
            assert set(det) == {"box", "label", "score"}
            assert len(det["box"]) == 4 and det["label"] in (0, 1)
            assert det["score"] >= 0.3
        assert len(frame) <= 16
    chunk = tp.make_chunk_predictor(served)
    assert res[:50] == chunk(frames[:50])
    assert res[50] == chunk(frames[1:])[49]
    # floats go in as given: bf16(u8) * bf16(1/255) is the uint8 path
    scale = float(torch.tensor(1 / 255, dtype=torch.bfloat16))
    floats = torch.from_numpy(frames[:50]).to(torch.bfloat16) * scale
    assert chunk(floats) == res[:50]
    assert len(tp.predict_sequence(served, frames[:7])) == 7
    logits, boxes, finite = tp.make_temporal_stream(served)(
        torch.from_numpy(frames[:50]).reshape(1, 50, 128, 128, 3))
    assert bool(finite)
    # 8x8 + 4x4 anchors at 128px, all selected; v3's head is float32, as
    # the reference's, behind its float32 GRU
    assert logits.shape == (50, 80, 3) and logits.dtype == torch.float32
    assert boxes.shape == (50, 80, 4) and boxes.dtype == torch.float32
    wire = json.dumps((frames[:2, :, :, 0] / 255.0).tolist())
    stdout = io.StringIO()
    serve_frames(lambda f: tp.predict_sequence(served, f),
                 stdin=io.StringIO(wire), stdout=stdout)
    out = json.loads(stdout.getvalue())
    assert len(out) == 2 and all(isinstance(f, list) for f in out)


def test_device_profile_spans_the_temporal_parts(served):
    """``device_profile temporal`` labels each part of a chunk by hooks
    that it removes again; here on the CPU, so host spans only."""
    from pautdx_torch.serve import device_profile

    stream = tp.make_temporal_stream(served)
    slab = torch.zeros((1, 4, 64, 64, 3), dtype=torch.uint8)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with device_profile.module_spans(served, device_profile.TEMPORAL_PARTS), \
            torch.profiler.profile(activities=acts) as prof:
        stream(slab)
    seen = {}
    for e in prof.events():
        if e.name in device_profile.TEMPORAL_PARTS:
            seen[e.name] = seen.get(e.name, 0) + 1
    assert seen == {"temporal.trunk": 1, "temporal.encoder": 1,
                    "temporal.attention_pool": 1, "temporal.gru": 2,
                    "temporal.heads": 3}
    assert not any(m._forward_hooks or m._forward_pre_hooks
                   for m in served.modules())
