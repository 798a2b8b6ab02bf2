"""pautdx_torch's signal serving held to the JAX reference on the CPU:
``SignalEndpoint`` (exact shapes, batch chunking, the overflow cap, 2-d
input, the reference's variables), the reference endpoint's padding fault
and the port's answer to it, the ``serve_signals`` bridge, the datasets,
metrics and IoU copies, ``SignalEvaluator`` and ``prediction_map`` on the
``json_volume_dir`` volumes with the same weights, and
``compat.torch_import`` against a numpy oracle and the JAX importer.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.compat import torch_import as jti
from pautdx.data import datasets as jds
from pautdx.data.volume import parse_json_volume as jparse
from pautdx.eval import iou as jiou
from pautdx.eval import metrics as jmetrics
from pautdx.eval import report as jreport
from pautdx.models.signal import (
    MSC_N as JMSC_N, HybridBinaryModel as JHybridBinary,
    MultiSignalClassifier as JMSC, SetTransformer as JSetTransformer,
    SignalClassifierMLP as JMLP,
)
from pautdx.serve import SignalEndpoint as JSignalEndpoint
from pautdx.serve import serve_signals as jserve_signals
from pautdx_torch.compat import torch_import as tti
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.data import datasets as tds
from pautdx_torch.data.volume import parse_json_volume
from pautdx_torch.eval import iou as tiou
from pautdx_torch.eval import metrics as tmetrics
from pautdx_torch.eval.report import SignalEvaluator, prediction_map
from pautdx_torch.models.signal import (
    MODEL_ZOO, MSC_N, DenseAutoencoder, HybridBinaryModel,
    MultiSignalClassifier, SetTransformer, SignalClassifierMLP,
    build_signal_model,
)
from pautdx_torch.serve.bridge import serve_signals
from pautdx_torch.serve.endpoints import SignalEndpoint
from tests.test_torch_signal_zoo import random_variables
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
S = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def signals(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def hybrid():
    """A one-layer HybridBinary: the reference module, its random
    variables, and the port's endpoint over them."""
    jmodel = JHybridBinary(num_transformer_layers=1)
    variables = random_variables(jmodel, signals(0, (1, 8, S)), 0)
    ep = SignalEndpoint(HybridBinaryModel(num_transformer_layers=1,
                                          device="cpu"), variables,
                        batch_buckets=(1, 2, 4), signal_buckets=(8, 16, 50),
                        device="cpu")
    return jmodel, variables, ep


def jax_apply(jmodel, variables):
    fwd = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    return lambda x: jax.tree_util.tree_map(
        np.asarray, fwd(variables, jnp.asarray(x, jnp.float32)))


# ---------------------------------------------------------------------------
# the endpoint


def test_reference_endpoint_pads_and_the_port_answers_at_the_exact_shape(
        hybrid):
    """The reference's endpoint answers N = 37 at its bucket 50, beside 13
    zero signals that HybridBinary's sequence mean and attention see: it
    moves the probabilities by 0.05 or more. The port answers at N = 37,
    within 1e-5 of the reference model at that shape."""
    jmodel, variables, ep = hybrid
    x = signals(1, (2, 37, S))
    exact = jax_apply(jmodel, variables)(x)
    padded = JSignalEndpoint(jmodel, variables, batch_buckets=(1, 2, 4),
                             signal_buckets=(8, 16, 50)).predict(x)["prob"]
    delta = float(np.abs(padded - exact).max())
    assert delta > 0.05, delta
    got = ep.predict(x)
    assert got["prob"].shape == (2, 37)
    np.testing.assert_allclose(got["prob"], exact, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got["pred"],
                                  (got["prob"] >= 0.5).astype(np.float32))


def test_endpoint_chunks_batches_and_takes_2d_input(hybrid):
    jmodel, variables, ep = hybrid
    x = signals(2, (9, 16, S))               # 9 > 4: chunks of 4, 4, 1
    want = jax_apply(jmodel, variables)(x)
    np.testing.assert_allclose(ep.predict(x)["prob"], want, rtol=0,
                               atol=TOL)
    one = ep.predict(x[3])                    # (N, S) -> (1, N)
    assert one["prob"].shape == (1, 16)
    np.testing.assert_allclose(one["prob"][0], want[3], rtol=0, atol=TOL)
    np.testing.assert_allclose(ep.predict(torch.from_numpy(x))["prob"],
                               want, rtol=0, atol=TOL)


def test_endpoint_overflow_cap(hybrid):
    """N up to 8 x the largest configured signal bucket is answered; past
    it, ValueError, as the reference."""
    _, _, ep = hybrid
    assert ep.predict(signals(3, (1, 400, S)))["prob"].shape == (1, 400)
    with pytest.raises(ValueError, match="overflow cap"):
        ep.predict(signals(3, (1, 401, S)))


def test_endpoint_returns_positions():
    jmodel = JMSC_N(num_layers=1)
    variables = random_variables(jmodel, signals(4, (1, 8, S)), 4)
    ep = SignalEndpoint(MSC_N(num_layers=1, signal_length=S, device="cpu"),
                        variables, device="cpu")
    x = signals(5, (3, 12, S))
    want = jax_apply(jmodel, variables)(x)
    got = ep.predict(x)
    assert set(got) == {"prob", "pred", "positions"}
    np.testing.assert_allclose(got["prob"], want["prob"], rtol=0, atol=TOL)
    np.testing.assert_allclose(got["positions"], want["positions"], rtol=0,
                               atol=TOL)


def test_signal_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    calls = [lambda: build_signal_model("HybridBinary"),
             lambda: SignalEndpoint(torch.nn.Identity()),
             lambda: DenseAutoencoder()]
    calls += [cls for cls in MODEL_ZOO.values()]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# the bridge


def test_signal_bridge_matches_reference():
    """A per-signal model (no mixing across signals, so the reference's
    padding moves nothing): the port's bridge writes the reference's
    keys and numbers."""
    jmodel = JMLP(hidden=(32, 16))
    variables = random_variables(jmodel, signals(6, (1, 8, S)), 6)
    x = signals(7, (6, S))
    payload = json.dumps({"signals": x.tolist()})
    outs = []
    for serve, ep in (
            (serve_signals, SignalEndpoint(
                SignalClassifierMLP((32, 16), signal_length=S,
                                    device="cpu"), variables,
                device="cpu")),
            (jserve_signals, JSignalEndpoint(jmodel, variables))):
        stdout = io.StringIO()
        serve(ep, stdin=io.StringIO(payload), stdout=stdout)
        outs.append(json.loads(stdout.getvalue()))
    got, want = outs
    assert set(got) == set(want) == {"prob", "pred"}
    assert np.asarray(got["prob"]).shape == (1, 6)
    np.testing.assert_allclose(got["prob"], want["prob"], rtol=0, atol=TOL)
    assert got["pred"] == want["pred"]


# ---------------------------------------------------------------------------
# datasets, metrics, IoU


@pytest.fixture(scope="module")
def datasets(json_volume_dir):
    return (tds.load_json_dir(json_volume_dir),
            jds.load_json_dir(json_volume_dir))


def _assert_same_sequences(got, want):
    for f in ("signals", "labels", "positions", "class_labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.label_names == want.label_names


def test_datasets_match_reference(datasets, json_volume_dir):
    got, want = datasets
    assert len(got) == len(want) > 0
    _assert_same_sequences(got, want)
    for fn in ("defect_focused",):
        _assert_same_sequences(getattr(tds, fn)(got), getattr(jds, fn)(want))
    for g, w in zip(tds.train_val_split(got, 0.25),
                    jds.train_val_split(want, 0.25)):
        _assert_same_sequences(g, w)
    overlap = tds.load_json_dir(json_volume_dir, seq_len=30, overlap=True)
    _assert_same_sequences(
        overlap, jds.load_json_dir(json_volume_dir, seq_len=30, overlap=True))
    for drop in (True, False):
        it_g = tds.BatchIterator(got, 5, seed=3, drop_remainder=drop)
        it_w = jds.BatchIterator(want, 5, seed=3, drop_remainder=drop)
        assert len(it_g) == len(it_w)
        for bg, bw in zip(it_g, it_w):
            assert set(bg) == set(bw)
            for k in bw:
                np.testing.assert_array_equal(bg[k], bw[k])


def test_metrics_and_iou_match_reference():
    rng = np.random.default_rng(8)
    probs = rng.uniform(size=(40, 7))
    probs[0, :3] = 0.5                          # ties and the threshold
    labels = (rng.uniform(size=(40, 7)) > 0.6).astype(np.float32)
    mask = (rng.uniform(size=(40, 7)) > 0.1).astype(np.float32)
    got = tmetrics.classification_report(probs, labels, 0.5, mask)
    assert got == jmetrics.classification_report(probs, labels, 0.5, mask)
    assert tmetrics.auc_roc(probs, labels, mask) == \
        jmetrics.auc_roc(probs, labels, mask)
    assert tmetrics.format_report(got) == jmetrics.format_report(got)
    a = np.sort(rng.uniform(size=(30, 2)), axis=-1)
    b = np.sort(rng.uniform(size=(30, 2)), axis=-1)
    np.testing.assert_array_equal(tiou.interval_iou(a, b),
                                  jiou.interval_iou(a, b))
    assert tiou.iou_statistics(a, b, mask[:30, 0]) == \
        jiou.iou_statistics(a, b, mask[:30, 0])
    items_p = [list(map(tuple, a[i:i + 3])) for i in range(0, 30, 3)]
    items_g = [list(map(tuple, b[i:i + 2])) for i in range(0, 30, 3)]
    assert tiou.detection_prf(items_p, items_g, 0.1) == \
        jiou.detection_prf(items_p, items_g, 0.1)


# ---------------------------------------------------------------------------
# the report and the prediction map


def test_signal_evaluator_matches_reference(datasets, tmp_path):
    """MSC_N (probabilities and positions) over both volumes' windows,
    batch 8 with the padded tail: every metric of the report."""
    got_ds, want_ds = datasets
    jmodel = JMSC_N(num_layers=1)
    variables = random_variables(jmodel, want_ds.signals[:1], 9)
    ep = SignalEndpoint(MSC_N(num_layers=1, device="cpu"), variables,
                        device="cpu")
    got = SignalEvaluator(ep.predict).run(got_ds, str(tmp_path))
    want = jreport.SignalEvaluator(jax_apply(jmodel, variables)).run(
        want_ds)
    assert set(got) == set(want)
    assert "iou_mean" in got and "auc" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    for name in ("metrics.txt", "metrics.csv", "metrics.json"):
        assert (tmp_path / name).is_file()


def test_prediction_map_matches_reference(hybrid, json_volume_dir):
    """The beam x scan map of a 6 x 80 volume (windows (0, 50) and the
    re-anchored (30, 80)) and of a 20-scan cut of it, padded to 50."""
    jmodel, variables, _ = hybrid
    ep = SignalEndpoint(HybridBinaryModel(num_transformer_layers=1,
                                          device="cpu"), variables,
                        device="cpu")
    path = f"{json_volume_dir}/vol0.json"
    vol, jvol = parse_json_volume(path), jparse(path)
    jfwd = jax_apply(jmodel, variables)
    got = prediction_map(ep.predict, vol)
    assert got.shape == (6, 80) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jreport.prediction_map(jfwd, jvol),
                               rtol=0, atol=TOL)
    for v in (vol, jvol):
        v.signals = {k: s[:20] for k, s in v.signals.items()}
    np.testing.assert_allclose(prediction_map(ep.predict, vol),
                               jreport.prediction_map(jfwd, jvol), rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the reference's .pth state dicts


class _RefMSC(torch.nn.Module):
    """A state dict under the reference's MSC key names."""

    def __init__(self, s, hidden=(128, 64, 32), heads=4):
        super().__init__()
        self.shared_layer = torch.nn.Sequential(
            torch.nn.Linear(s, hidden[0]), torch.nn.ReLU(),
            torch.nn.Linear(hidden[0], hidden[1]))
        self.attention = torch.nn.MultiheadAttention(hidden[1], heads,
                                                     batch_first=True)
        self.classifier = torch.nn.Sequential(
            torch.nn.Linear(hidden[1], hidden[2]), torch.nn.ReLU(),
            torch.nn.Linear(hidden[2], 1))


def _randomised_state(module, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) * 0.2
            for k, v in module.state_dict().items()}


def numpy_msc_forward(sd, x):
    """tests/test_compat_torch.py:20-48: the MSC checkpoint in numpy."""
    B, N, S_ = x.shape
    h = x.reshape(B * N, S_)
    h = np.maximum(h @ sd["shared_layer.0.weight"].T + sd["shared_layer.0.bias"], 0)
    h = np.maximum(h @ sd["shared_layer.2.weight"].T + sd["shared_layer.2.bias"], 0)
    h = h.reshape(B, N, -1)
    d = h.shape[-1]
    w_in, b_in = sd["attention.in_proj_weight"], sd["attention.in_proj_bias"]
    q = h @ w_in[:d].T + b_in[:d]
    k = h @ w_in[d:2 * d].T + b_in[d:2 * d]
    v = h @ w_in[2 * d:].T + b_in[2 * d:]
    heads, dh = 4, d // 4

    def split(t):
        return t.reshape(B, N, heads, dh).transpose(0, 2, 1, 3)

    qh, kh, vh = split(q), split(k), split(v)
    logits = qh @ kh.transpose(0, 1, 3, 2) / np.sqrt(dh)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    a = (w @ vh).transpose(0, 2, 1, 3).reshape(B, N, d)
    a = a @ sd["attention.out_proj.weight"].T + sd["attention.out_proj.bias"]
    c = np.maximum(a @ sd["classifier.0.weight"].T + sd["classifier.0.bias"], 0)
    c = c @ sd["classifier.2.weight"].T + sd["classifier.2.bias"]
    return 1.0 / (1.0 + np.exp(-c[..., 0]))


def test_msc_import_matches_numpy_oracle(tmp_path):
    """A state dict under the reference's keys (``nn.MultiheadAttention``'s
    packed in_proj), saved as a trainer dict and read back."""
    sd = _randomised_state(_RefMSC(320), 10)
    path = tmp_path / "msc.pth"
    torch.save({"epoch": 3, "model_state_dict": sd}, path)
    sd = tti.load_state_dict(str(path))
    model = tti.import_msc(sd, MultiSignalClassifier(device="cpu"))
    x = signals(11, (2, 7, 320))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = numpy_msc_forward({k: v.numpy().astype(np.float64)
                              for k, v in sd.items()}, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    # the same state dict through torch's own attention: the oracle holds
    ref = _RefMSC(320)
    ref.load_state_dict(sd)
    with torch.no_grad():
        h = ref.shared_layer(torch.from_numpy(x)).relu()
        c = ref.classifier(ref.attention(h, h, h)[0])
    np.testing.assert_allclose(torch.sigmoid(c[..., 0]).numpy(), want,
                               rtol=1e-4, atol=2e-5)


def test_set_transformer_and_mlp_imports_match_reference_importer():
    """Each state dict through the port's importer and through the JAX
    package's (into the JAX model): the same outputs."""
    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attention = torch.nn.MultiheadAttention(32, 4)
            self.layer_norm = torch.nn.LayerNorm(32)

    st = torch.nn.Module()
    st.encoder = torch.nn.Sequential(torch.nn.Linear(S, 32), torch.nn.ReLU(),
                                     Block(), Block())
    st.decoder = torch.nn.Sequential(torch.nn.Linear(32, 64),
                                     torch.nn.ReLU(), torch.nn.Linear(64, 1))
    mlp = torch.nn.Module()
    mlp.network = torch.nn.Sequential(
        torch.nn.Linear(S, 24), torch.nn.ReLU(), torch.nn.Linear(24, 12),
        torch.nn.ReLU(), torch.nn.Linear(12, 1))
    x = signals(12, (3, 9, S))
    cases = (
        (st, lambda sd: tti.import_set_transformer(
            sd, SetTransformer(32, signal_length=S, device="cpu")),
         jti.import_set_transformer, JSetTransformer(32)),
        (mlp, lambda sd: tti.import_mlp_classifier(
            sd, SignalClassifierMLP((24, 12), signal_length=S,
                                    device="cpu"), "network"),
         lambda sd: jti.import_mlp_classifier(sd, "network"),
         JMLP((24, 12))))
    for i, (ref, port_import, jax_import, jmodel) in enumerate(cases):
        sd = _randomised_state(ref, 20 + i)
        with torch.no_grad():
            got = port_import(sd)(torch.from_numpy(x)).numpy()
        want = jmodel.apply(jax_import({k: v.numpy()
                                        for k, v in sd.items()}),
                            jnp.asarray(x))
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def test_import_is_strict():
    sd = _randomised_state(_RefMSC(320), 30)
    with pytest.raises(RuntimeError, match="size mismatch"):
        tti.import_msc(sd, MultiSignalClassifier(signal_length=160,
                                                 device="cpu"))
    del sd["classifier.2.bias"]
    with pytest.raises(KeyError):
        tti.import_msc(sd, MultiSignalClassifier(device="cpu"))
