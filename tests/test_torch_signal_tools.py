"""The signal domain's host tools and importers held to the JAX reference
on the CPU:

- ``data/augment.py``: every array equal under one ``np.random.Generator``
  (``resample_1d``, ``pad_resample_sequence``, each ``RealisticNoise``
  kind, ``make_batch_augment``);
- ``utils/autogates.py``: ``find_gates`` equal, ``gate_mask`` on tensors
  equal to the reference's;
- ``compat/onnx_import.py``: both importers over an ONNX file the test
  writes byte by byte (ModelProto -> GraphProto -> TensorProto
  initializers, raw and packed float data, an int64 tensor and fields the
  reader skips), the port's ``MultiSignalClassifier`` within 1e-5 of the
  reference's over the reference's variables;
- ``serve/export.py``: HybridBinary exported with a polymorphic batch,
  saved as ``.pt2``, loaded and run at batches 1, 2 and 5 within 1e-5 of
  the eager model;
- ``train/anomaly.py``: thresholds, shapes and direction only (Adam in two
  frameworks drifts apart over an epoch): both workflows flag more of the
  anomalous signals than of the healthy ones.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.compat import onnx_import as jonnx
from pautdx.data import augment as jaug
from pautdx.models.signal import MultiSignalClassifier as JMSC
from pautdx.train import anomaly as janomaly
from pautdx.utils import autogates as jgates
from pautdx_torch.compat import onnx_import as tonnx
from pautdx_torch.data import augment as taug
from pautdx_torch.models.signal import build_signal_model
from pautdx_torch.serve.export import export_signal_model, load_exported
from pautdx_torch.train import anomaly as tanomaly
from pautdx_torch.utils import autogates as tgates
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# augment


def sequence(seed, L=6, S=40):
    r = gen(seed)
    sig = r.normal(size=(L, S)).astype(np.float32)
    pos = np.sort(r.uniform(0, 1, (L, 2)), -1).astype(np.float32)
    pos[::2] = 0.0                      # healthy signals keep (0, 0)
    return sig, pos


def test_resample_matches_reference():
    x = gen(0).normal(size=(3, 37)).astype(np.float32)
    for n in (37, 20, 64):
        np.testing.assert_array_equal(taug.resample_1d(x, n),
                                      jaug.resample_1d(x, n))


@pytest.mark.parametrize("varying", [True, False])
def test_pad_resample_matches_reference(varying):
    sig, pos = sequence(1)
    want = jaug.pad_resample_sequence(sig, pos, gen(2), (5, 30), varying)
    got = taug.pad_resample_sequence(sig, pos, gen(2), (5, 30), varying)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_realistic_noise_matches_reference_in_every_kind():
    """``__call__`` over a sequence, and ``_one`` under a seed of each of
    its six kinds (its first draw picks the kind)."""
    sig, _ = sequence(3, L=12)
    for seed in range(10):
        want = jaug.RealisticNoise(prob=1.0, max_fraction=0.5)(sig, gen(seed))
        got = taug.RealisticNoise(prob=1.0, max_fraction=0.5)(sig, gen(seed))
        np.testing.assert_array_equal(got, want)
    kinds = set()
    for seed in range(100):
        kind = int(gen(seed).integers(0, 6))
        if kind in kinds:
            continue
        kinds.add(kind)
        np.testing.assert_array_equal(
            taug.RealisticNoise()._one(sig[0], gen(seed)),
            jaug.RealisticNoise()._one(sig[0], gen(seed)))
    assert kinds == set(range(6))


def test_batch_augment_matches_reference():
    sig = np.stack([sequence(s)[0] for s in range(4)])
    pos = np.stack([sequence(s)[1] for s in range(4)])
    batch = {"signals": sig, "positions": pos, "labels": pos[..., 0] > 0}
    want = jaug.make_batch_augment((5, 30), jaug.RealisticNoise(0.8))(
        batch, gen(9))
    got = taug.make_batch_augment((5, 30), taug.RealisticNoise(0.8))(
        batch, gen(9))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# auto-gates


def dscan(seed):
    r = gen(seed)
    t = np.arange(200)
    echo = np.exp(-0.5 * ((t - 60) / 4.0) ** 2) + 0.7 * np.exp(
        -0.5 * ((t - 140) / 6.0) ** 2)
    return (echo[None] * r.uniform(0.5, 1.5, (30, 1))
            + 0.02 * r.normal(size=(30, 200))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_gates_and_gate_mask_match_reference(seed):
    d = dscan(seed)
    gates = tgates.find_gates(d)
    assert gates == jgates.find_gates(d)
    np.testing.assert_array_equal(tgates.row_statistics(d),
                                  jgates.row_statistics(d))
    a, b = gates[0]
    x = gen(seed).normal(size=(2, 5, 200)).astype(np.float32)
    want = np.asarray(jgates.gate_mask(jnp.asarray(x), a, b))
    np.testing.assert_array_equal(
        tgates.gate_mask(torch.from_numpy(x), a, b).numpy(), want)
    # a gate a row: (2, 1, 1) starts against (2, 5, 200) signals
    got = tgates.gate_mask(torch.from_numpy(x), torch.tensor([10, 50])
                           [:, None, None], 90).numpy()
    np.testing.assert_array_equal(got[0, :, 10:90], x[0, :, 10:90])
    assert not got[0, :, :10].any() and not got[1, :, :50].any()
    assert not got[:, :, 90:].any()


# ---------------------------------------------------------------------------
# ONNX


def varint(n):
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def field(number, wire, payload):
    key = varint(number << 3 | wire)
    if wire == 0:
        return key + varint(payload)
    return key + varint(len(payload)) + payload


def tensor_proto(name, arr, packed=False):
    arr = np.asarray(arr)
    msg = b"".join(field(1, 0, d) for d in arr.shape)
    msg += field(2, 0, 7 if arr.dtype == np.int64 else 1)
    if packed:
        msg += field(4, 2, struct.pack(f"<{arr.size}f", *arr.ravel()))
    else:
        msg += field(9, 2, arr.tobytes())
    return msg + field(8, 2, name.encode())


def write_msc_onnx(path, hidden=(16, 8, 4), S=24, seed=0):
    """The initializers of the reference's MSC export: torch-layout
    weights, x @ W ``onnx::MatMul_*`` operands, biases by name."""
    r = gen(seed)
    h0, h1, h2 = hidden

    def w(*shape):
        return r.normal(0, 0.3, shape).astype(np.float32)

    inits = {
        "shared_layer.0.weight": w(h0, S), "shared_layer.0.bias": w(h0),
        "shared_layer.2.weight": w(h1, h0), "shared_layer.2.bias": w(h1),
        "onnx::MatMul_131": w(h1, 3 * h1), "onnx::MatMul_132": w(h1, h2),
        "onnx::MatMul_133": w(h2, 1),
        "attention.in_proj_bias": w(3 * h1),
        "attention.out_proj.weight": w(h1, h1),
        "attention.out_proj.bias": w(h1),
        "classifier.0.bias": w(h2), "classifier.2.bias": w(1),
    }
    graph = field(1, 2, field(1, 2, b"input"))       # a NodeProto, skipped
    graph += field(2, 2, b"main_graph")
    for i, (name, arr) in enumerate(inits.items()):
        graph += field(5, 2, tensor_proto(name, arr, packed=i % 2 == 1))
    graph += field(5, 2, tensor_proto("shape", np.array([1, -1], np.int64)))
    model = field(1, 0, 8) + field(2, 2, b"pytorch") + field(7, 2, graph)
    with open(path, "wb") as f:
        f.write(model)
    return inits


def test_onnx_import_matches_reference(tmp_path):
    path = str(tmp_path / "msc.onnx")
    inits = write_msc_onnx(path)
    got_w = tonnx.load_onnx_initializers(path)
    want_w = jonnx.load_onnx_initializers(path)
    assert set(got_w) == set(want_w) == set(inits) | {"shape"}
    for k in want_w:
        np.testing.assert_array_equal(got_w[k], want_w[k])
    for k, v in inits.items():
        np.testing.assert_array_equal(got_w[k], v)

    variables = jonnx.import_msc_onnx(path)
    x = gen(1).normal(size=(2, 5, 24)).astype(np.float32)
    want = jax.jit(lambda v, s: JMSC(hidden=(16, 8, 4), num_heads=2).apply(
        v, s, train=False))(variables, jnp.asarray(x))
    model = tonnx.import_msc_onnx(path, num_heads=2, device="cpu")
    assert not model.training
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# export


def test_export_round_trip(tmp_path):
    model = build_signal_model("HybridBinary", num_transformer_layers=1,
                               device="cpu")
    path = str(tmp_path / "hybrid_binary.pt2")
    export_signal_model(model, (2, 10, 320), path, polymorphic_batch=True,
                        device="cpu")
    run = load_exported(path)
    for b in (1, 2, 5):
        x = torch.from_numpy(gen(b).normal(size=(b, 10, 320))
                             .astype(np.float32))
        with torch.no_grad():
            torch.testing.assert_close(run(x), model(x), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="at least 2"):
        export_signal_model(model, (1, 10, 320), path,
                            polymorphic_batch=True, device="cpu")


# ---------------------------------------------------------------------------
# the autoencoder workflow


def test_autoencoder_workflow_thresholds():
    r = gen(5)
    t = np.linspace(0, 1, 64)
    healthy = (np.sin(2 * np.pi * 4 * t)[None] * r.uniform(0.8, 1.2, (96, 1))
               + 0.05 * r.normal(size=(96, 64))).astype(np.float32)
    anomalous = healthy[:32].copy()
    anomalous[:, 20:28] += 2.0 * r.normal(size=(32, 8)).astype(np.float32)

    model = tanomaly.train_autoencoder(healthy, epochs=10, batch_size=32,
                                       device="cpu")
    thr = tanomaly.anomaly_threshold(model, healthy)
    res = tanomaly.detect_anomalies(model, anomalous, thr)
    assert res["score"].shape == (32,) and res["is_anomaly"].dtype == bool
    healthy_rate = tanomaly.detect_anomalies(model, healthy,
                                             thr)["is_anomaly"].mean()
    assert healthy_rate == pytest.approx(0.1, abs=0.02)
    assert res["is_anomaly"].mean() > 0.9

    jmodel, jvars = janomaly.train_autoencoder(healthy, epochs=10,
                                               batch_size=32)
    jthr = janomaly.anomaly_threshold(jmodel, jvars, healthy)
    jres = janomaly.detect_anomalies(jmodel, jvars, anomalous, jthr)
    assert jres["is_anomaly"].mean() > 0.9
    assert thr > 0 and jthr > 0
    # a batch larger than the data shrinks to it rather than training
    # nothing, in both
    small = tanomaly.train_autoencoder(healthy[:8], epochs=1,
                                       batch_size=64, device="cpu")
    before = tanomaly.train_autoencoder(healthy[:8], epochs=0,
                                        batch_size=64, device="cpu")
    assert any(not torch.equal(a, b) for a, b in
               zip(small.parameters(), before.parameters()))
