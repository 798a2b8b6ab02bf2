"""pautdx_torch's signal model zoo held to the JAX reference on the CPU:
every one of the 21 ``MODEL_ZOO`` names at the reduced depths of
``tests/test_signal_models.py`` and (B, N, S) = (2, 10, 320), eval mode,
each output (every key of a dict) within 1e-5 of ``model.apply(...,
train=False)`` jitted, the JAX variables carried across by
``load_jax_variables``; and ``DenseAutoencoder``.

Each model's JAX variables are drawn at random, every bias, norm scale
and BN statistic included, so that a leaf mapped to the wrong place
shows; their tree comes from ``jax.eval_shape``, so only the reference's
forward compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.models.signal import DenseAutoencoder as JDenseAutoencoder
from pautdx.models.signal.detection_zoo import MODEL_ZOO as JZOO
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.models.signal import (
    MODEL_ZOO, DenseAutoencoder, build_signal_model,
)
from torch_threads import one_torch_thread  # noqa: F401

B, N, S = 2, 10, 320
TOL = 1e-5

# tests/test_signal_models.py:17-30
TEST_KW = {
    "Simple": dict(num_layers=2, num_heads=4),
    "Complex": dict(num_layers=2),
    "NoiseRobust": dict(num_layers=2),
    "DirectDefect": dict(num_layers=2),
    "FluctuationRobust": dict(num_layers=2, num_heads=4),
    "HybridBinary": dict(num_transformer_layers=2),
    "ModernHybridBinary": dict(num_layers=2),
    "ImprovedMSC": dict(num_layers=2),
    "EnhancedPosition": dict(num_layers=2),
    "FixedEnhancedPosition": dict(num_layers=2),
    "Hybrid": dict(),
    "ConvMSC": dict(num_layers=2),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_leaf(name, shape, rng):
    """Kernels N(0, 1/fan_in), biases N(0, 0.1), norm scales 1 + N(0, 0.1),
    BN means N(0, 0.1) and variances U(0.5, 1.5), any other leaf (position
    encodings, background prototypes) N(0, 1)."""
    if name == "kernel":
        v = rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape)
    elif name in ("bias", "mean"):
        v = rng.normal(0.0, 0.1, shape)
    elif name == "scale":
        v = 1.0 + rng.normal(0.0, 0.1, shape)
    elif name == "var":
        v = rng.uniform(0.5, 1.5, shape)
    else:
        v = rng.normal(0.0, 1.0, shape)
    return v.astype(np.float32)


def random_variables(model, x, seed):
    """Variables of ``model``'s tree (from ``jax.eval_shape``: nothing
    compiles), every leaf drawn by ``random_leaf``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            jnp.asarray(x))

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict)
                else random_leaf(k, v.shape, rng) for k, v in tree.items()}

    return fill(jax.tree_util.tree_map(lambda a: a, dict(shapes)))


def jax_reference(model, x, seed):
    """Random variables of ``model`` and its jitted eval output."""
    variables = random_variables(model, x, seed)
    out = jax.jit(lambda v, s: model.apply(v, s, train=False))(
        variables, jnp.asarray(x))
    return variables, jax.tree_util.tree_map(np.asarray, out)


def assert_outputs_match(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_outputs_match(got[k], want[k])
        return
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def signals():
    return np.random.default_rng(0).normal(size=(B, N, S)).astype(np.float32)


def test_zoo_has_the_reference_names():
    assert list(MODEL_ZOO) == list(JZOO)
    assert len(MODEL_ZOO) == 21


@pytest.mark.parametrize("name", list(JZOO))
def test_zoo_model_matches_reference(name, signals):
    kw = TEST_KW.get(name, {})
    variables, want = jax_reference(JZOO[name](**kw), signals,
                                    list(JZOO).index(name))
    model = load_jax_variables(build_signal_model(name, device="cpu", **kw),
                               variables, device="cpu")
    assert not model.training
    with torch.inference_mode():
        got = model(torch.from_numpy(signals))
    assert_outputs_match(got, want)


def test_dense_autoencoder_matches_reference(signals):
    variables, want = jax_reference(JDenseAutoencoder(), signals, 99)
    model = load_jax_variables(DenseAutoencoder(device="cpu"), variables,
                               device="cpu")
    with torch.inference_mode():
        recon = model(torch.from_numpy(signals))
    assert_outputs_match(recon, want)
    np.testing.assert_allclose(
        DenseAutoencoder.anomaly_score(recon, torch.from_numpy(signals)),
        np.asarray(JDenseAutoencoder.anomaly_score(jnp.asarray(want),
                                                   jnp.asarray(signals))),
        rtol=1e-6, atol=TOL)
