"""The signal models of the training half held to the JAX reference on the
CPU at tiny widths, within 1e-5: ``AttentionPool``, ``BiLSTM``,
``ContextAggregator``, ``QueryAttentionAggregator``, the FPN pieces,
``SignalSequenceDetector``, ``EnhancedSignalSequenceDetector`` and
``Hybrid1DDetLoc`` (with ``decode``), in eval mode and in train mode,
where every BatchNorm's running statistics must agree within 1e-6.

Variables are drawn at random over ``jax.eval_shape``'s tree
(``tests/test_torch_signal_zoo.random_variables``) and carried across by
``load_jax_variables``. Train mode runs dropout 0 on both sides. The
reference's ``Hybrid1DDetLoc`` fixes its context dropout at 0.1, and its
GroupNorms have no mode, so its train-mode output at dropout 0 is its
eval output: the port's train-mode forward with its dropouts at 0 is
held to that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.models.signal import detloc1d as jdl
from pautdx.models.signal import seq_detector as jsd
from pautdx.nn import attention as jatt
from pautdx.nn import fpn1d as jfpn
from pautdx.nn import recurrent as jrec
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.models.signal import (
    EnhancedSignalSequenceDetector, Hybrid1DDetLoc, SignalSequenceDetector,
)
from pautdx_torch.nn import attention as tatt
from pautdx_torch.nn import fpn1d as tfpn
from pautdx_torch.nn import recurrent as trec
from tests.test_torch_signal_zoo import random_variables
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
STATS_TOL = 1e-6
B, L, S = 2, 6, 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def assert_tree_close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_tree_close(got[k], want[k], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_close(g, w, tol)
    else:
        got = got.detach().numpy()
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# layers


def test_attention_pool_matches_reference():
    x = seeded(0, (B, L, 12))
    jmod = jatt.AttentionPool()
    variables = random_variables(jmod, x, 1)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    tmod = load_jax_variables(tatt.AttentionPool(12), variables, "cpu")
    with torch.no_grad():
        assert_tree_close(tmod(torch.from_numpy(x)), want)


@pytest.mark.parametrize("jmod,tmod", [
    (jrec.BiLSTM(7), trec.BiLSTM(12, 7)),
    (jrec.ContextAggregator(12), trec.ContextAggregator(12)),
    (jrec.QueryAttentionAggregator(12, 2),
     trec.QueryAttentionAggregator(12, 2)),
], ids=["bilstm", "context", "query"])
def test_recurrent_matches_reference(jmod, tmod):
    x = seeded(2, (B, L, 12))
    variables = random_variables(jmod, x, 3)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    tmod = load_jax_variables(tmod, variables, "cpu").eval()
    with torch.no_grad():
        assert_tree_close(tmod(torch.from_numpy(x)), want)


def test_bilstm_input_biases_stay_zero():
    """The reference's input Denses have no bias: torch's ``bias_ih`` is
    loaded as 0 and takes no gradient, so AdamW leaves it at 0."""
    x = seeded(4, (B, L, 12))
    variables = random_variables(jrec.BiLSTM(7), x, 5)
    tmod = load_jax_variables(trec.BiLSTM(12, 7), variables, "cpu").train()
    tmod(torch.from_numpy(x)).square().sum().backward()
    for bias in (tmod.bias_ih_l0, tmod.bias_ih_l0_reverse):
        assert not bias.detach().any()
        assert not bias.grad.any()
    assert tmod.bias_hh_l0.grad.abs().sum() > 0


def test_fpn_backbone_film_and_head_match_reference():
    x = seeded(6, (B * L, S, 1))
    jmod = jfpn.BackboneFPN1D(width=8)
    variables = random_variables(jmod, x, 7)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    tmod = load_jax_variables(tfpn.BackboneFPN1D(8), variables, "cpu")
    with torch.no_grad():
        got = tmod(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    assert_tree_close([g.transpose(1, 2) for g in got], want)

    feat, ctx = seeded(8, (B, 9, 16)), seeded(9, (B, 10))
    shapes = jax.eval_shape(jfpn.FiLM1D().init, jax.random.PRNGKey(0),
                            jnp.asarray(feat), jnp.asarray(ctx))
    rng = np.random.default_rng(10)
    variables = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), shapes)
    want = jfpn.FiLM1D().apply(variables, jnp.asarray(feat), jnp.asarray(ctx))
    tmod = load_jax_variables(tfpn.FiLM1D(10, 16), variables, "cpu")
    with torch.no_grad():
        got = tmod(torch.from_numpy(feat.transpose(0, 2, 1).copy()),
                   torch.from_numpy(ctx))
    assert_tree_close(got.transpose(1, 2), want)

    jhead = jfpn.Head1D(width=12)
    variables = random_variables(jhead, feat, 11)
    want = jax.jit(jhead.apply)(variables, jnp.asarray(feat))
    tmod = load_jax_variables(tfpn.Head1D(16, 12), variables, "cpu")
    with torch.no_grad():
        assert_tree_close(
            tmod(torch.from_numpy(feat.transpose(0, 2, 1).copy())), want)


def test_decode_1d_matches_reference():
    cls, reg = seeded(12, (B, L, 8)), seeded(13, (B, L, 8, 2)) * 3.0
    want = jfpn.decode_1d(jnp.asarray(cls), jnp.asarray(reg), 8, S)
    got = tfpn.decode_1d(torch.from_numpy(cls), torch.from_numpy(reg), 8, S)
    assert_tree_close(got, want)


# ---------------------------------------------------------------------------
# models

MODELS = {
    "seq": (lambda: jsd.SignalSequenceDetector(
                d_model=16, num_heads=2, num_layers=1, dropout=0.0),
            lambda: SignalSequenceDetector(
                d_model=16, num_heads=2, num_layers=1, dropout=0.0,
                device="cpu")),
    "enhanced": (lambda: jsd.EnhancedSignalSequenceDetector(
                     d_model=16, num_heads=4, num_layers=1, dropout=0.0),
                 lambda: EnhancedSignalSequenceDetector(
                     d_model=16, num_heads=4, num_layers=1, dropout=0.0,
                     device="cpu")),
    "detloc": (lambda: jdl.Hybrid1DDetLoc(
                   width=8, d_context=16, num_heads=2, num_context_layers=1),
               lambda: Hybrid1DDetLoc(
                   width=8, d_context=16, num_heads=2, num_context_layers=1,
                   device="cpu")),
}


@pytest.fixture(scope="module")
def signals():
    return seeded(14, (B, L, S))


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_model_matches_reference(name, train, signals):
    jfn, tfn = MODELS[name]
    jmod = jfn()
    variables = random_variables(jmod, signals, 15)
    has_bs = "batch_stats" in variables
    jtrain = train and name != "detloc"
    want, state = jax.jit(lambda v, x: jmod.apply(
        v, x, train=jtrain, mutable=["batch_stats"] if jtrain and has_bs
        else []))(variables, jnp.asarray(signals))
    model = load_jax_variables(tfn(), variables, "cpu").train(train)
    for m in model.modules():            # Hybrid1DDetLoc's fixed 0.1
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    with torch.no_grad():
        got = model(torch.from_numpy(signals))
    assert_tree_close(got, want)
    if jtrain and has_bs:
        bufs = dict(model.named_buffers())
        flat = jax.tree_util.tree_flatten_with_path(state["batch_stats"])[0]
        for path, v in flat:
            key = ".".join(p.key for p in path)
            key = key.rsplit(".", 1)[0] + {"mean": ".running_mean",
                                           "var": ".running_var"}[path[-1].key]
            np.testing.assert_allclose(bufs[key].numpy(), np.asarray(v),
                                       rtol=0, atol=STATS_TOL, err_msg=key)
    if name == "detloc":
        want_d = jdl.Hybrid1DDetLoc.decode(want, S)
        assert_tree_close(Hybrid1DDetLoc.decode(got, S), want_d)
