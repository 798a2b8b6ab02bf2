"""pautdx_torch's signal-domain layers held to the JAX reference on the
CPU, within 1e-5: every block of ``nn/blocks.py`` (SAME padding at even
kernels, strides and dilations included, each norm kind, BatchNorm in
train mode with its running statistics), ``adaptive_avg_pool1d`` at L =
320 and 360, ``TinyMHA``'s cross-attention and mask, ``LocalAttention``,
both position encodings, and the encoder in its three flavours.

The reference's blocks take channels-last (N, L, C), the port's
channels-first (N, C, L): the inputs are made once from a numpy seed and
transposed for the port. Variables are drawn at random over the tree of
``jax.eval_shape`` and carried across by ``load_jax_variables``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.nn import attention as jatt
from pautdx.nn import blocks as jb
from pautdx.nn import transformer as jtr
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.nn import attention as tatt
from pautdx_torch.nn import blocks as tb
from pautdx_torch.nn import transformer as ttr
from tests.test_torch_signal_zoo import random_variables
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
C_IN = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nwc(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def ncw(x):
    """(N, L, C) numpy -> (N, C, L) torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def compare(jmod, tmod, x, *, channels_last=True, seed=0):
    """jmod over ``x`` against tmod over the same input (transposed to
    (N, C, L) when ``channels_last``), the same random variables."""
    variables = random_variables(jmod, x, seed)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    tmod = load_jax_variables(tmod, variables, device="cpu").eval()
    with torch.no_grad():
        got = tmod(ncw(x) if channels_last else torch.from_numpy(x))
    got = got.numpy()
    if channels_last:
        got = got.transpose(0, 2, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# blocks


@pytest.mark.parametrize("kind", ["batch", "group", "layer", "none"])
def test_norm1d_matches_reference(kind):
    compare(jb.Norm1D(kind), tb.Norm1D(kind, 12), nwc(1, (3, 17, 12)))


def test_batchnorm_train_mode_matches_reference():
    """The batch's statistics in the forward, and the running ones moved
    by momentum 0.99 with the biased variance."""
    x = nwc(2, (4, 21, 8))
    jmod = jb.Norm1D("batch")
    variables = random_variables(jmod, x, 3)
    want, state = jmod.apply(variables, jnp.asarray(x), True,
                             mutable=["batch_stats"])
    tmod = load_jax_variables(tb.Norm1D("batch", 8), variables,
                              device="cpu").train()
    with torch.no_grad():
        got = tmod(ncw(x)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    stats = state["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tmod.BatchNorm_0.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmod.BatchNorm_0.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,stride,dilation,length", [
    (3, 1, 1, 20), (4, 1, 1, 20), (5, 2, 1, 21), (4, 2, 1, 20),
    (3, 1, 2, 19), (6, 3, 2, 23)])
def test_conv_block_same_padding_matches_reference(k, stride, dilation,
                                                   length):
    compare(jb.ConvBlock1D(10, k, stride, dilation, norm="batch"),
            tb.ConvBlock1D(C_IN, 10, k, stride, dilation, norm="batch"),
            nwc(k, (3, length, C_IN)))


def test_same_padding_is_the_jax_split():
    """before = floor(total / 2); an even kernel pads one more after."""
    assert tb.same_padding(20, 4) == (1, 2)
    assert tb.same_padding(20, 3) == (1, 1)
    assert tb.same_padding(21, 5, stride=2) == (2, 2)
    assert tb.same_padding(20, 4, stride=2) == (1, 1)
    assert tb.same_padding(5, 1, stride=3) == (0, 0)


def test_conv_stack_matches_reference():
    compare(jb.ConvStack1D((8, 12, 12), (3, 4, 5), norm="group"),
            tb.ConvStack1D(C_IN, (8, 12, 12), (3, 4, 5), norm="group"),
            nwc(4, (2, 40, C_IN)))


@pytest.mark.parametrize("k,dilation", [(5, 1), (4, 1), (3, 3)])
def test_depthwise_conv_matches_reference(k, dilation):
    compare(jb.DepthwiseConv1D(k, dilation), tb.DepthwiseConv1D(C_IN, k,
                                                                dilation),
            nwc(5, (2, 33, C_IN)))


@pytest.mark.parametrize("kernels,chained", [((5, 8), False),
                                             ((15, 31), True)])
def test_background_extractor_matches_reference(kernels, chained):
    compare(jb.BackgroundExtractor(kernels, chained=chained),
            tb.BackgroundExtractor(C_IN, kernels, chained=chained),
            nwc(6, (2, 64, C_IN)))


def test_multiscale_and_dilated_branches_match_reference():
    x = nwc(7, (2, 45, C_IN))
    compare(jb.MultiScaleConv1D(5, (3, 5, 7, 11)),
            tb.MultiScaleConv1D(C_IN, 5, (3, 5, 7, 11)), x)
    compare(jb.DilatedBranches1D(5), tb.DilatedBranches1D(C_IN, 5), x)


@pytest.mark.parametrize("features", [C_IN, 9])
def test_residual_block_matches_reference(features):
    compare(jb.ResidualBlock1D(features, 3, dilation=2),
            tb.ResidualBlock1D(C_IN, features, 3, dilation=2),
            nwc(8, (2, 30, C_IN)))


def test_squeeze_excite_and_rms_norm_match_reference():
    x = nwc(9, (3, 25, 16))
    compare(jb.SqueezeExcite1D(), tb.SqueezeExcite1D(16), x)
    compare(jb.RMSNorm(), tb.RMSNorm(16), x)


def test_mlp_matches_reference():
    x = nwc(10, (3, 5, 20))
    compare(jb.MLP((16, 8, 4), final_act=jax.nn.relu),
            tb.MLP(20, (16, 8, 4), final_act=torch.relu), x,
            channels_last=False)


@pytest.mark.parametrize("length,out_len", [(320, 128), (360, 128),
                                            (256, 128), (37, 5)])
def test_adaptive_avg_pool_matches_reference(length, out_len):
    """The reference's hand-built bins, non-uniform at 320 and 360."""
    x = nwc(11, (3, length, 4))
    want = np.asarray(jax.jit(jb.adaptive_avg_pool1d,
                              static_argnums=1)(jnp.asarray(x), out_len))
    got = tb.adaptive_avg_pool1d(ncw(x), out_len).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # leading dims beyond one go through too
    got4 = tb.adaptive_avg_pool1d(ncw(x)[None], out_len)[0]
    np.testing.assert_allclose(got4.numpy().transpose(0, 2, 1), want,
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# attention and position encodings


def test_tiny_mha_cross_attention_and_mask_match_reference():
    rng = np.random.default_rng(12)
    q = rng.normal(size=(2, 7, 16)).astype(np.float32)
    kv = rng.normal(size=(2, 11, 16)).astype(np.float32)
    mask = rng.uniform(size=(2, 1, 7, 11)) > 0.3
    mask[..., 0] = True                          # no row fully masked
    jmod = jatt.TinyMHA(4)
    variables = random_variables(jmod, q, 13)
    want = jax.jit(lambda v, a, b, m: jmod.apply(v, a, b, mask=m))(
        variables, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(mask))
    tmod = load_jax_variables(tatt.TinyMHA(16, 4), variables, device="cpu")
    with torch.no_grad():
        got = tmod(torch.from_numpy(q), torch.from_numpy(kv),
                   mask=torch.from_numpy(mask))
        self_got = tmod(torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    self_want = jax.jit(jmod.apply)(variables, jnp.asarray(q))
    np.testing.assert_allclose(self_got.numpy(), np.asarray(self_want),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("k1,k2", [(11, 5), (9, 0), (4, 0)])
def test_local_attention_matches_reference(k1, k2):
    compare(jatt.LocalAttention(k1, k2), tatt.LocalAttention(16, k1, k2),
            nwc(14, (2, 23, 16)), channels_last=False)


def test_position_encodings_match_reference():
    x = nwc(15, (2, 37, 16))
    compare(jatt.RelativePositionEncoding(50),
            tatt.RelativePositionEncoding(16, 50), x, channels_last=False)
    for d in (16, 7):
        xd = nwc(16, (2, 37, d))
        compare(jatt.SinusoidalPositionEncoding(),
                tatt.SinusoidalPositionEncoding(d), xd, channels_last=False)
    assert not tatt.SinusoidalPositionEncoding(8).state_dict()


# ---------------------------------------------------------------------------
# encoders


@pytest.mark.parametrize("flavour,local", [("plain", (11, 5)),
                                           ("hybrid", (11, 5)),
                                           ("hybrid", (5, 0)),
                                           ("cross_shift", (11, 5))])
def test_encoder_flavours_match_reference(flavour, local):
    compare(jtr.Encoder(2, 4, 24, 0.1, flavour=flavour, local_kernels=local),
            ttr.Encoder(2, 16, 4, 24, 0.1, flavour=flavour,
                        local_kernels=local),
            nwc(17, (2, 13, 16)), channels_last=False)


def test_encoder_rejects_an_unknown_flavour():
    with pytest.raises(ValueError, match="flavour"):
        ttr.Encoder(1, 16, 4, 24, flavour="sparse")
