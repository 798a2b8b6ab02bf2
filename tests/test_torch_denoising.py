"""pautdx_torch's contrastive denoising groups held to the JAX package's on
the CPU: the JAX function's own four draws (``jax.random.split(key, 4)``,
drawn as ``make_denoising_queries`` draws them) go through the port's
``denoising_queries_from_draws``; the group is equal (box logits within
1e-6 absolute plus 1e-6 relative: under ``jit``, which keeps these tests
fast, XLA's fused arithmetic moves the reference's own logits by up to
4.3e-7 of their size), and ``denoising_loss`` and its gradient with respect to the logits
and boxes match ``jax.grad`` within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.losses import denoising as jdn
from pautdx_torch.losses import denoising as tdn
from torch_threads import one_torch_thread  # noqa: F401

NUM_LABELS = 2
NUM_QUERIES = 20
# jitted, so each shape compiles once instead of every op on its own
j_make = jax.jit(jdn.make_denoising_queries, static_argnums=(4, 5, 6))


def _gts(seed, B=3, M=4):
    rng = np.random.default_rng(seed)
    cxcy = rng.uniform(0.15, 0.85, (B, M, 2))
    wh = rng.uniform(0.02, 0.3, (B, M, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    classes = rng.integers(0, NUM_LABELS, (B, M)).astype(np.int32)
    mask = (rng.uniform(size=(B, M)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-1] = 0.0                               # a frame with no boxes
    classes[mask == 0] = -1                      # padded slots
    return boxes, classes, mask


@jax.jit
def _draws(key, shape):
    """The draws of ``make_denoising_queries``, in its order."""
    B, D = shape.shape
    k1, k2, k3, k4 = jax.random.split(key, 4)
    flip_u = jax.random.uniform(k1, (B, D))
    rand_label = jax.random.randint(k2, (B, D), 0, NUM_LABELS)
    sign = jax.random.randint(k3, (B, D, 4), 0, 2) * 2.0 - 1.0
    part = jax.random.uniform(k4, (B, D, 4))
    return flip_u, rand_label, sign, part


def _jax_draws(key, B, D):
    return [torch.from_numpy(np.array(t))
            for t in _draws(key, jnp.zeros((B, D)))]


@pytest.mark.parametrize("num_denoising,key", [(100, 0), (8, 3), (1, 5)])
def test_queries_from_the_reference_draws_match(num_denoising, key):
    boxes, classes, mask = _gts(key)
    B, M = mask.shape
    groups, D = tdn.denoising_group_size(M, num_denoising)
    assert (groups, D) == jdn.denoising_group_size(M, num_denoising)
    want = j_make(
        jax.random.PRNGKey(key), jnp.asarray(boxes), jnp.asarray(classes),
        jnp.asarray(mask), NUM_LABELS, NUM_QUERIES, num_denoising)
    got = tdn.denoising_queries_from_draws(
        *_jax_draws(jax.random.PRNGKey(key), B, D), torch.from_numpy(boxes),
        torch.from_numpy(classes), torch.from_numpy(mask), NUM_LABELS,
        NUM_QUERIES)
    assert got.keys() == want.keys()
    for k in ("class_ids", "attn_mask", "is_positive", "gt_index",
              "weight"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["box_logits"].numpy(),
                               np.asarray(want["box_logits"]), atol=1e-6,
                               rtol=1e-6)
    padded = torch.from_numpy(np.tile(mask, (1, 2 * groups))) == 0
    assert (got["class_ids"][padded] == NUM_LABELS).all()


def test_make_denoising_queries_draws_from_the_generator():
    """Shapes, dtypes and devices of a group drawn from a torch generator;
    the same seed gives the same group."""
    boxes, classes, mask = (torch.from_numpy(t) for t in _gts(1))
    groups, D = tdn.denoising_group_size(mask.shape[1])

    def draw():
        gen = torch.Generator().manual_seed(7)
        return tdn.make_denoising_queries(gen, boxes, classes, mask,
                                          NUM_LABELS, NUM_QUERIES)

    a, b = draw(), draw()
    assert a["box_logits"].shape == (3, D, 4)
    assert a["attn_mask"].shape == (D + NUM_QUERIES,) * 2
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_denoising_loss_and_gradient_match():
    boxes, classes, mask = _gts(2)
    B, M = mask.shape
    _, D = tdn.denoising_group_size(M, 16)
    rng = np.random.default_rng(9)
    logits = rng.normal(0, 2, (B, D, NUM_LABELS)).astype(np.float32)
    pred = np.concatenate([rng.uniform(0.2, 0.8, (B, D, 2)),
                           rng.uniform(0.05, 0.4, (B, D, 2))],
                          -1).astype(np.float32)
    dn_j = j_make(
        jax.random.PRNGKey(4), jnp.asarray(boxes), jnp.asarray(classes),
        jnp.asarray(mask), NUM_LABELS, NUM_QUERIES, 16)
    dn_t = {k: torch.from_numpy(np.array(v)) for k, v in dn_j.items()}

    def j_loss(lg, bx):
        return jdn.denoising_loss(lg, bx, dn_j, jnp.asarray(boxes),
                                  jnp.asarray(classes))

    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(logits),
                                              jnp.asarray(pred))
    lg = torch.from_numpy(logits).requires_grad_()
    bx = torch.from_numpy(pred).requires_grad_()
    got, got_aux = tdn.denoising_loss(lg, bx, dn_t, torch.from_numpy(boxes),
                                      torch.from_numpy(classes))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    for k in want_aux:
        np.testing.assert_allclose(got_aux[k].item(), float(want_aux[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for g, w in ((lg.grad, want_g[0]), (bx.grad, want_g[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
