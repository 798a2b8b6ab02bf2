"""pautdx_torch's training pieces held to the JAX package on the CPU: the
bilinear gather and deformable sampling with their gradients, the JV
solve, the D-FINE criterion, train-mode BatchNorm, the optimizer, the
schedules, the non-finite guard and the checkpoints.

Inputs are made with numpy from a seed and handed to both packages. The
weighted gather's CUDA kernel is held to the plain version here on the card
by tests/test_torch_kernels.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from scipy.optimize import linear_sum_assignment

from pautdx.losses import detr as jdetr
from pautdx.ops import deformable as jdeform
from pautdx.ops.lapjv import lapjv_batch as j_lapjv_batch
from pautdx.ops.pallas_gather import pallas_weighted_gather
from pautdx.train import optim as joptim
from pautdx.utils.debug import guarded as j_guarded
from pautdx_torch.losses import detr as tdetr
from pautdx_torch.models.vision.hgnet import BatchNorm
from pautdx_torch.ops import deformable, gather
from pautdx_torch.ops.lapjv import lapjv_batch
from pautdx_torch.train import optim as toptim
from pautdx_torch.train.checkpoint import CheckpointManager
from pautdx_torch.utils.debug import guarded


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


# ----------------------------------------------------------- weighted gather


def test_weighted_gather_matches_pallas():
    """Forward and both gradients of sum(out**2) against the Pallas kernel
    (interpret mode) and its custom VJP, at the gates of
    tests/test_pallas_ops.py:129-165 (1e-5); indices past either end are
    clipped by both."""
    rng = np.random.default_rng(8)
    B, L, C, T, K = 2, 30, 8, 12, 4
    flat = rng.normal(size=(B, L, C)).astype(np.float32)
    idx = rng.integers(-3, L + 3, (B, T, K)).astype(np.int32)
    w = rng.uniform(0, 1, (B, T, K)).astype(np.float32)

    def jloss(f, w_):
        return jnp.sum(pallas_weighted_gather(f, jnp.asarray(idx), w_, 0,
                                              True) ** 2)

    want = pallas_weighted_gather(jnp.asarray(flat), jnp.asarray(idx),
                                  jnp.asarray(w), 0, True)
    gf, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(flat),
                                              jnp.asarray(w))
    tf, tw = _t(flat, True), _t(w, True)
    before = gather.WEIGHTED_LAUNCHES
    got = gather.weighted_gather(tf, torch.from_numpy(idx), tw)
    (got ** 2).sum().backward()
    assert gather.WEIGHTED_LAUNCHES == before     # the CPU path launches none
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-5)
    # the written-out VJP the backward kernel is held to on the card
    g = (2 * got).detach()
    d_flat, d_w = gather.weighted_gather_backward_reference(
        _t(flat), torch.from_numpy(idx), _t(w), g)
    np.testing.assert_allclose(d_flat.numpy(), np.asarray(gf), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-5)


def test_weighted_gather_validates():
    flat = torch.zeros(2, 10, 4)
    idx = torch.zeros(2, 5, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="want flat"):
        gather.weighted_gather(flat, idx, torch.zeros(2, 5, 3))
    with pytest.raises(ValueError, match="empty table"):
        gather.weighted_gather(flat[:, :0], idx, torch.zeros(2, 5, 4))


def test_kernels_without_backward_refuse_grad_mode():
    """The attention kernel fills its output outside autograd (the TPU
    kernel has no VJP either): on any device, an input that needs a
    gradient under grad mode raises, and the same call under no_grad runs.
    The one-hot gather has its backward: gradients flow through it."""
    from pautdx_torch.ops import attention

    flat = torch.zeros(2, 10, 16, requires_grad=True)
    idx = torch.tensor([[0, 3, 3], [12, -1, 9]], dtype=torch.int32)
    q = torch.zeros(2, 5, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.aifi_attention(q, q, q, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.fused_attention(*(q.reshape(2, 2, 5, 16),) * 3)
    with torch.no_grad():
        assert gather.onehot_gather(flat, idx).shape == (2, 3, 16)
        assert attention.aifi_attention(q, q, q, 2).shape == q.shape
    gather.onehot_gather(flat, idx).sum().backward()
    assert flat.grad[0, :, 0].tolist() == [1, 0, 0, 2] + [0] * 6
    assert flat.grad[1, :, 0].tolist() == [1] + [0] * 8 + [2]


# ---------------------------------------------------------------- deformable


def test_deformable_bilinear_matches_reference():
    """method="default" against the JAX function (its 2x2-window path on
    the CPU, which tests/test_pallas_ops.py:168-197 holds to the Pallas
    branch): the output and the gradients to values, locations and
    attention weights, out-of-range locations included, at 1e-4/1e-5."""
    rng = np.random.default_rng(10)
    B, Q, h, d = 2, 5, 2, 4
    levels = [rng.normal(size=(B, 8, 8, h, d)).astype(np.float32),
              rng.normal(size=(B, 4, 4, h, d)).astype(np.float32)]
    loc = rng.uniform(-0.2, 1.2, (B, Q, 8, 2)).astype(np.float32)
    logits = rng.normal(size=(B, Q, h, 8)).astype(np.float32)
    wts = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probe = rng.normal(size=(B, Q, h * d)).astype(np.float32)

    def jloss(v0, v1, loc_, w_):
        out = jdeform.ms_deformable_attention_shared([v0, v1], loc_, w_,
                                                     [4, 4])
        return jnp.sum(out * probe), out

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                          has_aux=True)(
        *map(jnp.asarray, (*levels, loc, wts)))
    tv = [_t(v, True) for v in levels]
    tl, tw = _t(loc, True), _t(wts, True)
    got = deformable.ms_deformable_attention_shared(tv, tl, tw, [4, 4],
                                                    method="default")
    (got * torch.from_numpy(probe)).sum().backward()
    assert got.shape == (B, Q, h * d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    for t, g in zip((*tv, tl, tw), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5)


def test_bilinear_taps_zero_padding():
    """Corner rows are clamped into their level and offset by its base;
    a corner off the grid keeps weight 0, and the weights of a point fully
    inside sum to 1."""
    loc = torch.tensor([[[[0.5, 0.5], [-0.3, 0.2], [0.99, 0.99],
                          [0.25, 0.75]]]])
    idx, w = deformable.bilinear_taps([(4, 4), (2, 2)], loc, [2, 2])
    assert idx.dtype == torch.int32 and idx.shape == (1, 1, 4, 4)
    # level 0, x = y = 0.5 * 4 - 0.5 = 1.5: corners (1,1) (1,2) (2,1) (2,2)
    assert idx[0, 0, 0].tolist() == [5, 6, 9, 10]
    torch.testing.assert_close(w[0, 0, 0], torch.full((4,), 0.25))
    # x = -1.7: both x corners off the grid
    assert (w[0, 0, 1] == 0).all() and (idx[0, 0, 1] >= 0).all()
    # level 1 (base 16), x = y = 1.48: corners at 1 and 2, 2 off the grid
    assert idx[0, 0, 2].tolist() == [19, 19, 19, 19]
    assert w[0, 0, 2, 1:].eq(0).all() and 0 < w[0, 0, 2, 0] < 1
    torch.testing.assert_close(w[0, 0, 3].sum(), torch.tensor(1.0))


# ---------------------------------------------------------------------- lapjv


def test_lapjv_equals_reference_and_scipy():
    """Exactly the reference solver's columns (ties included, padded rows
    of a uniform 0 cost included), and scipy's optimal cost."""
    rng = np.random.default_rng(0)
    cost = rng.normal(size=(2, 3, 6, 40)).astype(np.float32)
    cost[0, 0] = np.round(cost[0, 0], 1)              # ties
    cost[1, :, 4:] = 0.0                              # padded gt rows
    got = lapjv_batch(cost)
    want = np.asarray(j_lapjv_batch(jnp.asarray(cost.reshape(6, 6, 40))))
    assert got.dtype == np.int32 and got.shape == (2, 3, 6)
    np.testing.assert_array_equal(got.reshape(6, 6), want)
    for c, a in zip(cost.reshape(6, 6, 40), got.reshape(6, 6)):
        assert len(set(a.tolist())) == 6
        r, col = linear_sum_assignment(c)
        np.testing.assert_allclose(c[np.arange(6), a].sum(), c[r, col].sum(),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="M <= Q"):
        lapjv_batch(np.zeros((1, 5, 3), np.float32))


# ------------------------------------------------------------------ criterion


B, Q, M, NL, BINS = 2, 20, 4, 2, 32


def _outputs(seed):
    """Seeded D-FINE-shaped outputs: 4 decoder heads (pre-head + 3 layers)
    with 3 sets of FDR corners, and the encoder head."""
    rng = np.random.default_rng(seed)

    def boxes():
        cxcy = rng.uniform(0.2, 0.8, (B, Q, 2))
        wh = rng.uniform(0.05, 0.4, (B, Q, 2))
        return np.concatenate([cxcy, wh], -1).astype(np.float32)

    def f(*shape, s=1.0):
        return (s * rng.normal(size=shape)).astype(np.float32)

    return {
        "intermediate_logits": [f(B, Q, NL) for _ in range(4)],
        "intermediate_boxes": [boxes() for _ in range(4)],
        "intermediate_corners": [f(B, Q, 4 * (BINS + 1)) for _ in range(3)],
        "initial_references": [boxes() for _ in range(3)],
        "enc_topk_logits": f(B, Q, NL),
        "enc_topk_bboxes": boxes(),
    }


def _gt(seed):
    rng = np.random.default_rng(seed)
    cxcy = rng.uniform(0.25, 0.75, (B, M, 2))
    wh = rng.uniform(0.1, 0.3, (B, M, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    classes = rng.integers(0, NL, (B, M)).astype(np.int32)
    mask = np.array([[1, 1, 1, 0], [1, 0, 0, 0]], np.float32)
    return boxes, classes, mask


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return _t(tree, True)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_build_cost_fgl_ddf_match_reference():
    out = _outputs(1)
    boxes, classes, mask = _gt(2)
    lg, bx = out["intermediate_logits"][1], out["intermediate_boxes"][1]
    want = jdetr.build_cost(*map(jnp.asarray, (lg, bx, boxes, classes,
                                               mask)))
    got = tdetr.build_cost(_t(lg), _t(bx), _t(boxes),
                           torch.from_numpy(classes), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    rng = np.random.default_rng(3)
    project = np.asarray(jdetr.weighting_function(BINS, 0.5, 4.0))
    corners = rng.normal(size=(6, 4 * (BINS + 1))).astype(np.float32)
    # target distances on, between and beyond the bins
    tdist = rng.uniform(-9, 9, (6, 4)).astype(np.float32)
    tdist[0] = project[[0, 5, 16, 32]]
    wgt = rng.uniform(0, 1, 6).astype(np.float32)
    want = jdetr._fgl_loss(jnp.asarray(corners), jnp.asarray(tdist),
                           jnp.asarray(project), jnp.asarray(wgt), BINS)
    got = tdetr._fgl_loss(_t(corners), _t(tdist), _t(project), _t(wgt),
                          BINS)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    s, t = (rng.normal(size=(B, Q, 4 * (BINS + 1))).astype(np.float32)
            for _ in range(2))
    w = rng.uniform(0, 1, (B, Q)).astype(np.float32)
    pos = (rng.uniform(size=(B, Q)) > 0.8).astype(np.float32)
    want = jdetr._ddf_loss(*map(jnp.asarray, (s, t, w, pos)), BINS)
    got = tdetr._ddf_loss(_t(s), _t(t), _t(w), _t(pos), BINS)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("legacy_vfl", [False, True])
def test_dfine_criterion_matches_reference(legacy_vfl):
    """The whole criterion (4 decoder heads, 3 with FDR corners and 2 with
    DDF, plus the encoder head, all matched through one host solve):
    every loss term and the gradient to every output at 1e-5."""
    out = _outputs(4)
    boxes, classes, mask = _gt(5)

    def jfn(o):
        return jdetr.dfine_criterion(o, *map(jnp.asarray, (boxes, classes,
                                                           mask)),
                                     num_labels=NL, max_num_bins=BINS,
                                     legacy_vfl=legacy_vfl)

    (jtotal, jaux), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, out))
    tout = _to_torch(out)
    total, aux = tdetr.dfine_criterion(tout, _t(boxes),
                                       torch.from_numpy(classes), _t(mask),
                                       NL, BINS, legacy_vfl=legacy_vfl)
    total.backward()
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    for t, g in zip(_leaves(tout), _leaves(jgrads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)


def test_hungarian_match_one_transfer_any_leading_dims():
    rng = np.random.default_rng(6)
    cost = rng.normal(size=(5, B, Q, M)).astype(np.float32)
    cost[0, 0, 3, 1] = np.nan
    got = tdetr.hungarian_match(torch.from_numpy(cost))
    assert got.dtype == torch.int64 and got.shape == (5, B, M)
    for h in range(5):
        want = jdetr.hungarian_match(jnp.asarray(cost[h]))
        np.testing.assert_array_equal(got[h].numpy(), np.asarray(want))


# ------------------------------------------------------------------ batchnorm


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_train_batchnorm_matches_flax(eps):
    """Outputs, input gradient and updated running statistics of flax's
    nn.BatchNorm(use_running_average=False) at its default momentum
    (biased variance), at D-FINE's eps and at YOLO's (``yolo.py:149``);
    eval mode reads the running statistics."""
    rng = np.random.default_rng(7)
    x = rng.normal(1.0, 2.0, (4, 5, 7, 6)).astype(np.float32)     # NHWC
    v = {"params": {"scale": (1 + rng.normal(0, .1, 6)).astype(np.float32),
                    "bias": rng.normal(0, .1, 6).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(0, .1, 6).astype(np.float32),
                         "var": rng.uniform(.5, 1.5, 6).astype(np.float32)}}
    probe = rng.normal(size=x.shape).astype(np.float32)

    def jfn(xx):
        y, m = fnn.BatchNorm(use_running_average=False, epsilon=eps).apply(
            v, xx, mutable=["batch_stats"])
        return jnp.sum(y * probe), (y, m)

    (_, (y, m)), gx = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(x))
    bn = BatchNorm(6, eps=eps)
    with torch.no_grad():
        bn.weight.copy_(_t(v["params"]["scale"]))
        bn.bias.copy_(_t(v["params"]["bias"]))
        bn.running_mean.copy_(_t(v["batch_stats"]["mean"]))
        bn.running_var.copy_(_t(v["batch_stats"]["var"]))
    bn.train()
    tx = _t(x.transpose(0, 3, 1, 2), True)
    out = bn(tx)
    (out * _t(probe.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(gx), rtol=1e-4, atol=1e-5)
    for k, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(m["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)
    bn.eval()
    with torch.no_grad():
        y_eval = bn(tx).numpy().transpose(0, 2, 3, 1)
    want = fnn.BatchNorm(use_running_average=True, epsilon=eps).apply(
        {"params": v["params"], "batch_stats": m["batch_stats"]},
        jnp.asarray(x))
    np.testing.assert_allclose(y_eval, np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------ optimizer


class _Two(torch.nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.w = torch.nn.Parameter(_t(a))
        self.head = torch.nn.Module()
        self.head.b = torch.nn.Parameter(_t(b))


def _adam_moments(opt_state):
    """{(path...): (mu, nu)} from every ScaleByAdamState in an optax
    state (several under multi_transform, with masked leaves)."""
    out = {}
    for st in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if not isinstance(st, optax.ScaleByAdamState):
            continue
        mus = jax.tree_util.tree_flatten_with_path(st.mu)[0]
        nus = dict(jax.tree_util.tree_flatten_with_path(st.nu)[0])
        for path, mu in mus:
            if hasattr(mu, "shape"):
                out[tuple(k.key for k in path)] = (mu, nus[path])
    return out


@pytest.mark.parametrize("groups,scale", [(False, 1.0), (True, 0.5)])
def test_make_optimizer_step_matches_optax(groups, scale):
    """Three steps from identical gradients, one of them above the clip
    norm: after EVERY step the parameters within 1e-6 of optax's
    chain(clip_by_global_norm, adamw) and AdamW's first and second moments
    within 1e-6 relative of optax's (so moments, bias correction and
    clipping agree step by step, not only the first update), per-group lr
    multipliers and a cosine schedule included, and an lr scale that
    multiplies the whole update (decay too)."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    grads = [(rng.normal(size=a.shape) * s, rng.normal(size=b.shape) * s)
             for s in (0.1, 3.0, 0.2)]
    sched = joptim.cosine_schedule(1e-2, 10, warmup_steps=2)
    kw = dict(learning_rate=1e-2)
    if groups:
        kw.update(group_lr_mults={"head": 3.0},
                  group_patterns={"head": ["head*"]})
    params = {"backbone": {"w": jnp.asarray(a)}, "head": {"b": jnp.asarray(b)}}
    jopt = joptim.make_optimizer(
        schedule=None if groups else sched,
        params=params if groups else None, **kw)
    jstate = jopt.init(params)
    model = _Two(a, b)
    topt = toptim.make_optimizer(
        schedule=None if groups else toptim.cosine_schedule(
            1e-2, 10, warmup_steps=2), **kw).init(model)
    leaves = {("backbone", "w"): model.backbone.w, ("head", "b"): model.head.b}
    for ga, gb in grads:
        g = {"backbone": {"w": jnp.asarray(ga, jnp.float32)},
             "head": {"b": jnp.asarray(gb, jnp.float32)}}
        upd, jstate = jopt.update(g, jstate, params)
        params = optax.apply_updates(params,
                                     joptim.scale_updates(upd, scale))
        model.backbone.w.grad = _t(ga)
        model.head.b.grad = _t(gb)
        topt.step(lr_scale=scale)
        moments = _adam_moments(jstate)
        assert sorted(moments) == sorted(leaves)
        for path, p in leaves.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[path[0]][path[1]]),
                                       rtol=0, atol=1e-6, err_msg=str(path))
            st = topt.adamw.state[p]
            for got, want in zip((st["exp_avg"], st["exp_avg_sq"]),
                                 moments[path]):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-12,
                                           err_msg=str(path))
    assert topt.count == 3
    labels = toptim.label_params(["backbone.w", "head.b", "head2.c"],
                                 {"head": ["head.*"]})
    assert labels == {"backbone.w": "default", "head.b": "head",
                      "head2.c": "default"}


def test_zero_frozen_grads_keeps_them_out_of_the_clip():
    model = _Two(np.ones((3, 4), np.float32), np.ones(5, np.float32))
    model.backbone.w.grad = torch.full((3, 4), 100.0)
    model.head.b.grad = torch.full((5,), 0.1)
    toptim.zero_frozen_grads(model, {"backbone.w": "frozen"})
    assert model.backbone.w.grad.abs().sum() == 0
    assert toptim.global_norm([p.grad for p in model.parameters()]) < 1.0


def test_schedules_plateau_ema_and_scale_match_reference():
    # optax evaluates the schedule in float32, the port in Python floats
    for kw in (dict(base_lr=1e-3, total_steps=50, warmup_steps=5),
               dict(base_lr=2e-4, total_steps=30, final_scale=0.1)):
        js, ts = joptim.cosine_schedule(**kw), toptim.cosine_schedule(**kw)
        for step in (0, 1, 4, 5, 6, 17, 29, 30, 49, 80):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5,
                                       atol=1e-12)
    jp, tp = joptim.ReduceLROnPlateau(patience=1), toptim.ReduceLROnPlateau(
        patience=1)
    for metric in (5.0, 4.0, 4.5, 4.6, 4.7, 3.0, 3.5, 3.6, 3.7, 3.8):
        assert tp.step(metric) == jp.step(metric)
    ema = {"w": torch.ones(3)}
    toptim.ema_update(ema, {"w": torch.zeros(3)}, decay=0.9)
    want = joptim.ema_update({"w": jnp.ones(3)}, {"w": jnp.zeros(3)}, 0.9)
    np.testing.assert_allclose(ema["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-7)
    got = toptim.scale_updates({"a": torch.ones(2)}, 0.5)
    assert got["a"].tolist() == [0.5, 0.5]


def test_guarded_replaces_non_finite_loss():
    def objective(x):
        return x.sum(), {"x": x.sum()}

    for values in ([1.0, 2.0], [1.0, float("nan")], [float("inf"), 0.0]):
        jl, jaux = j_guarded(objective)(jnp.asarray(values))
        tl, taux = guarded(objective)(torch.tensor(values))
        assert float(tl) == float(jl)
        assert float(taux["loss_was_finite"]) == float(jaux["loss_was_finite"])


# ----------------------------------------------------------------- checkpoint


def test_checkpoint_round_trip(tmp_path):
    """step_<n>/, markers.json (latest, best), metadata.json and
    history.json, as the reference's manager writes them; restored tensors
    identical."""
    ck = CheckpointManager(str(tmp_path))
    assert not ck.has_checkpoint
    rng = np.random.default_rng(12)
    states = [{"step": s, "params": {"w": _t(rng.normal(size=(3, 2)))},
               "batch_stats": {"m": _t(rng.normal(size=3))},
               "opt_state": {"count": s}}
              for s in range(3)]
    for s, st in enumerate(states):
        ck.save(s, st, metadata={"detector": "dfine"},
                history={"loss": list(range(s + 1))}, is_best=(s == 1))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "history.json", "markers.json", "metadata.json", "step_0", "step_1",
        "step_2"]
    assert json.loads((tmp_path / "markers.json").read_text()) == {
        "latest": 2, "best": 1}
    for which, step in (("latest", 2), ("best", 1), (0, 0)):
        state, meta = ck.restore(which)
        assert meta == {"detector": "dfine", "step": step}
        assert torch.equal(state["params"]["w"], states[step]["params"]["w"])
        assert torch.equal(state["batch_stats"]["m"],
                           states[step]["batch_stats"]["m"])
    assert ck.load_history() == {"loss": [0, 1, 2]}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore("best")
