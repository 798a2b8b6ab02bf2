"""The signal domain's losses held to the JAX reference on the CPU: every
loss and objective of ``losses/{classification,regression,position,
heatmap}.py`` and ``train.recipes.OBJECTIVES``, its value, its components
and its gradient with respect to the predictions, within 1e-6 at f32, on
the same numpy inputs (masks with zeros, probabilities at the clip, a
centre half way between two cells).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx import losses as jl
from pautdx.losses import heatmap as jhm
from pautdx.train import recipes as jrec
from pautdx_torch import losses as tl
from pautdx_torch.losses import heatmap as thm
from pautdx_torch.train import recipes as trec
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6
B, L = 3, 7
SIG_LEN = 96


def rng(seed):
    return np.random.default_rng(seed)


def f32(a):
    return np.asarray(a, np.float32)


def probs(seed, shape):
    p = rng(seed).uniform(0.0, 1.0, shape)
    p.flat[0], p.flat[1] = 0.0, 1.0          # at the 1e-7 clip
    return f32(p)


def labels(seed):
    return f32(rng(seed).integers(0, 2, (B, L)))


def intervals(seed, shape=(B, L)):
    a = rng(seed).uniform(0.0, 1.0, shape + (2,))
    return f32(np.sort(a, axis=-1))


def sample_mask():
    return f32([1.0, 1.0, 0.0])


def outs(seed, keys):
    r = rng(seed)
    shapes = {"prob": (B, L), "positions": (B, L, 2),
              "cls_uncertainty": (B, L), "pos_uncertainty": (B, L, 2),
              "class_logits": (B, L, 3), "anomaly": (B, L)}
    out = {k: f32(r.uniform(0.05, 0.95, shapes[k])) for k in keys}
    if "class_logits" in out:
        out["class_logits"] = f32(r.normal(size=shapes["class_logits"]))
    return out


def detloc_outs(seed):
    r = rng(seed)
    return [{"cls": f32(r.normal(size=(B, L, n))),
             "reg": f32(r.normal(size=(B, L, n, 2)))}
            for n in (SIG_LEN // 8, SIG_LEN // 16, SIG_LEN // 32)]


def detloc_positions():
    pos = intervals(20)
    # samples 18 to 30, exact in binary: centre 24, 24 / 8 - 0.5 = 2.5,
    # half way between the cells 2 and 3 of stride 8
    pos[0, 0] = [0.1875, 0.3125]
    return pos


# (name, reference fn, port fn, predictions (differentiated), the rest);
# every fn returns a scalar or a (scalar, components) pair
CASES = [
    ("bce", jl.bce, tl.bce, probs(1, (B, L)), (labels(2),)),
    ("bce_mask", jl.bce, tl.bce, probs(3, (B, L)),
     (labels(4), sample_mask()[:, None])),
    ("bce_with_logits", lambda x, y: jl.bce_with_logits(x, y, None, 2.0),
     lambda x, y: tl.bce_with_logits(x, y, None, 2.0),
     f32(rng(5).normal(size=(B, L)) * 4), (labels(6),)),
    ("focal", jl.focal_bce_with_logits, tl.focal_bce_with_logits,
     f32(rng(7).normal(size=(B, L)) * 4), (probs(8, (B, L)),)),
    ("ce", jl.cross_entropy, tl.cross_entropy,
     f32(rng(9).normal(size=(B, L, 3))),
     (rng(10).integers(0, 3, (B, L)).astype(np.int32),)),
    ("ce_weights_mask", lambda x, y, w, m: jl.cross_entropy(x, y, w, m),
     lambda x, y, w, m: tl.cross_entropy(x, y, w, m),
     f32(rng(11).normal(size=(B, L, 3))),
     (rng(12).integers(0, 3, (B, L)).astype(np.int32), f32([0.2, 1.0, 3.0]),
      sample_mask()[:, None])),
    ("interval_iou", lambda a, b: jl.interval_iou_1d(a, b).sum(),
     lambda a, b: tl.interval_iou_1d(a, b).sum(), intervals(13),
     (intervals(14),)),
    ("masked_l1", jl.masked_l1, tl.masked_l1, intervals(15),
     (intervals(16), labels(17))),
    ("masked_smooth_l1", lambda p, t, m: jl.masked_smooth_l1(p, t, m, 0.2),
     lambda p, t, m: tl.masked_smooth_l1(p, t, m, 0.2), intervals(18),
     (intervals(19), labels(20))),
    ("masked_iou", jl.masked_iou_loss, tl.masked_iou_loss, intervals(21),
     (intervals(22), labels(23))),
    ("focal_l1", jl.focal_l1, tl.focal_l1, intervals(24),
     (intervals(25), labels(26))),
    ("temporal_consistency", lambda x: jl.temporal_consistency(x, 1),
     lambda x: tl.temporal_consistency(x, 1), probs(27, (B, L)), ()),
    ("uncertainty", jl.uncertainty_regularizer, tl.uncertainty_regularizer,
     probs(28, (B, L)) * 3, ()),
    ("enhanced_position", jl.enhanced_position_loss,
     tl.enhanced_position_loss, intervals(29)[..., ::-1].copy(),
     (intervals(30), labels(31))),
    ("detection", jl.detection_loss, tl.detection_loss, probs(32, (B, L)),
     (labels(33), sample_mask())),
    ("detection_position", jl.detection_position_loss,
     tl.detection_position_loss, outs(34, ("prob", "positions")),
     (labels(35), intervals(36), sample_mask())),
    ("two_stage", jl.two_stage_loss, tl.two_stage_loss,
     outs(37, ("prob", "positions", "cls_uncertainty", "pos_uncertainty")),
     (labels(38), intervals(39), sample_mask())),
    ("seq_detector", jl.seq_detector_loss, tl.seq_detector_loss,
     outs(40, ("class_logits", "positions", "anomaly")),
     (rng(41).integers(0, 3, (B, L)).astype(np.int32), intervals(42),
      sample_mask())),
    ("position_accuracy", jl.position_accuracy_iou, tl.position_accuracy_iou,
     intervals(43), (intervals(44), labels(45))),
    ("detloc_criterion",
     lambda o, y, p: jhm.detloc_criterion(o, y, p, SIG_LEN),
     lambda o, y, p: thm.detloc_criterion(o, y, p, SIG_LEN),
     detloc_outs(46), (labels(47), detloc_positions())),
]
for _name in jrec.OBJECTIVES:
    _keys = {"detection": ("prob",),
             "detection_position": ("prob", "positions"),
             "two_stage": ("prob", "positions", "cls_uncertainty",
                           "pos_uncertainty"),
             "enhanced_position": ("positions",),
             "seq_detector": ("class_logits", "positions", "anomaly")}[_name]
    CASES.append((f"objective_{_name}",
                  lambda o, b, _n=_name: jrec.OBJECTIVES[_n](o, b),
                  lambda o, b, _n=_name: trec.OBJECTIVES[_n](o, b),
                  outs(50, _keys),
                  ({"labels": labels(51), "positions": intervals(52),
                    "sample_mask": sample_mask()},)))


def to_torch(tree, grad=False):
    if isinstance(tree, dict):
        return {k: to_torch(v, grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, grad) for v in tree)
    t = torch.from_numpy(np.ascontiguousarray(tree))
    return t.requires_grad_() if grad else t


def grads_of(tree):
    if isinstance(tree, dict):
        return {k: grads_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(grads_of(v) for v in tree)
    return tree.grad.numpy()


def split(res):
    return res if isinstance(res, tuple) else (res, {})


def assert_close(got, want, what):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=0, atol=TOL, err_msg=what),
        got, want)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_loss_value_and_gradient_match_reference(case):
    name, jfn, tfn, pred, rest = case

    def jloss(p):
        loss, aux = split(jfn(p, *rest))
        return loss, aux

    (want, want_aux), want_grad = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(pred)
    tpred = to_torch(pred, grad=True)
    got, got_aux = split(tfn(tpred, *to_torch(rest)))
    if not got.requires_grad:               # a count: zero gradient
        assert not any(np.any(g) for g in jax.tree_util.tree_leaves(
            want_grad))
        assert_close(got.numpy(), want, f"{name}: value")
        return
    got.backward()
    assert_close(got.detach().numpy(), want, f"{name}: loss")
    assert set(got_aux) == set(want_aux)
    assert_close({k: torch.as_tensor(v).detach().numpy()
                  for k, v in got_aux.items()}, dict(want_aux),
                 f"{name}: components")
    assert_close(grads_of(tpred), want_grad, f"{name}: gradient")


def test_detloc_targets_match_reference():
    """Per scale heatmap, offset, log width and the positive cell; a
    centre half way between two cells rounds to the even one in both."""
    y, pos = labels(60), detloc_positions()
    y[0, 0] = 1.0
    n_cells = (SIG_LEN // 8, SIG_LEN // 16, SIG_LEN // 32)
    want = jax.jit(lambda y, p: jhm.detloc_targets(y, p, SIG_LEN, n_cells))(
        y, pos)
    got = thm.detloc_targets(torch.from_numpy(y), torch.from_numpy(pos),
                             SIG_LEN, n_cells)
    assert_close([{k: v.numpy() for k, v in g.items()} for g in got],
                 [dict(w) for w in want], "detloc_targets")
    assert got[0]["pos_mask"][0, 0, 2] == 1.0     # round(2.5) = 2, even
