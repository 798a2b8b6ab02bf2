"""pautdx_torch's D-FINE-nano training step held to the JAX reference on the
CPU: the training config ``dfine_nano(num_labels=2)`` (bilinear decoder,
head-shared points, patchify8 stem, f32) at 128px, where 8x8 + 4x4 = 80
anchors are all selected (under 150 queries), so near-ties in the query
top-k cannot change the matched loss.

One module-scoped JAX computation: the same randomised weights (every BN
statistic, scale and bias too, as tests/test_torch_dfine.py does) and the
same batch go through ``jax.value_and_grad`` of ``dfine_criterion o
DFine.apply(train=True, mutable=["batch_stats"])`` and through the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pautdx.losses.detr import dfine_criterion as j_criterion
from pautdx.models.vision import dfine as jdf
from pautdx_torch.compat.jax_weights import load_jax_variables, port_state_dict
from pautdx_torch.models.vision import dfine as tdf
from pautdx_torch.train.detector import dfine_objective, make_train_batches
from pautdx_torch.train.optim import make_optimizer
from pautdx_torch.train.trainer import Trainer

IMG = 128
LR = 1e-3


def _randomise(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise(v, rng)
            continue
        v = np.asarray(v)
        if k in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, v.shape)
        elif k == "scale":
            v = 1.0 + rng.normal(0.0, 0.1, v.shape)
        elif k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        out[k] = v.astype(np.float32)
    return out


def _j_objective(out, batch):
    """``cli.py:212-221``."""
    boxes = batch["boxes"] / IMG
    cxcywh = jnp.stack([(boxes[..., 0] + boxes[..., 2]) / 2,
                        (boxes[..., 1] + boxes[..., 3]) / 2,
                        boxes[..., 2] - boxes[..., 0],
                        boxes[..., 3] - boxes[..., 1]], -1)
    return j_criterion(out, cxcywh, batch["classes"], batch["mask"], 2, 32)


@pytest.fixture(scope="module")
def reference():
    cfg = jdf.dfine_nano(num_labels=2)
    variables = jdf.DFine(cfg).init({"params": jax.random.PRNGKey(0)},
                                    jnp.zeros((1, IMG, IMG, 3)), train=False)
    rng = np.random.default_rng(0)
    variables = _randomise(jax.tree_util.tree_map(np.asarray,
                                                  dict(variables)), rng)
    batches = make_train_batches(2, 2, size=IMG, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_fn(params):
        out, mutated = jdf.DFine(cfg).apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb["images"], train=True, mutable=["batch_stats"])
        loss, aux = _j_objective(out, jb)
        return loss, mutated["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return dict(cfg=cfg, variables=variables, batches=batches,
                loss=float(loss), grads=jax.tree_util.tree_map(np.asarray,
                                                               grads),
                stats=jax.tree_util.tree_map(np.asarray, stats))


def _port(variables):
    model = tdf.DFine(tdf.dfine_nano(num_labels=2), device="cpu")
    return load_jax_variables(model, variables, device="cpu")


def test_training_config_copy_matches_reference(reference):
    assert tdf.config_to_dict(tdf.dfine_nano(num_labels=2)) == \
        jdf.config_to_dict(reference["cfg"])


def _zero_floor(grads) -> float:
    """Gradients below this norm are zero up to float noise: a bias in
    front of a train-mode BatchNorm (which removes any per-channel shift)
    or a key bias under the softmax. 1e-6 of the global norm; every other
    leaf of this model lies above 1e-5 of it."""
    return 1e-6 * float(np.sqrt(sum(float((g.double() ** 2).sum())
                                    for g in grads)))


def test_train_step_matches_reference(reference):
    """The loss at 1e-4; every gradient leaf at 1e-3 relative in norm, or,
    for a leaf whose gradient is zero up to float noise, within the noise
    floor (1e-6 of the global norm); the new BN statistics at 1e-5; the
    model is left in train mode."""
    model = _port(reference["variables"])
    batch = {k: torch.from_numpy(v) for k, v in
             reference["batches"][0].items()}
    out = model(batch["images"], train=True)
    assert model.training
    assert len(out["intermediate_corners"]) == 3
    assert len(out["initial_references"]) == 3
    assert not out["initial_references"][0].requires_grad
    loss, _ = dfine_objective(IMG, model.cfg)(out, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), reference["loss"], rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    want = port_state_dict({"params": reference["grads"]}, names)
    params = dict(model.named_parameters())
    floor = _zero_floor(want.values())
    for name in names:
        g = params[name].grad
        if g is None:              # the denoising embedding takes no part
            g = torch.zeros_like(params[name])
        w = want[name]
        err = (g - w).norm().item()
        assert err <= 1e-3 * w.norm().item() or (
            w.norm().item() < floor and err < floor), (name, err)
    stats = port_state_dict({"batch_stats": reference["stats"]},
                            [n for n, _ in model.named_buffers()])
    for name, buf in model.named_buffers():
        torch.testing.assert_close(buf, stats[name], rtol=1e-5, atol=1e-5)


def test_eval_mode_takes_no_batch_statistics(reference):
    """forward(train=False) reads the running statistics and leaves them
    as they are."""
    model = _port(reference["variables"])
    before = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        model(torch.from_numpy(reference["batches"][0]["images"]))
    assert not model.training
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n


def test_dropout_knobs_act_in_training_only():
    """The reference's dropout knobs (0 in the nano preset) become
    nn.Dropout in the encoder and decoder layers: two training forwards
    differ, two eval forwards agree."""
    cfg = dataclasses.replace(tdf.dfine_nano(num_labels=2), dropout=0.1,
                              attention_dropout=0.1, activation_dropout=0.1)
    model = tdf.DFine(cfg, device="cpu")
    # attention, residual and activation dropout in the AIFI layer and in
    # each of the 3 decoder layers
    assert sum(isinstance(m, torch.nn.Dropout)
               for m in model.modules()) == 3 * 4
    x = torch.from_numpy(make_train_batches(1, 1, IMG, seed=2)[0]["images"])
    with torch.no_grad():
        a, b = (model(x, train=True)["pred_boxes"] for _ in range(2))
        assert not torch.equal(a, b)
        a, b = (model(x)["pred_boxes"] for _ in range(2))
        assert torch.equal(a, b)


def test_non_finite_step_changes_nothing(reference):
    """A batch whose loss is NaN: no update, the optimizer's moments and
    count and the BN running statistics as before the step."""
    model = _port(reference["variables"])
    tt = Trainer(model, dfine_objective(IMG, model.cfg), make_optimizer(LR),
                 input_key="images")
    state = tt.init(reference["batches"][0])
    state, _ = tt.train_epoch(state, reference["batches"][:1])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {k: {n: t.clone() for n, t in v.items()}
               for k, v in state.optimizer.adamw.state.items()}
    bad = dict(reference["batches"][1])
    bad["boxes"] = np.full_like(bad["boxes"], np.nan)
    state, m = tt.train_epoch(state, [bad])
    assert m["update_was_finite"] == 0.0 and m["loss_was_finite"] == 0.0
    assert state.step == 2 and state.optimizer.count == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in state.optimizer.adamw.state.items():
        for n, t in v.items():
            assert torch.equal(t, moments[k][n]), n
    with pytest.raises(NotImplementedError, match="item 14"):
        Trainer(model, None, make_optimizer(LR), mesh=object())


def test_checkpoint_restores_the_model(reference, tmp_path):
    """fit() writes a checkpoint per epoch with the CLI's metadata;
    restore_dfine rebuilds the config from it and loads identical tensors,
    and TrainState.load_state_dict brings back the optimizer."""
    from pautdx_torch.train.checkpoint import restore_dfine
    from pautdx_torch.train.detector import dfine_metadata

    model = _port(reference["variables"])
    tt = Trainer(model, dfine_objective(IMG, model.cfg), make_optimizer(LR),
                 checkpoint_dir=str(tmp_path), input_key="images")
    state = tt.init(reference["batches"][0])
    logs = []
    state = tt.fit(state, lambda: reference["batches"][:1], epochs=1,
                   metadata=dfine_metadata(model.cfg, IMG), log=logs.append)
    assert logs and "train_total" in tt.history
    restored, saved, meta = restore_dfine(str(tmp_path), "latest",
                                          device="cpu")
    assert meta["step"] == 0 and meta["detector"] == "dfine"
    assert restored.cfg == model.cfg
    for k, v in model.state_dict().items():
        assert torch.equal(restored.state_dict()[k], v), k
    other = Trainer(restored, None, make_optimizer(LR), input_key="images")
    ostate = other.init(reference["batches"][0])
    ostate.load_state_dict(saved)
    assert ostate.step == 1 and ostate.optimizer.count == 1
    assert dataclasses.asdict(restored.cfg) == dataclasses.asdict(model.cfg)
