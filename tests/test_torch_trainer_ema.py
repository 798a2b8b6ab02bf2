"""The Trainer's EMA of the parameters (``Trainer(ema_decay=...)``) on a
tiny model, against its closed form and against the JAX ``Trainer``'s
``ema_params`` on a flax counterpart with the same weights and batches.
The EMA covers the parameters, not the BN statistics; it moves on a step
the guard refuses, toward the unchanged parameters, as the reference's
does (``ema_update`` of ``new_params``, which equal the old ones when the
update is zeroed); the checkpoint keeps it, and ``ema_weights`` swaps it
in and back."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pautdx.train import Trainer as JTrainer
from pautdx.train import make_optimizer as j_make_optimizer
from pautdx_torch.models.vision.hgnet import BatchNorm
from pautdx_torch.train.checkpoint import CheckpointManager
from pautdx_torch.train.optim import make_optimizer
from pautdx_torch.train.trainer import Trainer, ema_weights
from torch_threads import one_torch_thread  # noqa: F401

DECAY = 0.9
LR = 1e-2


class Tiny(nn.Module):
    def __init__(self, norm: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(4, 8)
        self.norm = BatchNorm(8) if norm else nn.Identity()
        self.fc2 = nn.Linear(8, 1)

    def forward(self, x, train: bool = False):
        self.train(train)
        return self.fc2(torch.relu(self.norm(self.fc1(x))))


class JTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Dense(1, name="fc2")(fnn.relu(fnn.Dense(8, name="fc1")(x)))


def _objective(out, batch):
    loss = ((out[..., 0] - batch["y"]) ** 2).mean()
    return loss, {"mse": loss}


def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(6, 4)).astype(np.float32),
             "y": rng.normal(size=(6,)).astype(np.float32)}
            for _ in range(n)]


def _trainer(model, **kw):
    return Trainer(model, _objective, make_optimizer(LR), ema_decay=DECAY,
                   input_key="x", **kw)


def test_ema_follows_its_closed_form_and_skips_bn_statistics():
    torch.manual_seed(0)
    model = Tiny(norm=True)
    tr = _trainer(model)
    state = tr.init(_batches()[0])
    assert set(state.ema) == {n for n, _ in model.named_parameters()}
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    for batch in _batches():
        tr.train_epoch(state, [batch])
        for n, p in model.named_parameters():
            want[n] = DECAY * want[n] + (1 - DECAY) * p.detach()
    for n in want:
        torch.testing.assert_close(state.ema[n], want[n], atol=1e-6,
                                   rtol=0)
        assert not torch.equal(state.ema[n], dict(
            model.named_parameters())[n])
    assert Trainer(model, _objective, make_optimizer(LR),
                   input_key="x").init(_batches()[0]).ema is None


def test_ema_moves_on_a_refused_step():
    torch.manual_seed(1)
    model = Tiny(norm=True)
    tr = _trainer(model)
    state = tr.init(_batches()[0])
    tr.train_epoch(state, _batches()[:1])
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    ema = {n: e.clone() for n, e in state.ema.items()}
    bad = dict(_batches()[1])
    bad["y"] = np.full_like(bad["y"], np.nan)
    _, m = tr.train_epoch(state, [bad])
    assert m["update_was_finite"] == 0.0
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), n
        want = DECAY * ema[n] + (1 - DECAY) * params[n]
        torch.testing.assert_close(state.ema[n], want, atol=1e-7, rtol=0)
        assert not torch.equal(state.ema[n], ema[n]), n


def test_ema_matches_the_jax_trainer():
    """Three steps of the JAX Trainer (ema_decay=0.9) and of the port's
    from the same weights and batches: the EMA within 1e-6."""
    batches = _batches()
    jt = JTrainer(JTiny(), _objective, j_make_optimizer(LR),
                  ema_decay=DECAY, input_key="x")
    jstate = jt.init(batches[0])
    # the reference's init aliases ema_params to params, and its jitted
    # step donates both, which XLA refuses ("donate the same buffer
    # twice"); a copy starts the EMA at the same values
    jstate = jstate.replace(
        ema_params=jax.tree_util.tree_map(jnp.copy, jstate.params))
    model = Tiny()
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            leaf = jstate.params[name]
            getattr(model, name).weight.copy_(
                torch.from_numpy(np.array(leaf["kernel"]).T))
            getattr(model, name).bias.copy_(
                torch.from_numpy(np.array(leaf["bias"])))
    tr = _trainer(model)
    state = tr.init(batches[0])
    for batch in batches:
        jstate, _ = jt.train_epoch(jstate, [batch])
        tr.train_epoch(state, [batch])
    for name in ("fc1", "fc2"):
        leaf = jax.tree_util.tree_map(np.asarray, jstate.ema_params[name])
        np.testing.assert_allclose(state.ema[f"{name}.weight"].numpy(),
                                   leaf["kernel"].T, atol=1e-6, rtol=0)
        np.testing.assert_allclose(state.ema[f"{name}.bias"].numpy(),
                                   leaf["bias"], atol=1e-6, rtol=0)


def test_checkpoint_keeps_the_ema_and_ema_weights_swap_back(tmp_path):
    torch.manual_seed(2)
    model = Tiny(norm=True)
    tr = _trainer(model, checkpoint_dir=str(tmp_path))
    state = tr.init(_batches()[0])
    state = tr.fit(state, lambda: _batches(), epochs=1, log=lambda s: None)
    saved, _ = CheckpointManager(str(tmp_path)).restore("latest")
    for n, e in state.ema.items():
        assert torch.equal(saved["ema_params"][n], e), n
    other = Tiny(norm=True)
    ostate = _trainer(other).init(_batches()[0])
    ostate.load_state_dict(saved)
    for n, e in state.ema.items():
        assert torch.equal(ostate.ema[n], e), n
    trained = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    with pytest.raises(RuntimeError, match="inside"):
        with ema_weights(state) as m:
            for n, p in m.named_parameters():
                assert torch.equal(p, state.ema[n]), n
            for n, b in m.named_buffers():
                assert torch.equal(b, stats[n]), n
            raise RuntimeError("inside")
    for n, p in model.named_parameters():
        assert torch.equal(p, trained[n]), n
