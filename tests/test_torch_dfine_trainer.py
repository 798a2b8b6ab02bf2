"""pautdx_torch's Trainer held to pautdx.train.Trainer on the CPU: two steps
of D-FINE-nano training (``dfine_nano(num_labels=2)`` at 128px, AdamW at
the CLI's lr, clipping, f32) from the same weights and batches.

One module-scoped JAX computation, the reference Trainer's two steps. The
weights, batches and objective are those of tests/test_torch_dfine_train.py.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dfine_trainer.py

prints why the second step is compared from the reference's first-step
state (see ``test_two_trainer_steps_match_reference``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pautdx.models.vision import dfine as jdf
from pautdx.train import Trainer as JTrainer
from pautdx.train import make_optimizer as j_make_optimizer
from pautdx_torch.compat.jax_weights import load_jax_variables, port_state_dict
from pautdx_torch.train.detector import dfine_objective, make_train_batches
from pautdx_torch.train.optim import make_optimizer
from pautdx_torch.train.trainer import Trainer
from test_torch_dfine_train import (IMG, LR, _j_objective, _port, _randomise,
                                    _zero_floor)

ADAM_EPS = 1e-8


def _copy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _reference_steps():
    cfg = jdf.dfine_nano(num_labels=2)
    batches = make_train_batches(2, 2, size=IMG, seed=1)
    jt = JTrainer(jdf.DFine(cfg), _j_objective, j_make_optimizer(LR),
                  input_key="images", prefetch=0)
    state = jt.init(batches[0])
    variables = _randomise(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}),
        np.random.default_rng(0))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = state.replace(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jt.optimizer.init(params))
    steps = []
    for batch in batches:
        state, metrics = jt.train_epoch(state, [batch])
        adam, = [s for s in jax.tree_util.tree_leaves(
            state.opt_state,
            is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        steps.append(dict(metrics=metrics, params=_copy(state.params),
                          stats=_copy(state.batch_stats),
                          count=int(adam.count), mu=_copy(adam.mu),
                          nu=_copy(adam.nu)))
    return dict(variables=variables, batches=batches, steps=steps)


@pytest.fixture(scope="module")
def reference():
    return _reference_steps()


def _grads(model, batch):
    """The port's raw gradients on ``batch``, from a copy of ``model``."""
    model = copy.deepcopy(model)
    out = model(torch.from_numpy(batch["images"]), train=True)
    loss, _ = dfine_objective(IMG, model.cfg)(
        out, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def _global_norm(grads) -> float:
    return float(np.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads.values())))


def _load_reference_state(model, opt, ref):
    """The reference's state after a step, into the port's model (params,
    BN statistics) and its AdamW (moments; the step count must agree)."""
    load_jax_variables(model, {"params": ref["params"],
                               "batch_stats": ref["stats"]}, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    mu = port_state_dict({"params": ref["mu"]}, names)
    nu = port_state_dict({"params": ref["nu"]}, names)
    assert opt.count == ref["count"]
    with torch.no_grad():
        for name, p in model.named_parameters():
            st = opt.adamw.state[p]
            assert int(st["step"]) == ref["count"]
            st["exp_avg"].copy_(mu[name])
            st["exp_avg_sq"].copy_(nu[name])


def test_two_trainer_steps_match_reference(reference):
    """Each step's loss terms and gradient norm at 1e-3, its BN statistics
    at 1e-5, and after it every parameter within 1e-2 * lr of the
    reference's in RMS and every element within 2 * lr (Adam's first-step
    bound). A leaf whose whole gradient is float noise (below 1e-6 of the
    global norm: a bias in front of a train-mode BatchNorm, a key bias
    under the softmax) is held to the element bound alone: Adam moves its
    elements by about lr either way.

    The first step starts from the common weights. Adam moves an element
    by lr * g / (|g| + eps), so rounding in g decides the move only where
    the clipped |g| is near eps (1e-8): every element more than 0.1 * lr
    from the reference's after the first step has a clipped gradient below
    20 * eps. The second step starts from the reference's first-step state
    (parameters, BN statistics, Adam moments and count), because the
    model's second-step gradient is sensitive to those few elements
    (running this file as a script prints by how much):
    from the port's own first-step state it drifts past these limits,
    whatever the optimizer does."""
    batches = reference["batches"]
    model = _port(reference["variables"])
    grads = _grads(model, batches[0])
    floor = _zero_floor(grads.values())
    clip = max(_global_norm(grads), 1.0)          # clip_norm is 1
    tt = Trainer(model, dfine_objective(IMG, model.cfg), make_optimizer(LR),
                 input_key="images")
    state = tt.init(batches[0])
    names = [n for n, _ in model.named_parameters()]
    buffers = [n for n, _ in model.named_buffers()]
    for i, (batch, ref) in enumerate(zip(batches, reference["steps"])):
        if i == 1:
            _load_reference_state(model, state.optimizer,
                                  reference["steps"][0])
        state, tm = tt.train_epoch(state, [batch])
        jm = ref["metrics"]
        assert tm["update_was_finite"] == 1.0 == jm["update_was_finite"]
        for k in ("total", "cls", "l1", "giou", "ddf", "grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3,
                                       err_msg=f"step {i}: {k}")
        want = port_state_dict({"params": ref["params"]}, names)
        for name, p in model.named_parameters():
            d = (p.detach() - want[name]).double().abs()
            assert d.max().item() <= 2 * LR, (i, name)
            if grads[name].norm().item() < floor:
                continue
            assert d.pow(2).mean().sqrt().item() <= 1e-2 * LR, (i, name)
            if i == 0 and (d > 0.1 * LR).any():
                g = grads[name].abs()[d > 0.1 * LR] / clip
                assert g.max().item() < 20 * ADAM_EPS, name
        stats = port_state_dict({"batch_stats": ref["stats"]}, buffers)
        for name, buf in model.named_buffers():
            torch.testing.assert_close(buf, stats[name], rtol=1e-5,
                                       atol=1e-5)
    assert state.step == 2 and state.optimizer.count == 2


def _second_step_sensitivity():
    """How far the port's second-step gradient moves between the port's
    own first-step state and the reference's, and how much of that the
    elements more than ``t * lr`` from the reference's carry."""
    ref = _reference_steps()
    batches = ref["batches"]
    model = _port(ref["variables"])
    g0 = _grads(model, batches[0])
    clip = max(_global_norm(g0), 1.0)
    tt = Trainer(model, dfine_objective(IMG, model.cfg), make_optimizer(LR),
                 input_key="images")
    tt.train_epoch(tt.init(batches[0]), batches[:1])
    own = {n: p.detach().clone() for n, p in model.named_parameters()}
    want = port_state_dict({"params": ref["steps"][0]["params"]}, list(own))
    at_ref = _grads(_port({"params": ref["steps"][0]["params"],
                           "batch_stats": ref["steps"][0]["stats"]}),
                    batches[1])
    base = _global_norm(at_ref)
    floor = _zero_floor(g0.values())

    def gap(params):
        probe = _port({"params": ref["steps"][0]["params"],
                       "batch_stats": ref["steps"][0]["stats"]})
        with torch.no_grad():
            for n, p in probe.named_parameters():
                p.copy_(params[n])
        g = _grads(probe, batches[1])
        return _global_norm({n: g[n] - at_ref[n] for n in g}) / base

    print(f"step-2 gradient from the port's own step-1 state: "
          f"{gap(own):.3e} of its norm from the one at the reference's")
    for t in (0.5, 0.1, 0.01):
        far = {n: ((own[n] - want[n]).abs() > t * LR)
               & (g0[n].norm() >= floor) for n in own}
        count = sum(int(m.sum()) for m in far.values())
        gmax = max((float(g0[n].abs()[m].max()) / clip
                    for n, m in far.items() if m.any()), default=0.0)
        mixed = {n: torch.where(far[n], want[n], own[n]) for n in own}
        print(f"{count} elements (outside the noise-gradient leaves) more "
              f"than {t} * lr from the reference's "
              f"after step 1 (largest clipped step-0 |g| among them "
              f"{gmax:.3e}); with them set to the reference's, the step-2 "
              f"gradient is {gap(mixed):.3e} of its norm away")


if __name__ == "__main__":
    _second_step_sensitivity()
