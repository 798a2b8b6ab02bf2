"""Training the signal domain, held to the JAX reference on the CPU.

- The ``Trainer``'s two repairs: ``input_key`` defaults to ``"signals"``,
  as the reference's (``Trainer(model, objective, optimizer)`` over a
  ``BatchIterator`` batch); and dropout draws from a generator the
  trainer owns, seeded from (``seed``, step): two ``train_signal`` runs
  from one seed give bit-equal weights whatever the global generator
  holds, and two seeds give different ones.
- Three ``Trainer`` steps of the port against three of the reference's
  ``Trainer``, HybridBinary under the ``detection`` recipe and
  ``SignalSequenceDetector`` under ``seq_detector`` (its three parameter
  groups and the cosine lr of ``train.signal.recipe_optimizer`` against
  the reference's ``make_optimizer(..., group_lr_mults=, group_patterns=,
  params=)`` and ``cosine_schedule``), dropout 0, in float64: every
  parameter and BN statistic within 1e-9. (In f32 the gradients that are
  zero by construction, a conv bias before a train-mode BatchNorm or an
  attention key's bias, are rounding noise, which Adam's first step
  turns into +-lr.) The reference's GRU cells start from a float32 zero
  carry, which its scan cannot carry in float64; the test gives them the
  same zeros in float64.
- ``train_signal`` -> ``restore_signal_model`` -> ``SignalEndpoint`` on
  two tiny JSON volumes; ``dp=True`` in one gloo rank (the one-process run
  bit for bit) and over two spawned ranks (the state returned is rank 0's
  last checkpoint); ``HybridPhases`` freezing as
  ``tests/test_recipes_phases.py`` checks it; ``SNRCurriculum``'s fresh
  plateau controller a stage.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from pautdx.models.signal import HybridBinaryModel as JHybridBinary
from pautdx.models.signal.seq_detector import (
    SignalSequenceDetector as JSeqDetector,
)
from pautdx.train import optim as joptim
from pautdx.train import recipes as jrecipes
from pautdx.train.trainer import Trainer as JTrainer
from pautdx.train.trainer import TrainState as JTrainState
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.data.datasets import BatchIterator, SignalSequences
from pautdx_torch.data.synthetic import VolumeSpec, write_json_volume
from pautdx_torch.models.signal import (
    HybridBinaryModel, HybridModel, SignalSequenceDetector,
)
from pautdx_torch.serve.endpoints import SignalEndpoint
from pautdx_torch.train.optim import (
    ReduceLROnPlateau, cosine_schedule, label_params, make_optimizer,
)
from pautdx_torch.train.recipes import RECIPES, HybridPhases, SNRCurriculum
from pautdx_torch.train import signal as signal_train
from pautdx_torch.train.checkpoint import CheckpointManager
from pautdx_torch.train.signal import (
    recipe_optimizer, restore_signal_model, train_signal,
)
from pautdx_torch.train.trainer import Trainer
from tests.test_torch_signal_zoo import random_variables
from torch_threads import one_torch_thread  # noqa: F401

B, L, S = 2, 5, 64
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dataset(n, seed=0):
    r = np.random.default_rng(seed)
    pos = np.sort(r.uniform(0, 1, (n, L, 2)), -1).astype(np.float32)
    y = r.integers(0, 2, (n, L)).astype(np.float32)
    return SignalSequences(r.normal(size=(n, L, S)).astype(np.float32), y,
                           pos * y[..., None])


def tiny_hybrid_binary(dropout=0.0):
    return HybridBinaryModel((32, 16, 8), 2, dropout, 1, pooled_len=32,
                             device="cpu")


def test_trainer_takes_signals_by_default():
    """Repair: the reference's ``Trainer(model, objective, opt)`` reads
    ``batch["signals"]``; the port's read ``"images"`` and raised."""
    trainer = Trainer(tiny_hybrid_binary(), RECIPES["detection"]
                      .make_objective(), make_optimizer())
    batches = list(BatchIterator(dataset(4), 2))
    state = trainer.init(batches[0])
    _, row = trainer.train_epoch(state, batches[:1])
    assert row["update_was_finite"] == 1.0 and state.step == 1
    assert trainer.model.training
    aux, _ = trainer.evaluate(state, batches[1:])
    assert np.isfinite(aux["loss"]) and not trainer.model.training


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    d = tmp_path_factory.mktemp("signal_volumes")
    for i in range(2):
        write_json_volume(str(d / f"v{i}.json"),
                          VolumeSpec(n_beams=3, n_scans=40, seed=11 + i))
    return str(d)


@pytest.fixture(scope="module")
def runs(volumes, tmp_path_factory):
    """``train_signal`` three times, two epochs of HybridBinary at full
    width (dropout 0.15): seed 0 after the global generator was seeded 1,
    seed 0 again after it was seeded 2, and seed 1."""
    out = {}
    for name, seed, glob in (("a", 0, 1), ("b", 0, 2), ("c", 1, 1)):
        torch.manual_seed(glob)
        ck = str(tmp_path_factory.mktemp(f"ck_{name}"))
        trainer, state = train_signal(volumes, ck, epochs=2, batch_size=4,
                                      seq_len=8, seed=seed, device="cpu",
                                      log=lambda m: None)
        out[name] = (ck, trainer, {k: v.detach().clone() for k, v in
                                   state.model.state_dict().items()})
    return out


def test_train_signal_dropout_is_seeded_by_the_trainer(runs):
    """Repair: the trainer's own generator, seeded from (seed, step), gives
    the same dropout masks whatever ran before; the parent drew them from
    the global generator."""
    a, b, c = (runs[k][2] for k in "abc")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a
               if a[k].is_floating_point())
    assert runs["a"][1].history["epoch"] == [0, 1]


def test_train_signal_restores_into_the_endpoint(runs):
    ck, trainer, weights = runs["a"]
    model, meta = restore_signal_model(ck, device="cpu")
    assert meta["model"] == "HybridBinary" and meta["recipe"] == "detection"
    assert meta["seq_len"] == 8 and meta["signal_length"] == 320
    assert not model.training
    sd = model.state_dict()
    best = meta["step"]
    if best == len(trainer.history["epoch"]) - 1:   # best is the last epoch
        assert all(torch.equal(sd[k], weights[k]) for k in sd)
    x = np.random.default_rng(3).normal(size=(2, 8, 320)).astype(np.float32)
    got = SignalEndpoint(model, device="cpu").predict(x)["prob"]
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape == (2, 8)


def test_train_signal_dp_and_shape_errors(volumes, tmp_path, runs):
    # dp=True on the CPU: one gloo rank, the run of seed 0 bit for bit
    _, state = train_signal(volumes, str(tmp_path / "dp"), epochs=2,
                            batch_size=4, seq_len=8, seed=0, dp=True,
                            device="cpu", log=lambda m: None)
    want = runs["a"][2]
    got = state.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="signal_length"):
        train_signal(volumes, str(tmp_path), seq_len=8, signal_length=360,
                     device="cpu")
    with pytest.raises(ValueError, match="no batch"):
        train_signal(volumes, str(tmp_path), device="cpu")   # seq_len 50


def _equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def test_train_signal_dp_over_spawned_ranks_returns_rank_0s_run(volumes,
                                                                tmp_path):
    """dp over two spawned gloo ranks, as over two cards: the state
    returned is rank 0's last checkpoint, its trained optimizer included,
    with the history rank 0 wrote."""
    out = str(tmp_path / "dp2")
    kw = dict(data_dir=volumes, out=out, model="HybridBinary",
              recipe="detection", epochs=2, batch_size=4, seq_len=8,
              defect_focused=False, signal_length=320, seed=0)
    trainer, state = signal_train._train_dp(kw, torch.device("cpu"),
                                            lambda m: None, n=2)
    saved, meta = CheckpointManager(out).restore("latest")
    assert meta["step"] == 1 and trainer.history["epoch"] == [0, 1]
    assert all(np.isfinite(trainer.history["train_bce"]))
    assert state.step == saved["step"] > 0
    assert _equal_trees(state.state_dict(), saved)
    assert state.optimizer.count > 0


# ---------------------------------------------------------------------------
# three steps against the reference's Trainer, float64

CASES = {
    "hybrid_binary": (
        "detection",
        lambda: JHybridBinary((32, 16, 8), 2, 0.0, 1, pooled_len=32),
        tiny_hybrid_binary),
    "seq_detector": (
        "seq_detector",
        lambda: JSeqDetector(d_model=16, num_heads=2, num_layers=1,
                             dropout=0.0),
        lambda: SignalSequenceDetector(d_model=16, num_heads=2, num_layers=1,
                                       dropout=0.0, device="cpu")),
}


@pytest.fixture
def float64_gru_carry(monkeypatch):
    """The reference's GRU cells start from a zero carry in their
    ``param_dtype``, float32, which its scan cannot carry in float64: the
    same zeros in float64 instead."""
    init = fnn.GRUCell.initialize_carry

    def initialize_carry(self, rng, input_shape):
        return jnp.asarray(init(self, rng, input_shape),
                           jax.dtypes.canonicalize_dtype(jnp.float64))

    monkeypatch.setattr(fnn.GRUCell, "initialize_carry", initialize_carry)


@pytest.mark.parametrize("name", list(CASES))
def test_trainer_steps_match_reference(name, float64_gru_carry):
    recipe_name, jfn, tfn = CASES[name]
    jrec, rec = jrecipes.RECIPES[recipe_name], RECIPES[recipe_name]
    batches = [{k: np.asarray(v, np.float64) for k, v in b.items()}
               for b in BatchIterator(dataset(B * STEPS, 5), B, seed=1)]
    jmod = jfn()
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64),
        random_variables(jmod, batches[0]["signals"].astype(np.float32), 6))
    total = 10
    with jax.enable_x64(True):
        params = variables["params"]
        schedule = (joptim.cosine_schedule(jrec.learning_rate, total)
                    if jrec.scheduler == "cosine" else None)
        jopt = joptim.make_optimizer(
            jrec.learning_rate, jrec.weight_decay, jrec.clip_norm,
            schedule=schedule, group_lr_mults=jrec.group_lr_mults,
            group_patterns=jrec.group_patterns, params=params)
        jt = JTrainer(jmod, jrec.make_objective(), jopt, prefetch=0)
        jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=variables.get("batch_stats", {}),
                             opt_state=jopt.init(params))
        jstate, _ = jt.train_epoch(jstate, batches)
        want = jax.tree_util.tree_map(np.array, {
            "params": jstate.params, "batch_stats": jstate.batch_stats})

    model = load_jax_variables(tfn().double(), variables, "cpu")
    trainer = Trainer(model, rec.make_objective(),
                      recipe_optimizer(rec, total))
    state = trainer.init(batches[0])
    _, row = trainer.train_epoch(state, batches)
    assert state.step == STEPS and row["update_was_finite"] == 1.0
    if rec.group_lr_mults:
        groups = {g["label"]: g["lr"] for g in
                  state.optimizer.adamw.param_groups}
        lr = cosine_schedule(rec.learning_rate, total)(STEPS - 1)
        assert groups == pytest.approx({k: lr * m for k, m in
                                        rec.group_lr_mults.items()})
    got = load_jax_variables(tfn().double(), want, "cpu").state_dict()
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), got[k].numpy(), rtol=0,
                                   atol=1e-9, err_msg=k)


def test_recipe_groups_and_cosine_match_reference():
    """The ``seq_detector`` recipe's labels of every parameter, by module,
    and its cosine lr at every count, against the reference's."""
    rec = RECIPES["seq_detector"]
    model = SignalSequenceDetector(d_model=16, num_heads=2, num_layers=1,
                                   device="cpu")
    x = np.zeros((1, 3, S), np.float32)
    shapes = jax.eval_shape(JSeqDetector(d_model=16, num_heads=2,
                                         num_layers=1).init,
                            jax.random.PRNGKey(0), jnp.asarray(x))
    jlabels = joptim.label_params(shapes["params"], rec.group_patterns)
    by_module = {}
    for path, lab in jax.tree_util.tree_flatten_with_path(jlabels)[0]:
        by_module.setdefault(path[0].key, set()).add(lab)
    labels = label_params([n for n, _ in model.named_parameters()],
                          rec.group_patterns)
    assert {n.split(".")[0] for n in labels} == set(by_module)
    for n, lab in labels.items():
        assert by_module[n.split(".")[0]] == {lab}, n
    sched = cosine_schedule(rec.learning_rate, 40)
    with jax.enable_x64(True):
        jsched = joptim.cosine_schedule(rec.learning_rate, 40)
        for count in (0, 1, 7, 20, 39, 40, 55):
            assert sched(count) == pytest.approx(float(jsched(count)),
                                                 rel=1e-12)


def test_hybrid_phases_freeze_the_masked_groups():
    """Phase 1 at lr 1e-2: the detection path moves, the position head and
    descriptor (lr 0) stay bit-equal (``tests/test_recipes_phases.py``)."""
    torch.manual_seed(0)
    model = HybridModel(d_model=32, num_heads=2, norm="group",
                        signal_length=S, device="cpu")
    det_mask, _, _ = HybridPhases().phase_masks()
    opt = make_optimizer(1e-2, group_lr_mults=det_mask,
                         group_patterns=HybridPhases.group_patterns()
                         ).init(model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    x = torch.from_numpy(dataset(2, 7).signals)
    out = model(x)
    (out["prob"].mean() + out["positions"].mean()).backward()
    opt.step()
    labels = {g["label"]: g["lr"] for g in opt.adamw.param_groups}
    # every parameter is in one of the two groups: "default" holds none
    assert labels == {"detection": 1e-2, "position": 0.0}
    moved = {k: not torch.equal(p, before[k])
             for k, p in model.named_parameters()}
    assert any(moved[k] for k in moved if k.startswith("detection."))
    assert not any(moved[k] for k in moved
                   if k.startswith(("position_head.",
                                    "position_descriptor.")))


def test_snr_curriculum_takes_a_fresh_controller_a_stage():
    class Recorder:
        def __init__(self):
            self.fits = []

        def fit(self, state, tr, va, *, epochs, plateau, log, **kw):
            self.fits.append((tr, epochs, plateau, plateau.scale,
                              plateau.best))
            plateau.step(1.0)
            plateau.step(2.0)
            return state + 1

    trainer = Recorder()
    state = SNRCurriculum(pretrain_epochs=1, epochs=1).run(
        trainer, 0, ("easy", None), ("hard", None),
        plateau_factory=lambda: ReduceLROnPlateau(patience=0),
        log=lambda m: None)
    assert state == 2
    (tr0, ep0, p0, s0, b0), (tr1, ep1, p1, s1, b1) = trainer.fits
    assert (tr0, ep0, tr1, ep1) == ("easy", 1, "hard", 1)
    assert p0 is not p1 and p0.scale == 0.5
    assert (s1, b1) == (1.0, None)        # the second stage starts afresh
