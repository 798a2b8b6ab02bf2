"""Multi-device training, held to the JAX reference on the CPU.

The reference's data parallelism is one program over the global batch
(``Trainer(mesh=make_mesh(8))``); the port's is four gloo ranks, one
process each, that must give the same numbers. One module-scoped launch
of four CPU ranks (``pautdx_torch.mesh.parity.parity_suite``) computes
everything the rank-side tests assert; the JAX references are computed
here while the ranks run, and the ranks read their inputs from files.

- the mesh shapes: ``mesh_shape`` and ``mesh_2d_shape`` against the
  reference's ``make_mesh(n, ("dp", "tp"))`` and ``mesh_2d(n, 2)``;
- the tp rules on ``dfine_nano``: the same leaves sharded on the
  translated dims, the same ``tp_coverage``, at tp 2, 3 and 4 (3 divides
  no width: every rule falls back to replication);
- the dp step: two steps of the ``detection`` recipe on a narrow
  HybridBinary with BatchNorm, float64, four ranks at global batch 8,
  against the reference's ``Trainer`` on its 8-device mesh: parameters,
  BN statistics and the epoch's aux to rtol 1e-5, atol 1e-6;
- the dp x tp step (``dryrun_rank`` on a (2, 2) mesh, the reference's
  tiny D-FINE at 64px): the loss within 1e-4 of one process's step over
  the whole batch, every gradient leaf within 1e-3 of it plus an
  absolute floor of 1e-6 of the gradient's global norm, or within twice
  the one-process step's own f32 noise where that is larger (how far the
  same step moves with its rows reversed or rolled by half the batch, as
  ``chip_smoke.py`` phase 29 raises its limits to twice the CPU step's
  error), and the parameters the AdamW update of those gradients (one process applying the ranks' gradients lands within
  1e-7 of the ranks' parameters), the BN statistics within rtol 1e-5,
  atol 1e-6 of one process's.
  Parameters are not compared with the one-process step directly:
  Adam's first step turns a gradient element at f32 noise level into
  +-lr, so two correct steps differ there by up to 2e-4;
- the batch placements: ``batch_sharding``, ``replicated`` and
  ``shard_batch`` of a ragged batch on the dp and the (dp, tp) mesh;
- the tp eval forward against the reference's replicated forward (5e-4,
  the tolerance of ``tests/test_mesh_tp.py``);
- a ragged eval (5 rows on 4 ranks) equal to one process; the reference
  cannot place such a batch (``pautdx/train/trainer.py:179`` through
  ``prefetch_to_device(..., sharding=batch_sharding(mesh))``) and raises;
- the guard: NaN rows on one rank leave every rank's weights, moments and
  BN statistics as they were;
- checkpoints: written by rank 0 alone, and they restore in one process.
"""

import operator
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from __graft_entry__ import _tiny_cfg
from pautdx.mesh import batch_sharding as jbatch_sharding
from pautdx.mesh import make_mesh as jmake_mesh
from pautdx.mesh.tp import mesh_2d as jmesh_2d
from pautdx.mesh.tp import tp_coverage as jtp_coverage
from pautdx.mesh.tp import tp_spec_tree as jtp_spec_tree
from pautdx.models.signal import HybridBinaryModel as JHybridBinary
from pautdx.models.vision import dfine as jdf
from pautdx.train import optim as joptim
from pautdx.train import recipes as jrecipes
from pautdx.train.trainer import Trainer as JTrainer
from pautdx.train.trainer import TrainState as JTrainState
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.data.datasets import BatchIterator
from pautdx_torch.mesh import mesh_shape
from pautdx_torch.mesh.dryrun import (Spec, dryrun_inputs, one_process_step,
                                      rounding_noise, tiny_config)
from pautdx_torch.mesh.launch import launch
from pautdx_torch.mesh.parity import hybrid_binary, parity_suite
from pautdx_torch.mesh.tp import mesh_2d_shape, tp_coverage, tp_spec_tree
from pautdx_torch.models.vision.dfine import DFine, dfine_nano
from pautdx_torch.train.checkpoint import CheckpointManager, load_model_state
from pautdx_torch.train.optim import make_optimizer
from pautdx_torch.train.recipes import RECIPES
from pautdx_torch.train.trainer import Trainer
from tests.test_torch_signal_train import dataset
from tests.test_torch_signal_zoo import random_variables

WORLD = 4
GLOBAL_BATCH = 8
STEPS = 2
TOTAL = 10            # the cosine schedule's length (detection: none)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save_batches(path, batches):
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})


def _jax_dp_reference(jmod, variables, batches):
    """The reference's ``Trainer(mesh=make_mesh(8))``, two steps, float64;
    its GRU cells (if any) start from a float64 zero carry."""
    init = fnn.GRUCell.initialize_carry

    def initialize_carry(self, rng, input_shape):
        return jnp.asarray(init(self, rng, input_shape), jnp.float64)

    jrec = jrecipes.RECIPES["detection"]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(fnn.GRUCell, "initialize_carry", initialize_carry)
        params = variables["params"]
        jopt = joptim.make_optimizer(jrec.learning_rate, jrec.weight_decay,
                                     jrec.clip_norm)
        jt = JTrainer(jmod, jrec.make_objective(), jopt, mesh=jmake_mesh(8))
        jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=variables.get("batch_stats", {}),
                             opt_state=jopt.init(params))
        jstate, agg = jt.train_epoch(jstate, batches)
        return agg, jax.tree_util.tree_map(np.array, {
            "params": jstate.params, "batch_stats": jstate.batch_stats})


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    files = {k: str(d / n) for k, n in (
        ("hb_weights", "hb.pt"), ("batches", "batches.npz"),
        ("ragged", "ragged.npz"), ("dfine_weights", "dfine.pt"),
        ("ckpt", "ckpt"))}
    batches = [{k: np.asarray(v, np.float64) for k, v in b.items()}
               for b in BatchIterator(dataset(GLOBAL_BATCH * STEPS, 5),
                                      GLOBAL_BATCH, seed=1)]
    ragged = {k: np.asarray(v, np.float64)[:5]
              for k, v in next(iter(BatchIterator(dataset(8, 9), 8))).items()}
    _save_batches(files["batches"], batches)
    _save_batches(files["ragged"], [ragged])
    jmod = JHybridBinary((64, 32, 16), 2, 0.0, 1, pooled_len=32,
                         norm="batch")
    hb_vars = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64),
        random_variables(jmod, batches[0]["signals"].astype(np.float32), 6))
    torch.save(load_jax_variables(hybrid_binary(), hb_vars, "cpu")
               .state_dict(), files["hb_weights"])
    jdfine = jdf.DFine(_tiny_cfg())
    images = dryrun_inputs(WORLD, 64)["images"]
    df_vars = random_variables(jdfine, images[:1], 3)
    torch.save(load_jax_variables(DFine(tiny_config(), device="cpu"),
                                  df_vars, "cpu").state_dict(),
               files["dfine_weights"])

    ranks, errors = [], []

    def run():
        try:
            ranks.extend(launch(parity_suite, WORLD, "cpu",
                                args=(files, TOTAL), threads=1,
                                timeout=240))
        except BaseException as e:       # raised again below
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    try:
        refs = {"dp": _jax_dp_reference(jmod, hb_vars, batches)}
        out = jax.jit(lambda v, x: jdfine.apply(v, x, train=False))(
            df_vars, jnp.asarray(images))
        refs["tp_eval"] = {k: np.asarray(out[k])
                           for k in ("logits", "pred_boxes")}
        spec = Spec(weights=files["dfine_weights"], eval_forward=True,
                    batch=WORLD)
        refs["step"] = one_process_step(spec, "cpu")
        refs["noise"] = rounding_noise(spec, refs["step"], "cpu")
    finally:
        thread.join()
    if errors:
        raise errors[0]
    return files, ranks, refs


# ---------------------------------------------------------------------------
# pure functions against the reference


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shapes_match_reference(n):
    assert mesh_shape(n, ("dp",)) == (n,)
    assert mesh_shape(n, ("dp", "tp")) == \
        jmake_mesh(n, ("dp", "tp")).devices.shape
    assert mesh_2d_shape(n, 2) == jmesh_2d(n, 2).devices.shape
    with pytest.raises(ValueError):
        mesh_shape(n, ("a", "b", "c"))


@pytest.fixture(scope="module")
def nano():
    jmodel = jdf.DFine(jdf.dfine_nano(num_labels=2))
    shapes = jax.eval_shape(lambda k: jmodel.init(
        {"params": k}, jnp.zeros((1, 640, 640, 3), jnp.float32),
        train=False), jax.random.PRNGKey(0))
    return shapes["params"], DFine(dfine_nano(num_labels=2), device="cpu")


def _port_name(path) -> str:
    name = ".".join(str(getattr(k, "key", k)) for k in path)
    return name[:-len("kernel")] + "weight" if name.endswith("kernel") \
        else name


@pytest.mark.parametrize("tp", (2, 3, 4))
def test_tp_rules_match_reference_on_dfine_nano(nano, tp):
    """The same leaves sharded on the translated dims: a Linear kernel's
    (in, out) axes are the port's (out, in), a conv kernel's HWIO axes
    its OIHW; the reference's ``P(tp)`` bias is dim 0."""
    jparams, model = nano
    specs = jtp_spec_tree(jparams, tp)
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {}
    for path, spec in leaves:
        axis = next((i for i, a in enumerate(spec) if a is not None), None)
        if axis is None:
            continue
        ndim = len(spec)
        dim = {1: 0, 2: 1 - axis, 4: 3 - axis}[ndim] if ndim != 1 else 0
        want[_port_name(path)] = dim
    got = {k: d for k, d in tp_spec_tree(model, tp).items() if d is not None}
    assert got == want
    assert len(list(model.parameters())) == len(leaves) == 393
    assert sum(p.numel() for p in model.parameters()) == 2_972_845
    cov = tp_coverage(model, tp)
    assert cov == pytest.approx(jtp_coverage(jparams, tp), abs=1e-9)
    if tp in (2, 4):
        assert len(got) == 95
        assert cov == pytest.approx(0.6648769, abs=1e-7)
    else:   # 3 divides no sharded width: every rule falls back
        assert got == {} and cov == 0.0


# ---------------------------------------------------------------------------
# the ranks against the reference and against one process


def test_ranks_agree(suite):
    _, ranks, _ = suite
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    sums = [r["dp_checksum"] for r in ranks]
    assert all(s == sums[0] for s in sums)


def test_dp_step_matches_reference_mesh_trainer(suite):
    _, ranks, refs = suite
    agg_want, want = refs["dp"]
    got = ranks[0]["dp"]
    want_sd = load_jax_variables(hybrid_binary(), want, "cpu").state_dict()
    assert set(got["state"]) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert set(got["agg"]) == set(agg_want)
    for k, v in agg_want.items():
        assert got["agg"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def test_dp_tp_step_matches_one_process(suite):
    files, ranks, refs = suite
    got, want = ranks[0]["dryrun"], refs["step"]
    assert got["mesh"] == (2, 2)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    gw, noise = want["grads"], refs["noise"]
    floor = 1e-6 * sum(float(g.double().pow(2).sum())
                       for g in gw.values()) ** 0.5
    for k, g in gw.items():
        err = (got["grads"][k] - g).norm().item()
        assert err <= max(1e-3 * g.norm().item() + floor, 2 * noise[k]), k
    # the ranks' parameters are the AdamW update of their gradients
    model = DFine(tiny_config(), device="cpu")
    model.load_state_dict(torch.load(files["dfine_weights"]))
    for n, p in model.named_parameters():
        p.grad = got["grads"][n].clone()
    make_optimizer(1e-4, weight_decay=1e-4, clip_norm=1.0).init(model).step(
        1.0, torch.tensor(got["grad_norm"]))
    for k, v in model.state_dict().items():
        if k in got["grads"]:
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-7, err_msg=k)
        else:       # the BN statistics, from the global batch's moments
            np.testing.assert_allclose(got["params"][k].numpy(),
                                       want["params"][k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_tp_shardings_place_the_rules_on_the_mesh(suite):
    _, ranks, _ = suite
    specs = tp_spec_tree(DFine(tiny_config(), device="cpu"), 2)
    for r in ranks:
        assert r["placements"] == {n: (None, d) for n, d in specs.items()}


def test_batch_placements_and_shard_batch(suite):
    """``batch_sharding`` splits the rows over dp and replicates over tp,
    ``replicated`` replicates everywhere; ``shard_batch`` gives each rank
    its dp rank's rows of a ragged batch, padded with the last row and
    masked."""
    _, ranks, _ = suite
    x = np.arange(10.0).reshape(5, 2)
    for r in ranks:
        for key, axes, dp, d in (("dp", 1, WORLD, r["rank"]),
                                 ("dp_tp", 2, 2, r["rank"] // 2)):
            got = r["sharding"][key]
            assert got["batch"] == (0,) + (None,) * (axes - 1)
            assert got["replicated"] == (None,) * axes
            per = -(-5 // dp)
            idx = np.arange(d * per, (d + 1) * per)
            np.testing.assert_array_equal(got["rows"]["x"],
                                          x[np.minimum(idx, 4)])
            np.testing.assert_array_equal(got["rows"]["row_mask"], idx < 5)


def test_tp_eval_forward_matches_reference(suite):
    _, ranks, refs = suite
    got = ranks[0]["dryrun"]["eval"]
    for k, want in refs["tp_eval"].items():
        np.testing.assert_allclose(got[k].numpy(), want, rtol=5e-4,
                                   atol=5e-4, err_msg=k)


def test_ragged_eval_equals_one_process(suite):
    """Fault in the reference, not copied: its dp eval of a batch whose
    rows do not divide by the devices raises."""
    files, ranks, _ = suite
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((5, 4)), jbatch_sharding(jmake_mesh(8)))
    model = hybrid_binary()
    model.load_state_dict(ranks[0]["dp"]["state"])
    rec = RECIPES["detection"]
    trainer = Trainer(model, rec.make_objective(), make_optimizer())
    with np.load(files["ragged"]) as f:
        ragged = {k.split("/")[1]: f[k] for k in f.files}
    aux, collected = trainer.evaluate(trainer.init(ragged), [ragged],
                                      collect=lambda o, b: o)
    got = ranks[0]["ragged"]
    assert got["prob"].shape == (5, 5)
    np.testing.assert_allclose(got["prob"].numpy(), collected[0].numpy(),
                               rtol=0, atol=1e-12)
    for r in ranks:
        assert set(r["ragged"]["aux"]) == set(aux)
        for k, v in aux.items():
            assert r["ragged"]["aux"][k] == pytest.approx(v, rel=1e-12,
                                                          abs=1e-12), k


def test_guard_refuses_on_every_rank(suite):
    _, ranks, _ = suite
    for r in ranks:
        assert r["guard"]["kept"], r["rank"]
        assert r["guard"]["row"]["update_was_finite"] == 0.0
        assert r["guard"]["row"]["loss_was_finite"] == 0.0


def test_checkpoint_written_by_rank_0_restores(suite):
    files, ranks, _ = suite
    assert [r["checkpoint"]["writer"] for r in ranks] == \
        [True] + [False] * (WORLD - 1)
    histories = [r["checkpoint"]["history"] for r in ranks]
    for h in histories[1:]:
        assert {k: v for k, v in h.items() if k != "time_s"} == \
            {k: v for k, v in histories[0].items() if k != "time_s"}
    state, meta = CheckpointManager(files["ckpt"]).restore("latest")
    assert meta["step"] == 0
    model = hybrid_binary()
    load_model_state(model, state)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ranks[0]["checkpoint"]["state"][k]), k


def test_launch_raises_a_rank_failure_with_its_traceback():
    """A rank's exception comes back to the caller with the rank's
    traceback, and every rank is gone."""
    with pytest.raises(RuntimeError, match="(?s)rank . of 2 failed.*"
                       "ZeroDivisionError"):
        launch(operator.truediv, 2, "cpu", args=(1, 0), threads=1,
               timeout=120)
