"""pautdx_torch's temporal D-FINE training held to the JAX reference on the
CPU: the anomaly consistency loss, each variant's trainable set and
optimizer groups (``trainable_mask`` and ``tools/bench_accuracy.py``'s
labels), one v3 step at ``tests/test_temporal_train.py``'s TINY trunk
(bilinear decoder, so the weighted gather and its backward), two
optimizer steps against the reference's optax chains, the harness's
dataset, and ``train_temporal`` end to end over a trunk checkpoint.

The JAX variables come from ``jax.eval_shape`` of one v3 init, filled from
a seeded numpy generator, so that no JAX init is compiled; the v1 and v2
trees are its subsets.
"""

import os
import sys
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pautdx.data import synthetic as jsynthetic
from pautdx.data.vision import detection_frames_from_volume, sequence_chunks
from pautdx.data.volume import parse_json_volume
from pautdx.losses.detr import dfine_criterion
from pautdx.models.vision import dfine as jdf
from pautdx.models.vision import temporal_dfine as jtd
from pautdx.train.optim import zero_frozen_grads
from pautdx_torch.compat.jax_weights import load_jax_variables, port_state_dict
from pautdx_torch.models.vision import dfine as tdf
from pautdx_torch.models.vision import temporal_dfine as ttd
from pautdx_torch.train import temporal as ttrain
from pautdx_torch.train.checkpoint import CheckpointManager
from pautdx_torch.train.detector import dfine_metadata
from tests.test_dfine_train import TINY
from torch_threads import one_torch_thread  # noqa: F401

IMG = 64
T = 4
LAYERS = 2
HEADS = 4
NUM_T = TINY.num_labels + 1
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
V2_ONLY = ("temporal_attention.0", "temporal_attention.2",
           "context_aggregator", "context_projector", "anomaly_detector.0",
           "anomaly_detector.2", "anomaly_detector.4")


def _jax_model(variant):
    return jtd.TemporalDFine(
        TINY, variant=variant,
        num_temporal_labels=None if variant == "v1" else NUM_T,
        num_temporal_layers=LAYERS, temporal_heads=HEADS)


def _port_model(variant):
    return ttd.TemporalDFine(
        tdf.config_from_dict(jdf.config_to_dict(TINY)), variant=variant,
        num_temporal_labels=None if variant == "v1" else NUM_T,
        num_temporal_layers=LAYERS, temporal_heads=HEADS, device="cpu")


def _filled(shapes, rng):
    """Kernels N(0, 1/fan_in), embeddings N(0, 1), biases and BN means
    N(0, 0.1), scales 1 + N(0, 0.1), variances U(0.5, 1.5)."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, Mapping):
            out[k] = _filled(v, rng)
            continue
        shape = tuple(v.shape)
        if k == "kernel":
            a = rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape)
        elif k == "embedding":
            a = rng.normal(0.0, 1.0, shape)
        elif k in ("bias", "mean"):
            a = rng.normal(0.0, 0.1, shape)
        elif k == "scale":
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        else:
            assert k == "var", k
            a = rng.uniform(0.5, 1.5, shape)
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def variables():
    """Each variant's JAX variables (v2's and v1's are v3's subsets, v1
    with a trunk-width class head), after ``init_heads_from_trunk``."""
    shapes = jax.eval_shape(lambda: _jax_model("v3").init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((T, IMG, IMG, 3)),
        train=False))
    rng = np.random.default_rng(0)
    v3 = _filled(shapes, rng)
    v2 = {"params": {k: v for k, v in v3["params"].items()
                     if k not in V2_ONLY},
          "batch_stats": v3["batch_stats"]}
    d = TINY.d_model
    v1 = {"params": dict(v2["params"], class_head={
        "kernel": rng.normal(0, d ** -0.5, (d, TINY.num_labels)).astype(
            np.float32),
        "bias": np.zeros(TINY.num_labels, np.float32)}),
        "batch_stats": v3["batch_stats"]}
    return {v: jax.tree_util.tree_map(np.asarray, jtd.init_heads_from_trunk(
        dict(tree), v)) for v, tree in (("v1", v1), ("v2", v2), ("v3", v3))}


@pytest.fixture(scope="module")
def sequence():
    """tests/test_temporal_train.py's sequence: 64px frames of one
    synthetic volume, the first T-frame chunk that holds a box."""
    spec = jsynthetic.VolumeSpec(n_beams=6, n_scans=8, n_samples=128,
                                 seed=41)
    defects = [jsynthetic.SyntheticDefect(1, 4, 0, 7, 0.3, 0.5)]
    vol_arr, _ = jsynthetic.generate_volume(spec, defects)
    vol = parse_json_volume(jsynthetic.volume_to_json_dict(vol_arr, defects))
    frames = detection_frames_from_volume(vol, out_size=IMG, max_boxes=2)
    chunk = sequence_chunks(frames, seq_len=T, require_gt=True)[0]
    return {"images": chunk.images[:T].astype(np.float32),
            "boxes": chunk.normalized_cxcywh()[:T],
            "classes": chunk.classes[:T], "mask": chunk.mask[:T]}


def _port(variant, tree):
    return load_jax_variables(_port_model(variant), tree, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread for this module: the suite runs in several
    worker processes at once, where each op's thread team would otherwise
    wait on the others' (many small ops a step, tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the consistency loss, the trainable sets and the groups


def test_consistency_loss_matches_reference():
    a = np.random.default_rng(1).normal(size=(T, 20, 2)).astype(np.float32)
    want = jax.jit(jtd.temporal_consistency_loss)(a)
    got = ttd.temporal_consistency_loss(torch.from_numpy(a))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _bench_labels(variant, params):
    """``tools/bench_accuracy.py:580-597``'s ``group``, over the
    reference's ``trainable_mask``."""
    mask = jtd.trainable_mask(variant, params)

    def group(path, _):
        keys = [getattr(p, "key", str(p)) for p in path]
        m = mask
        for k in keys:
            if isinstance(m, bool):
                break
            m = m[k]
        if not (m if isinstance(m, bool) else True):
            return "frozen"
        top = keys[0]
        if top == "trunk":
            return "trunk"
        if top == "class_head":
            return "classifier"
        return "temporal"

    return jax.tree_util.tree_map_with_path(group, params)


CODES = {"frozen": 1, "trunk": 2, "temporal": 3, "classifier": 4}


def _by_name(model, coded):
    """A tree of per-leaf codes, each leaf an array full of its code ->
    {port parameter name: code}. A torch GRU entry stacks several JAX
    leaves, and its b_hr and b_hz have none (0 here): the largest wins."""
    names = [n for n, _ in model.named_parameters()]
    return {n: int(t.max()) for n, t in port_state_dict(
        {"params": coded}, names).items()}


@pytest.mark.parametrize("variant", ttd.VARIANTS)
def test_trainable_mask_and_labels_match_reference(variables, variant):
    params = variables[variant]["params"]
    model = _port(variant, variables[variant])
    want_mask = _by_name(model, jax.tree_util.tree_map(
        lambda m, a: np.full(a.shape, float(m), np.float32),
        jtd.trainable_mask(variant, params), params))
    got_mask = ttd.trainable_mask(variant, model)
    assert got_mask == {n: bool(v) for n, v in want_mask.items()}
    assert 0 < sum(got_mask.values()) < len(got_mask)
    want = _by_name(model, jax.tree_util.tree_map(
        lambda lab, a: np.full(a.shape, CODES[lab], np.float32),
        _bench_labels(variant, params), params))
    got = ttrain.temporal_labels(model, variant)
    assert {n: CODES[lab] for n, lab in got.items()} == want
    assert set(got.values()) == {"frozen"} | set(ttrain.PEAKS[variant])


# ---------------------------------------------------------------------------
# one v3 step


def test_v3_step_matches_reference(variables, sequence):
    """The bench's v3 objective (criterion on the final head plus 0.1 x
    the consistency) with dropout off on both sides: the loss within
    1e-5 relative, the gradient within 1e-4 in norm as a whole and each
    leaf within 1e-3 of its own norm or, for a leaf at float noise (a
    conv in front of a train-mode BatchNorm, a key bias under the
    softmax), within 1e-6 of the global norm."""
    tree = variables["v3"]
    jmodel = _jax_model("v3")
    batch = sequence

    def loss_fn(p):
        out = jmodel.apply({"params": p, "batch_stats": tree["batch_stats"]},
                           batch["images"], train=False)
        head_out = {"intermediate_logits": [out["logits"]],
                    "intermediate_boxes": [out["pred_boxes"]],
                    "intermediate_corners": [], "initial_references": []}
        loss, _ = dfine_criterion(head_out, batch["boxes"], batch["classes"],
                                  batch["mask"], jmodel.head_labels,
                                  TINY.max_num_bins)
        return loss + 0.1 * jtd.temporal_consistency_loss(out["anomaly"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tree["params"])
    model = _port("v3", tree).eval()
    out = model(torch.from_numpy(batch["images"]))
    tl, aux = ttrain.temporal_objective(model, "v3")(
        out, {k: torch.from_numpy(v) for k, v in batch.items()})
    tl.backward()
    assert set(aux) >= {"consistency", "total"}
    np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    want = port_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                             grads)}, names)
    params = dict(model.named_parameters())
    got = {n: (params[n].grad if params[n].grad is not None
               else torch.zeros_like(params[n])) for n in names}
    sq = sum(float(w.double().pow(2).sum()) for w in want.values())
    err = sum(float((got[n] - w).double().pow(2).sum())
              for n, w in want.items())
    assert (err / sq) ** 0.5 <= 1e-4, (err / sq) ** 0.5
    floor = 1e-6 * sq ** 0.5
    for n, w in want.items():
        e = (got[n] - w).norm().item()
        assert e <= 1e-3 * w.norm().item() or e <= floor, (n, e)
    # the trunk's decoder trains, its backbone takes gradient too (the
    # optimizer freezes it), the GRU's b_hr and b_hz none
    assert got["trunk.model.decoder.layers.0.fc1.weight"].norm() > 0
    h = model.context_aggregator.hidden_size
    assert not got["context_aggregator.bias_hh_l0"][:2 * h].any()


# ---------------------------------------------------------------------------
# the optimizer


def _bench_chain(variant, params, steps):
    """``tools/bench_accuracy.py:605-627``'s optax chain."""
    mask = jtd.trainable_mask(variant, params)

    def sched(peak):
        return optax.warmup_cosine_decay_schedule(
            0.0, peak, max(5, steps // 10), steps, peak / 50)

    if variant == "v1":
        return optax.chain(zero_frozen_grads(mask),
                           optax.clip_by_global_norm(1.0),
                           optax.multi_transform(
                               {True: optax.adamw(sched(2e-4),
                                                  weight_decay=0.01),
                                False: optax.set_to_zero()}, mask)), sched
    labels = _bench_labels(variant, params)
    if variant == "v3":
        tx = {"frozen": optax.set_to_zero(),
              "trunk": optax.adamw(sched(1e-5), weight_decay=0.01),
              "temporal": optax.adamw(sched(5e-4), weight_decay=0.01),
              "classifier": optax.adamw(sched(1e-4), weight_decay=0.01)}
    else:
        tx = {"frozen": optax.set_to_zero(),
              "trunk": optax.set_to_zero(),
              "temporal": optax.adamw(sched(5e-4), weight_decay=0.01),
              "classifier": optax.adamw(sched(1e-3), weight_decay=0.01)}
    return optax.chain(zero_frozen_grads(labels),
                       optax.clip_by_global_norm(1.0),
                       optax.multi_transform(tx, labels)), sched


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("variant", ttd.VARIANTS)
def test_optimizer_matches_reference(variables, variant):
    """Two steps from the same float64 weights and gradients (the frozen
    leaves' gradients nonzero too): each group's lr within 1e-6 relative
    of the schedule at its peak, every update within 1e-6 x its group's
    peak lr of the reference's, the frozen parameters unchanged bit for
    bit and out of the optimizer."""
    steps = 40
    params = _f64(variables[variant]["params"])
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(0, 3, a.shape),
                                    params) for _ in range(2)]
    chain, sched = _bench_chain(variant, params, steps)
    @jax.jit
    def step(g, state, p):
        updates, state = chain.update(g, state, p)
        return optax.apply_updates(p, updates), state

    with jax.enable_x64(True):
        p = jax.tree_util.tree_map(jnp.asarray, params)
        state = chain.init(p)
        for g in grads:
            p, state = step(g, state, p)
        want = jax.tree_util.tree_map(np.asarray, p)
    model = _port(variant, variables[variant]).double()
    start = {n: t.detach().clone() for n, t in model.named_parameters()}
    opt = ttrain.temporal_optimizer(model, variant, steps)
    labels = ttrain.temporal_labels(model, variant)
    assert {id(q) for q in opt.params} == {
        id(q) for n, q in model.named_parameters() if labels[n] != "frozen"}
    names = [n for n, _ in model.named_parameters()]
    for i, g in enumerate(grads):
        port_g = port_state_dict({"params": g}, names)
        for n, q in model.named_parameters():
            q.grad = port_g[n].to(q.dtype) if q.requires_grad else None
        opt.step()
        for group in opt.adamw.param_groups:
            peak = ttrain.PEAKS[variant][group["label"]]
            assert abs(group["lr"] - float(sched(peak)(i))) <= \
                1e-6 * float(sched(peak)(i)) + 1e-30, (group["label"], i)
    want = port_state_dict({"params": want}, names)
    for n, q in model.named_parameters():
        if labels[n] == "frozen":
            assert torch.equal(q.detach(), start[n]), n
            assert not q.requires_grad
            continue
        lr = ttrain.PEAKS[variant][labels[n]]
        err = (q.detach() - want[n]).abs().max().item()
        assert err <= 1e-6 * lr, (n, err, lr)
        assert not torch.equal(q.detach(), start[n]) or \
            not start[n].any(), n


# ---------------------------------------------------------------------------
# the dataset and the recipe end to end


def test_make_temporal_dataset_matches_reference(monkeypatch):
    """One seed at 20 scans, 8-frame sequences at 64px: the same chunks,
    boxes, classes and masks bit for bit; the images within 2^-22 (XLA's
    fused bilinear resize rounds a third of the pixels one ulp away from
    the unfused one's)."""
    sys.path.insert(0, TOOLS)
    try:
        import bench_accuracy as ba
    finally:
        sys.path.remove(TOOLS)
    monkeypatch.setattr(ba, "IMG", IMG)
    monkeypatch.setattr(ba, "SEQ_LEN", 8)
    want = ba.make_temporal_dataset([201, 202], n_scans=20, rng_seed=4)
    got = ttrain.make_temporal_dataset([201, 202], n_scans=20, rng_seed=4,
                                       size=IMG, seq_len=8, device="cpu")
    assert len(got) == len(want) >= 4
    for g, w in zip(got, want):
        for k in ("boxes", "classes", "mask"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
        np.testing.assert_allclose(g.images, w.images, atol=2.0 ** -22,
                                   rtol=0)
    stacked = ttrain.stack_chunks(got, "cpu")
    np.testing.assert_allclose(
        stacked["boxes"].numpy(), np.stack([c.normalized_cxcywh()
                                            for c in want]), atol=1e-7)


@pytest.fixture(scope="module")
def trunk_dir(tmp_path_factory, variables):
    """A D-FINE checkpoint of the TINY trunk with its config in the
    metadata, as ``train_bscan_detector`` writes one."""
    d = str(tmp_path_factory.mktemp("trunk"))
    trunk = variables["v3"]
    tree = {c: trunk[c]["trunk"] for c in ("params", "batch_stats")}
    model = load_jax_variables(tdf.DFine(tdf.config_from_dict(
        jdf.config_to_dict(TINY)), device="cpu"), tree, device="cpu")
    CheckpointManager(d).save(0, {
        "params": dict(model.named_parameters()),
        "batch_stats": dict(model.named_buffers())},
        metadata=dfine_metadata(model.cfg, IMG))
    return d


@pytest.mark.parametrize("variant", ttd.VARIANTS)
def test_train_temporal_keeps_the_frozen_set(trunk_dir, variant):
    """Six steps over two sequences from the trunk checkpoint: finite
    losses, the trunk's weights taken from the checkpoint, the frozen
    parameters and every BN statistic unchanged bit for bit, the
    trainable ones moved."""
    spec = dict(n_scans=12, rng_seed=4, size=IMG, seq_len=T, device="cpu")
    chunks = ttrain.make_temporal_dataset([201], **spec)[:2]
    restored = tdf.DFine(tdf.config_from_dict(jdf.config_to_dict(TINY)),
                         device="cpu")
    state, _ = CheckpointManager(trunk_dir).restore()
    restored.load_state_dict({**state["params"], **state["batch_stats"]})
    trainer, tstate = ttrain.build_temporal_trainer(variant, trunk_dir, 6,
                                                    device="cpu")
    model = tstate.model
    assert model.head_labels == (2 if variant == "v1" else 3)
    for n, t in restored.state_dict().items():
        assert torch.equal(model.trunk.state_dict()[n], t), n
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    _, tstate, rows = ttrain.train_temporal(variant, trunk_dir, chunks, 6,
                                            device="cpu", log=lambda m: None)
    model = tstate.model
    assert all(np.isfinite(r["total"]) and r["update_was_finite"] == 1.0
               for r in rows)
    labels = ttrain.temporal_labels(model, variant)
    after = model.state_dict()
    for n, _ in model.named_buffers():
        assert torch.equal(after[n], before[n]), n
    moved = {}
    for n, lab in labels.items():
        if lab == "frozen":
            assert torch.equal(after[n], before[n]), n
        else:
            moved.setdefault(lab, []).append(
                not torch.equal(after[n], before[n]))
    assert set(moved) == set(ttrain.PEAKS[variant])
    assert all(any(m) for m in moved.values()), {
        lab: sum(m) for lab, m in moved.items()}
