"""The served D-FINE's CUDA graphs (``pautdx_torch.serve.graphs``) on the
CPU: when a call replays and when it runs the eager forward, the replay's
input copy, outputs, hooks and counters over a stand-in graph, and the two
counters in the tracer's launch-path list.

A CUDA graph needs the card: the captures and replays themselves are held
to the eager forward in ``tests/test_torch_kernels.py``.
"""

import pytest
import torch
from torch.utils import _pytree as pytree

from pautdx_torch.losses.denoising import make_denoising_queries
from pautdx_torch.models.vision.dfine import DFine
from pautdx_torch.ops import attention, gather
from pautdx_torch.ops.qconv import int8_sites, set_int8_scales
from pautdx_torch.serve import graphs, throughput
from pautdx_torch.utils import profiling
from pautdx_torch.utils.profiling import TRACER, span
from torch_threads import one_torch_thread  # noqa: F401

# 64 px frames, prepatchified: 20 anchors, so 20 queries
FRAMES = (2, 8, 8, 192)
QUERIES = 20


def served():
    return throughput.build_serving_model(device="cpu", batch=2).model


def wire():
    gen = torch.Generator().manual_seed(3)
    return torch.randint(0, 256, FRAMES, generator=gen, dtype=torch.uint8)


def denoising_group():
    gen = torch.Generator().manual_seed(4)
    boxes = torch.tensor([[[0.5, 0.5, 0.2, 0.3], [0.3, 0.6, 0.1, 0.2]]] * 2)
    return make_denoising_queries(gen, boxes, torch.zeros(2, 2,
                                                          dtype=torch.long),
                                  torch.ones(2, 2, dtype=torch.bool), 2,
                                  QUERIES, num_denoising=8)


def _int8(model):
    set_int8_scales(model, {next(iter(int8_sites(model))): 0.01})


def _recording(model):
    next(iter(int8_sites(model).values())).int8_recording = True


def _frozen(model):
    # the fused attention refuses inputs that need a gradient
    model.requires_grad_(False)


def _pre_hook(model):
    model.model.enc_score_head.register_forward_pre_hook(
        lambda module, args: None)


# each case: its reason, the call's keyword arguments, whether grad is on,
# and what to do to the model first
CASES = {
    "cpu input": ("input on cpu", {}, False, None),
    "train": ("training mode", {"train": True}, False, None),
    "grad enabled": ("grad enabled", {}, True, _frozen),
    "denoising": ("a denoising group", {"denoising": True}, False, None),
    "int8 scales": ("int8 sites set or recording", {}, False, _int8),
    "int8 recording": ("int8 sites set or recording", {}, False,
                       _recording),
    "pre-hook": ("a forward pre-hook on a submodule", {}, False, _pre_hook),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_call_the_graph_cannot_serve_runs_eagerly(case):
    """Each condition alone sends the call down ``DFine.forward``: its
    reason is the one reported, nothing is captured or replayed, and the
    outputs equal ``DFine.forward``'s own under the same condition."""
    reason, kwargs, grad, prepare = CASES[case]
    model, x = served(), wire()
    if prepare is not None:
        prepare(model)
    if kwargs.get("denoising"):
        kwargs = {"denoising": denoising_group()}
    counts = (graphs.CAPTURES, graphs.REPLAYS)
    with torch.set_grad_enabled(grad):
        assert graphs.eager_reason(model, x, **kwargs) == reason
        got = model(x, **kwargs)
        model.eval()
        want = DFine.forward(model, x, **kwargs)
    assert model.graphs == {}
    assert (graphs.CAPTURES, graphs.REPLAYS) == counts
    got_leaves, got_spec = pytree.tree_flatten(got)
    want_leaves, want_spec = pytree.tree_flatten(want)
    assert got_spec == want_spec
    assert all(torch.equal(a, b) for a, b in zip(got_leaves, want_leaves))


def test_a_global_module_hook_runs_eagerly():
    model, x = served(), wire()
    handle = torch.nn.modules.module.register_module_forward_hook(
        lambda module, args, out: None)
    try:
        with torch.inference_mode():
            assert graphs.eager_reason(model, x) == "a global module hook"
    finally:
        handle.remove()
    with torch.inference_mode():
        assert graphs.eager_reason(model, x) == "input on cpu"


def test_the_served_model_is_a_dfine_with_its_state_dict():
    model = served()
    plain = throughput.fold_uint8_stem(throughput.cast_params_bf16(
        DFine(throughput.serving_config(), device="cpu", seed=0)))
    assert isinstance(model, DFine) and type(plain) is DFine
    assert list(model.state_dict()) == list(plain.state_dict())
    assert all(torch.equal(model.state_dict()[k], v)
               for k, v in plain.state_dict().items())


def test_the_hook_scan_is_kept_until_a_hook_is_registered():
    """A served call reads the submodules' hooks from the last scan; a
    hook registered anywhere makes the next call scan again."""
    model = served()
    first = model.scan()
    assert model.scan() is first and first.hooked == ()
    head = model.model.enc_score_head
    handle = head.register_forward_hook(lambda module, args, out: None)
    again = model.scan()
    assert again is not first and again.hooked == (head,)
    assert model.scan() is again
    handle.remove()
    torch.nn.Identity().register_forward_hook(lambda m, a, o: None)
    assert model.scan().hooked == ()


def test_a_removed_pre_hook_lets_the_model_replay_again():
    """While a pre-hook is there each call scans again, so that its
    removal is seen at the next call."""
    model, x = served(), wire()
    handle = model.model.encoder.register_forward_pre_hook(
        lambda module, args: None)
    with torch.inference_mode():
        assert graphs.eager_reason(model, x) == ("a forward pre-hook on a "
                                                 "submodule")
        assert model.scan().stamp is None
        handle.remove()
        assert graphs.eager_reason(model, x) == "input on cpu"
        assert model.scan().stamp is not None


def test_a_cast_drops_the_graphs():
    model = served()
    model.graphs[("key",)] = object()
    model.to(torch.float32)
    assert model.graphs == {}


class _StandIn:
    """A captured graph's place: replays nothing, counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_copies_in_returns_copies_fires_hooks_and_counts(
        monkeypatch):
    """Over a stand-in graph: the input lands in the static input; the
    outputs come back as copies, aliases kept; each recorded hooked call
    fires the module's hooks, with and without kwargs, in order; the
    launch counters advance by the capture's counts."""
    monkeypatch.setattr(attention, "LAUNCHES", 5)
    monkeypatch.setattr(gather, "LAUNCHES", 7)
    monkeypatch.setattr(graphs, "REPLAYS", 0)
    static = torch.zeros(3)
    logits = torch.arange(4.0)
    out = {"logits": logits, "intermediate_logits": [torch.ones(2), logits]}
    head, other = torch.nn.Linear(2, 2), torch.nn.Identity()
    seen = []
    head.register_forward_hook(lambda m, a, o: seen.append(("head", a, o)))
    other.register_forward_hook(
        lambda m, a, kw, o: seen.append(("other", kw, o)), with_kwargs=True)
    calls = [(head, (torch.ones(2),), {}, torch.full((2,), 2.0)),
             (other, (), {"k": 1}, torch.full((1,), 3.0)),
             (head, (torch.ones(2),), {}, torch.full((2,), 4.0))]
    stand_in = _StandIn()
    g = graphs._Graph(stand_in, static, out, calls,
                      {"aifi_attention": 1, "onehot_gather": 3})
    x = torch.tensor([1.0, 2.0, 3.0])
    got = g.replay(x)
    assert stand_in.replays == 1 and graphs.REPLAYS == 1
    assert torch.equal(static, x)
    assert torch.equal(got["logits"], logits)
    assert got["logits"].data_ptr() != logits.data_ptr()
    assert got["intermediate_logits"][1] is got["logits"]
    assert [s[0] for s in seen] == ["head", "other", "head"]
    assert seen[1][1] == {"k": 1}
    assert [s[2][0].item() for s in seen] == [2.0, 3.0, 4.0]
    assert (attention.LAUNCHES, gather.LAUNCHES) == (6, 10)
    # a later replay leaves the first call's outputs as they were
    logits.add_(10.0)
    g.replay(x)
    assert torch.equal(got["logits"], torch.arange(4.0))


def test_a_hook_that_replaces_its_output_raises():
    head = torch.nn.Linear(2, 2)
    head.register_forward_hook(lambda m, a, o: o * 2)
    g = graphs._Graph(_StandIn(), torch.zeros(1), {"x": torch.zeros(1)},
                      [(head, (torch.ones(2),), {}, torch.ones(2))], {})
    with pytest.raises(RuntimeError, match="replacement output"):
        g.replay(torch.zeros(1))


def test_the_graph_counters_are_launch_path_counters(monkeypatch):
    """Captures and replays are in ``LAUNCH_COUNTERS``; ``summary`` gives
    them a top-level span's call, and ``advance_launches`` moves each
    counter it names by its count."""
    labels = {label: (module, attr)
              for label, module, attr in profiling.LAUNCH_COUNTERS}
    assert labels["dfine_graph_capture"] == ("pautdx_torch.serve.graphs",
                                             "CAPTURES")
    assert labels["dfine_graph_replay"] == ("pautdx_torch.serve.graphs",
                                            "REPLAYS")
    monkeypatch.setattr(graphs, "CAPTURES", 0)
    monkeypatch.setattr(graphs, "REPLAYS", 0)
    monkeypatch.setattr(attention, "LAUNCHES", 0)
    TRACER.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("test.first"):
            graphs.CAPTURES += 1
            profiling.advance_launches({"dfine_graph_replay": 1,
                                        "aifi_attention": 1})
        with span("test.first"):
            profiling.advance_launches({"dfine_graph_replay": 1,
                                        "aifi_attention": 1})
    s = TRACER.summary()
    assert s["launches"]["test.first"] == {"dfine_graph_capture": 0.5,
                                           "dfine_graph_replay": 1.0,
                                           "aifi_attention": 1.0}
    assert profiling.launch_counts()["dfine_graph_replay"] == 2
