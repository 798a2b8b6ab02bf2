"""pautdx_torch's HF D-FINE bridge (``compat/dfine_import.py``) against
``transformers``' ``DFineForObjectDetection`` and the JAX package's
converter, on the CPU.

The HF model is built from the small config of
``tests/test_dfine_parity.py`` (no download) and re-randomised as
``tests/test_torch_dfine_hf.py::test_model_matches_transformers`` does;
the JAX converter's target tree comes from ``jax.eval_shape`` (no JAX init
or forward runs).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from pautdx.compat import dfine_import as jimport
from pautdx.models.vision import dfine as jdf
from pautdx_torch.compat import dfine_import
from pautdx_torch.compat.jax_weights import load_jax_variables
from pautdx_torch.eval import accuracy
from pautdx_torch.models.vision import dfine as tdf
from torch_threads import one_torch_thread  # noqa: F401

SIDE = 128


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_model():
    from tests.test_dfine_parity import _small_hf_configs
    from transformers.models.d_fine.modeling_d_fine import (
        DFineForObjectDetection,
    )

    hf_cfg, jcfg = _small_hf_configs()
    torch.manual_seed(0)
    hf = DFineForObjectDetection(hf_cfg).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith(("up", "reg_scale")):
                continue
            if p.dim() >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
            elif name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=g)
            else:
                p.normal_(1.0, 0.1, generator=g)
        # BN statistics off 0 and 1, so that a misplaced one shows
        for name, b in hf.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=g)
    cfg = dataclasses.replace(
        tdf.config_from_dict(jdf.config_to_dict(jcfg)),
        encoder_fused_attn=True)
    return hf, hf_cfg, jcfg, cfg


def _jax_route(hf, jcfg, cfg):
    """The route of ``test_model_matches_transformers``: the JAX
    converter, then ``load_jax_variables``."""
    shapes = jax.eval_shape(lambda k: jdf.DFine(jcfg).init(
        {"params": k}, jnp.zeros((1, SIDE, SIDE, 3), jnp.float32),
        train=False), jax.random.PRNGKey(0))
    target = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    variables, unused = jimport.convert_state_dict(
        jimport.load_torch_model_state(hf), target)
    port = load_jax_variables(tdf.DFine(cfg, device="cpu"), variables,
                              device="cpu")
    return port, unused


def test_convert_matches_the_jax_route(hf_model):
    """The same port state, entry for entry, and the same unused HF keys
    as the JAX converter reports."""
    hf, _, jcfg, cfg = hf_model
    via_jax, jax_unused = _jax_route(hf, jcfg, cfg)
    port = tdf.DFine(cfg, device="cpu")
    unused = dfine_import.load_hf_state_dict(port, hf.state_dict())
    assert set(unused) == set(jax_unused)
    assert any(k.endswith("num_batches_tracked") for k in unused)
    assert any(k.startswith("model.decoder.class_embed") for k in unused)
    want = via_jax.state_dict()
    for k, v in port.state_dict().items():
        # HF's config has no denoising: both keep their own target's value
        if "denoising" not in k:
            assert torch.equal(v, want[k]), k


def test_bridge_detections_match_transformers(hf_model):
    """The port loaded through the bridge gives the detections of
    ``transformers``' model on the same image, matched by assignment."""
    hf, _, _, cfg = hf_model
    port = tdf.DFine(cfg, device="cpu")
    dfine_import.load_hf_state_dict(port, hf.state_dict())
    x = np.random.default_rng(0).normal(size=(1, SIDE, SIDE, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))

    def feats(boxes, logits):
        return np.concatenate([boxes, 1 / (1 + np.exp(-logits))], -1)

    ft = feats(got["pred_boxes"][0].numpy(), got["logits"][0].numpy())
    fh = feats(want.pred_boxes[0].numpy(), want.logits[0].numpy())
    cost = np.linalg.norm(ft[:, None] - fh[None], axis=-1)
    r, c = linear_sum_assignment(cost)
    assert (cost[r, c] < 2e-3).sum() >= cost.shape[0] - 4
    assert np.median(cost[r, c]) < 1e-3


def test_export_round_trip_is_exact_and_loads_strictly(hf_model):
    """HF -> port -> HF gives back every HF entry bit for bit (the tied
    heads and the config-derived buffers included), and the exported dict
    loads strictly into ``DFineForObjectDetection``."""
    from transformers.models.d_fine.modeling_d_fine import (
        DFineForObjectDetection,
    )

    hf, hf_cfg, _, cfg = hf_model
    port = tdf.DFine(cfg, device="cpu")
    dfine_import.load_hf_state_dict(port, hf.state_dict())
    template = DFineForObjectDetection(hf_cfg).state_dict()
    out = dfine_import.export_state_dict(port, template)
    assert out.keys() == hf.state_dict().keys()
    for k, v in hf.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue            # a counter the template keeps at its own 0
        assert torch.equal(out[k], v), k
    fresh = DFineForObjectDetection(hf_cfg).eval()
    fresh.load_state_dict(out, strict=True)


def test_export_without_template_converts_back(hf_model):
    """Without ``transformers``' template (the card machine has none): the
    port's entries and the tied aliases, converted back bit for bit, the
    aliases reported unused."""
    hf, _, _, cfg = hf_model
    port = tdf.DFine(cfg, device="cpu")
    dfine_import.load_hf_state_dict(port, hf.state_dict())
    out = dfine_import.export_state_dict(port)
    back, unused = dfine_import.convert_state_dict(out, tdf.DFine(
        cfg, device="cpu"))
    assert unused and all(k.startswith("model.decoder.") for k in unused)
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k


def test_missing_entry_raises(hf_model):
    hf, _, _, cfg = hf_model
    sd = dict(hf.state_dict())
    key = next(k for k in sd if k.endswith("lateral_convs.0.conv.weight"))
    del sd[key]
    with pytest.raises(KeyError, match="no HF source"):
        dfine_import.convert_state_dict(sd, tdf.DFine(cfg, device="cpu"))
    sd[key] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape mismatch"):
        dfine_import.convert_state_dict(sd, tdf.DFine(cfg, device="cpu"))


def test_accuracy_parity_small_quick_run(capsys):
    """The harness's ``--parity-small`` arm end to end on the CPU: the
    small HF-architecture config trained, its export scored through
    ``transformers`` beside the port's own outputs on the same frames,
    and the export round trip bit-equal."""
    result = accuracy.main(["--quick", "--device", "cpu", "--volumes", "1",
                            "--steps", "2", "--batch", "4",
                            "--parity-small"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    arm = last["parity_small"]
    assert arm == json.loads(json.dumps(result["parity_small"]))
    assert arm["steps"] == 2 and 0.0 <= arm["port_map50"] <= 1.0
    assert arm["export_round_trip_exact"] is True
    assert arm["torch"]["frames"] == last["val_frames"] == 60
    assert 0.0 <= arm["torch"]["map50"] <= 1.0
    assert arm["torch"]["max_logit_delta"] < 1e-4
    assert arm["torch"]["max_box_delta"] < 1e-4
