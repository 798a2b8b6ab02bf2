"""pautdx_torch stands alone: it imports neither JAX nor the JAX package,
and without a card its entry points raise unless asked for the CPU."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORTS_EVERY_MODULE = r"""
import importlib, pkgutil, sys
import pautdx_torch
names = [m.name for m in pkgutil.walk_packages(pautdx_torch.__path__,
                                               "pautdx_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "pautdx"))
print(len(names), bad)
"""


def test_importing_the_port_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORTS_EVERY_MODULE],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.split(" ", 1)
    assert int(n) >= 70
    assert bad.strip() == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|pautdx)\b(?!_torch)"
    r"|from\s+(jax|flax|pautdx)\b(?!_torch))", re.M)


def test_port_sources_name_no_jax_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "pautdx_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 54
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not _FORBIDDEN.search(src), path
        assert "flax" not in src, path


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from pautdx_torch import resolve_device
    from pautdx_torch.compat.jax_weights import load_jax_variables
    from pautdx_torch.mesh import make_mesh
    from pautdx_torch.mesh.dryrun import dryrun_multichip
    from pautdx_torch.mesh.dryrun import main as dryrun_main
    from pautdx_torch.mesh.launch import launch
    from pautdx_torch.models.vision.dfine import DFine
    from pautdx_torch.models.vision.hgnet import HGNetV2
    from pautdx_torch.models.vision.temporal_dfine import TemporalDFine
    from pautdx_torch.models.vision.yolo import YOLO
    from pautdx_torch.serve.endpoints import DetectorEndpoint
    from pautdx_torch.serve.temporal_predict import (
        build_temporal_model, temporal_serving_config,
    )
    from pautdx_torch.serve.throughput import (
        build_serving_model, make_uint8_slab, serving_config,
    )
    from pautdx_torch.serve.yolo_predict import (
        build_yolo_predictor, make_frame_slab, yolo_config,
        yolo_serving_config,
    )

    for call in (lambda: resolve_device(),
                 lambda: build_serving_model(),
                 lambda: make_uint8_slab((2, 3)),
                 lambda: DFine(serving_config()),
                 lambda: HGNetV2(serving_config().backbone),
                 lambda: load_jax_variables(torch.nn.Linear(2, 2), {}),
                 lambda: build_yolo_predictor(),
                 lambda: build_yolo_predictor(cfg=yolo_config("yolo11n")),
                 lambda: YOLO(yolo_serving_config()),
                 lambda: YOLO(yolo_config("yolov9c-seg")),
                 lambda: make_frame_slab(1, 2),
                 lambda: DetectorEndpoint(lambda x: x),
                 lambda: build_temporal_model(),
                 lambda: TemporalDFine(temporal_serving_config()),
                 lambda: make_mesh(),
                 lambda: launch(max, 2, args=(1, 2)),
                 lambda: dryrun_multichip(4),
                 lambda: dryrun_main(["4"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="unsupported device"):
        resolve_device("meta")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: a non-zero exit and no result line, both from the checkout
    and from a directory that holds only the script."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_chip_smoke_matching_is_minimal():
    """chip_smoke.py matches detection sets without scipy; its assignment
    must be the minimum-cost one."""
    import importlib.util

    from scipy.optimize import linear_sum_assignment

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(0)
    for n in (1, 7, 150):
        cost = rng.uniform(size=(n, n))
        r, c = linear_sum_assignment(cost)
        got = smoke.matched_costs(cost)
        assert got.shape == (n,)
        np.testing.assert_allclose(got.sum(), cost[r, c].sum(), rtol=1e-12)
