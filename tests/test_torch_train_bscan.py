"""Training D-FINE-nano from PAUT volumes on the CPU: ``train_bscan_detector``
over a directory with a JSON volume and a txt tree (frames, batches on a
host thread, the EMA, denoising groups, per-epoch checkpoints), and the
accuracy harness's ``--quick`` run at 128 px with two volumes and three
steps of batch 4."""

import json

import numpy as np
import pytest
import torch

from pautdx_torch.data import synthetic
from pautdx_torch.eval import accuracy
from pautdx_torch.train.checkpoint import CheckpointManager, restore_dfine
from pautdx_torch.train.detector import train_bscan_detector
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests train a model, and the test
    workers share the machine's cores, where torch's own thread pool per
    worker would oversubscribe them many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def volume_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("volumes")
    (spec_a, def_a), (spec_b, def_b) = accuracy.harness_volumes(
        [100, 101], 1, n_scans=14)
    synthetic.write_json_volume(str(d / "a.json"), spec_a, def_a)
    synthetic.write_txt_tree(str(d), spec_b, def_b, file_folder="b")
    (d / "notes.md").write_text("not a volume")
    return str(d)


def test_train_bscan_detector_from_volumes(volume_dir, tmp_path):
    logs = []
    trainer, state = train_bscan_detector(
        volume_dir, size=64, batch_size=14, epochs=2, out=str(tmp_path),
        ema_decay=0.9, num_denoising=16, device="cpu", log=logs.append)
    assert logs[0] == "28 frames"
    assert state.step == 2 * (28 // 14) and state.optimizer.count > 0
    assert logs[1].startswith("[epoch 0]") and " dn=" in logs[1]
    saved, meta = CheckpointManager(str(tmp_path)).restore("latest")
    assert meta["step"] == 1 and meta["detector"] == "dfine"
    for k, v in state.ema.items():
        assert torch.equal(saved["ema_params"][k], v), k
    model, _, _ = restore_dfine(str(tmp_path), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, trainer.model.state_dict()[k]), k
    with pytest.raises(ValueError, match="want 'dfine' or 'yolo'"):
        train_bscan_detector(volume_dir, detector="rtdetr", device="cpu")


def test_accuracy_quick_run(capsys):
    result = accuracy.main(["--quick", "--device", "cpu", "--volumes", "1",
                            "--steps", "3", "--batch", "4"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(result))
    assert last["steps"] == 3 and last["img_size"] == 128
    assert last["train_frames"] == last["val_frames"] == 60
    assert set(last["map50"]) == {"f32_bilinear", "f32_discrete",
                                  "bf16_bilinear", "bf16_discrete",
                                  "serving", "serving_int8"}
    assert all(0.0 <= v <= 1.0 for v in last["map50"].values())
    assert last["serving_int8_minus_serving"] == (
        last["map50"]["serving_int8"] - last["map50"]["serving"])
    assert np.isfinite(last["median_ms_per_step"])
    assert last["discrete_step"]["limit"] == 1e-3
    assert last["device"]["nvidia_smi"] is None
