"""Checkpoints with the reference's self-describing on-disk contract.

Counterpart of ``pautdx/train/checkpoint.py``, with ``torch.save`` in place
of orbax. Under the checkpoint directory:

- ``step_<n>/state.pt``: the train state (``TrainState.state_dict()``:
  step, params, BN statistics, optimizer state), CPU tensors;
- ``markers.json``: ``{"latest": n, "best": m}``;
- ``metadata.json``: what the caller saved with it (``dfine_config`` for a
  D-FINE run, which :func:`restore_dfine` rebuilds the model from);
- ``history.json``: the per-epoch history, rewritten at every save.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from pautdx_torch.device import resolve_device
from pautdx_torch.models.vision.dfine import DFine, config_from_dict


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    # -- markers ----------------------------------------------------------
    def _markers(self) -> Dict[str, int]:
        p = os.path.join(self.directory, "markers.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def _write_markers(self, m: Dict[str, int]) -> None:
        with open(os.path.join(self.directory, "markers.json"), "w") as f:
            json.dump(m, f)

    # -- save / restore ---------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             metadata: Optional[Dict] = None,
             history: Optional[Dict] = None,
             is_best: bool = False) -> str:
        """``state`` is a dict of tensors and plain values
        (``TrainState.state_dict()``)."""
        path = os.path.join(self.directory, f"step_{step}")
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
        if metadata is not None:
            with open(os.path.join(self.directory, "metadata.json"), "w") as f:
                json.dump(metadata, f, indent=1)
        if history is not None:   # crash-safe per-epoch dump
            with open(os.path.join(self.directory, "history.json"), "w") as f:
                json.dump(history, f)
        m = self._markers()
        m["latest"] = step
        if is_best:
            m["best"] = step
        self._write_markers(m)
        return path

    def restore(self, which: Union[str, int] = "latest"
                ) -> Tuple[Dict[str, Any], Dict]:
        """(state, metadata) of a step, or of the ``"latest"``/``"best"``
        marker; ``metadata["step"]`` says which step."""
        if isinstance(which, str):
            m = self._markers()
            if which not in m:
                raise FileNotFoundError(
                    f"no '{which}' checkpoint in {self.directory}")
            step = m[which]
        else:
            step = int(which)
        path = os.path.join(self.directory, f"step_{step}", "state.pt")
        state = torch.load(path, map_location="cpu", weights_only=True)
        meta_path = os.path.join(self.directory, "metadata.json")
        metadata = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                metadata = json.load(f)
        metadata["step"] = step
        return state, metadata

    def load_history(self) -> Dict:
        p = os.path.join(self.directory, "history.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    @property
    def has_checkpoint(self) -> bool:
        return bool(self._markers())


def load_model_state(model: torch.nn.Module, state: Dict[str, Any]) -> None:
    """Fill ``model``'s parameters and BN statistics from a saved state,
    strictly: a missing, unused or reshaped entry raises, naming the
    likely cause."""
    entries = {**state["params"], **state["batch_stats"]}
    try:
        model.load_state_dict(entries, strict=True)
    except RuntimeError as e:
        raise ValueError(
            f"checkpoint does not match the model's parameters: the model "
            f"config likely changed between save and restore; compare the "
            f"checkpoint's metadata.json with the config you restore into. "
            f"Original error: {e}") from e


def restore_dfine(directory: str, which: Union[str, int] = "latest",
                  device=None):
    """Rebuild the D-FINE of a checkpoint from its
    ``metadata["dfine_config"]`` and load its weights: (model, state,
    metadata). The model is in eval mode on ``device`` (default
    ``"cuda"``)."""
    dev = resolve_device(device)
    state, metadata = CheckpointManager(directory).restore(which)
    if "dfine_config" not in metadata:
        raise KeyError(f"{directory}/metadata.json has no dfine_config")
    model = DFine(config_from_dict(metadata["dfine_config"]), device=dev)
    load_model_state(model, state)
    return model, state, metadata
