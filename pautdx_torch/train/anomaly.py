"""The autoencoder anomaly workflow: train on healthy signals, threshold
the reconstruction error.

Counterpart of ``pautdx/train/anomaly.py``: ``train_autoencoder`` trains
``DenseAutoencoder`` on healthy A-scans with MSE under plain Adam (the
reference's ``optax.adam``: no weight decay, no clipping), shrinking the
batch to N when fewer than a batch of signals are given;
``anomaly_threshold`` is a quantile (0.9: the top 10 % flagged) of the
healthy reconstruction errors, and ``detect_anomalies`` flags the signals
above it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pautdx_torch.device import Device, resolve_device
from pautdx_torch.models.signal import DenseAutoencoder


def train_autoencoder(healthy_signals: np.ndarray, *, epochs: int = 30,
                      batch_size: int = 64, learning_rate: float = 1e-3,
                      seed: int = 0, device: Device = None
                      ) -> DenseAutoencoder:
    """``healthy_signals`` (N, S) -> the trained model, in eval mode on
    ``device`` (default ``"cuda"``); weights and batch order from
    ``seed``."""
    dev = resolve_device(device)
    data = torch.as_tensor(np.asarray(healthy_signals, np.float32),
                           device=dev)
    n, s = data.shape
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = DenseAutoencoder(signal_length=s, device=dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    # fewer signals than a batch: one smaller batch, not zero steps
    batch_size = min(batch_size, n)
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=dev)
        for i in range(0, n - batch_size + 1, batch_size):
            batch = data[order[i:i + batch_size]]
            loss = (model(batch) - batch).square().mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return model.eval()


@torch.no_grad()
def _errors(model: DenseAutoencoder, signals: np.ndarray) -> np.ndarray:
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(signals, np.float32), device=dev)
    return DenseAutoencoder.anomaly_score(model.eval()(x), x).cpu().numpy()


def anomaly_threshold(model: DenseAutoencoder, healthy_signals: np.ndarray,
                      quantile: float = 0.9) -> float:
    """The ``quantile`` of the healthy reconstruction errors."""
    return float(np.quantile(_errors(model, healthy_signals), quantile))


def detect_anomalies(model: DenseAutoencoder, signals: np.ndarray,
                     threshold: float) -> Dict[str, np.ndarray]:
    err = _errors(model, signals)
    return {"score": err, "is_anomaly": err > threshold}
