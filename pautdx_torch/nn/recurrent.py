"""Recurrent context aggregators.

Counterpart of ``pautdx/nn/recurrent.py``. Ported: ``BiGRU``, the
temporal D-FINE v3's context aggregator. ``BiLSTM`` and the aggregators
around it belong to the signal models' training half (ROADMAP.md, queue
1, item 11b).

The reference runs its two GRU cells with ``lax.scan``, outside any
Pallas kernel, so the port runs one bidirectional GRU through
``torch.gru`` (cuDNN on the card). Both start from zero carries and
compute ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``; the weight
bridge (``compat.jax_weights``) maps the reference cells' six Denses onto
torch's stacked (r, z, n) weights.
"""

from __future__ import annotations

import warnings

import torch
from torch import nn


class BiGRU(nn.GRU):
    """Bidirectional GRU over (B, T, d_in), batch first; returns the
    per-step features (B, T, 2 * hidden), forward direction first.

    dtype, as in the reference: its carry starts as float32 zeros (the JAX
    ``param_dtype``), and its Denses compute in the promoted dtype, so
    under bf16 weights the recurrence and its output are float32. The
    GRU here runs in ``promote(x.dtype, float32)`` over its weights cast
    to that dtype. Cast weights are fresh tensors, which cuDNN packs into
    its own layout at every call (2 x 99 K weights at d 128) and warns
    about; that warning is silenced here, the packing is the price of
    keeping the weights in their serving dtype."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__(d_in, hidden, batch_first=True, bidirectional=True)
        # the reference's hidden Denses hr and hz have no bias; torch's
        # b_hr and b_hz (the first 2 * hidden of bias_hh), which the
        # weight bridge fills with 0, take the same gradient as b_ir and
        # b_iz, so training them would move those gates' biases twice as
        # fast as the reference's (Adam steps each parameter by about the
        # lr). Their gradient is zeroed, so they stay 0.
        for bias in (self.bias_hh_l0, self.bias_hh_l0_reverse):
            bias.register_hook(self._without_gate_biases)

    def _without_gate_biases(self, grad: torch.Tensor) -> torch.Tensor:
        h = self.hidden_size
        return torch.cat([torch.zeros_like(grad[:2 * h]), grad[2 * h:]])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        dt = torch.promote_types(x.dtype, torch.float32)
        h0 = x.new_zeros((2, x.shape[0], self.hidden_size), dtype=dt)
        weights = [w.to(dt) for ws in self.all_weights for w in ws]
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "RNN module weights are not "
                                    "part of single contiguous chunk")
            return torch.gru(x.to(dt), h0, weights, True, 1, self.dropout,
                             self.training, True, True)[0]
