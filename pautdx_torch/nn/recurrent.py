"""Recurrent context aggregators.

Counterpart of ``pautdx/nn/recurrent.py``: ``BiGRU`` (the temporal
D-FINE v3's aggregator), ``BiLSTM``, ``ContextAggregator`` (two stacked
BiGRUs of d/2 a direction, then ``proj``; SignalSequenceDetector's) and
``QueryAttentionAggregator`` (BiLSTM of d a direction, ``proj``, then a
learned (1, d) query through ``TinyMHA``; the Enhanced detector's).

The reference runs its cells with ``lax.scan``, outside any Pallas
kernel, so the port runs each bidirectional layer through ``torch.gru``
or ``torch.lstm`` (cuDNN on the card). All start from zero carries. The
GRU computes ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))`` in both;
the LSTMs gate i, f, g, o alike. The weight bridge
(``compat.jax_weights``) maps the reference cells' Denses onto torch's
stacked weights; the biases the reference lacks (the GRU's hidden r and
z, the LSTM's input Denses) are 0 and their gradients are zeroed, so they
stay 0: torch's two biases of one gate take the same gradient, and Adam
would move that gate's bias twice as fast as the reference's.
"""

from __future__ import annotations

import warnings

import torch
from torch import nn

from pautdx_torch.nn.attention import TinyMHA


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


class BiLSTM(nn.LSTM):
    """Bidirectional LSTM over (B, T, d_in), batch first; returns (B, T,
    2 * hidden), forward direction first. The reference's input Denses
    ``ii``/``if``/``ig``/``io`` have no bias, so ``bias_ih`` is 0 and
    takes no gradient; the hidden Denses' biases are ``bias_hh``. f32
    only, as the models that use it are trained and served in f32."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__(d_in, hidden, batch_first=True, bidirectional=True)
        for bias in (self.bias_ih_l0, self.bias_ih_l0_reverse):
            bias.register_hook(torch.zeros_like)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(x)[0]


class ContextAggregator(nn.Module):
    """``num_layers`` stacked ``BiGRU(d / 2)`` (``gru_{i}``), then
    ``proj``: (B, T, d) -> (B, T, d)."""

    def __init__(self, d: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"gru_{i}", BiGRU(d, d // 2))
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"gru_{i}")(x)
        return self.proj(x)


class QueryAttentionAggregator(nn.Module):
    """``BiLSTM(d)`` -> ``proj`` (2d -> d), then a learned (1, d) ``query``
    attends to the sequence through ``query_attn``: returns (per-step
    features (B, T, d), pooled context (B, d))."""

    def __init__(self, d: int, num_heads: int = 4):
        super().__init__()
        self.BiLSTM_0 = BiLSTM(d, d)
        self.proj = nn.Linear(2 * d, d)
        self.query = nn.Parameter(torch.randn(1, d) * 0.02)
        self.query_attn = TinyMHA(d, num_heads)

    def forward(self, x: torch.Tensor):
        h = self.proj(self.BiLSTM_0(x))
        q = self.query.expand(*x.shape[:-2], 1, self.query.shape[-1])
        return h, self.query_attn(q, h)[..., 0, :]
