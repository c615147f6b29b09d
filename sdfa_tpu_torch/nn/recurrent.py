"""Recurrent layers: the time LSTM stack and FreqLstm (counterpart of
``sdfa_tpu/nn/recurrent.py``; GRU and LSTM2d are not ported yet).

Weights keep the JAX layout — ``w_ih_l{k}[_reverse]`` (in, 4H),
``w_hh_l{k}[_reverse]`` (H, 4H), torch gate order i, f, g, o — so the flax
tree bridges by name.

Routing is by ``self.training``. In eval mode a 2-layer bidirectional
stack runs ``ops.bilstm2`` (both layers behind one call), any other depth
runs ``ops.bilstm_layer`` per layer, and FreqLstm ("full" mode) runs
``ops.freq_lstm``. In training mode every layer (FreqLstm's too) computes
its input projection as a library product, which autograd differentiates,
and runs the recurrences through ``ops.bilstm_core``, whose backward is a
kernel as well. Every wrapper takes its plain PyTorch version for CPU
tensors, and the modules take the plain versions under
``ops.plain_versions()``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import ops
from ..ops.bilstm2 import bilstm2, bilstm2_plain
from ..ops.bilstm_core import bilstm_core, bilstm_core_plain
from ..ops.bilstm_layer import bilstm_layer, bilstm_layer_plain
from ..ops.freq_lstm import freq_lstm, freq_lstm_plain
from .layers import FullyConnected, dropout


class LSTM(nn.Module):
    """Multi-layer biLSTM over time, batch first: (B, T, C) → (B, T, 2H), with
    dropout between layers in training mode."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bias: bool = False, batch_first: bool = True, dropout: float = 0.0,
                 bidirectional: bool = False):
        super().__init__()
        if not batch_first:
            raise NotImplementedError("only batch_first layout is used")
        if not bidirectional:
            raise NotImplementedError("unidirectional LSTM is not ported yet")
        self.input_size, self.hidden_size = int(input_size), int(hidden_size)
        self.num_layers, self.bias = int(num_layers), bool(bias)
        self.dropout = float(dropout)
        self.dropout_generator = None  # see layers.set_dropout_generator
        self._stacked = {}  # layer → (parameter stamp, stacked weights), eval mode only
        n = 4 * self.hidden_size
        for layer in range(self.num_layers):
            in_size = self.input_size if layer == 0 else 2 * self.hidden_size
            for sfx in (f"_l{layer}", f"_l{layer}_reverse"):
                self.register_parameter("w_ih" + sfx, nn.Parameter(torch.empty(in_size, n)))
                self.register_parameter("w_hh" + sfx, nn.Parameter(torch.empty(self.hidden_size, n)))
                if self.bias:
                    self.register_parameter("b_ih" + sfx, nn.Parameter(torch.empty(n)))
                    self.register_parameter("b_hh" + sfx, nn.Parameter(torch.empty(n)))

    def reset_parameters(self, gen: torch.Generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters(recurse=False):
                p.copy_(torch.rand(p.shape, generator=gen) * (2 * stdv) - stdv)

    def layer_weights(self, layer: int):
        """(w_ih (2, in, 4H), w_hh (2, H, 4H), gate bias (2, 4H) or None),
        direction 0 forward, 1 reverse.

        In eval mode with autograd off the stacked tensors are kept between
        calls. They are dropped by a version check, not an ``_apply``
        override: the stamp holds every parameter's storage address and
        in-place version, so ``.to()`` (new storage), ``load_state_dict`` and
        an optimizer step (in-place writes) all miss. In training mode, or
        with autograd on, nothing is kept: the stack stays part of the graph."""
        sfx = (f"_l{layer}", f"_l{layer}_reverse")
        keep = not self.training and not torch.is_grad_enabled()
        if keep:
            params = [getattr(self, n + s) for s in sfx
                      for n in (("w_ih", "w_hh", "b_ih", "b_hh") if self.bias
                                else ("w_ih", "w_hh"))]
            stamp = tuple((p.data_ptr(), 0 if p.is_inference() else p._version) for p in params)
            hit = self._stacked.get(layer)
            if hit is not None and hit[0] == stamp:
                return hit[1]
        else:
            self._stacked.clear()
        w_ih = torch.stack([getattr(self, "w_ih" + s) for s in sfx])
        w_hh = torch.stack([getattr(self, "w_hh" + s) for s in sfx])
        gb = None
        if self.bias:
            gb = torch.stack([getattr(self, "b_ih" + s) + getattr(self, "b_hh" + s)
                              for s in sfx])
        if keep:
            self._stacked[layer] = (stamp, (w_ih, w_hh, gb))
        return w_ih, w_hh, gb

    def forward(self, x):
        if self.training:
            return self._forward_train(x)
        plain = ops.using_plain()
        if self.num_layers == 2:
            lw = [self.layer_weights(0), self.layer_weights(1)]
            return (bilstm2_plain if plain else bilstm2)(x.contiguous(), *lw[0], *lw[1])
        layer_fn = bilstm_layer_plain if plain else bilstm_layer
        for layer in range(self.num_layers):
            x = layer_fn(x.contiguous(), *self.layer_weights(layer))
        return x

    def _forward_train(self, x):
        """Per layer: xp[d] = x·w_ih[d] (+ b_ih + b_hh) for both directions in
        one product, laid out (2, T, B, 4H) as the core takes it; the
        recurrences in ``bilstm_core``; dropout between layers."""
        core = bilstm_core_plain if ops.using_plain() else bilstm_core
        for layer in range(self.num_layers):
            w_ih, w_hh, gb = self.layer_weights(layer)
            xp = torch.matmul(x.transpose(0, 1).unsqueeze(0), w_ih.unsqueeze(1))
            if gb is not None:
                xp += gb[:, None, None, :]  # in place: the product's backward does not read xp
            x = core(xp.contiguous(), w_hh).transpose(0, 1)  # (T, B, 2H) → (B, T, 2H)
            if layer < self.num_layers - 1 and self.dropout > 0.0:
                x = dropout(x, self.dropout, self.dropout_generator)
        return x


class FreqLstm(nn.Module):
    """Bidirectional LSTM along the frequency axis ("spectral gathering"):
    (B, C, F, T) → per-timestep biLSTM over F, all F outputs projected to
    ``output_size`` → (B, output_size, 1, T). "full" mode only."""

    def __init__(self, input_size: int, freq_length: int, hidden_size: int = 128,
                 output_size: int = 256, bias: bool = True, mode: str = "full"):
        super().__init__()
        if mode != "full":
            raise NotImplementedError(f"FreqLstm mode {mode!r} is not ported yet")
        self.freq_length, self.hidden_size = int(freq_length), int(hidden_size)
        self.output_size = int(output_size)
        self.lstm = LSTM(input_size, hidden_size, num_layers=1, bias=bias,
                         bidirectional=True)
        self.proj = FullyConnected(self.freq_length * 2 * self.hidden_size,
                                   self.output_size, bias=bias)

    def forward(self, x):
        bsz, ch, fq, t = x.shape
        if fq != self.freq_length:
            raise ValueError(f"expected {self.freq_length} freq bins, got {fq}")
        rows = x.permute(0, 3, 2, 1).reshape(bsz * t, fq, ch).contiguous()  # (B·T, F, C)
        if self.training:
            h = self.lstm(rows)  # (B·T, F, 2H) through the training core
            out = self.proj(h.reshape(bsz * t, fq * 2 * self.hidden_size))
        else:
            w_ih, w_hh, gb = self.lstm.layer_weights(0)
            fused = freq_lstm_plain if ops.using_plain() else freq_lstm
            out = fused(rows, w_ih, w_hh, gb, self.proj.weight(), self.proj.bias)
        return out.reshape(bsz, t, self.output_size).transpose(1, 2)[:, :, None, :]
