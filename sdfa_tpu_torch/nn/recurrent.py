"""Recurrent layers (counterpart of ``sdfa_tpu/nn/recurrent.py``): the LSTM
and GRU stacks, one- or two-directional, FreqLstm ("full" and "last" modes)
and LSTM2d.

Weights keep the JAX layout — ``w_ih_l{k}[_reverse]`` (in, nG·H),
``w_hh_l{k}[_reverse]`` (H, nG·H), torch gate order (LSTM i, f, g, o; GRU r,
z, n) — so the flax tree bridges by name.

Routes are picked from the shapes alone, before anything launches, as the
JAX modules gate their Pallas kernels (``bilstm_routes``, ``freq_route``). A
bidirectional LSTM layer in eval mode runs ``ops.bilstm2`` (a 2-layer stack
behind one call) or ``ops.bilstm_layer`` (per layer), FreqLstm "full" runs
``ops.freq_lstm``; in training mode every bidirectional layer computes its
input projection as a library product, which autograd differentiates, and
runs the recurrences through ``ops.bilstm_core``, whose backward is a kernel
as well. On a card every shape the JAX gate sends to a Pallas kernel runs a
kernel of the port (any hidden width that is a multiple of 128); a shape no
kernel takes — where JAX takes its scan — runs the plain recurrence, counted
in ``ops.PLAIN_ROUTES``.
On the CPU every layer goes through its wrapper, which is its plain version
there; under ``ops.plain_versions()`` the modules take the plain versions.
FreqLstm "last" and LSTM2d are built of 1-layer bidirectional LSTMs and
route through them. The one-directional LSTM and the GRU have no Pallas
kernel in JAX: on a card they run cuDNN through ``torch._VF`` (autograd
differentiates it), on the CPU and under ``ops.plain_versions()`` a plain
step loop.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import _VF, nn

from .. import ops
from ..ops.bilstm2 import bilstm2, bilstm2_plain
from ..ops.bilstm_core import bilstm_core, bilstm_core_plain
from ..ops.bilstm_core import takes as core_takes
from ..ops.bilstm_layer import bilstm_layer, bilstm_layer_plain, lstm_dir
from ..ops.bilstm_layer import takes as layer_takes
from ..ops.freq_lstm import freq_lstm, freq_lstm_plain
from ..ops.freq_lstm import takes as freq_takes
from .layers import FullyConnected, dropout

PLAIN = "plain"


def bilstm_routes(hidden: int, sizes: Sequence[int], training: bool) -> Tuple[str, ...]:
    """The route on a card of each layer of a bidirectional LSTM stack whose
    layers take ``sizes`` input features, from the shapes alone. Training:
    ``"bilstm_core"`` where its kernels take H. Eval: ``"bilstm2"`` for both
    layers of a 2-layer stack its kernel takes, else per layer
    ``"bilstm_layer"`` where its kernel takes (H, in). The kernels take every
    H that is a multiple of 128 and any input width: all the JAX module sends
    to its Pallas kernels (``sdfa_tpu/nn/recurrent.py:236-238, 293-304``) and
    the inputs it scans; a layer no kernel takes (H not a multiple of 128,
    where JAX takes its scan too) is ``"plain"``."""
    if training:
        return ("bilstm_core" if core_takes(hidden) else PLAIN,) * len(sizes)
    per = tuple("bilstm_layer" if layer_takes(hidden, n) else PLAIN for n in sizes)
    return ("bilstm2", "bilstm2") if per == ("bilstm_layer", "bilstm_layer") else per


def freq_route(hidden: int, out: int) -> str:
    """FreqLstm "full" in eval mode on a card: ``"freq_lstm"`` where its
    kernels take (H, out) — every H that is a multiple of 128, any output and
    any input width, all the JAX module sends to its Pallas kernel
    (``recurrent.py:427-435``) — else ``"plain"``, where JAX takes its scan
    too."""
    return "freq_lstm" if freq_takes(hidden, out) else PLAIN


def on_card(x) -> bool:
    """Whether the card's routes apply to ``x``: a CUDA tensor outside
    ``ops.plain_versions()``."""
    return x.device.type == "cuda" and not ops.using_plain()


def gru_dir(xp: torch.Tensor, w_hh: torch.Tensor, b_hh, reverse: bool) -> torch.Tensor:
    """One direction of a GRU scan: xp (rows, T, 3H) input projection with
    b_ih → h (rows, T, H). Torch gate order r, z, n; the n gate takes
    r·(h·W_hn + b_hn)."""
    rows, steps, _ = xp.shape
    h = xp.new_zeros(rows, w_hh.shape[0])
    hs = [None] * steps
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        hh = h @ w_hh
        if b_hh is not None:
            hh = hh + b_hh
        xr, xz, xn = xp[:, t].chunk(3, dim=-1)
        hr, hz, hn = hh.chunk(3, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        h = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
        hs[t] = h
    return torch.stack(hs, dim=1)


class _RNNBase(nn.Module):
    """Parameters, init, inter-layer dropout and the library / plain layers
    shared by the LSTM and the GRU: (B, T, C) → (B, T, H·dirs)."""

    n_gates = 4

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bias: bool = False, batch_first: bool = True, dropout: float = 0.0,
                 bidirectional: bool = False):
        super().__init__()
        if not batch_first:
            raise NotImplementedError("only batch_first layout is used")
        self.input_size, self.hidden_size = int(input_size), int(hidden_size)
        self.num_layers, self.bias = int(num_layers), bool(bias)
        self.dropout = float(dropout)
        self.bidirectional = bool(bidirectional)
        self.dirs = 2 if self.bidirectional else 1
        self.dropout_generator = None  # see layers.set_dropout_generator
        self.data_mesh = None  # see layers.set_data_mesh
        n = self.n_gates * self.hidden_size
        for layer in range(self.num_layers):
            for sfx in self.suffixes(layer):
                self.register_parameter("w_ih" + sfx,
                                        nn.Parameter(torch.empty(self.layer_size(layer), n)))
                self.register_parameter("w_hh" + sfx,
                                        nn.Parameter(torch.empty(self.hidden_size, n)))
                if self.bias:
                    self.register_parameter("b_ih" + sfx, nn.Parameter(torch.empty(n)))
                    self.register_parameter("b_hh" + sfx, nn.Parameter(torch.empty(n)))

    def layer_size(self, layer: int) -> int:
        return self.input_size if layer == 0 else self.dirs * self.hidden_size

    def suffixes(self, layer: int) -> Tuple[str, ...]:
        return (f"_l{layer}", f"_l{layer}_reverse")[:self.dirs]

    def reset_parameters(self, gen: torch.Generator):
        stdv = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters(recurse=False):
                p.copy_(torch.rand(p.shape, generator=gen) * (2 * stdv) - stdv)

    def _between_layers(self, x, layer: int):
        if self.training and layer < self.num_layers - 1 and self.dropout > 0.0:
            return dropout(x, self.dropout, self.dropout_generator, self.data_mesh)
        return x

    def library_layer(self, x, layer: int):
        """One layer through ``torch._VF`` (cuDNN on a card), the JAX weights
        transposed to its contiguous (gates·H, in) layout; differentiable."""
        weights = []
        for sfx in self.suffixes(layer):
            weights += [getattr(self, "w_ih" + sfx).t().contiguous(),
                        getattr(self, "w_hh" + sfx).t().contiguous()]
            if self.bias:
                weights += [getattr(self, "b_ih" + sfx), getattr(self, "b_hh" + sfx)]
        h0 = x.new_zeros(self.dirs, x.shape[0], self.hidden_size)
        if self.n_gates == 4:
            return _VF.lstm(x.contiguous(), (h0, h0), weights, self.bias, 1, 0.0, self.training,
                            self.bidirectional, True)[0]
        return _VF.gru(x.contiguous(), h0, weights, self.bias, 1, 0.0, self.training,
                       self.bidirectional, True)[0]

    def plain_layer(self, x, layer: int):
        """One layer as a plain step loop per direction; differentiable."""
        outs = []
        for d, sfx in enumerate(self.suffixes(layer)):
            w_ih, w_hh = getattr(self, "w_ih" + sfx), getattr(self, "w_hh" + sfx)
            b_ih = getattr(self, "b_ih" + sfx) if self.bias else None
            b_hh = getattr(self, "b_hh" + sfx) if self.bias else None
            xp = x @ w_ih
            if self.n_gates == 4:
                outs.append(lstm_dir(xp if b_ih is None else xp + (b_ih + b_hh), w_hh,
                                     reverse=bool(d)))
            else:
                outs.append(gru_dir(xp if b_ih is None else xp + b_ih, w_hh, b_hh,
                                    reverse=bool(d)))
        return torch.cat(outs, dim=-1) if len(outs) == 2 else outs[0]

    def _forward_library(self, x):
        """Layer by layer through cuDNN on a card, the step loop elsewhere."""
        lib = on_card(x)
        for layer in range(self.num_layers):
            x = (self.library_layer if lib else self.plain_layer)(x, layer)
            x = self._between_layers(x, layer)
        return x


class LSTM(_RNNBase):
    """Multi-layer (bi)LSTM over time, batch first: (B, T, C) → (B, T, H·dirs),
    with dropout between layers in training mode."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._stacked = {}  # layer → (parameter stamp, stacked weights), eval mode only

    def layer_weights(self, layer: int):
        """(w_ih (2, in, 4H), w_hh (2, H, 4H), gate bias (2, 4H) or None) of a
        bidirectional layer, direction 0 forward, 1 reverse.

        In eval mode with autograd off the stacked tensors are kept between
        calls. They are dropped by a version check, not an ``_apply``
        override: the stamp holds every parameter's storage address and
        in-place version, so ``.to()`` (new storage), ``load_state_dict`` and
        an optimizer step (in-place writes) all miss. In training mode, or
        with autograd on, nothing is kept: the stack stays part of the graph."""
        sfx = self.suffixes(layer)
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

    def routes(self, x) -> Tuple[str, ...]:
        """``bilstm_routes`` of this stack for the input ``x`` on a card;
        elsewhere every layer through its wrapper, whose plain version the
        CPU and ``ops.plain_versions()`` take."""
        if on_card(x):
            return bilstm_routes(self.hidden_size,
                                 [self.layer_size(n) for n in range(self.num_layers)],
                                 self.training)
        return ("bilstm_core" if self.training else "bilstm_layer",) * self.num_layers

    def forward(self, x):
        if not self.bidirectional:
            return self._forward_library(x)
        routes = self.routes(x)
        if self.training:
            return self._forward_train(x, routes)
        plain = ops.using_plain()
        if routes[0] == "bilstm2":
            lw = [self.layer_weights(0), self.layer_weights(1)]
            return (bilstm2_plain if plain else bilstm2)(x.contiguous(), *lw[0], *lw[1])
        for layer, route in enumerate(routes):
            if route == PLAIN:
                ops.plain_route(x)
            fn = bilstm_layer if route == "bilstm_layer" and not plain else bilstm_layer_plain
            x = fn(x.contiguous(), *self.layer_weights(layer))
        return x

    def _forward_train(self, x, routes):
        """Per layer: xp[d] = x·w_ih[d] (+ b_ih + b_hh) for both directions in
        one product, laid out (2, T, B, 4H) as the core takes it; the
        recurrences in ``bilstm_core``; dropout between layers."""
        plain = ops.using_plain()
        for layer, route in enumerate(routes):
            if route == PLAIN:
                ops.plain_route(x)
            core = bilstm_core if route == "bilstm_core" and not plain else bilstm_core_plain
            w_ih, w_hh, gb = self.layer_weights(layer)
            xp = torch.matmul(x.transpose(0, 1).unsqueeze(0), w_ih.unsqueeze(1))
            if gb is not None:
                xp += gb[:, None, None, :]  # in place: the product's backward does not read xp
            x = core(xp.contiguous(), w_hh).transpose(0, 1)  # (T, B, 2H) → (B, T, 2H)
            x = self._between_layers(x, layer)
        return x


class GRU(_RNNBase):
    """Multi-layer (bi)GRU over time, batch first: (B, T, C) → (B, T, H·dirs)."""

    n_gates = 3

    def forward(self, x):
        return self._forward_library(x)


class FreqLstm(nn.Module):
    """Bidirectional LSTM along the frequency axis ("spectral gathering"):
    (B, C, F, T) → per-timestep biLSTM over F → (B, output_size, 1, T). Mode
    "full" projects all F outputs of both directions; any other mode ("last")
    projects the forward direction's last step and the reverse direction's
    first. A 3-D input (B, C, F) gives (B, output_size, 1)."""

    def __init__(self, input_size: int, freq_length: int, hidden_size: int = 128,
                 output_size: int = 256, bias: bool = True, mode: str = "full"):
        super().__init__()
        self.mode, self.full = mode, mode == "full"
        self.freq_length, self.hidden_size = int(freq_length), int(hidden_size)
        self.output_size = int(output_size)
        self.lstm = LSTM(input_size, hidden_size, num_layers=1, bias=bias,
                         bidirectional=True)
        proj_in = (self.freq_length if self.full else 1) * 2 * self.hidden_size
        self.proj = FullyConnected(proj_in, self.output_size, bias=bias)

    def forward(self, x):
        dim4 = x.ndim == 4
        if dim4:
            bsz, ch, fq, t = x.shape
            rows = x.permute(0, 3, 2, 1).reshape(bsz * t, fq, ch)  # (B·T, F, C)
        else:
            (bsz, ch, fq), t = x.shape, 1
            rows = x.transpose(1, 2)
        if fq != self.freq_length:
            raise ValueError(f"expected {self.freq_length} freq bins, got {fq}")
        rows = rows.contiguous()
        if self.full and not self.training:
            out = self._full_eval(rows)
        else:
            h = self.lstm(rows)  # (B·T, F, 2H): its routes, the training core in training
            hid = self.hidden_size
            h = (h.reshape(bsz * t, fq * 2 * hid) if self.full
                 else torch.cat([h[:, -1, :hid], h[:, 0, hid:]], dim=-1))
            out = self.proj(h)
        out = out.reshape(bsz, t, self.output_size).transpose(1, 2)
        return out[:, :, None, :] if dim4 else out

    def _full_eval(self, rows):
        route = freq_route(self.hidden_size, self.output_size) if on_card(rows) else "freq_lstm"
        if route == PLAIN:
            ops.plain_route(rows)
        fused = freq_lstm if route == "freq_lstm" and not ops.using_plain() else freq_lstm_plain
        w_ih, w_hh, gb = self.lstm.layer_weights(0)
        return fused(rows, w_ih, w_hh, gb, self.proj.weight(), self.proj.bias)


class LSTM2d(nn.Module):
    """Alternating frequency-axis and time-axis 1-layer biLSTMs (``lstm_{k}``)
    over (B, C, F, T), with a residual where a layer keeps the shape; each
    layer routes as a bidirectional LSTM does."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2,
                 bias: bool = True):
        super().__init__()
        self.num_layers = int(num_layers)
        size = int(input_size)
        for layer in range(self.num_layers):
            self.add_module(f"lstm_{layer}", LSTM(size, hidden_size, num_layers=1, bias=bias,
                                                  bidirectional=True))
            size = 2 * int(hidden_size)

    def forward(self, x):
        bsz, _, fq, t = x.shape
        out = x
        for layer in range(self.num_layers):
            lstm = getattr(self, f"lstm_{layer}")
            if layer % 2 == 0:  # along F, a row per (batch, time)
                seq = out.permute(0, 3, 2, 1).reshape(bsz * t, fq, -1)
                h = lstm(seq.contiguous()).reshape(bsz, t, fq, -1).permute(0, 3, 2, 1)
            else:  # along T, a row per (batch, frequency)
                seq = out.permute(0, 2, 3, 1).reshape(bsz * fq, t, -1)
                h = lstm(seq.contiguous()).reshape(bsz, fq, t, -1).permute(0, 3, 1, 2)
            out = h + out if h.shape == out.shape else h
        return out
