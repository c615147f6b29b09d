"""Per-layer biLSTM kernel (``csrc/bilstm_layer.cu``) and its plain version.

Counterpart of ``sdfa_tpu/ops/pallas_bilstm.py``: ``bilstm_layer`` takes
the arguments of ``bilstm_layer_fused`` — x (rows, T, in), w_ih
(2, in, 4H), w_hh (2, H, 4H), gate bias (2, 4H) or None; direction 0
forward, 1 reverse; gate order i, f, g, o — and returns (rows, T, 2H)
float32, forward h in ``[..., :H]`` and reverse h in ``[..., H:]``. The
input projection is computed inside the kernel.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = 0  # kernel launches by ``bilstm_layer`` in this process

HIDDEN, MAX_IN = 256, 512  # what the CUDA kernel takes


def lstm_dir(xp: torch.Tensor, w_hh: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One direction of an LSTM scan: xp (rows, T, 4H) input projection with
    bias → h (rows, T, H). Torch gate order i, f, g, o."""
    rows, steps, _ = xp.shape
    h = xp.new_zeros(rows, w_hh.shape[0])
    c = torch.zeros_like(h)
    hs = [None] * steps
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        i, f, g, o = (xp[:, t] + h @ w_hh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[t] = h
    return torch.stack(hs, dim=1)


def bilstm_layer_plain(x, w_ih, w_hh, gate_bias):
    """One biLSTM layer, plain PyTorch: (rows, T, in) → (rows, T, 2H)
    (``bilstm_layer_reference`` in the JAX package)."""
    outs = []
    for d in range(2):
        xp = x @ w_ih[d]
        if gate_bias is not None:
            xp = xp + gate_bias[d]
        outs.append(lstm_dir(xp, w_hh[d], reverse=bool(d)))
    return torch.cat(outs, dim=-1)


def bilstm_layer(x, w_ih, w_hh, gate_bias):
    """One biLSTM layer: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; any other input raises."""
    if x.device.type == "cpu":
        return bilstm_layer_plain(x, w_ih, w_hh, gate_bias)
    rows, steps, n_in = x.shape
    gdim = 4 * HIDDEN
    if n_in > MAX_IN or w_hh.shape[1] != HIDDEN:
        raise ValueError(f"bilstm_layer kernel takes H={HIDDEN}, in<={MAX_IN}; got x "
                         f"{tuple(x.shape)}, w_hh {tuple(w_hh.shape)}")
    build.check("x", x, (rows, steps, n_in))
    build.check("w_ih", w_ih, (2, n_in, gdim))
    build.check("w_hh", w_hh, (2, HIDDEN, gdim))
    if gate_bias is not None:
        build.check("gate_bias", gate_bias, (2, gdim))
    out = torch.empty(rows, steps, 2 * HIDDEN, device=x.device, dtype=torch.float32)
    build.launch("bilstm_layer", (x, w_ih, w_hh, gate_bias, out),
                 (rows, steps, n_in, HIDDEN), x.device)
    global LAUNCHES
    LAUNCHES += 1
    return out
