"""Fused FreqLstm kernel (``csrc/freq_lstm.cu``) and its plain version.

Counterpart of ``sdfa_tpu/ops/pallas_freq_lstm.py``: ``freq_lstm`` takes
the arguments of ``freq_lstm_fused`` — x (rows, F, C), w_ih (2, C, 4H),
w_hh (2, H, 4H), gate bias (2, 4H) or None, w_proj (F·2H, out) with row
index f·2H + d·H + h, b_proj (out,) or None — and returns (rows, out).
"""

from __future__ import annotations

import torch

from . import build
from .bilstm_layer import bilstm_layer_plain

LAUNCHES = 0  # kernel launches by ``freq_lstm`` in this process

HIDDEN, OUT_DIM, MAX_IN = 128, 256, 128  # what the CUDA kernel takes


def freq_lstm_plain(x, w_ih, w_hh, gate_bias, w_proj, b_proj):
    """Plain PyTorch version: scan both directions, concat all F outputs,
    project (the oracle ``freq_lstm_reference`` in the JAX package)."""
    rows, n_freq, _ = x.shape
    h = bilstm_layer_plain(x, w_ih, w_hh, gate_bias)  # (rows, F, 2H)
    out = h.reshape(rows, -1) @ w_proj
    return out + b_proj if b_proj is not None else out


def freq_lstm(x, w_ih, w_hh, gate_bias, w_proj, b_proj):
    """Fused FreqLstm: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; any other input raises."""
    if x.device.type == "cpu":
        return freq_lstm_plain(x, w_ih, w_hh, gate_bias, w_proj, b_proj)
    rows, n_freq, n_in = x.shape
    gdim = 4 * HIDDEN
    if n_in > MAX_IN or w_hh.shape[1] != HIDDEN or w_proj.shape[1] != OUT_DIM:
        raise ValueError(f"freq_lstm kernel takes H={HIDDEN}, out={OUT_DIM}, in<={MAX_IN}; "
                         f"got x {tuple(x.shape)}, w_hh {tuple(w_hh.shape)}, "
                         f"w_proj {tuple(w_proj.shape)}")
    build.check("x", x, (rows, n_freq, n_in))
    build.check("w_ih", w_ih, (2, n_in, gdim))
    build.check("w_hh", w_hh, (2, HIDDEN, gdim))
    build.check("w_proj", w_proj, (n_freq * 2 * HIDDEN, OUT_DIM))
    if gate_bias is not None:
        build.check("gate_bias", gate_bias, (2, gdim))
    if b_proj is not None:
        build.check("b_proj", b_proj, (OUT_DIM,))
    out = torch.empty(rows, OUT_DIM, device=x.device, dtype=torch.float32)
    build.launch("freq_lstm", (x, w_ih, w_hh, gate_bias, w_proj, b_proj, out),
                 (rows, n_freq, n_in, HIDDEN, OUT_DIM), x.device)
    global LAUNCHES
    LAUNCHES += 1
    return out
