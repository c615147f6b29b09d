"""Fused 2-layer biLSTM kernel (``csrc/bilstm2.cu``) and its plain version.

Counterpart of ``sdfa_tpu/ops/pallas_bilstm2.py``: ``bilstm2`` takes the
arguments of ``bilstm_2layer_fused`` — x (rows, T, in), per layer w_ih
(2, in, 4H), w_hh (2, H, 4H), gate bias (2, 4H) or None; direction 0
forward, 1 reverse — and returns (rows, T, 2H) float32.
"""

from __future__ import annotations

import torch

from . import build
from .bilstm_layer import HIDDEN, MAX_IN, bilstm_layer_plain  # one step loop, one limit

LAUNCHES = 0  # kernel launches by ``bilstm2`` in this process


def bilstm2_plain(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2):
    """Plain PyTorch version: two layers back to back
    (``bilstm_2layer_reference``)."""
    return bilstm_layer_plain(bilstm_layer_plain(x, w_ih1, w_hh1, gb1), w_ih2, w_hh2, gb2)


def bilstm2(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2):
    """Fused two-layer biLSTM: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; any other input raises."""
    if x.device.type == "cpu":
        return bilstm2_plain(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2)
    rows, steps, n_in = x.shape
    gdim = 4 * HIDDEN
    if n_in > MAX_IN or w_hh1.shape[1] != HIDDEN:
        raise ValueError(f"bilstm2 kernel takes H={HIDDEN}, in<={MAX_IN}; got x "
                         f"{tuple(x.shape)}, w_hh {tuple(w_hh1.shape)}")
    build.check("x", x, (rows, steps, n_in))
    build.check("w_ih1", w_ih1, (2, n_in, gdim))
    build.check("w_hh1", w_hh1, (2, HIDDEN, gdim))
    build.check("w_ih2", w_ih2, (2, 2 * HIDDEN, gdim))
    build.check("w_hh2", w_hh2, (2, HIDDEN, gdim))
    for name, gb in (("gb1", gb1), ("gb2", gb2)):
        if gb is not None:
            build.check(name, gb, (2, gdim))
    stack = torch.empty(rows, steps, 2 * HIDDEN, device=x.device, dtype=torch.float32)
    out = torch.empty_like(stack)
    build.launch("bilstm2", (x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2, stack, out),
                 (rows, steps, n_in, HIDDEN), x.device)
    global LAUNCHES
    LAUNCHES += 1
    return out
