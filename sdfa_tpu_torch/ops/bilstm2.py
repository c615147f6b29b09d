"""2-layer biLSTM kernel (``csrc/bilstm2.cu``) and its plain version.

Counterpart of ``sdfa_tpu/ops/pallas_bilstm2.py``: ``bilstm2`` takes the
arguments of ``bilstm_2layer_fused`` — x (rows, T, in), per layer w_ih
(2, in, 4H), w_hh (2, H, 4H), gate bias (2, 4H) or None; direction 0
forward, 1 reverse — and returns (rows, T, 2H) float32.

One entry point, one call into the library: it stages both layers' w_ih
for the input projection, then per row chunk it enqueues the layer of
``csrc/bilstm_layer.cuh`` twice (the input projection in 3xTF32, then the
step loop: the cluster step at H = 128 and 256, the wide step loop from 384
on), layer 1's output stack in a scratch tensor between them. It takes what
the per-layer kernel takes for both layers (``bilstm_layer.takes``: any H
that is a multiple of 128, any input width). ``bilstm2_tiled`` walks the
same chunks and phases in plain tensors for the CPU tests.
"""

from __future__ import annotations

import collections

import torch

from . import build, launch_counters, note_launch
from .bilstm_layer import (bilstm_layer_plain, chunk_rows, layer_tiled_chunk, proj_scratch,
                           scratch_rows, takes)  # one layer, one tiling, one limit
from .bilstm_layer import cost as layer_cost

LAUNCHES = collections.Counter()  # kernel launches by ``bilstm2`` in this process, by hidden width
launch_counters(__name__, "LAUNCHES")


def bilstm2_plain(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2):
    """Plain PyTorch version: two layers back to back
    (``bilstm_2layer_reference``)."""
    return bilstm_layer_plain(bilstm_layer_plain(x, w_ih1, w_hh1, gb1), w_ih2, w_hh2, gb2)


def cost(rows: int, steps: int, n_in: int, hidden: int, gate_bias: bool = True):
    """(flops, bytes) of one launch: the two layers' products, 2 rows T 2
    ((in + H) + (2H + H)) 4H FLOP, and every input read once, the output
    written once (layer 1's output stack is scratch, not counted)."""
    f1, b1 = layer_cost(rows, steps, n_in, hidden, gate_bias)
    f2, b2 = layer_cost(rows, steps, 2 * hidden, hidden, gate_bias)
    stack = 4.0 * rows * steps * 2 * hidden  # layer 1's output and layer 2's input
    return f1 + f2, b1 + b2 - 2 * stack


def bilstm2_tiled(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2, capacity=None):
    """``bilstm2_plain``'s function computed the kernel's way: per row chunk
    all of layer 1 into the stack, then layer 2 from it (``capacity``:
    resident blocks of the wide step loop, from H = 384 on)."""
    chunk = chunk_rows(x.shape[1], w_hh1.shape[1])
    outs = []
    for r in range(0, x.shape[0], chunk):
        stack = layer_tiled_chunk(x[r:r + chunk], w_ih1, w_hh1, gb1, capacity)
        outs.append(layer_tiled_chunk(stack, w_ih2, w_hh2, gb2, capacity))
    return torch.cat(outs)


def bilstm2(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2):
    """Two-layer biLSTM: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors; any other input, or a shape the kernels do not
    take, raises."""
    if x.device.type == "cpu":
        return bilstm2_plain(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2)
    rows, steps, n_in = x.shape
    hid = w_hh1.shape[1]
    if not (takes(hid, n_in) and takes(hid, 2 * hid)) or steps < 1:
        raise ValueError(f"bilstm2 kernel takes H a multiple of 128, in>=1, T>=1; got x "
                         f"{tuple(x.shape)}, w_hh {tuple(w_hh1.shape)}")
    gdim = 4 * hid
    build.check("x", x, (rows, steps, n_in))
    build.check("w_ih1", w_ih1, (2, n_in, gdim))
    build.check("w_hh1", w_hh1, (2, hid, gdim))
    build.check("w_ih2", w_ih2, (2, 2 * hid, gdim))
    build.check("w_hh2", w_hh2, (2, hid, gdim))
    for name, gb in (("gb1", gb1), ("gb2", gb2)):
        if gb is not None:
            build.check(name, gb, (2, gdim))
    build.check_aligned(w_ih1=w_ih1, w_hh1=w_hh1, gb1=gb1, w_ih2=w_ih2, w_hh2=w_hh2, gb2=gb2)
    n = scratch_rows(rows, steps, hid)  # one chunk's rows: the scratch does not grow with the batch
    (wt1, wt2), xpad = proj_scratch(x, n_in, hid, n * steps, w_ih_inputs=(2 * hid,))
    xp = torch.empty(2, n, steps, gdim, device=x.device, dtype=torch.float32)
    stack = torch.empty(n, steps, 2 * hid, device=x.device, dtype=torch.float32)
    out = torch.empty(rows, steps, 2 * hid, device=x.device, dtype=torch.float32)
    build.launch("bilstm2", (x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2, wt1, wt2, xpad, xp, stack,
                             out),
                 (rows, steps, n_in, hid, chunk_rows(steps, hid)), x.device)
    LAUNCHES[hid] += 1
    note_launch("bilstm2", cost(rows, steps, n_in, hid, gb1 is not None))
    return out
