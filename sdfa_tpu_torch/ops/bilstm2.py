"""2-layer biLSTM kernel (``csrc/bilstm2.cu``) and its plain version.

Counterpart of ``sdfa_tpu/ops/pallas_bilstm2.py``: ``bilstm2`` takes the
arguments of ``bilstm_2layer_fused`` — x (rows, T, in), per layer w_ih
(2, in, 4H), w_hh (2, H, 4H), gate bias (2, 4H) or None; direction 0
forward, 1 reverse — and returns (rows, T, 2H) float32.

One entry point, one call into the library: per row chunk it enqueues the
layer of ``csrc/bilstm_layer.cuh`` twice (tiled input projection, then the
step loop on a cluster of H / 32 blocks), layer 1's output stack in a scratch
tensor between them. It takes what the per-layer kernel takes for both
layers (``bilstm_layer.takes``: H = 128 or 256). ``bilstm2_tiled`` walks the
same chunks and phases in plain tensors for the CPU tests.
"""

from __future__ import annotations

import collections

import torch

from . import build
from .bilstm_layer import (HIDDENS, MAX_IN, bilstm_layer_plain, chunk_rows, layer_tiled_chunk,
                           scratch_rows, takes)  # one layer, one tiling, one limit

LAUNCHES = collections.Counter()  # kernel launches by ``bilstm2`` in this process, by hidden width


def bilstm2_plain(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2):
    """Plain PyTorch version: two layers back to back
    (``bilstm_2layer_reference``)."""
    return bilstm_layer_plain(bilstm_layer_plain(x, w_ih1, w_hh1, gb1), w_ih2, w_hh2, gb2)


def bilstm2_tiled(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2):
    """``bilstm2_plain``'s function computed the kernel's way: per row chunk
    all of layer 1 into the stack, then layer 2 from it."""
    chunk = chunk_rows(x.shape[1], w_hh1.shape[1])
    outs = []
    for r in range(0, x.shape[0], chunk):
        stack = layer_tiled_chunk(x[r:r + chunk], w_ih1, w_hh1, gb1)
        outs.append(layer_tiled_chunk(stack, w_ih2, w_hh2, gb2))
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
        raise ValueError(f"bilstm2 kernel takes H in {HIDDENS}, in<={MAX_IN}, T>=1; got x "
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
    n = scratch_rows(rows, steps, hid)  # one chunk's rows: the scratch does not grow with the batch
    xp = torch.empty(2, n, steps, gdim, device=x.device, dtype=torch.float32)
    stack = torch.empty(n, steps, 2 * hid, device=x.device, dtype=torch.float32)
    out = torch.empty(rows, steps, 2 * hid, device=x.device, dtype=torch.float32)
    build.launch("bilstm2", (x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2, xp, stack, out),
                 (rows, steps, n_in, hid, chunk_rows(steps, hid)), x.device)
    LAUNCHES[hid] += 1
    return out
