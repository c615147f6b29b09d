"""FreqLstm kernels (``csrc/freq_lstm.cu``) and their plain version.

Counterpart of ``sdfa_tpu/ops/pallas_freq_lstm.py``: ``freq_lstm`` takes
the arguments of ``freq_lstm_fused`` — x (rows, F, C), w_ih (2, C, 4H),
w_hh (2, H, 4H), gate bias (2, 4H) or None, w_proj (F·2H, out) with row
index f·2H + d·H + h, b_proj (out,) or None — and returns (rows, out).

On a card a chunk of rows goes through three phases, each a hand-written
kernel: the input projection xp = x·w_ih (+ bias) for all frequency steps
and both directions at once; the recurrence on the cluster step of
``csrc/bilstm_layer.cuh`` (a cluster of 4 blocks holds one direction's w_hh
in shared memory and owns ``ROW_TILE`` rows, the two directions in different
clusters side by side), its h (rows, F, 2H) written to scratch; the output
projection h·w_proj as a tiled product whose K = F·2H is split in slabs of
``K_SLAB``, the slabs' partial sums added in slab order. What is not CUDA —
the row chunks (whole waves of resident clusters), the scratch sizes, the
slabs and their order — lives here, and ``freq_lstm_tiled`` walks the same
tiling in plain tensors so that the CPU tests reach it.
"""

from __future__ import annotations

import torch

from . import build
from .bilstm_layer import bilstm_layer_plain, layer_tiled_chunk

LAUNCHES = 0  # wrapper calls of ``freq_lstm`` that launched the kernels

HIDDEN, OUT_DIM = 128, 256  # what the CUDA kernels take
ROW_TILE = 32               # rows per cluster, walked as two sub-tiles that take turns
K_SLAB = 512                # K range of one partial sum of the output projection
# Rows are walked in chunks of at most SCRATCH_ROW_STEPS (row, step) pairs, so
# the scratch does not grow with the batch. Per pair: xp 2 · 4H floats, h 2H
# floats, and out / K_SLAB · 2H floats of partial sums: 5.5 KiB, 176 MiB in all.
SCRATCH_ROW_STEPS = 32768


def takes(hidden: int, out: int) -> bool:
    """Whether the CUDA kernels take FreqLstm at ``hidden`` units per
    direction projected to ``out`` features."""
    return hidden == HIDDEN and out == OUT_DIM


def freq_lstm_plain(x, w_ih, w_hh, gate_bias, w_proj, b_proj):
    """Plain PyTorch version: scan both directions, concat all F outputs,
    project (the oracle ``freq_lstm_reference`` in the JAX package)."""
    rows, n_freq, _ = x.shape
    h = bilstm_layer_plain(x, w_ih, w_hh, gate_bias)  # (rows, F, 2H)
    out = h.reshape(rows, -1) @ w_proj
    return out + b_proj if b_proj is not None else out


def chunk_rows(steps: int, clusters: int) -> int:
    """Rows per chunk at ``steps`` frequency steps on a card that holds
    ``clusters`` clusters of the step kernel at once: whole waves (a row tile
    is two clusters, one per direction) where a wave fits
    ``SCRATCH_ROW_STEPS``, else whole row tiles, never less than one row."""
    wave = max(1, clusters // 2) * ROW_TILE
    fit = SCRATCH_ROW_STEPS // steps
    if fit >= wave:
        return fit - fit % wave
    if fit >= ROW_TILE:
        return fit - fit % ROW_TILE
    return max(1, fit)


def scratch_rows(rows: int, steps: int, clusters: int) -> int:
    """Rows of scratch (xp, h, partial sums) a call allocates: one chunk's, or
    all rows where they are fewer."""
    return min(rows, chunk_rows(steps, clusters))


def out_slabs(k: int) -> int:
    """In how many slabs the output projection's K = F · 2H is summed."""
    return -(-k // K_SLAB)


def sum_slabs(parts, b_proj, order=None):
    """The slabs' partial sums added one after the other in slab order (or in
    ``order``, for the tests), then the bias: a fixed order, so results repeat
    bit for bit."""
    order = range(len(parts)) if order is None else order
    total = None
    for s in order:
        total = parts[s].clone() if total is None else total + parts[s]
    return total if b_proj is None else total + b_proj


def freq_lstm_tiled(x, w_ih, w_hh, gate_bias, w_proj, b_proj, clusters: int, slab_order=None):
    """``freq_lstm_plain``'s function computed the kernels' way: row chunks of
    ``chunk_rows(F, clusters)``; per chunk the projection for all steps, the
    cluster step loop with the directions apart (``layer_tiled_chunk``) into
    the h scratch, then the output projection as one partial sum per K slab,
    added by ``sum_slabs``."""
    rows, n_freq, _ = x.shape
    chunk = chunk_rows(n_freq, clusters)
    outs = []
    for r in range(0, rows, chunk):
        h = layer_tiled_chunk(x[r:r + chunk], w_ih, w_hh, gate_bias)  # (n, F, 2H) scratch
        h = h.reshape(h.shape[0], -1)
        parts = [h[:, k:k + K_SLAB] @ w_proj[k:k + K_SLAB]
                 for k in range(0, h.shape[1], K_SLAB)]
        outs.append(sum_slabs(parts, b_proj, slab_order))
    return torch.cat(outs)


def max_active_clusters(device) -> int:
    """How many clusters of the step kernel ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters`` for the launch the wrapper makes). Also
    checks that the tiling the kernels were built with is this module's."""
    clusters, row_tile, k_slab = build.query_ints("freq_lstm", "freq_lstm_tiling", 3, device)
    if (row_tile, k_slab) != (ROW_TILE, K_SLAB) or clusters < 2:
        raise RuntimeError(f"freq_lstm.cu owns {row_tile} rows a cluster and sums K in slabs of "
                           f"{k_slab}, {clusters} clusters resident; this module says "
                           f"{ROW_TILE} and {K_SLAB}")
    return clusters


def freq_lstm(x, w_ih, w_hh, gate_bias, w_proj, b_proj):
    """FreqLstm: the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors; any other input raises."""
    if x.device.type == "cpu":
        return freq_lstm_plain(x, w_ih, w_hh, gate_bias, w_proj, b_proj)
    rows, n_freq, n_in = x.shape
    gdim = 4 * HIDDEN
    if not takes(w_hh.shape[1], w_proj.shape[1]) or n_freq < 1 or n_in < 1:
        raise ValueError(f"freq_lstm kernels take H={HIDDEN}, out={OUT_DIM}, F>=1, in>=1; "
                         f"got x {tuple(x.shape)}, w_hh {tuple(w_hh.shape)}, "
                         f"w_proj {tuple(w_proj.shape)}")
    k = n_freq * 2 * HIDDEN
    build.check("x", x, (rows, n_freq, n_in))
    build.check("w_ih", w_ih, (2, n_in, gdim))
    build.check("w_hh", w_hh, (2, HIDDEN, gdim))
    build.check("w_proj", w_proj, (k, OUT_DIM))
    if gate_bias is not None:
        build.check("gate_bias", gate_bias, (2, gdim))
    if b_proj is not None:
        build.check("b_proj", b_proj, (OUT_DIM,))
    for name, t in (("w_ih", w_ih), ("gate_bias", gate_bias), ("w_proj", w_proj),
                    ("b_proj", b_proj)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels read it 16 bytes at a time; it starts at "
                             f"{t.data_ptr():#x}")
    clusters = max_active_clusters(x.device)
    n = scratch_rows(rows, n_freq, clusters)
    empty = dict(device=x.device, dtype=torch.float32)
    xp = torch.empty(2, n, n_freq, gdim, **empty)
    h = torch.empty(n, n_freq, 2 * HIDDEN, **empty)
    part = torch.empty(out_slabs(k), n, OUT_DIM, **empty)
    out = torch.empty(rows, OUT_DIM, **empty)
    build.launch("freq_lstm", (x, w_ih, w_hh, gate_bias, w_proj, b_proj, xp, h, part, out),
                 (rows, n_freq, n_in, HIDDEN, OUT_DIM, chunk_rows(n_freq, clusters)), x.device)
    global LAUNCHES
    LAUNCHES += 1
    return out
