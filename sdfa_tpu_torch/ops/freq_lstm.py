"""FreqLstm kernels (``csrc/freq_lstm.cu``) and their plain version.

Counterpart of ``sdfa_tpu/ops/pallas_freq_lstm.py``: ``freq_lstm`` takes
the arguments of ``freq_lstm_fused`` — x (rows, F, C), w_ih (2, C, 4H),
w_hh (2, H, 4H), gate bias (2, 4H) or None, w_proj (F·2H, out) with row
index f·2H + d·H + h, b_proj (out,) or None — and returns (rows, out).

On a card a chunk of rows goes through three phases, each a hand-written
kernel: the input projection xp = x·w_ih (+ bias) for all frequency steps
and both directions at once, in 3xTF32 on the tensor cores (w_ih staged once
per call: ``bilstm_layer.proj_scratch``); the recurrence on the step loop of
``csrc/bilstm_layer.cuh`` (at H = 128 and 256 the cluster step: a cluster of
4 or 8 blocks holds one direction's w_hh in shared memory and owns
``ROW_TILE`` rows, the two directions in different clusters side by side;
from H = 384 on the wide step loop, w_hh streamed through L2 and h·w_hh in
3xTF32 on the tensor cores, blocks of ``WIDE_ROW_TILE`` rows), its h (rows, F, 2H)
written to scratch; the output projection h·w_proj in 3xTF32 on the tensor
cores too, at any output width: K = F·2H is split in slabs of ``K_SLAB``,
each slab's partial sum taken k tile by k tile of ``OUT_K`` (three TF32
products, h and w_proj split into hi and lo parts, in ``wgmma``'s truncating
f32 sums), the slabs added in slab order in f32, then the bias. The kernel
computes the transposed product w_proj^T·h^T, so that w_proj is read as it
lies, (K, out), and split in registers, and h, K-major as the step loop
writes it, is the operand the tensor cores read from shared memory: nothing
is staged before the call, and a w_proj updated in place is always read
anew. What is not CUDA — the row chunks (whole waves of resident clusters,
or of the wide loop's row tiles), the scratch sizes, the slabs and their
order, the k tiles — lives here, and ``freq_lstm_tiled`` walks the same
tiling in plain tensors so that the CPU tests reach it
(``output_projection_tiled`` for the last phase). ``output_projection`` runs
that phase alone, for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import collections

import torch

from . import build, launch_counters, note_launch
from .bilstm_layer import (HIDDENS, WIDE_ROW_TILE, WIDE_UNITS, bilstm_layer_plain,
                           layer_tiled_chunk, proj_scratch)
from .bilstm_layer import takes as layer_takes
from .tf32 import tiled_product

LAUNCHES = collections.Counter()  # wrapper calls that launched the kernels, by hidden width
launch_counters(__name__, "LAUNCHES")

ROW_TILE = 32               # rows per cluster at H = 128 and 256 (the wide loop's blocks own
                            # WIDE_ROW_TILE)
K_SLAB = 512                # K range of one partial sum of the output projection
OUT_K = 32                  # the output projection's k depth of a stage
# Rows are walked in chunks of at most ``row_steps(H)`` (row, step) pairs, so
# the scratch does not grow with the batch. Per pair at H = 128 and out = 256:
# xp 2 · 4H floats, h 2H floats, and out / K_SLAB · 2H floats of partial sums:
# 5.5 KiB, 176 MiB in all. SCRATCH_ROW_STEPS is the count at H = 128; a wider
# H takes proportionally fewer pairs.
SCRATCH_ROW_STEPS = 32768


def takes(hidden: int, out: int) -> bool:
    """Whether the CUDA kernels take FreqLstm at ``hidden`` units per
    direction projected to ``out`` features: any multiple of 128 and any
    output width, what the JAX gate sends to its Pallas kernel
    (``sdfa_tpu/nn/recurrent.py:427-435``)."""
    return layer_takes(hidden, 1) and out >= 1


def cost(rows: int, n_freq: int, n_in: int, hidden: int, out: int, gate_bias: bool = True,
         b_proj: bool = True):
    """(flops, bytes) of one launch: both directions' products over F steps,
    2 rows F (2 (in + H) 4H + 2H out) FLOP, and every input read once, the
    output written once."""
    gdim, k = 4 * hidden, n_freq * 2 * hidden
    flops = 2.0 * rows * (n_freq * 2 * (n_in + hidden) * gdim + k * out)
    floats = (rows * n_freq * n_in + 2 * n_in * gdim + 2 * hidden * gdim + 2 * gdim * gate_bias
              + k * out + out * b_proj + rows * out)
    return flops, 4.0 * floats


def freq_lstm_plain(x, w_ih, w_hh, gate_bias, w_proj, b_proj):
    """Plain PyTorch version: scan both directions, concat all F outputs,
    project (the oracle ``freq_lstm_reference`` in the JAX package)."""
    rows, n_freq, _ = x.shape
    h = bilstm_layer_plain(x, w_ih, w_hh, gate_bias)  # (rows, F, 2H)
    out = h.reshape(rows, -1) @ w_proj
    return out + b_proj if b_proj is not None else out


def row_steps(hidden: int) -> int:
    """(row, step) pairs of a chunk at ``hidden`` units: about the same
    scratch bytes at every width."""
    return SCRATCH_ROW_STEPS * 128 // hidden


def row_tile(hidden: int) -> int:
    """Rows a (row tile, direction) group of the step loop owns at ``hidden``
    units: a cluster's ``ROW_TILE`` at ``HIDDENS``, a block's
    ``WIDE_ROW_TILE`` in the wide loop from H = 384 on."""
    return ROW_TILE if hidden in HIDDENS else WIDE_ROW_TILE


def chunk_rows(steps: int, groups: int, hidden: int) -> int:
    """Rows per chunk at ``steps`` frequency steps and ``hidden`` units on a
    card that holds ``groups`` (row tile, direction) groups of the step loop
    at once (``resident_groups``): whole waves (a row tile is two groups, one
    per direction) where a wave fits ``row_steps(hidden)``, else whole row
    tiles (``row_tile``), never less than one row."""
    tile = row_tile(hidden)
    wave = max(1, groups // 2) * tile
    fit = row_steps(hidden) // steps
    if fit >= wave:
        return fit - fit % wave
    if fit >= tile:
        return fit - fit % tile
    return max(1, fit)


def scratch_rows(rows: int, steps: int, groups: int, hidden: int) -> int:
    """Rows of scratch (xp, h, partial sums) a call allocates: one chunk's, or
    all rows where they are fewer."""
    return min(rows, chunk_rows(steps, groups, hidden))


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


def freq_lstm_tiled(x, w_ih, w_hh, gate_bias, w_proj, b_proj, groups: int, slab_order=None):
    """``freq_lstm_plain``'s function computed the kernels' way: row chunks of
    ``chunk_rows(F, groups, H)``; per chunk the projection for all steps, the
    step loop with the directions apart (``layer_tiled_chunk``; from H = 384
    on the wide loop with ``groups`` · H / ``WIDE_UNITS`` resident blocks, so
    that its waves are the chunk's) into the h scratch, then the output projection as
    ``output_projection_tiled``: a 3xTF32 partial sum per K slab, added by
    ``sum_slabs``."""
    rows, n_freq, _ = x.shape
    hid = w_hh.shape[1]
    chunk = chunk_rows(n_freq, groups, hid)
    capacity = groups * (hid // WIDE_UNITS)
    outs = []
    for r in range(0, rows, chunk):
        h = layer_tiled_chunk(x[r:r + chunk], w_ih, w_hh, gate_bias, capacity)  # (n, F, 2H)
        outs.append(output_projection_tiled(h.reshape(h.shape[0], -1), w_proj, b_proj,
                                            slab_order))
    return torch.cat(outs)


def output_projection_tiled(h, w_proj, b_proj, slab_order=None):
    """The output projection (rows, K) → (rows, out) the way its kernel
    computes it: one partial sum per K slab of ``K_SLAB``, each in 3xTF32 k
    tile by k tile of ``OUT_K`` (``tiled_product``: h and w_proj split into
    TF32 parts, the kernel rounding ties away from zero, this to even), the
    slabs added by ``sum_slabs`` in slab order (or ``slab_order``), the bias
    last."""
    parts = [tiled_product(h[:, k:k + K_SLAB], w_proj[k:k + K_SLAB], OUT_K)
             for k in range(0, h.shape[1], K_SLAB)]
    return sum_slabs(parts, b_proj, slab_order)


def tiling(device) -> dict:
    """What ``device`` holds at once of the step loops FreqLstm runs:
    clusters at H = 128 and 256 (``cudaOccupancyMaxActiveClusters`` for the
    launches the wrapper makes), blocks of the wide step loop (``"wide"``).
    Also checks that the tiling the kernels were built with is this
    module's."""
    c128, c256, wide, row_tile, k_slab = build.query_ints("freq_lstm", "freq_lstm_tiling", 5,
                                                          device)
    if (row_tile, k_slab) != (ROW_TILE, K_SLAB) or min(c128, c256) < 2 or wide < 1:
        raise RuntimeError(f"freq_lstm.cu owns {row_tile} rows a cluster and sums K in slabs of "
                           f"{k_slab}, {c128} / {c256} clusters, {wide} wide blocks resident; "
                           f"this module says {ROW_TILE} and {K_SLAB}")
    return {128: c128, 256: c256, "wide": wide}


def out_tiling(device) -> dict:
    """The output projection as built: its k depth of a stage (checked
    against ``OUT_K``) and how many of its blocks ``device`` holds at once."""
    k, blocks = build.query_ints("freq_lstm", "freq_lstm_out_tiling", 2, device)
    if k != OUT_K:
        raise RuntimeError(f"freq_lstm.cu's output projection stages {k} k; OUT_K says {OUT_K}")
    return {"k_tile": k, "resident_blocks": blocks}


def resident_groups(device, hidden: int) -> int:
    """(Row tile, direction) groups of the step loop at ``hidden`` units that
    ``device`` holds at once: clusters at ``HIDDENS``, the wide loop's blocks
    over H / ``WIDE_UNITS`` from H = 384 on."""
    held = tiling(device)
    return held[hidden] if hidden in HIDDENS else held["wide"] // (hidden // WIDE_UNITS)


def freq_lstm(x, w_ih, w_hh, gate_bias, w_proj, b_proj):
    """FreqLstm: the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors; any other input, or a shape the kernels do not take, raises."""
    if x.device.type == "cpu":
        return freq_lstm_plain(x, w_ih, w_hh, gate_bias, w_proj, b_proj)
    rows, n_freq, n_in = x.shape
    hid, out_dim = w_hh.shape[1], w_proj.shape[1]
    gdim = 4 * hid
    if not takes(hid, out_dim) or n_freq < 1 or n_in < 1:
        raise ValueError(f"freq_lstm kernels take H a multiple of 128, out>=1, F>=1, in>=1; "
                         f"got x {tuple(x.shape)}, w_hh {tuple(w_hh.shape)}, "
                         f"w_proj {tuple(w_proj.shape)}")
    k = n_freq * 2 * hid
    build.check("x", x, (rows, n_freq, n_in))
    build.check("w_ih", w_ih, (2, n_in, gdim))
    build.check("w_hh", w_hh, (2, hid, gdim))
    build.check("w_proj", w_proj, (k, out_dim))
    if gate_bias is not None:
        build.check("gate_bias", gate_bias, (2, gdim))
    if b_proj is not None:
        build.check("b_proj", b_proj, (out_dim,))
    build.check_aligned(w_ih=w_ih, w_hh=w_hh, gate_bias=gate_bias)
    groups = resident_groups(x.device, hid)
    n = scratch_rows(rows, n_freq, groups, hid)
    empty = dict(device=x.device, dtype=torch.float32)
    (wt,), xpad = proj_scratch(x, n_in, hid, n * n_freq)
    xp = torch.empty(2, n, n_freq, gdim, **empty)
    h = torch.empty(n, n_freq, 2 * hid, **empty)
    part = torch.empty(out_slabs(k), n, out_dim, **empty)
    out = torch.empty(rows, out_dim, **empty)
    build.launch("freq_lstm", (x, w_ih, w_hh, gate_bias, w_proj, b_proj, wt, xpad, xp, h, part,
                               out),
                 (rows, n_freq, n_in, hid, out_dim, chunk_rows(n_freq, groups, hid)), x.device)
    LAUNCHES[hid] += 1
    note_launch("freq_lstm", cost(rows, n_freq, n_in, hid, out_dim, gate_bias is not None,
                                  b_proj is not None))
    return out


def output_projection(h, w_proj, b_proj):
    """The output projection alone, as a chunk of ``freq_lstm`` runs it: h
    (rows, K) → (rows, out). The kernel for CUDA tensors (no launch counter:
    no path calls it, the tests and ``chip_smoke.py`` hold it to
    ``output_projection_tiled``), ``output_projection_tiled`` for CPU
    tensors."""
    if h.device.type == "cpu":
        return output_projection_tiled(h, w_proj, b_proj)
    rows, k = h.shape
    out_dim = w_proj.shape[-1]
    if k % 4 or out_dim < 1:
        raise ValueError(f"output_projection takes K a multiple of 4, out >= 1; got h "
                         f"{tuple(h.shape)}, w_proj {tuple(w_proj.shape)}")
    build.check("h", h, (rows, k))
    build.check("w_proj", w_proj, (k, out_dim))
    if b_proj is not None:
        build.check("b_proj", b_proj, (out_dim,))
    build.check_aligned(h=h)
    empty = dict(device=h.device, dtype=torch.float32)
    part = torch.empty(out_slabs(k), rows, out_dim, **empty)
    out = torch.empty(rows, out_dim, **empty)
    build.launch("freq_lstm", (h, w_proj, b_proj, part, out), (rows, k, out_dim), h.device,
                 entry="freq_lstm_output_projection")
    return out
