"""Per-layer biLSTM kernel (``csrc/bilstm_layer.cu``) and its plain version.

Counterpart of ``sdfa_tpu/ops/pallas_bilstm.py``: ``bilstm_layer`` takes
the arguments of ``bilstm_layer_fused`` — x (rows, T, in), w_ih
(2, in, 4H), w_hh (2, H, 4H), gate bias (2, 4H) or None; direction 0
forward, 1 reverse; gate order i, f, g, o — and returns (rows, T, 2H)
float32, forward h in ``[..., :H]`` and reverse h in ``[..., H:]``.

On a card the layer is two hand-written kernels per row chunk
(``csrc/bilstm_layer.cuh``): a product computes the input projection
xp = x·w_ih (+ bias) for all steps at once into a scratch tensor (any input
width), in 3xTF32 on the tensor cores (``projection_tiled`` says how), then
the step loop. At ``HIDDENS`` (128 and 256) the step loop holds
w_hh in the shared memory of a cluster of H / 32 blocks (8 at H = 256, 4 at
H = 128): block s of a cluster owns hidden units 32s … 32s+31 of one
direction for a tile of 32 rows. From H = 384 on (any multiple of 128) no
cluster's shared memory holds w_hh, and the wide step loop takes its place:
one cooperative launch per wave of rows, a block owning ``WIDE_UNITS`` units
of one direction for a tile of ``WIDE_ROW_TILE`` rows, its step's product
h·w_hh in 3xTF32 on the tensor cores with w_hh and h streamed through L2 in
k tiles of ``WIDE_K`` (``wide_steps_tiled`` says how), one grid-wide barrier
a step (``takes``: every shape the JAX gate sends to its kernel). What is not
CUDA — the row chunks, the scratch size, which gate columns a block owns, the
waves — lives here, and ``bilstm_layer_tiled`` walks the same tiling in plain
tensors so that the CPU tests reach it.

The input projection's scratch (``proj_scratch``, also for ``bilstm2`` and
``freq_lstm``): w_ih transposed and split into its TF32 parts, written by a
kernel of the same launch on every call (nothing is cached, so a weight
updated in place between calls is always read anew); and, where x cannot be
copied 16 bytes at a time (an input width that is no multiple of 4, or x not
16-byte aligned: ``proj_needs_pad``, the one route for such inputs), a copy of
x with its rows padded with zeros to a multiple of 4, which the launch fills.
``projection`` runs the projection alone, for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import collections

import torch

from . import build, launch_counters, note_launch
from .tf32 import tiled_product

LAUNCHES = collections.Counter()  # kernel launches by ``bilstm_layer`` in this process, by hidden width
launch_counters(__name__, "LAUNCHES")

HIDDENS = (128, 256)       # the widths of the cluster step; the wide step loop takes the rest
UNITS_PER_BLOCK = 32       # hidden units a block of a cluster owns, whatever the width
ROW_TILE = 32              # rows per cluster, walked as two sub-tiles that take turns
SUB_TILE = ROW_TILE // 2
PROJ_K = 32                # the input projection's k depth of a stage (its weights' K is
                           # padded to a multiple)
WIDE_ROW_TILE = 64         # the wide step loop (both passes): rows a block owns,
WIDE_UNITS = 16            # hidden units it owns (4 · 16 gate columns),
WIDE_K = 32                # the k depth of one stage of its product (the sums promoted to
                           # f32 registers after each)
# Rows are walked in chunks of at most ``row_steps(H)`` (row, step) pairs (one
# row where T alone is more), so the scratch does not grow with the batch: xp
# holds 2 · 4H floats per pair, 128 MiB at any width; the 2-layer kernel's
# stack another 2H floats per pair, 32 MiB. SCRATCH_ROW_STEPS is the count at
# H = 256; at H = 128 a pair is half the bytes and a chunk twice the pairs.
SCRATCH_ROW_STEPS = 16384


def takes(hidden: int, n_in: int) -> bool:
    """Whether the CUDA kernels take a layer of ``hidden`` units per direction
    over ``n_in`` input features (the 2-layer kernel: both its layers): any
    multiple of 128, any input width — every shape the JAX gate sends to its
    Pallas kernel (``sdfa_tpu/nn/recurrent.py:236-238, 293-296``) and the
    inputs it scans."""
    return hidden > 0 and hidden % 128 == 0 and n_in >= 1


def wide_wave_rows(hidden: int, capacity: int) -> int:
    """Rows one cooperative launch of the wide step loop takes at ``hidden``
    units on a card that holds ``capacity`` of its blocks at once: whole row
    tiles of ``WIDE_ROW_TILE``, each 2 · H / ``WIDE_UNITS`` blocks (both
    directions)."""
    return capacity // (2 * (hidden // WIDE_UNITS)) * WIDE_ROW_TILE


def cost(rows: int, steps: int, n_in: int, hidden: int, gate_bias: bool = True):
    """(flops, bytes) of one launch: both directions' input projection and
    recurrence, 2 rows T 2 (in + H) 4H FLOP, and every input read once, the
    output written once."""
    gdim = 4 * hidden
    flops = 2.0 * rows * steps * 2 * (n_in + hidden) * gdim
    floats = (rows * steps * n_in + 2 * n_in * gdim + 2 * hidden * gdim + 2 * gdim * gate_bias
              + rows * steps * 2 * hidden)
    return flops, 4.0 * floats


def cluster_blocks(hidden: int) -> int:
    """Blocks of a cluster of the step kernel at ``hidden`` units: 8 or 4."""
    return hidden // UNITS_PER_BLOCK


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


def row_steps(hidden: int) -> int:
    """(row, step) pairs of a chunk at ``hidden`` units: the same scratch bytes
    at every width."""
    return SCRATCH_ROW_STEPS * max(HIDDENS) // hidden


def chunk_rows(steps: int, hidden: int) -> int:
    """Rows per chunk at ``steps`` time steps and ``hidden`` units: whole row
    tiles where a tile fits ``row_steps(hidden)``, never less than one row."""
    n = max(1, row_steps(hidden) // steps)
    return n - n % ROW_TILE if n >= ROW_TILE else n


def scratch_rows(rows: int, steps: int, hidden: int) -> int:
    """Rows of scratch (xp, the 2-layer stack) a call allocates: one chunk's,
    or all rows where they are fewer."""
    return min(rows, chunk_rows(steps, hidden))


def block_columns(block: int, hidden: int) -> torch.Tensor:
    """The gate columns block ``block`` of a cluster owns, as the kernel holds
    them, [unit][gate]: hidden unit j owns columns j, H+j, 2H+j, 3H+j, so a
    block's 128 columns are four strided runs, not one. A cluster is
    ``cluster_blocks(hidden)`` blocks."""
    units = block * UNITS_PER_BLOCK + torch.arange(UNITS_PER_BLOCK)
    return (units[:, None] + hidden * torch.arange(4)[None, :]).reshape(-1)


def projection_tiled(x, w_ih, gate_bias):
    """The input projection the way its kernel computes it, (rows, T, in) →
    (2, rows, T, 4H): x and w_ih split into TF32 parts (``split_tf32``; the
    kernel rounds ties away from zero, this ties to even: they differ on exact
    ties only), then per k tile of ``PROJ_K`` input features (the last one
    partial: any input width) the three products x_hi·w_hi, x_hi·w_lo,
    x_lo·w_hi added to one sum, then the gate bias."""
    xp = tiled_product(x[None], w_ih[:, None], PROJ_K)  # (2, rows, T, 4H)
    return xp if gate_bias is None else xp + gate_bias[:, None, None]


def proj_needs_pad(x) -> bool:
    """Whether the projection reads x through the padded copy: its rows
    cannot be copied 16 bytes at a time (``bilstm_layer.cuh::proj_needs_pad``)."""
    return x.shape[-1] % 4 != 0 or x.data_ptr() % 16 != 0


def proj_scratch(x, n_in: int, hidden: int, pairs: int, w_ih_inputs=()):
    """The input projection's scratch for one call on ``x``: (wt, xpad). wt
    (2, 8H, K padded to ``PROJ_K``) holds w_ih transposed and split, one for
    ``n_in`` and one more for each width in ``w_ih_inputs`` (a later layer's
    input); xpad (pairs, ``n_in`` rounded up to 4) is allocated only where
    ``proj_needs_pad(x)``, for the (row, step) pairs of one chunk."""
    empty = dict(device=x.device, dtype=torch.float32)
    wts = [torch.empty(2, 8 * hidden, -(-k // PROJ_K) * PROJ_K, **empty)
           for k in (n_in, *w_ih_inputs)]
    xpad = torch.empty(pairs, -(-n_in // 4) * 4, **empty) if proj_needs_pad(x) else None
    return wts, xpad


def layer_tiled_chunk(x, w_ih, w_hh, gate_bias, capacity=None):
    """One chunk of rows the way the kernels walk it, in plain tensors: the
    projection for all steps first (``projection_tiled``), then the step loop.
    At ``HIDDENS``, per
    (row tile, direction) the cluster step over the tile's two sub-tiles, in
    which each of the cluster's blocks multiplies the full h by its own column
    slice (k in four interleaved quarters, summed pairwise as the warp
    exchanges do), applies the cell to its units and hands its h slice to the
    buffer the next step reads; from H = 384 on ``wide_steps_tiled`` over
    time-ordered views (``capacity``: its resident blocks)."""
    rows, steps, _ = x.shape
    hid = w_hh.shape[1]
    xp = projection_tiled(x, w_ih, gate_bias)  # (2, rows, T, 4H)
    out = x.new_empty(rows, steps, 2 * hid)
    if hid not in HIDDENS:
        wide_steps_tiled(xp.transpose(1, 2), w_hh, out.transpose(0, 1), capacity)
        return out
    per = UNITS_PER_BLOCK
    blocks = cluster_blocks(hid)  # 8 at H = 256, 4 at H = 128
    cols = [block_columns(b, hid) for b in range(blocks)]
    for row0 in range(0, rows, SUB_TILE):  # a tile's sub-tiles are independent rows
        n = min(SUB_TILE, rows - row0)  # the kernel computes the sub-tile's other rows on zeros
        for d in range(2):
            w_blocks = [w_hh[d][:, c] for c in cols]  # each block's resident slice
            h = [x.new_zeros(n, hid), x.new_empty(n, hid)]  # double-buffered
            c_state = x.new_zeros(n, hid)
            for step in range(steps):
                t = step if d == 0 else steps - 1 - step
                cur, nxt = step % 2, 1 - step % 2
                for b in range(blocks):
                    own = slice(b * per, (b + 1) * per)
                    part = [h[cur][:, q::4] @ w_blocks[b][q::4] for q in range(4)]
                    pre = ((part[0] + part[2]) + (part[1] + part[3])
                           + xp[d, row0:row0 + n, t][:, cols[b]]).reshape(n, per, 4)
                    i, f, o = (torch.sigmoid(pre[..., q]) for q in (0, 1, 3))
                    c_state[:, own] = f * c_state[:, own] + i * torch.tanh(pre[..., 2])
                    h[nxt][:, own] = o * torch.tanh(c_state[:, own])
                out[row0:row0 + n, t, d * hid:(d + 1) * hid] = h[nxt]
    return out


def wide_run_columns(hidden: int):
    """The gate columns of each run of ``WIDE_UNITS`` units of the wide step
    loop, gate-major: block x owns units 16x … 16x+15, columns q·H + those
    units for the gates q = i, f, g, o (the kernel orders them otherwise in
    its product; each column's sum is the same)."""
    return [torch.cat([q * hidden + u0 + torch.arange(WIDE_UNITS) for q in range(4)])
            for u0 in range(0, hidden, WIDE_UNITS)]


def wide_steps_tiled(xp, w_hh, out, capacity=None, gates=None, cs=None):
    """The wide step loop, in plain tensors: xp (2, T, rows, 4H) and out (T,
    rows, 2H) indexed by time (time-ordered views of a layer's tensors too).
    Per wave of ``wide_wave_rows(H, capacity)`` rows (all rows in one where
    ``capacity`` is None) and step, each block — a direction, a row tile of
    ``WIDE_ROW_TILE``, a run of ``WIDE_UNITS`` units — multiplies the previous
    h of its rows, read back from ``out`` at the direction's previous time
    index, by its 64 gate columns of w_hh in 3xTF32 (``tiled_product``: both
    split into TF32 parts, three products a k tile of ``WIDE_K``, each tile's
    sum added to the total in f32 from k = 0 on, as the kernel promotes its
    tensor-core sums every k tile), adds the xp slab, and applies the cell;
    with ``gates`` and ``cs`` given, it writes the post-activation gates and c
    as the training core's forward does. Writes ``out`` (and ``gates``,
    ``cs``) in place."""
    _, steps, rows, gdim = xp.shape
    hid = gdim // 4
    wave = rows if capacity is None else wide_wave_rows(hid, capacity)
    if wave <= 0:
        raise ValueError(f"no row tile of the wide loop at H={hid} fits {capacity} blocks")
    runs = wide_run_columns(hid)
    for r0 in range(0, rows, wave):  # one cooperative launch
        r1 = min(r0 + wave, rows)
        c_state = xp.new_zeros(2, rows, hid)
        for step in range(steps):  # a grid-wide barrier between steps
            for d in range(2):
                t = step if d == 0 else steps - 1 - step
                tp = t - 1 if d == 0 else t + 1
                for t0 in range(r0, r1, WIDE_ROW_TILE):
                    rs = slice(t0, min(t0 + WIDE_ROW_TILE, r1))
                    n = rs.stop - rs.start
                    for x0, cols in zip(range(0, hid, WIDE_UNITS), runs):
                        units = slice(x0, x0 + WIDE_UNITS)
                        if step > 0:
                            acc = tiled_product(out[tp, rs, d * hid:(d + 1) * hid],
                                                w_hh[d][:, cols], WIDE_K)
                        else:
                            acc = xp.new_zeros(n, 4 * WIDE_UNITS)
                        pre = (acc + xp[d, t, rs][:, cols]).reshape(n, 4, WIDE_UNITS)
                        i, f, o = (torch.sigmoid(pre[:, q]) for q in (0, 1, 3))
                        g = torch.tanh(pre[:, 2])
                        c_state[d, rs, units] = f * c_state[d, rs, units] + i * g
                        out[t, rs, d * hid + x0:d * hid + x0 + WIDE_UNITS] = (
                            o * torch.tanh(c_state[d, rs, units]))
                        if gates is not None:
                            gates[d, t, rs][:, cols] = torch.cat([i, f, g, o], dim=-1)
                            cs[d, t, rs, units] = c_state[d, rs, units]
    return out


def bilstm_layer_tiled(x, w_ih, w_hh, gate_bias, capacity=None):
    """``bilstm_layer_plain``'s function computed the kernel's way: row
    chunks of ``chunk_rows(T, H)``, each through ``layer_tiled_chunk``
    (``capacity``: resident blocks of the wide step loop, from H = 384 on)."""
    chunk = chunk_rows(x.shape[1], w_hh.shape[1])
    return torch.cat([layer_tiled_chunk(x[r:r + chunk], w_ih, w_hh, gate_bias, capacity)
                      for r in range(0, x.shape[0], chunk)])


def max_active_clusters(device) -> dict:
    """How many clusters of the step kernel ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters`` for the launches the wrapper makes),
    by hidden width: {128: clusters, 256: clusters}."""
    return dict(zip(HIDDENS, build.query_ints("bilstm_layer", "bilstm_layer_clusters", 2,
                                              device)))


def wide_resident_blocks(device) -> int:
    """How many blocks of the wide step loop ``device`` holds at once
    (resident blocks a multiprocessor × multiprocessors): what one cooperative
    launch may take. Also checks the tiling it was built with: the rows and
    units a block owns and the k depth of a stage (``WIDE_ROW_TILE``,
    ``WIDE_UNITS``, ``WIDE_K``)."""
    blocks, *tiling = build.query_ints("bilstm_layer", "bilstm_layer_wide_blocks", 4, device)
    if tuple(tiling) != (WIDE_ROW_TILE, WIDE_UNITS, WIDE_K):
        raise RuntimeError(f"bilstm_layer.cuh's wide step loop owns {tiling[0]} rows x "
                           f"{tiling[1]} units a block in k tiles of {tiling[2]}; this module "
                           f"says {WIDE_ROW_TILE} x {WIDE_UNITS}, {WIDE_K}")
    return blocks


def bilstm_layer(x, w_ih, w_hh, gate_bias):
    """One biLSTM layer: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors; any other input, or a shape the kernels do not
    take, raises."""
    if x.device.type == "cpu":
        return bilstm_layer_plain(x, w_ih, w_hh, gate_bias)
    rows, steps, n_in = x.shape
    hid = w_hh.shape[1]
    if not takes(hid, n_in) or steps < 1:
        raise ValueError(f"bilstm_layer kernel takes H a multiple of 128, in>=1, T>=1; got x "
                         f"{tuple(x.shape)}, w_hh {tuple(w_hh.shape)}")
    gdim = 4 * hid
    build.check("x", x, (rows, steps, n_in))
    build.check("w_ih", w_ih, (2, n_in, gdim))
    build.check("w_hh", w_hh, (2, hid, gdim))
    if gate_bias is not None:
        build.check("gate_bias", gate_bias, (2, gdim))
    build.check_aligned(w_ih=w_ih, w_hh=w_hh, gate_bias=gate_bias)
    n = scratch_rows(rows, steps, hid)
    (wt,), xpad = proj_scratch(x, n_in, hid, n * steps)
    xp = torch.empty(2, n, steps, gdim, device=x.device, dtype=torch.float32)
    out = torch.empty(rows, steps, 2 * hid, device=x.device, dtype=torch.float32)
    build.launch("bilstm_layer", (x, w_ih, w_hh, gate_bias, wt, xpad, xp, out),
                 (rows, steps, n_in, hid, chunk_rows(steps, hid)), x.device)
    LAUNCHES[hid] += 1
    note_launch("bilstm_layer", cost(rows, steps, n_in, hid, gate_bias is not None))
    return out


def projection(x, w_ih, gate_bias):
    """The input projection alone, as the layer kernels run it: (rows, T, in)
    → (2, rows, T, 4H). The kernel for CUDA tensors (no launch counter: no
    path calls it, the tests and ``chip_smoke.py`` hold it to
    ``projection_tiled``), ``projection_tiled`` for CPU tensors."""
    if x.device.type == "cpu":
        return projection_tiled(x, w_ih, gate_bias)
    rows, steps, n_in = x.shape
    gdim = w_ih.shape[-1]
    if gdim % 4 or not takes(gdim // 4, n_in):
        raise ValueError(f"projection takes 4H with H a multiple of 128; got w_ih "
                         f"{tuple(w_ih.shape)}")
    build.check("x", x, (rows, steps, n_in))
    build.check("w_ih", w_ih, (2, n_in, gdim))
    if gate_bias is not None:
        build.check("gate_bias", gate_bias, (2, gdim))
    build.check_aligned(w_ih=w_ih, gate_bias=gate_bias)
    (wt,), xpad = proj_scratch(x, n_in, gdim // 4, rows * steps)
    xp = torch.empty(2, rows, steps, gdim, device=x.device, dtype=torch.float32)
    build.launch("bilstm_layer", (x, w_ih, gate_bias, wt, xpad, xp),
                 (rows * steps, n_in, gdim // 4), x.device, entry="bilstm_layer_projection")
    return xp


def proj_tiling(device) -> dict:
    """The input projection as built: its k depth of a stage (checked against
    ``PROJ_K``) and how many of its blocks ``device`` holds at once."""
    k, blocks = build.query_ints("bilstm_layer", "bilstm_layer_proj_tiling", 2, device)
    if k != PROJ_K:
        raise RuntimeError(f"bilstm_layer.cuh's projection stages {k} k; PROJ_K says {PROJ_K}")
    return {"k_tile": k, "resident_blocks": blocks}
