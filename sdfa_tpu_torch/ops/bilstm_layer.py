"""Per-layer biLSTM kernel (``csrc/bilstm_layer.cu``) and its plain version.

Counterpart of ``sdfa_tpu/ops/pallas_bilstm.py``: ``bilstm_layer`` takes
the arguments of ``bilstm_layer_fused`` — x (rows, T, in), w_ih
(2, in, 4H), w_hh (2, H, 4H), gate bias (2, 4H) or None; direction 0
forward, 1 reverse; gate order i, f, g, o — and returns (rows, T, 2H)
float32, forward h in ``[..., :H]`` and reverse h in ``[..., H:]``.

On a card the layer is two hand-written kernels per row chunk
(``csrc/bilstm_layer.cuh``): a tiled product computes the input projection
xp = x·w_ih (+ bias) for all steps at once into a scratch tensor, then the
step loop runs with w_hh held in the shared memory of a cluster of H / 32
blocks (8 at H = 256, 4 at H = 128): block s of a cluster owns hidden units
32s … 32s+31 of one direction for a tile of 32 rows. The kernels take
``HIDDENS`` and inputs up to ``MAX_IN`` wide (``takes``); the modules pick
another route for any other shape before they call this wrapper
(``nn/recurrent.py::bilstm_routes``). What
is not CUDA — the row chunks, the scratch size, which gate columns a block
owns — lives here, and ``bilstm_layer_tiled`` walks the same tiling in plain
tensors so that the CPU tests reach it.
"""

from __future__ import annotations

import collections

import torch

from . import build, note_launch

LAUNCHES = collections.Counter()  # kernel launches by ``bilstm_layer`` in this process, by hidden width

HIDDENS, MAX_IN = (128, 256), 512  # what the CUDA kernels take
UNITS_PER_BLOCK = 32       # hidden units a block of a cluster owns, whatever the width
ROW_TILE = 32              # rows per cluster, walked as two sub-tiles that take turns
SUB_TILE = ROW_TILE // 2
# Rows are walked in chunks of at most ``row_steps(H)`` (row, step) pairs (one
# row where T alone is more), so the scratch does not grow with the batch: xp
# holds 2 · 4H floats per pair, 128 MiB at either width; the 2-layer kernel's
# stack another 2H floats per pair, 32 MiB. SCRATCH_ROW_STEPS is the count at
# H = 256; at H = 128 a pair is half the bytes and a chunk twice the pairs.
SCRATCH_ROW_STEPS = 16384


def takes(hidden: int, n_in: int) -> bool:
    """Whether the CUDA kernels take a layer of ``hidden`` units per direction
    over ``n_in`` input features (the 2-layer kernel: both its layers)."""
    return hidden in HIDDENS and 1 <= n_in <= MAX_IN


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
    at either width."""
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


def layer_tiled_chunk(x, w_ih, w_hh, gate_bias):
    """One chunk of rows the way the kernels walk it, in plain tensors: the
    projection for all steps first, then per (row tile, direction) the step
    loop over the tile's two sub-tiles, in which each of the cluster's blocks
    multiplies the full h by its own column slice (k in four interleaved
    quarters, summed pairwise as the warp exchanges do), applies the cell to
    its units and hands its h slice to the buffer the next step reads."""
    rows, steps, _ = x.shape
    hid = w_hh.shape[1]
    per = UNITS_PER_BLOCK
    blocks = cluster_blocks(hid)  # 8 at H = 256, 4 at H = 128
    cols = [block_columns(b, hid) for b in range(blocks)]
    xp = torch.stack([x @ w_ih[d] if gate_bias is None else x @ w_ih[d] + gate_bias[d]
                      for d in range(2)])  # (2, rows, T, 4H)
    out = x.new_empty(rows, steps, 2 * hid)
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


def bilstm_layer_tiled(x, w_ih, w_hh, gate_bias):
    """``bilstm_layer_plain``'s function computed the kernel's way: row
    chunks of ``chunk_rows(T, H)``, each through ``layer_tiled_chunk``."""
    chunk = chunk_rows(x.shape[1], w_hh.shape[1])
    return torch.cat([layer_tiled_chunk(x[r:r + chunk], w_ih, w_hh, gate_bias)
                      for r in range(0, x.shape[0], chunk)])


def max_active_clusters(device) -> dict:
    """How many clusters of the step kernel ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters`` for the launches the wrapper makes),
    by hidden width: {128: clusters, 256: clusters}."""
    return dict(zip(HIDDENS, build.query_ints("bilstm_layer", "bilstm_layer_clusters", 2,
                                              device)))


def bilstm_layer(x, w_ih, w_hh, gate_bias):
    """One biLSTM layer: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors; any other input, or a shape the kernels do not
    take, raises."""
    if x.device.type == "cpu":
        return bilstm_layer_plain(x, w_ih, w_hh, gate_bias)
    rows, steps, n_in = x.shape
    hid = w_hh.shape[1]
    if not takes(hid, n_in) or steps < 1:
        raise ValueError(f"bilstm_layer kernel takes H in {HIDDENS}, in<={MAX_IN}, T>=1; got x "
                         f"{tuple(x.shape)}, w_hh {tuple(w_hh.shape)}")
    gdim = 4 * hid
    build.check("x", x, (rows, steps, n_in))
    build.check("w_ih", w_ih, (2, n_in, gdim))
    build.check("w_hh", w_hh, (2, hid, gdim))
    if gate_bias is not None:
        build.check("gate_bias", gate_bias, (2, gdim))
    xp = torch.empty(2, scratch_rows(rows, steps, hid), steps, gdim, device=x.device,
                     dtype=torch.float32)
    out = torch.empty(rows, steps, 2 * hid, device=x.device, dtype=torch.float32)
    build.launch("bilstm_layer", (x, w_ih, w_hh, gate_bias, xp, out),
                 (rows, steps, n_in, hid, chunk_rows(steps, hid)), x.device)
    LAUNCHES[hid] += 1
    note_launch("bilstm_layer", cost(rows, steps, n_in, hid, gate_bias is not None))
    return out
