"""The biLSTM training core (``csrc/bilstm_core.cu``): forward and backward
recurrences as CUDA kernels behind one ``torch.autograd.Function``, and the
plain version.

Counterpart of ``sdfa_tpu/ops/pallas_bilstm_train.py``: ``bilstm_core(xp,
w_hh)`` takes the time-ordered input projections (+ bias) of both directions
xp (2, T, rows, 4H) and w_hh (2, H, 4H), gate order i, f, g, o, and returns
(T, rows, 2H) — forward h in ``[..., :H]``, reverse h in ``[..., H:]``.

The forward kernel saves the post-activation gates (2, T, rows, 4H) and the
cell states (2, T, rows, H); the backward kernel walks each direction's
steps in reverse, carries dh and dc, and emits d(xp). Both residuals are
indexed by time (not by the direction's step number, as the Pallas kernel
has them): direction 1's previous step is t + 1. As in the JAX package,
``dw_hh[d] = h_prev[d]ᵀ · dg[d]`` is a library product outside the kernel,
and the input projection with its gradients belongs to the caller.

On a card at ``HIDDENS`` (128 and 256) both passes keep w_hh in the shared
memory of a thread-block cluster: H / 32 blocks own a tile of
``ROW_TILE[H]`` rows of one direction, block s the four gates of hidden
units 32s … 32s+31, the same slice in both passes (no transposed copy of
w_hh is made). The forward is the step loop of ``csrc/bilstm_layer.cuh``
indexed by time; the backward multiplies a block's own d_pre columns by its
slice, hands every block the partial sums of that block's units, and adds
them in block order. From H = 384 on (any multiple of 128) both passes run
the wide step loop of the same header: w_hh streamed through L2, the step's
product in 3xTF32 on the tensor cores, one grid-wide barrier a step; the
backward reads the previous step's d_pre of all 4H columns back from d(xp)
and multiplies it by w_hh's rows of its ``WIDE_UNITS`` units.
What is not CUDA — which columns a block owns, in how many interleaved
parts a product is summed, the order of the partial sums, the waves — lives
here too: ``forward_steps_tiled`` and ``backward_steps_tiled`` walk the same
tiling in plain tensors so that the CPU tests reach it; nothing on a path
calls them.
"""

from __future__ import annotations

import collections

import torch
from torch.autograd.function import once_differentiable

from . import build, launch_counters, note_launch
from .bilstm_layer import (UNITS_PER_BLOCK, WIDE_K, WIDE_ROW_TILE, WIDE_UNITS, block_columns,
                           lstm_dir, wide_run_columns, wide_steps_tiled, wide_wave_rows)
from .tf32 import tiled_product

FWD_LAUNCHES = 0  # forward-kernel launches in this process
BWD_LAUNCHES = 0  # backward-kernel launches in this process
LAUNCHES_BY_HIDDEN = collections.Counter()  # both, by ("fwd" | "bwd", hidden width)
launch_counters(__name__, "FWD_LAUNCHES", "BWD_LAUNCHES", "LAUNCHES_BY_HIDDEN")

HIDDENS = (128, 256)            # the widths of the cluster step; the wide step loop takes the rest
ROW_TILE = {128: 32, 256: 16}   # rows a cluster owns, walked as two sub-tiles that take turns


def takes(hidden: int) -> bool:
    """Whether the CUDA kernels take a recurrence of ``hidden`` units per
    direction: any multiple of 128, what the JAX gate sends to its Pallas
    kernel (``sdfa_tpu/nn/recurrent.py:302-304``)."""
    return hidden > 0 and hidden % 128 == 0


def cost(steps: int, rows: int, hidden: int):
    """(flops, bytes) of one launch of the forward or of the backward kernel,
    the same for both: h · w_hh (d_pre · w_hhᵀ) at every step of both
    directions, 2 T rows 2H 4H FLOP; the forward reads xp and w_hh and writes
    out, the gates and c, the backward reads the gates, c, w_hh and d(out) and
    writes d(xp), as many bytes."""
    gdim = 4 * hidden
    flops = 2.0 * steps * rows * 2 * hidden * gdim
    xp = gates = 2 * steps * rows * gdim
    out, cs, w = steps * rows * 2 * hidden, 2 * steps * rows * hidden, 2 * hidden * gdim
    return flops, 4.0 * (gates + cs + w + out + xp)


def bilstm_core_plain(xp, w_hh):
    """Plain PyTorch version: a Python scan per direction, differentiated
    by autograd (``bilstm_core_reference`` in the JAX package)."""
    return torch.cat([lstm_dir(xp[d].transpose(0, 1), w_hh[d], reverse=bool(d)).transpose(0, 1)
                      for d in range(2)], dim=-1)


def forward_steps(xp, w_hh):
    """The forward kernel's step, in plain tensors: → (out (T, rows, 2H),
    gates (2, T, rows, 4H) post-activation, c (2, T, rows, H))."""
    _, steps, rows, gdim = xp.shape
    hid = gdim // 4
    out = xp.new_empty(steps, rows, 2 * hid)
    gates = torch.empty_like(xp)
    cs = xp.new_empty(2, steps, rows, hid)
    for d in range(2):
        h = xp.new_zeros(rows, hid)
        c = torch.zeros_like(h)
        for step in range(steps):
            t = step if d == 0 else steps - 1 - step
            pre = xp[d, t] + h @ w_hh[d]
            i, f, o = (torch.sigmoid(pre[:, q * hid:(q + 1) * hid]) for q in (0, 1, 3))
            g = torch.tanh(pre[:, 2 * hid:3 * hid])
            c = f * c + i * g
            h = o * torch.tanh(c)
            gates[d, t] = torch.cat([i, f, g, o], dim=-1)
            cs[d, t] = c
            out[t, :, d * hid:(d + 1) * hid] = h
    return out, gates, cs


def _d_pre(i, f, g, o, c, c_prev, dh_tot, dc):
    """The cell's backward at one step: → (d_pre of the gates i, f, g, o,
    stacked on a new last axis, and dc handed to the previous step)."""
    tc = torch.tanh(c)
    dcv = dc + dh_tot * o * (1.0 - tc * tc)
    d_pre = torch.stack([dcv * g * i * (1.0 - i), dcv * c_prev * f * (1.0 - f),
                         dcv * i * (1.0 - g * g), dh_tot * tc * o * (1.0 - o)], dim=-1)
    return d_pre, dcv * f


def backward_steps(gates, cs, w_hh, dout):
    """The backward kernel's step, in plain tensors: BPTT over both
    directions → dg (2, T, rows, 4H) = d(xp)."""
    _, steps, rows, gdim = gates.shape
    hid = gdim // 4
    dg = torch.empty_like(gates)
    for d in range(2):
        dh = gates.new_zeros(rows, hid)
        dc = torch.zeros_like(dh)
        for step in range(steps - 1, -1, -1):
            t = step if d == 0 else steps - 1 - step
            t_prev = t - 1 if d == 0 else t + 1
            i, f, g, o = gates[d, t].chunk(4, dim=-1)
            c_prev = cs[d, t_prev] if step > 0 else torch.zeros_like(dc)
            d_pre, dc = _d_pre(i, f, g, o, cs[d, t], c_prev,
                               dout[t, :, d * hid:(d + 1) * hid] + dh, dc)
            d_pre = d_pre.transpose(1, 2).reshape(rows, gdim)  # gate-major, as xp has it
            dg[d, t] = d_pre
            dh = d_pre @ w_hh[d].T
    return dg


def cluster_blocks(hid: int) -> int:
    """Blocks of a cluster at ``hid`` hidden units: each owns 32 of them."""
    return hid // UNITS_PER_BLOCK


def column_parts(hid: int) -> int:
    """In how many interleaved parts of its 32 units a lane of the backward
    product sums a block's 128 (unit, gate) columns: a warp holds a quarter
    of the H outputs, H / 16 side by side, the parts on the lanes left over."""
    return 32 // (hid // 16)


def sum_partials(partials, order=None):
    """The blocks' partial sums added one after the other in block order (or
    in ``order``, for the tests): a fixed order, so results repeat bit for bit."""
    order = range(len(partials)) if order is None else order
    total = None
    for b in order:
        total = partials[b].clone() if total is None else total + partials[b]
    return total


def forward_steps_tiled(xp, w_hh, capacity=None):
    """``forward_steps``' function computed the forward kernel's way: per
    (sub-tile of rows, direction) a step loop in which each block of the
    cluster multiplies the full h by its own column slice (k in four
    interleaved quarters, summed pairwise as the warp exchanges do), applies
    the cell to its 32 units, writes their gates and c at their TIME index
    and hands its h slice to the buffer the next step reads. From H = 384 on,
    ``wide_steps_tiled`` with the gates and c saved (``capacity``: its
    resident blocks)."""
    _, steps, rows, gdim = xp.shape
    hid = gdim // 4
    out = xp.new_empty(steps, rows, 2 * hid)
    gates = torch.empty_like(xp)
    cs = xp.new_empty(2, steps, rows, hid)
    if hid not in HIDDENS:
        wide_steps_tiled(xp, w_hh, out, capacity, gates, cs)
        return out, gates, cs
    per, blocks, sub = UNITS_PER_BLOCK, cluster_blocks(hid), ROW_TILE[hid] // 2
    cols = [block_columns(b, hid) for b in range(blocks)]
    for row0 in range(0, rows, sub):  # a tile's sub-tiles are independent rows
        rs = slice(row0, min(row0 + sub, rows))  # the kernel computes the other rows on zeros
        n = rs.stop - rs.start
        for d in range(2):
            w_blocks = [w_hh[d][:, c] for c in cols]  # each block's resident slice
            h = [xp.new_zeros(n, hid), xp.new_empty(n, hid)]  # double-buffered
            c_state = xp.new_zeros(n, hid)
            for step in range(steps):
                t = step if d == 0 else steps - 1 - step
                cur, nxt = step % 2, 1 - step % 2
                for b in range(blocks):
                    own = slice(b * per, (b + 1) * per)
                    part = [h[cur][:, q::4] @ w_blocks[b][q::4] for q in range(4)]
                    pre = ((part[0] + part[2]) + (part[1] + part[3])
                           + xp[d, t, rs][:, cols[b]]).reshape(n, per, 4)
                    i, f, o = (torch.sigmoid(pre[..., q]) for q in (0, 1, 3))
                    g = torch.tanh(pre[..., 2])
                    c_state[:, own] = f * c_state[:, own] + i * g
                    h[nxt][:, own] = o * torch.tanh(c_state[:, own])
                    gates[d, t, rs][:, cols[b]] = torch.stack([i, f, g, o], dim=-1).reshape(n, -1)
                cs[d, t, rs] = c_state
                out[t, rs, d * hid:(d + 1) * hid] = h[nxt]
    return out, gates, cs


def wide_backward_steps_tiled(gates, cs, w_hh, dout, capacity=None):
    """The wide loop's backward in plain tensors: per wave of rows (see
    ``wide_steps_tiled``) and step, last to first, each block — a direction,
    a row tile of ``WIDE_ROW_TILE``, a run of ``WIDE_UNITS`` units — computes
    dh of its units as the previous step's d_pre of all 4H columns, read back
    from dg, times w_hh's rows of its units, in 3xTF32 (``tiled_product``,
    k tiles of ``WIDE_K`` over K = 4H, each tile's sum added to the total in
    f32 from k = 0 on), adds d(out), and turns it, dc and the residuals into
    d_pre, written to dg at its time index."""
    _, steps, rows, gdim = gates.shape
    hid = gdim // 4
    wave = rows if capacity is None else wide_wave_rows(hid, capacity)
    if wave <= 0:
        raise ValueError(f"no row tile of the wide loop at H={hid} fits {capacity} blocks")
    runs = wide_run_columns(hid)
    dg = torch.empty_like(gates)
    for r0 in range(0, rows, wave):  # one cooperative launch
        r1 = min(r0 + wave, rows)
        dc = gates.new_zeros(2, rows, hid)
        for step in range(steps - 1, -1, -1):  # a grid-wide barrier between steps
            for d in range(2):
                t = step if d == 0 else steps - 1 - step
                tn = t + 1 if d == 0 else t - 1  # the step processed before this one
                tp = t - 1 if d == 0 else t + 1  # the direction's previous step
                for t0 in range(r0, r1, WIDE_ROW_TILE):
                    rs = slice(t0, min(t0 + WIDE_ROW_TILE, r1))
                    n = rs.stop - rs.start
                    for x0, cols in zip(range(0, hid, WIDE_UNITS), runs):
                        units = slice(x0, x0 + WIDE_UNITS)
                        if step < steps - 1:
                            dh = tiled_product(dg[d, tn, rs], w_hh[d, units].T, WIDE_K)
                        else:
                            dh = gates.new_zeros(n, WIDE_UNITS)
                        i, f, g, o = gates[d, t, rs][:, cols].reshape(n, 4, WIDE_UNITS).unbind(1)
                        c_prev = cs[d, tp, rs, units] if step > 0 else torch.zeros_like(i)
                        d_pre, dc[d, rs, units] = _d_pre(
                            i, f, g, o, cs[d, t, rs, units], c_prev,
                            dout[t, rs, d * hid + x0:d * hid + x0 + WIDE_UNITS] + dh,
                            dc[d, rs, units])
                        dg[d, t, rs][:, cols] = d_pre.transpose(1, 2).reshape(n, -1)
    return dg


def backward_steps_tiled(gates, cs, w_hh, dout, block_order=None, capacity=None):
    """``backward_steps``' function computed the backward kernel's way: per
    (sub-tile of rows, direction) and step, each block of the cluster turns
    dh, dc and the residuals of its 32 units into d_pre (written to dg at
    its time index), multiplies that slice, [unit][gate], by the SAME column
    slice of w_hh the forward holds, contracting over its own columns in
    ``column_parts`` interleaved parts of its units, which gives partial sums
    for all H units; every block then adds the partial sums of its units in
    block order. The last step's dh is used by nothing and not computed. From
    H = 384 on, ``wide_backward_steps_tiled``."""
    _, steps, rows, gdim = gates.shape
    hid = gdim // 4
    if hid not in HIDDENS:
        return wide_backward_steps_tiled(gates, cs, w_hh, dout, capacity)
    per, blocks, sub = UNITS_PER_BLOCK, cluster_blocks(hid), ROW_TILE[hid] // 2
    parts = column_parts(hid)
    cols = [block_columns(b, hid) for b in range(blocks)]
    dg = torch.empty_like(gates)
    for row0 in range(0, rows, sub):
        rs = slice(row0, min(row0 + sub, rows))
        n = rs.stop - rs.start
        for d in range(2):
            w_blocks = [w_hh[d][:, c].reshape(hid, per, 4) for c in cols]  # [k][unit][gate]
            dh, dc = gates.new_zeros(n, hid), gates.new_zeros(n, hid)
            for step in range(steps - 1, -1, -1):
                t = step if d == 0 else steps - 1 - step
                t_prev = t - 1 if d == 0 else t + 1
                partials = []
                for b in range(blocks):
                    own = slice(b * per, (b + 1) * per)
                    i, f, g, o = gates[d, t, rs][:, cols[b]].reshape(n, per, 4).unbind(-1)
                    c_prev = cs[d, t_prev, rs, own] if step > 0 else torch.zeros_like(i)
                    d_pre, dc[:, own] = _d_pre(
                        i, f, g, o, cs[d, t, rs, own], c_prev,
                        dout[t, rs, d * hid + own.start:d * hid + own.stop] + dh[:, own],
                        dc[:, own])
                    dg[d, t, rs][:, cols[b]] = d_pre.reshape(n, -1)
                    if step > 0:
                        part = [torch.einsum("nuq,kuq->nk", d_pre[:, p::parts],
                                             w_blocks[b][:, p::parts]) for p in range(parts)]
                        partials.append(part[0] + part[1] if parts == 2
                                        else (part[0] + part[2]) + (part[1] + part[3]))
                if step > 0:
                    dh = sum_partials(partials, block_order)
    return dg


def max_active_clusters(device) -> dict:
    """How many clusters of each kernel ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters`` for the launches the wrappers make):
    {(H, "fwd" | "bwd"): clusters}. Also checks that the row tiles the
    kernels were built with are ``ROW_TILE`` (and ``WIDE_ROW_TILE`` from H =
    384 on)."""
    lib = build.load_library("bilstm_core")
    for hid, tile in (*ROW_TILE.items(), (384, WIDE_ROW_TILE)):
        if lib.sdfa_bilstm_core_row_tile(hid) != tile:
            raise RuntimeError(f"bilstm_core.cu owns {lib.sdfa_bilstm_core_row_tile(hid)} rows a "
                               f"cluster at H={hid}, this module says {tile}")
    counts = build.query_ints("bilstm_core", "bilstm_core_clusters", 4, device)
    return dict(zip(((128, "fwd"), (128, "bwd"), (256, "fwd"), (256, "bwd")), counts))


def wide_resident_blocks(device) -> dict:
    """How many blocks of the wide loop's forward and backward kernels
    ``device`` holds at once: {"fwd": blocks, "bwd": blocks}."""
    return dict(zip(("fwd", "bwd"), build.query_ints("bilstm_core", "bilstm_core_wide_blocks",
                                                     2, device)))


def _core_dims(xp):
    _, steps, rows, gdim = xp.shape
    hid = gdim // 4
    if not takes(hid):
        raise ValueError(f"bilstm_core kernels take H a multiple of 128; got {tuple(xp.shape)}")
    return steps, rows, hid


def _forward_kernel(xp, w_hh):
    steps, rows, hid = _core_dims(xp)
    build.check("xp", xp, (2, steps, rows, 4 * hid))
    build.check("w_hh", w_hh, (2, hid, 4 * hid))
    build.check_aligned(xp=xp, w_hh=w_hh)
    out = torch.empty(steps, rows, 2 * hid, device=xp.device, dtype=torch.float32)
    gates = torch.empty_like(xp)
    cs = torch.empty(2, steps, rows, hid, device=xp.device, dtype=torch.float32)
    build.launch("bilstm_core", (xp, w_hh, out, gates, cs), (steps, rows, hid), xp.device,
                 entry="bilstm_core_fwd")
    global FWD_LAUNCHES
    FWD_LAUNCHES += 1
    LAUNCHES_BY_HIDDEN["fwd", hid] += 1
    note_launch("bilstm_core_fwd", cost(steps, rows, hid))
    return out, gates, cs


def _backward_kernel(gates, cs, w_hh, dout):
    steps, rows, hid = _core_dims(gates)
    build.check("gates", gates, (2, steps, rows, 4 * hid))
    build.check("w_hh", w_hh, (2, hid, 4 * hid))
    build.check("c", cs, (2, steps, rows, hid))
    build.check("dout", dout, (steps, rows, 2 * hid))
    build.check_aligned(gates=gates, c=cs, w_hh=w_hh, dout=dout)
    dg = torch.empty_like(gates)
    build.launch("bilstm_core", (gates, cs, w_hh, dout, dg), (steps, rows, hid), gates.device,
                 entry="bilstm_core_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    LAUNCHES_BY_HIDDEN["bwd", hid] += 1
    note_launch("bilstm_core_bwd", cost(steps, rows, hid))
    return dg


def dw_hh(out, dg):
    """dw_hh[d] = Σ_{t, row} h_prev[d]ᵀ · dg[d], with h_prev the output one
    step earlier in the direction's sense: time t − 1 for the forward
    direction, t + 1 for the reverse (zero at the direction's first step)."""
    hid = out.shape[-1] // 2
    return torch.stack([
        torch.einsum("trh,trg->hg", out[:-1, :, :hid], dg[0, 1:]),
        torch.einsum("trh,trg->hg", out[1:, :, hid:], dg[1, :-1])])


class BilstmCore(torch.autograd.Function):
    """out = core(xp, w_hh) with the hand-written backward. CUDA tensors go
    through the kernels; CPU tensors through the kernels' plain-tensor
    transcriptions, which is how the CPU tests reach the backward formula."""

    @staticmethod
    def forward(ctx, xp, w_hh):
        on_cpu = xp.device.type == "cpu"
        out, gates, cs = (forward_steps if on_cpu else _forward_kernel)(xp, w_hh)
        ctx.save_for_backward(gates, cs, out, w_hh)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        gates, cs, out, w_hh = ctx.saved_tensors
        on_cpu = gates.device.type == "cpu"
        dout = dout.contiguous()
        if dout.data_ptr() % 16:  # a view that starts off the kernels' 16-byte reads
            dout = dout.clone()
        dg = (backward_steps if on_cpu else _backward_kernel)(gates, cs, w_hh, dout)
        return (dg if ctx.needs_input_grad[0] else None,
                dw_hh(out, dg) if ctx.needs_input_grad[1] else None)


def bilstm_core(xp, w_hh):
    """Differentiable biLSTM recurrent core: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors; any other input raises."""
    if xp.device.type == "cpu":
        return bilstm_core_plain(xp, w_hh)
    return BilstmCore.apply(xp, w_hh)
