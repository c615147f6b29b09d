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
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import build
from .bilstm_layer import lstm_dir

FWD_LAUNCHES = 0  # forward-kernel launches in this process
BWD_LAUNCHES = 0  # backward-kernel launches in this process

HIDDENS = (128, 256)  # what the CUDA kernels take


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


def backward_steps(gates, cs, w_hht, dout):
    """The backward kernel's step, in plain tensors: BPTT over both
    directions → dg (2, T, rows, 4H) = d(xp). ``w_hht`` is (2, 4H, H)."""
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
            tc = torch.tanh(cs[d, t])
            dh_tot = dout[t, :, d * hid:(d + 1) * hid] + dh
            dcv = dc + dh_tot * o * (1.0 - tc * tc)
            d_pre = torch.cat([dcv * g * i * (1.0 - i), dcv * c_prev * f * (1.0 - f),
                               dcv * i * (1.0 - g * g), dh_tot * tc * o * (1.0 - o)], dim=-1)
            dg[d, t] = d_pre
            dh = d_pre @ w_hht[d]
            dc = dcv * f
    return dg


def _core_dims(xp):
    _, steps, rows, gdim = xp.shape
    hid = gdim // 4
    if hid not in HIDDENS:
        raise ValueError(f"bilstm_core kernels take H in {HIDDENS}; got {tuple(xp.shape)}")
    return steps, rows, hid


def _forward_kernel(xp, w_hh):
    steps, rows, hid = _core_dims(xp)
    build.check("xp", xp, (2, steps, rows, 4 * hid))
    build.check("w_hh", w_hh, (2, hid, 4 * hid))
    out = torch.empty(steps, rows, 2 * hid, device=xp.device, dtype=torch.float32)
    gates = torch.empty_like(xp)
    cs = torch.empty(2, steps, rows, hid, device=xp.device, dtype=torch.float32)
    build.launch("bilstm_core", (xp, w_hh, out, gates, cs), (steps, rows, hid), xp.device,
                 entry="bilstm_core_fwd")
    global FWD_LAUNCHES
    FWD_LAUNCHES += 1
    return out, gates, cs


def _backward_kernel(gates, cs, w_hht, dout):
    steps, rows, hid = _core_dims(gates)
    build.check("gates", gates, (2, steps, rows, 4 * hid))
    build.check("w_hht", w_hht, (2, 4 * hid, hid))
    build.check("c", cs, (2, steps, rows, hid))
    build.check("dout", dout, (steps, rows, 2 * hid))
    dg = torch.empty_like(gates)
    build.launch("bilstm_core", (gates, cs, w_hht, dout, dg), (steps, rows, hid), gates.device,
                 entry="bilstm_core_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
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
        dg = (backward_steps if on_cpu else _backward_kernel)(
            gates, cs, w_hh.transpose(1, 2).contiguous(), dout.contiguous())
        return (dg if ctx.needs_input_grad[0] else None,
                dw_hh(out, dg) if ctx.needs_input_grad[1] else None)


def bilstm_core(xp, w_hh):
    """Differentiable biLSTM recurrent core: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors; any other input raises."""
    if xp.device.type == "cpu":
        return bilstm_core_plain(xp, w_hh)
    return BilstmCore.apply(xp, w_hh)
