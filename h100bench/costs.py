"""The yardstick's arithmetic: peaks of the card and the work of each kernel
group, from shapes alone.

The formulas are frozen copies of ``sdfa_tpu_torch/ops/{freq_lstm,bilstm_layer,
bilstm2,bilstm_core,decode_solve}.py::cost`` at commit
cd76b759f00e984f3c2c328d391715c072553d14, with two changes: K3 is counted at
the mesh's own triangle and free-vertex counts (no padding), and every float32
product is counted once, whatever split the kernel runs it in. All shares are
taken against the dense TF32 peak, which no float32-accurate split can beat,
so no share can pass 100% when a later change moves the split.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM, dense rates, at its 700 W limit
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)


def lstm_layer(rows: int, steps: int, n_in: int, hidden: int, gate_bias: bool = True):
    """One biLSTM layer launch: 2 rows T 2 (in + H) 4H FLOP; every input read
    once, the output written once."""
    gdim = 4 * hidden
    flops = 2.0 * rows * steps * 2 * (n_in + hidden) * gdim
    floats = (rows * steps * n_in + 2 * n_in * gdim + 2 * hidden * gdim + 2 * gdim * gate_bias
              + rows * steps * 2 * hidden)
    return flops, 4.0 * floats


def bilstm2(rows: int, steps: int, n_in: int, hidden: int, gate_bias: bool = True):
    """The 2-layer launch (K2): both layers, layer 1's output stack not counted."""
    f1, b1 = lstm_layer(rows, steps, n_in, hidden, gate_bias)
    f2, b2 = lstm_layer(rows, steps, 2 * hidden, hidden, gate_bias)
    stack = 4.0 * rows * steps * 2 * hidden
    return f1 + f2, b1 + b2 - 2 * stack


def freq_lstm(rows: int, n_freq: int, n_in: int, hidden: int, out: int, gate_bias: bool = True,
              b_proj: bool = True):
    """K1: both directions over F steps and the output projection,
    2 rows F (2 (in + H) 4H + 2H out) FLOP."""
    gdim, k = 4 * hidden, n_freq * 2 * hidden
    flops = 2.0 * rows * (n_freq * 2 * (n_in + hidden) * gdim + k * out)
    floats = (rows * n_freq * n_in + 2 * n_in * gdim + 2 * hidden * gdim + 2 * gdim * gate_bias
              + k * out + out * b_proj + rows * out)
    return flops, 4.0 * floats


def bilstm_core(steps: int, rows: int, hidden: int):
    """K5, one forward or one backward launch: 2 T rows 2H 4H FLOP."""
    gdim = 4 * hidden
    flops = 2.0 * steps * rows * 2 * hidden * gdim
    xp = gates = 2 * steps * rows * gdim
    out, cs, w = steps * rows * 2 * hidden, 2 * steps * rows * hidden, 2 * hidden * gdim
    return flops, 4.0 * (gates + cs + w + out + xp)


def decode_solve(windows: int, ks: int, kr: int, tris: int, nf: int):
    """K3's delta body: the decode 2 W (6 Ks + 3 Kr) T and the product
    2 W 9 T NF, each once; the bases, means, template transforms, x0 and the
    operator read once, the vertices written once."""
    flops = 2.0 * windows * (6 * ks + 3 * kr) * tris + 2.0 * windows * 9 * tris * nf
    floats = (windows * (ks + kr) + (ks + 1) * 6 * tris + (kr + 1) * 3 * tris + nf * 3 * tris
              + 9 * tris + 3 * nf + windows * 3 * nf)
    return flops, 4.0 * floats
