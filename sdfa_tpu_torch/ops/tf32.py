"""TF32 rounding in plain tensors: the operands the tensor cores see.

The kernels that multiply on Hopper's tensor cores in TF32 (K3's products in
``csrc/decode_solve.cu``, the recurrent kernels' input projection in
``csrc/bilstm_layer.cuh``, FreqLstm's output projection in
``csrc/freq_lstm.cu``) round each float32 operand to nearest first; the
tensor cores would truncate it. 3xTF32 keeps float32 grade from two TF32
parts of each value. ``round_tf32`` and ``split_tf32`` repeat that rounding
for the plain versions, the constant builds and the CPU tests;
``tiled_product`` is the two projections' 3xTF32 product, k tile by k tile.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits) to nearest, ties to
    even, in integer arithmetic on the bits; the result is float32 with the
    13 low bits zero. (The kernels round ties away from zero, ``cvt.rna``:
    the two differ on exact ties only.)"""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """float32 x as two TF32 values (hi, lo): hi = x rounded, lo = x − hi
    rounded (x − hi is exact in float32). hi + lo keeps 22 of x's 24
    mantissa bits, and hi·hi + hi·lo + lo·hi misses a product by lo·lo."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def tiled_product(a: torch.Tensor, b: torch.Tensor, k_tile: int) -> torch.Tensor:
    """a (..., K) · b (..., K, N) the way the projections' kernels compute it
    on the tensor cores: both split into TF32 parts (``split_tf32``), then per
    k tile of ``k_tile`` (the last one partial) the three products a_hi·b_hi,
    a_hi·b_lo, a_lo·b_hi added to one sum, tile after tile from k = 0 on."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    total = None
    for k0 in range(0, a.shape[-1], k_tile):
        ks = slice(k0, k0 + k_tile)
        term = (a_hi[..., ks] @ b_hi[..., ks, :] + a_hi[..., ks] @ b_lo[..., ks, :]
                + a_lo[..., ks] @ b_hi[..., ks, :])
        total = term if total is None else total + term
    return total
