"""Fused PCA decode + delta-form deformation solve (``csrc/decode_solve.cu``)
and its plain version.

Counterpart of ``sdfa_tpu/ops/pallas_decode_solve.py`` (delta mode): from
the heads' raw PCA coefficients, decode the 9 k-major planes per triangle,
build T = exp(skew(r))·S, and solve onto the free vertices as
x = x0 + (T − T0)·P. ``prep_consts`` builds the constants once per
template on the host: k-major bases, T0 (the transform entries of the PCA
means), x0 (T0's solve, in float64) and P twice: ``p`` in float32 for the
plain version, ``p_t`` transposed, padded and rounded to TF32 for the kernel.

On a card the decode kernel writes ΔT = T − T0 rounded to TF32, and the
product ΔT·P runs on the tensor cores in TF32 with float32 sums: the delta
form exists so that a short mantissa is enough (the TPU kernel multiplies in
one bf16 pass). Both operands are rounded to nearest before the tensor cores
see them, which would truncate. What is not CUDA — ``p_t``'s layout, into
how many parts K is split so that the blocks fill the card, the order the
parts are added in — lives here; ``round_tf32`` and
``decode_solve_rounded`` repeat the kernel's rounding in plain tensors for
the CPU tests, and nothing on a path calls them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import build, using_plain
from .deform_solver import (DeformConsts, DeformationSolver, SolverSpec,
                            assemble_from_free, transform_entries_from_planes)

LAUNCHES = 0  # wrapper calls of ``decode_solve`` that launched the kernels

T_ALIGN = 128  # triangle padding: the decode kernel's block width
M_TILE, N_TILE, K_TILE = 128, 128, 32  # the product kernel's output tile and k per stage
MIN_PART_TILES = 16  # a part of K is at least this many k tiles, so that its ring fills


class DecodeSolveConsts(NamedTuple):
    """Kernel constants; T' = n_tris padded to T_ALIGN, NF = n_free.
    basis_s (Ks, 6, T'), means_s (6, T'), basis_r (Kr, 3, T'), means_r
    (3, T'), p (3, T', NF), t0 (9, T'), x0 (3, NF), p_t (NF padded to
    N_TILE, 3T'). The padded tail has zero bases, means and P rows: its T is
    the identity, as is its T0. ``p_t`` is what the kernel multiplies by: p
    viewed as (3T', NF), transposed (TF32 tensor-core products take both
    operands with K contiguous), zero rows from NF on, every value rounded to
    TF32. ``p`` stays for the plain version, so the card holds P twice: 155
    MB more at FLAME's counts."""

    basis_s: torch.Tensor
    means_s: torch.Tensor
    basis_r: torch.Tensor
    means_r: torch.Tensor
    p: torch.Tensor
    t0: torch.Tensor
    x0: torch.Tensor
    p_t: torch.Tensor


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits) to nearest, ties to
    even, in integer arithmetic on the bits; the result is float32 with the
    13 low bits zero. (The decode kernel rounds ties away from zero,
    ``cvt.rna``: the two differ on exact ties only.)"""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores make of a float32 operand that was not rounded:
    the 13 low bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def transposed_p(p: torch.Tensor) -> torch.Tensor:
    """``p_t`` of p (3, T', NF): (NF padded to N_TILE, 3T'), rounded to TF32."""
    _, tp, nf = p.shape
    p_t = p.new_zeros(-(-nf // N_TILE) * N_TILE, 3 * tp)
    p_t[:nf] = p.reshape(3 * tp, nf).T
    return round_tf32(p_t)


def prep_consts(scale_comp_t, scale_means, rotat_comp_t, rotat_means,
                solver: DeformationSolver, device) -> DecodeSolveConsts:
    """Build the kernel constants from the PCA inversions ((6T, Ks) and
    (3T, Kr) components with their means) and the solver's host operator.
    The kernel solves identity equation tables only (equation k reads
    triangle k); a correspondence table goes through ``ops.solve_fn``."""
    if not solver.spec.identity_eq:
        raise ValueError("decode_solve takes identity equation tables only; this template "
                         f"has {solver.n_eqs} correspondence equations")
    n = solver.n_tris
    tp = -(-n // T_ALIGN) * T_ALIGN

    def km(comp, means, per_tri):
        comp = torch.as_tensor(comp, dtype=torch.float32).cpu()
        means = torch.as_tensor(means, dtype=torch.float32).cpu().reshape(-1)
        b = comp.reshape(n, per_tri, -1).permute(2, 1, 0)  # (K, per_tri, T)
        b = torch.nn.functional.pad(b, (0, tp - n))
        m = torch.nn.functional.pad(means.reshape(n, per_tri).T, (0, tp - n))
        return b.contiguous(), m.contiguous()

    basis_s, means_s = km(scale_comp_t, scale_means, 6)
    basis_r, means_r = km(rotat_comp_t, rotat_means, 3)
    t = transform_entries_from_planes([means_s[k] for k in range(6)]
                                      + [means_r[k] for k in range(3)])
    t0 = torch.stack([t[i][j] for i in range(3) for j in range(3)])  # (9, T') f32
    p64 = solver.p_planes()  # (3, T, NF) f64
    t064 = t0.double().numpy()[:, :n]
    x0 = np.stack([sum(t064[3 * dd + c] @ p64[c] for c in range(3)) for dd in range(3)])
    p = np.zeros((3, tp, solver.n_free), np.float32)
    p[:, :n] = p64
    p = torch.from_numpy(p)
    to = dict(device=device, dtype=torch.float32)
    return DecodeSolveConsts(basis_s.to(**to), means_s.to(**to), basis_r.to(**to),
                             means_r.to(**to), p.to(**to), t0.to(**to),
                             torch.as_tensor(x0, **to), transposed_p(p).to(**to))


def delta_transforms(coef_s, coef_r, dsc: DecodeSolveConsts) -> torch.Tensor:
    """The decode in plain tensors: (W, Ks), (W, Kr) → ΔT = T − T0, (W, 9, T')."""
    w = coef_s.shape[0]
    tp = dsc.p.shape[1]
    d_s = (coef_s @ dsc.basis_s.reshape(dsc.basis_s.shape[0], -1)).reshape(w, 6, tp)
    d_r = (coef_r @ dsc.basis_r.reshape(dsc.basis_r.shape[0], -1)).reshape(w, 3, tp)
    d_s, d_r = d_s + dsc.means_s, d_r + dsc.means_r
    t = transform_entries_from_planes([d_s[:, k] for k in range(6)]
                                      + [d_r[:, k] for k in range(3)])
    return torch.stack([t[i][j] for i in range(3) for j in range(3)], dim=1) - dsc.t0


def decode_solve_plain(coef_s, coef_r, dsc: DecodeSolveConsts) -> torch.Tensor:
    """Plain PyTorch version: (W, Ks), (W, Kr) → (W, 3, NF)."""
    w = coef_s.shape[0]
    _, tp, nf = dsc.p.shape
    dt = delta_transforms(coef_s, coef_r, dsc)
    return (dt.reshape(3 * w, 3 * tp) @ dsc.p.reshape(3 * tp, nf)).reshape(w, 3, nf) + dsc.x0


def decode_solve_rounded(coef_s, coef_r, dsc: DecodeSolveConsts, rounding=round_tf32):
    """``decode_solve_plain`` with the product's operands as the kernel hands
    them to the tensor cores: ΔT through ``rounding`` (the kernel rounds to
    nearest; ``truncate_tf32`` shows what the tensor cores would do to an
    operand left alone), times ``p_t``, summed in float32."""
    w = coef_s.shape[0]
    _, tp, nf = dsc.p.shape
    dt = rounding(delta_transforms(coef_s, coef_r, dsc)).reshape(3 * w, 3 * tp)
    return (dt @ dsc.p_t[:nf].T).reshape(w, 3, nf) + dsc.x0


def k_parts(m: int, n_pad: int, k: int, resident: int) -> int:
    """Into how many parts the product kernel splits K for an (m, n_pad)
    output on a card that holds ``resident`` of its blocks at once: as many as
    keep every block resident in one wave, each at least ``MIN_PART_TILES`` k
    tiles, none empty. The parts are added in part order whatever their
    number, so a shape's result repeats bit for bit."""
    tiles = max(1, -(-m // M_TILE) * (n_pad // N_TILE))
    k_tiles = k // K_TILE
    parts = max(1, min(resident // tiles, k_tiles // MIN_PART_TILES))
    per = -(-k_tiles // parts)
    return -(-k_tiles // per)


def resident_blocks(device) -> int:
    """How many blocks of the product kernel ``device`` holds at once (its
    occupancy times the multiprocessors). Also checks that the tile the kernel
    was built with is this module's."""
    blocks, *tile = build.query_ints("decode_solve", "decode_solve_tiling", 4, device)
    if tuple(tile) != (M_TILE, N_TILE, K_TILE) or blocks < 1:
        raise RuntimeError(f"decode_solve.cu multiplies in tiles of {tile}, {blocks} resident; "
                           f"this module says {(M_TILE, N_TILE, K_TILE)}")
    return blocks


def decode_solve(coef_s, coef_r, dsc: DecodeSolveConsts) -> torch.Tensor:
    """Decode + delta solve: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors; any other input raises. → (W, 3, NF)."""
    if coef_s.device.type == "cpu":
        return decode_solve_plain(coef_s, coef_r, dsc)
    w, ks = coef_s.shape
    kr = coef_r.shape[1]
    _, tp, nf = dsc.p.shape
    build.check("coef_s", coef_s, (w, ks))
    build.check("coef_r", coef_r, (w, kr))
    build.check("basis_s", dsc.basis_s, (ks, 6, tp))
    build.check("means_s", dsc.means_s, (6, tp))
    build.check("basis_r", dsc.basis_r, (kr, 3, tp))
    build.check("means_r", dsc.means_r, (3, tp))
    n_pad = dsc.p_t.shape[0]
    build.check("p_t", dsc.p_t, (-(-nf // N_TILE) * N_TILE, 3 * tp))
    build.check("t0", dsc.t0, (9, tp))
    build.check("x0", dsc.x0, (3, nf))
    parts = k_parts(3 * w, n_pad, 3 * tp, resident_blocks(coef_s.device))
    empty = dict(device=coef_s.device, dtype=torch.float32)
    dt = torch.empty(w, 9, tp, **empty)           # ΔT in TF32 values: 364 KB a window
    part = torch.empty(parts, 3 * w, n_pad, **empty)  # the K parts' partial sums
    out = torch.empty(w, 3, nf, **empty)
    build.launch("decode_solve",
                 (coef_s, coef_r, dsc.basis_s, dsc.means_s, dsc.basis_r, dsc.means_r, dsc.p_t,
                  dsc.t0, dsc.x0, dt, part, out), (w, ks, kr, tp, nf, n_pad, parts),
                 coef_s.device)
    global LAUNCHES
    LAUNCHES += 1
    return out


def decode_solve_fused(coef_s, coef_r, dsc: DecodeSolveConsts, consts: DeformConsts,
                       spec: SolverSpec, cnst_verts) -> torch.Tensor:
    """Coefficients → full vertices: ``decode_solve`` (its plain version
    inside ``ops.plain_versions()``) then ``assemble_from_free``."""
    x = (decode_solve_plain if using_plain() else decode_solve)(coef_s, coef_r, dsc)
    return assemble_from_free(consts, spec, x, cnst_verts)
