"""Fused PCA decode + deformation solve (``csrc/decode_solve.cu``): its two
bodies and their plain versions.

Counterpart of ``sdfa_tpu/ops/pallas_decode_solve.py``: from the heads' raw
PCA coefficients, decode the 9 k-major planes per triangle, build
T = exp(skew(r))·S and solve onto the free vertices. ``prep_consts`` builds
the constants once per template on the host, and the template's equation
table picks the body through their type:

- an identity table (equation k reads triangle k) takes the delta body,
  the counterpart of ``_kernel_delta``: x = x0 + (T − T0)·P.
  ``DecodeSolveConsts`` holds k-major bases, T0 (the transform entries of
  the PCA means), x0 (T0's solve, in float64) and P twice: ``p`` in float32
  for the plain version, ``p_t`` transposed, padded and rounded to TF32 for
  the kernel. On a card the decode kernel writes ΔT = T − T0 rounded to
  TF32, and ΔT·P runs on the tensor cores in TF32 with float32 sums: the
  delta form exists so that a short mantissa is enough (the TPU kernel
  multiplies in one bf16 pass);
- a table with triangle correspondences takes the full body, the
  counterpart of ``_kernel``: x = T_eq·P over the equations, equation k
  reading triangle ``eq_idx[k]``, or the identity where it has no source.
  The solve is linear in T, so ``fold_table`` folds the table into P once,
  in float64: Pt[c][t] sums P[c][e] over the equations e of triangle t,
  x_id[d] sums P[d][e] over the equations with no source, and with T0 and
  x0f = T0·Pt + x_id the full body is x = x0f + (T − T0)·Pt, the delta
  body's structure over the triangles. ``DecodeSolveFullConsts`` holds the
  same bases, T0, x0f, ``b_t`` (Pt transposed and split into TF32 hi and lo
  parts) and, for the plain version, the table and ``p`` over the
  equations. On a card the decode kernel writes ΔT in float32 once per
  triangle, and the product runs as 3xTF32 (ΔT_hi·Pt_hi + ΔT_hi·Pt_lo +
  ΔT_lo·Pt_hi, ΔT split in registers), float32 grade as the TPU kernel's
  three bf16 passes are. The plain version stays the decode, the gather
  and the float32 product over the equations: a check of the fold, not a
  copy of it.

Both bodies round their operands to nearest before the tensor cores see
them, which would truncate. What is not CUDA — the fold, the operands'
layouts, into how many parts K is split so that the blocks fill the card,
the order the parts are added in — lives here; ``round_tf32`` and
``split_tf32`` (``ops/tf32.py``, shared with the recurrent kernels' input
projection), ``decode_solve_rounded`` and ``decode_solve_full_rounded``
repeat the kernels' rounding in plain tensors for the CPU tests.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Union

import numpy as np
import torch

from . import build, note_launch, using_plain
from .deform_solver import (_EYE9, DeformConsts, DeformationSolver, SolverSpec,
                            assemble_from_free, transform_entries_from_planes)
from .tf32 import round_tf32, split_tf32

LAUNCHES = collections.Counter()  # wrapper calls that launched the kernels, by body: delta, full

T_ALIGN = 128  # triangle and equation padding: the decode kernels' block width
M_TILE, N_TILE, K_TILE = 128, 128, 32  # the product kernel's output tile and k per stage
MIN_PART_TILES = 16  # a part of K is at least this many k tiles, so that its ring fills


class DecodeSolveConsts(NamedTuple):
    """The delta body's constants; T' = n_tris padded to T_ALIGN, NF = n_free.
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


class DecodeSolveFullConsts(NamedTuple):
    """The full body's constants; T' = n_tris and E' = n_eqs, each padded to
    T_ALIGN. basis_s, means_s, basis_r, means_r and t0 as the delta body's;
    x0 (3, NF): x0f = T0·Pt + x_id of ``fold_table``, in float64, rounded once
    to float32; b_t (2, NF padded to N_TILE, 3T'): Pt viewed as (3T', NF),
    transposed, zero rows from NF on, split into TF32 parts hi (``b_t[0]``)
    and lo (``b_t[1]``) by ``split_tf32``. For the plain version: eq_idx
    (E',) int32, the source triangle of each equation, −1 where it has none
    (the identity), the padded tail too; p (3, E', NF) float32, zero rows
    from n_eqs on. The card holds P as 3 floats an equation entry and 6 a
    triangle entry: 0.57 GB at FLAME's counts with 13966 equations (a kernel
    over the equations, B' = [hi | lo | hi] of 9 floats an equation entry,
    held 0.86 GB)."""

    basis_s: torch.Tensor
    means_s: torch.Tensor
    basis_r: torch.Tensor
    means_r: torch.Tensor
    eq_idx: torch.Tensor
    p: torch.Tensor
    t0: torch.Tensor
    x0: torch.Tensor
    b_t: torch.Tensor


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores make of a float32 operand that was not rounded:
    the 13 low bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _padded_t(p: torch.Tensor) -> torch.Tensor:
    """p (3, T', NF) viewed as (3T', NF), transposed, zero rows from NF to NF
    padded to N_TILE: TF32 tensor-core products take both operands with K
    contiguous."""
    _, tp, nf = p.shape
    p_t = p.new_zeros(-(-nf // N_TILE) * N_TILE, 3 * tp)
    p_t[:nf] = p.reshape(3 * tp, nf).T
    return p_t


def transposed_p(p: torch.Tensor) -> torch.Tensor:
    """``p_t`` of p (3, T', NF): (NF padded to N_TILE, 3T'), rounded to TF32."""
    return round_tf32(_padded_t(p))


def prep_consts(scale_comp_t, scale_means, rotat_comp_t, rotat_means,
                solver: DeformationSolver, device
                ) -> Union[DecodeSolveConsts, DecodeSolveFullConsts]:
    """Build a body's constants from the PCA inversions ((6T, Ks) and (3T, Kr)
    components with their means) and the solver's host operator: the delta
    body's on an identity equation table, the full body's on a table with
    triangle correspondences (``prep_full_consts``)."""
    if not solver.spec.identity_eq:
        return prep_full_consts(scale_comp_t, scale_means, rotat_comp_t, rotat_means, solver,
                                device)
    n = solver.n_tris
    tp = -(-n // T_ALIGN) * T_ALIGN
    basis_s, means_s, basis_r, means_r = _k_major(scale_comp_t, scale_means, rotat_comp_t,
                                                  rotat_means, n, tp)
    t0 = _t0(means_s, means_r)
    p64 = solver.p_planes()  # (3, T, NF) f64
    x0 = fold_x0(t0.numpy()[:, :n], p64, 0.0)
    p = np.zeros((3, tp, solver.n_free), np.float32)
    p[:, :n] = p64
    p = torch.from_numpy(p)
    to = dict(device=device, dtype=torch.float32)
    return DecodeSolveConsts(basis_s.to(**to), means_s.to(**to), basis_r.to(**to),
                             means_r.to(**to), p.to(**to), t0.to(**to),
                             torch.as_tensor(x0, **to), transposed_p(p).to(**to))


def fold_table(solver: DeformationSolver, tp: int):
    """The equation table folded into P, in float64: (Pt (3, ``tp``, NF), x_id
    (3, NF)). Pt[c][t] = Σ P[c][e] over the equations e whose source is
    triangle t (zero for a triangle with none, and for the padded tail);
    x_id[d] = Σ P[d][e] over the equations with no source, whose T is the
    identity. Then Σ_e T_src(e)·P[e] = Σ_t T_t·Pt[t] + x_id for any T."""
    p64 = torch.from_numpy(solver.p_planes())  # (3, n_eqs, NF)
    src = torch.from_numpy(np.asarray(solver._eq_src, np.int64))
    has = src >= 0
    pt = p64.new_zeros(3, tp, p64.shape[2]).index_add_(1, src[has], p64[:, has])
    return pt.numpy(), p64[:, ~has].sum(dim=1).numpy()


def fold_x0(t0: np.ndarray, pt: np.ndarray, x_id: np.ndarray) -> np.ndarray:
    """x0f (3, NF) = T0·Pt + x_id in float64, from T0 (9, T') and the fold:
    the solve of the PCA means, the full body's reference point."""
    t0 = np.asarray(t0, np.float64)
    return np.stack([sum(t0[3 * dd + c] @ pt[c] for c in range(3)) for dd in range(3)]) + x_id


def prep_full_consts(scale_comp_t, scale_means, rotat_comp_t, rotat_means,
                     solver: DeformationSolver, device) -> DecodeSolveFullConsts:
    """The full body's constants, on any equation table (an identity table
    too: the full body then computes the TPU ``_kernel``'s function). The
    table is folded into P on the host in float64 (``fold_table``), x0f =
    T0·Pt + x_id in float64 and rounded once; ``b_t`` is split on
    ``device``."""
    n, n_eqs = solver.n_tris, solver.n_eqs
    tp = -(-n // T_ALIGN) * T_ALIGN
    ep = -(-n_eqs // T_ALIGN) * T_ALIGN
    basis_s, means_s, basis_r, means_r = _k_major(scale_comp_t, scale_means, rotat_comp_t,
                                                  rotat_means, n, tp)
    t0 = _t0(means_s, means_r)
    pt, x_id = fold_table(solver, tp)
    x0 = fold_x0(t0.numpy(), pt, x_id)
    eq_idx = np.full(ep, -1, np.int32)
    eq_idx[:n_eqs] = solver._eq_src
    p = np.zeros((3, ep, solver.n_free), np.float32)
    p[:, :n_eqs] = solver.p_planes()
    to = dict(device=device, dtype=torch.float32)
    pt32 = torch.from_numpy(pt.astype(np.float32)).to(**to)
    return DecodeSolveFullConsts(basis_s.to(**to), means_s.to(**to), basis_r.to(**to),
                                 means_r.to(**to), torch.from_numpy(eq_idx).to(device),
                                 torch.from_numpy(p).to(**to), t0.to(**to),
                                 torch.as_tensor(x0, **to), split_pt(pt32))


def split_pt(pt: torch.Tensor) -> torch.Tensor:
    """``b_t`` of Pt (3, T', NF) float32: (2, NF padded to N_TILE, 3T'), Pt
    transposed and split into TF32 parts hi and lo."""
    return torch.stack(split_tf32(_padded_t(pt)))


def _t0(means_s, means_r) -> torch.Tensor:
    """T0 (9, T'), the transform entries of the PCA means in float32: the value
    the decode kernel subtracts, so that T = ΔT + T0 exactly. The padded tail
    has zero means: its T0 is the identity, as is its T."""
    t = transform_entries_from_planes([means_s[k] for k in range(6)]
                                      + [means_r[k] for k in range(3)])
    return torch.stack([t[i][j] for i in range(3) for j in range(3)])


def _k_major(scale_comp_t, scale_means, rotat_comp_t, rotat_means, n: int, tp: int):
    """The bases k-major and padded to ``tp`` triangles: basis_s (Ks, 6, T'),
    means_s (6, T'), basis_r (Kr, 3, T'), means_r (3, T'), float32 on the host."""

    def km(comp, means, per_tri):
        comp = torch.as_tensor(comp, dtype=torch.float32).cpu()
        means = torch.as_tensor(means, dtype=torch.float32).cpu().reshape(-1)
        b = comp.reshape(n, per_tri, -1).permute(2, 1, 0)  # (K, per_tri, T)
        b = torch.nn.functional.pad(b, (0, tp - n))
        m = torch.nn.functional.pad(means.reshape(n, per_tri).T, (0, tp - n))
        return b.contiguous(), m.contiguous()

    return (*km(scale_comp_t, scale_means, 6), *km(rotat_comp_t, rotat_means, 3))


def transforms(coef_s, coef_r, dsc) -> torch.Tensor:
    """The decode in plain tensors: (W, Ks), (W, Kr) → T's entries per
    triangle, (W, 9, T'), row-major T[d][c]."""
    w = coef_s.shape[0]
    tp = dsc.basis_s.shape[2]
    d_s = (coef_s @ dsc.basis_s.reshape(dsc.basis_s.shape[0], -1)).reshape(w, 6, tp)
    d_r = (coef_r @ dsc.basis_r.reshape(dsc.basis_r.shape[0], -1)).reshape(w, 3, tp)
    d_s, d_r = d_s + dsc.means_s, d_r + dsc.means_r
    t = transform_entries_from_planes([d_s[:, k] for k in range(6)]
                                      + [d_r[:, k] for k in range(3)])
    return torch.stack([t[i][j] for i in range(3) for j in range(3)], dim=1)


def delta_transforms(coef_s, coef_r, dsc) -> torch.Tensor:
    """Either body's decode in plain tensors: ΔT = T − T0, (W, 9, T')."""
    return transforms(coef_s, coef_r, dsc) - dsc.t0


def equation_transforms(coef_s, coef_r, fsc: DecodeSolveFullConsts) -> torch.Tensor:
    """The full body's decode in plain tensors: each equation's T, (W, 9, E'):
    the decode per triangle, then the gather of the table, the identity where
    an equation has no source."""
    t9 = transforms(coef_s, coef_r, fsc)
    tp = t9.shape[2]
    eye = torch.tensor(_EYE9, dtype=t9.dtype, device=t9.device)
    ext = torch.cat([t9, eye[:, None].expand(t9.shape[:-1] + (1,))], dim=-1)
    return ext.index_select(-1, torch.where(fsc.eq_idx < 0, tp, fsc.eq_idx))


def decode_solve_plain(coef_s, coef_r, dsc: DecodeSolveConsts) -> torch.Tensor:
    """The delta body's plain version: (W, Ks), (W, Kr) → (W, 3, NF)."""
    w = coef_s.shape[0]
    _, tp, nf = dsc.p.shape
    dt = delta_transforms(coef_s, coef_r, dsc)
    return (dt.reshape(3 * w, 3 * tp) @ dsc.p.reshape(3 * tp, nf)).reshape(w, 3, nf) + dsc.x0


def decode_solve_full_plain(coef_s, coef_r, fsc: DecodeSolveFullConsts) -> torch.Tensor:
    """The full body's plain version: (W, Ks), (W, Kr) → (W, 3, NF), the
    decode, the gather and the float32 product over the equations."""
    w = coef_s.shape[0]
    _, ep, nf = fsc.p.shape
    t = equation_transforms(coef_s, coef_r, fsc)
    return (t.reshape(3 * w, 3 * ep) @ fsc.p.reshape(3 * ep, nf)).reshape(w, 3, nf)


def decode_solve_rounded(coef_s, coef_r, dsc: DecodeSolveConsts, rounding=round_tf32):
    """``decode_solve_plain`` with the product's operands as the kernel hands
    them to the tensor cores: ΔT through ``rounding`` (the kernel rounds to
    nearest; ``truncate_tf32`` shows what the tensor cores would do to an
    operand left alone), times ``p_t``, summed in float32."""
    w = coef_s.shape[0]
    _, tp, nf = dsc.p.shape
    dt = rounding(delta_transforms(coef_s, coef_r, dsc)).reshape(3 * w, 3 * tp)
    return (dt @ dsc.p_t[:nf].T).reshape(w, 3, nf) + dsc.x0


def decode_solve_full_rounded(coef_s, coef_r, fsc: DecodeSolveFullConsts) -> torch.Tensor:
    """``decode_solve_full_plain`` as the kernel computes it: ΔT over the
    triangles split into TF32 parts, times ``b_t``'s parts, ΔT_hi·Pt_hi +
    ΔT_hi·Pt_lo + ΔT_lo·Pt_hi with float32 sums, + x0f."""
    w = coef_s.shape[0]
    nf = fsc.x0.shape[1]
    tp = fsc.t0.shape[1]
    hi, lo = split_tf32(delta_transforms(coef_s, coef_r, fsc).reshape(3 * w, 3 * tp))
    b_hi, b_lo = fsc.b_t[0, :nf].T, fsc.b_t[1, :nf].T
    return (hi @ b_hi + hi @ b_lo + lo @ b_hi).reshape(w, 3, nf) + fsc.x0


def cost(windows: int, ks: int, kr: int, tp: int, nf: int):
    """(flops, bytes) of one delta launch at ``tp`` padded triangles and ``nf``
    free vertices: the decode, 2 W (6 Ks + 3 Kr) T' FLOP in float32, and the
    product, 2 W 9 T' NF in TF32 on the tensor cores; every input read once
    (the bases, means, T0, x0 and ``p_t``, not ``p``), the output written once."""
    n_pad = -(-nf // N_TILE) * N_TILE
    flops = 2.0 * windows * (6 * ks + 3 * kr) * tp + 2.0 * windows * 9 * tp * nf
    floats = (windows * (ks + kr) + (ks + 1) * 6 * tp + (kr + 1) * 3 * tp + n_pad * 3 * tp
              + 9 * tp + 3 * nf + windows * 3 * nf)
    return flops, 4.0 * floats


def cost_full(windows: int, ks: int, kr: int, tp: int, nf: int):
    """(flops, bytes) of one full launch at ``tp`` padded triangles and ``nf``
    free vertices: the decode once per triangle, 2 W (6 Ks + 3 Kr) T' FLOP
    in float32, and the folded product as the tensor cores run it, three TF32
    products of 2 W 9 T' NF; every input read once (the bases, means, T0,
    x0f and ``b_t``, not ``p`` or the table, which only the plain version
    reads), the output written once."""
    n_pad = -(-nf // N_TILE) * N_TILE
    flops = 2.0 * windows * (6 * ks + 3 * kr) * tp + 3 * 2.0 * windows * 9 * tp * nf
    floats = (windows * (ks + kr) + (ks + 1) * 6 * tp + (kr + 1) * 3 * tp + 2 * n_pad * 3 * tp
              + 9 * tp + 3 * nf + windows * 3 * nf)
    return flops, 4.0 * floats


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


def resident_blocks(device, body: str = "delta") -> int:
    """How many blocks of a body's product kernel (``"delta"`` or ``"full"``)
    ``device`` holds at once (its occupancy times the multiprocessors). Also
    checks that the tile the kernels were built with is this module's."""
    delta, *tile, full = build.query_ints("decode_solve", "decode_solve_tiling", 5, device)
    blocks = {"delta": delta, "full": full}[body]
    if tuple(tile) != (M_TILE, N_TILE, K_TILE) or blocks < 1:
        raise RuntimeError(f"decode_solve.cu multiplies in tiles of {tile}, {blocks} resident; "
                           f"this module says {(M_TILE, N_TILE, K_TILE)}")
    return blocks


def _launch(body: str, coef_s, coef_r, c, b_t, b_lead=()) -> torch.Tensor:
    """Check a body's inputs and launch its three kernels on ``coef_s``'s
    card: the delta body (``sdfa_decode_solve``, ``b_t`` = ``p_t``) or the full
    body (``sdfa_decode_solve_full``, ``b_t`` = Pt's two parts, ``b_lead`` =
    (2,)), which take the same arguments; counts the launch under ``body``.
    → (W, 3, NF)."""
    tp, nf = c.t0.shape[1], c.x0.shape[1]
    w, ks = coef_s.shape
    kr = coef_r.shape[1]
    n_pad = -(-nf // N_TILE) * N_TILE
    for name, t, shape in (("coef_s", coef_s, (w, ks)), ("coef_r", coef_r, (w, kr)),
                           ("basis_s", c.basis_s, (ks, 6, tp)), ("means_s", c.means_s, (6, tp)),
                           ("basis_r", c.basis_r, (kr, 3, tp)), ("means_r", c.means_r, (3, tp)),
                           ("b_t", b_t, (*b_lead, n_pad, 3 * tp)), ("t0", c.t0, (9, tp)),
                           ("x0", c.x0, (3, nf))):
        build.check(name, t, shape)
    parts = k_parts(3 * w, n_pad, 3 * tp, resident_blocks(coef_s.device, body))
    empty = dict(device=coef_s.device, dtype=torch.float32)
    dt = torch.empty(w, 9, tp, **empty)           # ΔT, TF32 values or float32: 364 KB a window
    part = torch.empty(parts, 3 * w, n_pad, **empty)  # the K parts' partial sums
    out = torch.empty(w, 3, nf, **empty)
    build.launch("decode_solve",
                 (coef_s, coef_r, c.basis_s, c.means_s, c.basis_r, c.means_r, b_t, c.t0, c.x0,
                  dt, part, out), (w, ks, kr, tp, nf, n_pad, parts), coef_s.device,
                 entry="decode_solve" if body == "delta" else "decode_solve_full")
    LAUNCHES[body] += 1
    return out


def decode_solve(coef_s, coef_r, dsc: DecodeSolveConsts) -> torch.Tensor:
    """Decode + delta solve: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors; any other input raises. → (W, 3, NF)."""
    if coef_s.device.type == "cpu":
        return decode_solve_plain(coef_s, coef_r, dsc)
    out = _launch("delta", coef_s, coef_r, dsc, dsc.p_t)
    note_launch("decode_solve", cost(out.shape[0], coef_s.shape[1], coef_r.shape[1],
                                     dsc.t0.shape[1], out.shape[2]))
    return out


def decode_solve_full(coef_s, coef_r, fsc: DecodeSolveFullConsts) -> torch.Tensor:
    """Decode + full solve: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors; any other input raises. → (W, 3, NF)."""
    if coef_s.device.type == "cpu":
        return decode_solve_full_plain(coef_s, coef_r, fsc)
    out = _launch("full", coef_s, coef_r, fsc, fsc.b_t, (2,))
    note_launch("decode_solve_full", cost_full(out.shape[0], coef_s.shape[1], coef_r.shape[1],
                                               fsc.t0.shape[1], out.shape[2]))
    return out


def decode_solve_fused(coef_s, coef_r, dsc: Union[DecodeSolveConsts, DecodeSolveFullConsts],
                       consts: DeformConsts, spec: SolverSpec, cnst_verts) -> torch.Tensor:
    """Coefficients → full vertices: the body of ``dsc``'s type (the delta
    body on an identity table, the full body on a correspondence table; their
    plain versions inside ``ops.plain_versions()``), then
    ``assemble_from_free``."""
    if isinstance(dsc, DecodeSolveFullConsts):
        fn = decode_solve_full_plain if using_plain() else decode_solve_full
    else:
        fn = decode_solve_plain if using_plain() else decode_solve
    return assemble_from_free(consts, spec, fn(coef_s, coef_r, dsc), cnst_verts)
