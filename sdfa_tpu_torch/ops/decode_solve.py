"""Fused PCA decode + delta-form deformation solve (``csrc/decode_solve.cu``)
and its plain version.

Counterpart of ``sdfa_tpu/ops/pallas_decode_solve.py`` (delta mode): from
the heads' raw PCA coefficients, decode the 9 k-major planes per triangle,
build T = exp(skew(r))·S, and solve onto the free vertices as
x = x0 + (T − T0)·P. ``prep_consts`` builds the constants once per
template on the host: k-major bases, T0 (the transform entries of the PCA
means) and x0 (T0's solve, in float64).
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


class DecodeSolveConsts(NamedTuple):
    """Kernel constants; T' = n_tris padded to T_ALIGN, NF = n_free.
    basis_s (Ks, 6, T'), means_s (6, T'), basis_r (Kr, 3, T'), means_r
    (3, T'), p (3, T', NF), t0 (9, T'), x0 (3, NF). The padded tail has
    zero bases, means and P rows: its T is the identity, as is its T0."""

    basis_s: torch.Tensor
    means_s: torch.Tensor
    basis_r: torch.Tensor
    means_r: torch.Tensor
    p: torch.Tensor
    t0: torch.Tensor
    x0: torch.Tensor


def prep_consts(scale_comp_t, scale_means, rotat_comp_t, rotat_means,
                solver: DeformationSolver, device) -> DecodeSolveConsts:
    """Build the kernel constants from the PCA inversions ((6T, Ks) and
    (3T, Kr) components with their means) and the solver's host operator."""
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
    to = dict(device=device, dtype=torch.float32)
    return DecodeSolveConsts(basis_s.to(**to), means_s.to(**to), basis_r.to(**to),
                             means_r.to(**to), torch.from_numpy(p).to(**to),
                             t0.to(**to), torch.as_tensor(x0, **to))


def decode_solve_plain(coef_s, coef_r, dsc: DecodeSolveConsts) -> torch.Tensor:
    """Plain PyTorch version: (W, Ks), (W, Kr) → (W, 3, NF)."""
    w = coef_s.shape[0]
    _, tp, nf = dsc.p.shape
    d_s = (coef_s @ dsc.basis_s.reshape(dsc.basis_s.shape[0], -1)).reshape(w, 6, tp)
    d_r = (coef_r @ dsc.basis_r.reshape(dsc.basis_r.shape[0], -1)).reshape(w, 3, tp)
    d_s, d_r = d_s + dsc.means_s, d_r + dsc.means_r
    t = transform_entries_from_planes([d_s[:, k] for k in range(6)]
                                      + [d_r[:, k] for k in range(3)])
    dt = torch.stack([t[i][j] for i in range(3) for j in range(3)], dim=1) - dsc.t0
    return (dt.reshape(3 * w, 3 * tp) @ dsc.p.reshape(3 * tp, nf)).reshape(w, 3, nf) + dsc.x0


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
    build.check("p", dsc.p, (3, tp, nf))
    build.check("t0", dsc.t0, (9, tp))
    build.check("x0", dsc.x0, (3, nf))
    scratch = torch.empty(w, 9, tp, device=coef_s.device, dtype=torch.float32)
    out = torch.empty(w, 3, nf, device=coef_s.device, dtype=torch.float32)
    build.launch("decode_solve", (coef_s, coef_r, *dsc, scratch, out), (w, ks, kr, tp, nf),
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
