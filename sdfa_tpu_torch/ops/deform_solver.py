"""Deformation-transfer solver (counterpart of ``sdfa_tpu/ops/deform_solver.py``).

The host build is float64 numpy/scipy, as in the JAX package: per-triangle
Gram-Schmidt frame weights, sparse A (free vertices) / Ar (constrained),
AᵀA + reg, its SuperLU factorization and dense inverse, the direct-solve
operator P = (A·inv)ᵀ and the constraint term par = P·Ar. The device side
is torch: ``transform_entries_from_planes`` (T = exp(skew(r))·S per
triangle), ``solve_fn`` (direct method) and ``assemble_from_free``.
Identity equations only: the triangle-correspondence fan-out is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class DeformConsts(NamedTuple):
    """Device constants of the direct solve."""

    p: torch.Tensor              # (3, n_tris, n_free) per-component operator planes
    par: torch.Tensor            # (n_free, n_cnsts) constraint subtraction
    free_ids: torch.Tensor       # (n_free,) int64
    cnst_ids: torch.Tensor       # (n_cnsts,) int64
    template_cnst: torch.Tensor  # (n_cnsts, 3)


class SolverSpec(NamedTuple):
    n_verts: int
    n_tris: int
    n_free: int
    n_cnsts: int


def _gram_schmidt_qr(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Column-wise Gram-Schmidt with the reference's degeneracy branch."""
    rows, cols = a.shape
    q = np.zeros((rows, cols))
    r = np.zeros((cols, cols))
    for j in range(cols):
        v = a[:, j].copy()
        for i in range(j):
            r[i, j] = q[:, i] @ v
            v -= r[i, j] * q[:, i]
        vlen = np.sqrt(v @ v)
        if vlen < 1e-6:
            r[j, j] = 1.0
        else:
            r[j, j] = vlen
            q[:, j] = v / vlen
    return q, r


class DeformationSolver:
    """Prefactorized solver for a fixed template mesh (host build, f64)."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 cnst_indices: Optional[Sequence[int]] = None, reg: float = 1e-10):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        verts = np.asarray(verts, np.float64).reshape(-1, 3)
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        self.n_verts, self.n_tris = len(verts), len(faces)
        self.template_verts = verts
        cnst = np.asarray(cnst_indices if cnst_indices is not None else [],
                          np.int64).reshape(-1)
        self.n_cnsts = len(cnst)
        self.cnst_indices = cnst

        is_cnst = np.zeros(self.n_verts, bool)
        is_cnst[cnst] = True
        self.free_ids = np.nonzero(~is_cnst)[0]
        self.n_free = len(self.free_ids)
        vi_to_col = np.full(self.n_verts, -1, np.int64)
        vi_to_col[self.free_ids] = np.arange(self.n_free)
        vi_to_col_r = np.full(self.n_verts, -1, np.int64)
        vi_to_col_r[cnst] = np.arange(self.n_cnsts)

        # W[j, slot, c]: slot 0 = v1 (−U0c−U1c), slot 1 = v2 (U0c), 2 = v3 (U1c)
        w = np.zeros((self.n_tris, 3, 3))
        for j in range(self.n_tris):
            v1, v2, v3 = verts[faces[j]]
            q, r = _gram_schmidt_qr(np.stack([v2 - v1, v3 - v1], axis=1))
            uj = np.linalg.inv(r) @ q.T
            w[j, 0] = -uj[0] - uj[1]
            w[j, 1] = uj[0]
            w[j, 2] = uj[1]

        # sparse A / Ar: row 3k+c of triangle k, one entry per corner
        rows = (3 * np.arange(self.n_tris)[:, None, None] + np.arange(3)[None, None, :])
        rows = np.broadcast_to(rows, (self.n_tris, 3, 3))          # [k, slot, c]
        vi = np.broadcast_to(faces[:, :, None], (self.n_tris, 3, 3))
        free = vi_to_col[vi] >= 0
        a_mat = sp.csr_matrix((w[free], (rows[free], vi_to_col[vi][free])),
                              shape=(3 * self.n_tris, self.n_free))
        ar_mat = sp.csr_matrix((w[~free], (rows[~free], vi_to_col_r[vi][~free])),
                               shape=(3 * self.n_tris, max(self.n_cnsts, 1)))
        self._ar = ar_mat
        # equation k reads triangle _eq_src[k]'s transform: the identity table
        # (the correspondence fan-out is not ported)
        self._eq_src = np.arange(self.n_tris, dtype=np.int64)
        self._at = a_mat.T.tocsr()
        ata = (self._at @ a_mat).toarray()
        if reg:
            ata[np.diag_indices_from(ata)] += reg
        self._lu = spla.splu(sp.csc_matrix(ata))
        inv = np.linalg.inv(ata)
        # P = inv·Aᵀ = (A·inv)ᵀ (inv is symmetric): (n_free, 3·n_tris)
        self._p_np = np.ascontiguousarray((a_mat @ inv).T)
        self._par_np = np.ascontiguousarray((ar_mat.T.tocsr() @ self._p_np.T).T)
        self.spec = SolverSpec(self.n_verts, self.n_tris, self.n_free, self.n_cnsts)

    def p_planes(self) -> np.ndarray:
        """(3, n_tris, n_free) float64: P[c][t] = column 3t+c of the operator."""
        return np.stack([self._p_np[:, c::3].T for c in range(3)])

    def device_consts(self, device) -> DeformConsts:
        f32 = dict(device=device, dtype=torch.float32)
        cnst_verts = (self.template_verts[self.cnst_indices] if self.n_cnsts
                      else np.zeros((0, 3)))
        return DeformConsts(
            p=torch.as_tensor(self.p_planes(), **f32).contiguous(),
            par=torch.as_tensor(self._par_np[:, :self.n_cnsts], **f32),
            free_ids=torch.as_tensor(self.free_ids, device=device),
            cnst_ids=torch.as_tensor(self.cnst_indices, device=device),
            template_cnst=torch.as_tensor(cnst_verts, **f32))

    def solve_host(self, dgrad: np.ndarray,
                   cnst_verts: Optional[np.ndarray] = None) -> np.ndarray:
        """float64 oracle via SuperLU: dgrad (n_tris, 9) → vertices (V, 3)."""
        dgrad = np.asarray(dgrad, np.float64).reshape(-1, 9)
        if dgrad.shape[0] != self.n_tris:
            raise ValueError(f"dgrad has {dgrad.shape[0]} triangles, mesh has {self.n_tris}")
        d = transforms_t_np(dgrad).reshape(3 * self.n_tris, 3)
        c = None
        if self.n_cnsts > 0:
            c = (self.template_verts[self.cnst_indices] if cnst_verts is None
                 else np.asarray(cnst_verts, np.float64).reshape(-1, 3))
            d = d - self._ar @ c
        x = self._lu.solve(self._at @ d)
        out = np.zeros((self.n_verts, 3))
        out[self.free_ids] = x
        if c is not None:
            out[self.cnst_indices] = c
        return out


def transforms_t_np(dgrad: np.ndarray) -> np.ndarray:
    """float64 numpy (exp(skew)·S)ᵀ per triangle: (n, 9) → (n, 3, 3)."""
    n = len(dgrad)
    s = np.zeros((n, 3, 3))
    s[:, 0, 0] = dgrad[:, 0] + 1.0
    s[:, 0, 1] = s[:, 1, 0] = dgrad[:, 1]
    s[:, 0, 2] = s[:, 2, 0] = dgrad[:, 2]
    s[:, 1, 1] = dgrad[:, 3] + 1.0
    s[:, 1, 2] = s[:, 2, 1] = dgrad[:, 4]
    s[:, 2, 2] = dgrad[:, 5] + 1.0
    w = np.stack([-dgrad[:, 8], dgrad[:, 7], -dgrad[:, 6]], axis=-1)
    angle = np.linalg.norm(w, axis=-1)
    r = np.tile(np.eye(3), (n, 1, 1))
    nz = angle >= 1e-6
    if nz.any():
        axis = w[nz] / angle[nz, None]
        k = np.zeros((nz.sum(), 3, 3))
        k[:, 0, 1] = -axis[:, 2]; k[:, 0, 2] = axis[:, 1]
        k[:, 1, 0] = axis[:, 2]; k[:, 1, 2] = -axis[:, 0]
        k[:, 2, 0] = -axis[:, 1]; k[:, 2, 1] = axis[:, 0]
        sa = np.sin(angle[nz])[:, None, None]
        ca = (1 - np.cos(angle[nz]))[:, None, None]
        r[nz] = np.eye(3) + sa * k + ca * (k @ k)
    return np.swapaxes(r @ s, -1, -2)


def transform_entries_from_planes(d):
    """The 9 component planes d[0..8] → t[i][j] planes of T = exp(skew)·S
    (same formula as the JAX package's, shared with the kernel's plain
    version)."""
    s = [[d[0] + 1.0, d[1], d[2]],
         [d[1], d[3] + 1.0, d[4]],
         [d[2], d[4], d[5] + 1.0]]
    w0, w1, w2 = -d[8], d[7], -d[6]
    theta = torch.sqrt(w0 * w0 + w1 * w1 + w2 * w2)
    small = theta < 1e-6
    inv_t = torch.where(small, torch.zeros_like(theta),
                        1.0 / torch.where(small, torch.ones_like(theta), theta))
    a0, a1, a2 = w0 * inv_t, w1 * inv_t, w2 * inv_t
    st, ct = torch.sin(theta), torch.cos(theta)
    omc = 1.0 - ct
    r = [[ct + omc * a0 * a0, -st * a2 + omc * a0 * a1, st * a1 + omc * a0 * a2],
         [st * a2 + omc * a1 * a0, ct + omc * a1 * a1, -st * a0 + omc * a1 * a2],
         [-st * a1 + omc * a2 * a0, st * a0 + omc * a2 * a1, ct + omc * a2 * a2]]
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    r = [[torch.where(small, one if i == j else zero, r[i][j]) for j in range(3)]
         for i in range(3)]
    return [[r[i][0] * s[0][j] + r[i][1] * s[1][j] + r[i][2] * s[2][j] for j in range(3)]
            for i in range(3)]


def assemble_from_free(consts: DeformConsts, spec: SolverSpec, x: torch.Tensor,
                       cnst_verts: torch.Tensor) -> torch.Tensor:
    """Free-vertex solution x (..., 3, n_free) → vertices (..., V, 3):
    subtract the constrained-vertex correction, scatter free and
    constrained ids."""
    if spec.n_cnsts > 0:
        x = x - (consts.par @ cnst_verts).T
    batch = x.shape[:-2]
    out = x.new_zeros(batch + (3, spec.n_verts))
    out[..., consts.free_ids] = x
    if spec.n_cnsts > 0:
        out[..., consts.cnst_ids] = cnst_verts.T.expand(batch + (3, spec.n_cnsts))
    return out.transpose(-1, -2)


def solve_fn(consts: DeformConsts, dgrad: torch.Tensor, cnst_verts: torch.Tensor,
             spec: SolverSpec) -> torch.Tensor:
    """Direct solve: dgrad planes (..., n_tris·9) in the k-major layout
    [k·n_tris + tri] → vertices (..., V, 3)."""
    n = spec.n_tris
    t = transform_entries_from_planes([dgrad[..., k * n:(k + 1) * n] for k in range(9)])
    x = torch.stack([sum(t[dd][c] @ consts.p[c] for c in range(3)) for dd in range(3)],
                    dim=-2)  # (..., 3, n_free)
    return assemble_from_free(consts, spec, x, cnst_verts)
