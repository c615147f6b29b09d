"""Deformation-transfer solver (counterpart of ``sdfa_tpu/ops/deform_solver.py``).

The host build is float64 numpy/scipy, as in the JAX package: per-triangle
Gram-Schmidt frame weights, the equation table (one equation per
triangle, or with triangle correspondences for cross-topology
retargeting one per source triangle of each target triangle and an
identity row for a triangle with none), sparse A (free vertices) / Ar
(constrained) over the equations, AᵀA + reg, its SuperLU factorization and
dense inverse, the direct-solve operator P = (A·inv)ᵀ and the constraint
term par = P·Ar.

The device side is torch: ``transform_entries_from_planes`` (T =
exp(skew(r))·S per triangle), ``solve_fn`` (direct: the 9 transform
planes, the equation gather, one product with P over the ``n_eqs``
equations in float32, ``assemble_from_free``), ``solve_mat_fn`` (the same
from raw matrices) and ``refine_fn`` (the right-hand side by segment sums,
the dense inverse and iterative refinement: an independent cross-check).
The fused decode + solve kernel (``ops.decode_solve``) takes both kinds of
table from PCA coefficients; ``solve_fn`` serves models without PCA heads
and the host-side callers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# the 9 entries of the 3×3 identity, row-major: the transform of an equation
# whose target triangle has no source
_EYE9 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


class DeformConsts(NamedTuple):
    """Device constants of the direct solve."""

    p: torch.Tensor              # (3, n_eqs, n_free) per-component operator planes
    par: torch.Tensor            # (n_free, n_cnsts) constraint subtraction
    free_ids: torch.Tensor       # (n_free,) int64
    cnst_ids: torch.Tensor       # (n_cnsts,) int64
    template_cnst: torch.Tensor  # (n_cnsts, 3)
    eq_idx: torch.Tensor         # (n_eqs,) source triangle of each equation, n_tris → I


class RefineConsts(NamedTuple):
    """Device constants of ``method="refine"`` only, built at its first use."""

    w_eq: torch.Tensor           # (n_eqs, 3 slots, 3) frame weights of each equation
    seg_ids: torch.Tensor        # (n_eqs·3,) free column of each (equation, slot), n_free: none
    inv: torch.Tensor            # (n_free, n_free) (AᵀA)⁻¹
    ata: torch.Tensor            # (n_free, n_free) AᵀA
    atar: torch.Tensor           # (n_free, n_cnsts) Aᵀ·Ar


class SolverSpec(NamedTuple):
    n_verts: int
    n_tris: int
    n_free: int
    n_cnsts: int
    n_eqs: int
    identity_eq: bool  # equation k reads triangle k: no gather, and the delta body applies


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


def equation_table(n_tris: int, corr_count: Optional[Sequence[int]] = None,
                   corr_faces: Optional[Sequence[int]] = None):
    """(eq_tri, eq_src) of the least-squares equations: without
    correspondences one per triangle; with them, target triangle j gets
    max(1, corr_count[j]) equations, equation k reading source triangle
    corr_faces[k], or the identity (−1) where j has no source (its
    corr_faces entry is a placeholder)."""
    if corr_count is None or len(corr_count) == 0:
        eq = np.arange(n_tris, dtype=np.int64)
        return eq, eq.copy()
    count = np.asarray(corr_count, np.int64)
    if len(count) != n_tris:
        raise ValueError(f"{len(count)} correspondence counts for {n_tris} triangles")
    steps = np.maximum(count, 1)
    eq_tri = np.repeat(np.arange(n_tris, dtype=np.int64), steps)
    faces = np.asarray(corr_faces if corr_faces is not None else [], np.int64)
    if len(faces) < len(eq_tri):
        raise ValueError(f"{len(faces)} correspondence faces for {len(eq_tri)} equations")
    eq_src = np.where(np.repeat(count, steps) > 0, faces[:len(eq_tri)], -1)
    if eq_src.max(initial=-1) >= n_tris or eq_src.min(initial=0) < -1:
        raise ValueError(f"a source triangle is outside 0..{n_tris - 1}")
    return eq_tri, eq_src


class DeformationSolver:
    """Prefactorized solver for a fixed template mesh (host build, f64).

    ``corr_count`` / ``corr_faces``: per target triangle the number of its
    source triangles and their ids, concatenated (a triangle with none
    takes one placeholder), as the reference's ``set_target`` takes them.
    The dgrad a solve takes has ``n_tris`` triangles either way."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 cnst_indices: Optional[Sequence[int]] = None,
                 corr_count: Optional[Sequence[int]] = None,
                 corr_faces: Optional[Sequence[int]] = None, reg: float = 1e-10):
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

        eq_tri, self._eq_src = equation_table(self.n_tris, corr_count, corr_faces)
        self.n_eqs = len(eq_tri)

        # W[j, slot, c]: slot 0 = v1 (−U0c−U1c), slot 1 = v2 (U0c), 2 = v3 (U1c),
        # U = R⁻¹·Qᵀ of each triangle's edge matrix (one batched inverse: a 2×2
        # inverse per call costs more in dispatch than in arithmetic)
        v1, v2, v3 = (verts[faces[:, i]] for i in range(3))
        qr = [_gram_schmidt_qr(np.stack([a, b], axis=1)) for a, b in zip(v2 - v1, v3 - v1)]
        q = np.stack([t[0] for t in qr])                      # (n_tris, 3, 2)
        u = np.linalg.inv(np.stack([t[1] for t in qr])) @ q.transpose(0, 2, 1)  # (n_tris, 2, 3)
        w = np.stack([-u[:, 0] - u[:, 1], u[:, 0], u[:, 1]], axis=1)
        self._w_eq = w[eq_tri]  # the weights of each equation's target triangle

        # sparse A / Ar: row 3k+c of equation k, one entry per corner of its target
        rows = (3 * np.arange(self.n_eqs)[:, None, None] + np.arange(3)[None, None, :])
        rows = np.broadcast_to(rows, (self.n_eqs, 3, 3))          # [k, slot, c]
        vi = np.broadcast_to(faces[eq_tri][:, :, None], (self.n_eqs, 3, 3))
        free = vi_to_col[vi] >= 0
        a_mat = sp.csr_matrix((self._w_eq[free], (rows[free], vi_to_col[vi][free])),
                              shape=(3 * self.n_eqs, self.n_free))
        ar_mat = sp.csr_matrix((self._w_eq[~free], (rows[~free], vi_to_col_r[vi][~free])),
                               shape=(3 * self.n_eqs, max(self.n_cnsts, 1)))
        self._ar = ar_mat
        self._at = a_mat.T.tocsr()
        self._reg = reg
        ata = self._ata()
        self._lu = spla.splu(sp.csc_matrix(ata))
        self._inv_np = np.linalg.inv(ata)
        # P = inv·Aᵀ = (A·inv)ᵀ (inv is symmetric): (n_free, 3·n_eqs)
        self._p_np = np.ascontiguousarray((a_mat @ self._inv_np).T)
        self._par_np = np.ascontiguousarray((ar_mat.T.tocsr() @ self._p_np.T).T)
        seg = vi_to_col[faces[eq_tri]]
        self._seg_ids = np.where(seg < 0, self.n_free, seg).reshape(-1)
        identity = bool(self.n_eqs == self.n_tris and np.array_equal(self._eq_src, eq_tri))
        self.spec = SolverSpec(self.n_verts, self.n_tris, self.n_free, self.n_cnsts,
                               self.n_eqs, identity)
        self._consts, self._refine_consts = {}, {}

    def _ata(self) -> np.ndarray:
        """AᵀA + reg·I, float64 dense."""
        ata = (self._at @ self._at.T).toarray()
        if self._reg:
            ata[np.diag_indices_from(ata)] += self._reg
        return ata

    def p_planes(self) -> np.ndarray:
        """(3, n_eqs, n_free) float64: P[c][k] = column 3k+c of the operator."""
        return np.stack([self._p_np[:, c::3].T for c in range(3)])

    def device_consts(self, device) -> DeformConsts:
        """The solves' constants on ``device``, uploaded once per device."""
        device = torch.device(device)
        if device not in self._consts:
            f32 = dict(device=device, dtype=torch.float32)
            cnst_verts = (self.template_verts[self.cnst_indices] if self.n_cnsts
                          else np.zeros((0, 3)))
            eq_idx = np.where(self._eq_src < 0, self.n_tris, self._eq_src)
            self._consts[device] = DeformConsts(
                p=torch.as_tensor(self.p_planes(), **f32).contiguous(),
                par=torch.as_tensor(self._par_np[:, :self.n_cnsts], **f32),
                free_ids=torch.as_tensor(self.free_ids, device=device),
                cnst_ids=torch.as_tensor(self.cnst_indices, device=device),
                template_cnst=torch.as_tensor(cnst_verts, **f32),
                eq_idx=torch.as_tensor(eq_idx, device=device))
        return self._consts[device]

    def refine_consts(self, device) -> RefineConsts:
        """``method="refine"``'s constants on ``device``, built and uploaded at
        its first use there: the serving path never reads them."""
        device = torch.device(device)
        if device not in self._refine_consts:
            f32 = dict(device=device, dtype=torch.float32)
            self._refine_consts[device] = RefineConsts(
                w_eq=torch.as_tensor(self._w_eq, **f32),
                seg_ids=torch.as_tensor(self._seg_ids, device=device),
                inv=torch.as_tensor(self._inv_np, **f32),
                ata=torch.as_tensor(self._ata(), **f32),
                atar=torch.as_tensor((self._at @ self._ar).toarray()[:, :self.n_cnsts], **f32))
        return self._refine_consts[device]

    def _device_inputs(self, x, cnst_verts, device):
        """(x as float32 on the device, the constants there, the constrained
        vertices there): on ``device``, else on ``x``'s if it is a tensor,
        else on the card."""
        if device is None:
            device = x.device if isinstance(x, torch.Tensor) else "cuda"
        consts = self.device_consts(device)
        x = torch.as_tensor(x, dtype=torch.float32, device=consts.p.device)
        c = (consts.template_cnst if cnst_verts is None else
             torch.as_tensor(cnst_verts, dtype=torch.float32, device=consts.p.device))
        return x, consts, c

    def solve(self, dgrad, cnst_verts=None, refine: int = 2, method: str = "direct",
              device=None) -> torch.Tensor:
        """dgrad (..., n_tris, 9) or (..., n_tris·9) in the reference layout
        [tri·9 + k] → vertices (..., V, 3), float32 on the device.
        ``method="direct"``: one product with P (``solve_fn``);
        ``"refine"``: segment sums, the dense inverse and ``refine``
        refinement steps (``refine_fn``), an independent cross-check."""
        dgrad, consts, c = self._device_inputs(dgrad, cnst_verts, device)
        if dgrad.shape[-1] != 9:
            dgrad = dgrad.reshape(dgrad.shape[:-1] + (-1, 9))
        if dgrad.shape[-2] != self.n_tris:
            raise ValueError(f"dgrad must be (..., {self.n_tris}, 9), got {tuple(dgrad.shape)}")
        if method == "refine":
            return refine_fn(consts, self.refine_consts(c.device), self.spec, dgrad, c, refine)
        if method != "direct":
            raise ValueError(f"unknown method {method!r}")
        planes = dgrad.transpose(-1, -2).reshape(dgrad.shape[:-2] + (9 * self.n_tris,))
        return solve_fn(consts, planes, c, self.spec)

    def solve_from_matrices(self, dmat, cnst_verts=None, device=None) -> torch.Tensor:
        """Raw row-major matrices (..., n_tris, 3, 3), (..., n_tris, 9) or the
        C ABI's (n_tris·3, 3) block stack → vertices (..., V, 3) float32."""
        dmat, consts, c = self._device_inputs(dmat, cnst_verts, device)
        if dmat.dim() == 2 and dmat.shape[-1] == 3:
            dmat = dmat.reshape(self.n_tris, 3, 3)
        if dmat.shape[-1] == 9:
            dmat = dmat.reshape(dmat.shape[:-1] + (3, 3))
        if dmat.shape[-3:] != (self.n_tris, 3, 3):
            raise ValueError(f"matrices must be (..., {self.n_tris}, 3, 3), "
                             f"got {tuple(dmat.shape)}")
        return solve_mat_fn(consts, self.spec, dmat, c)

    def _host_rhs(self, tt: np.ndarray, cnst_verts):
        """Tᵀ (n_tris, 3, 3) → (the back-substitution's right-hand side
        Aᵀ·(D − Ar·C), C): D stacks each equation's Tᵀ, the identity where
        its target has no source."""
        if tt.shape[0] != self.n_tris:
            raise ValueError(f"{tt.shape[0]} triangles, mesh has {self.n_tris}")
        ttx = np.concatenate([tt, np.eye(3)[None]])
        d = ttx[np.where(self._eq_src < 0, self.n_tris, self._eq_src)].reshape(
            3 * self.n_eqs, 3)
        c = None
        if self.n_cnsts > 0:
            c = (self.template_verts[self.cnst_indices] if cnst_verts is None
                 else np.asarray(cnst_verts, np.float64).reshape(-1, 3))
            d = d - self._ar @ c
        return self._at @ d, c

    def _host_solve(self, tt: np.ndarray, cnst_verts) -> np.ndarray:
        rhs, c = self._host_rhs(tt, cnst_verts)
        out = np.zeros((self.n_verts, 3))
        out[self.free_ids] = self._lu.solve(rhs)
        if c is not None:
            out[self.cnst_indices] = c
        return out

    def solve_host(self, dgrad: np.ndarray,
                   cnst_verts: Optional[np.ndarray] = None) -> np.ndarray:
        """float64 oracle via SuperLU: dgrad (n_tris, 9) → vertices (V, 3)."""
        return self._host_solve(transforms_t_np(np.asarray(dgrad, np.float64).reshape(-1, 9)),
                                cnst_verts)

    def solve_host_from_matrices(self, dmat: np.ndarray,
                                 cnst_verts: Optional[np.ndarray] = None) -> np.ndarray:
        """float64 oracle of the matrix variant: the least-squares rows are Tᵀ
        (the reference reads the row-major buffer as column-major)."""
        dmat = np.asarray(dmat, np.float64).reshape(-1, 3, 3)
        return self._host_solve(np.swapaxes(dmat, -1, -2), cnst_verts)


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


def equation_entries(consts: DeformConsts, spec: SolverSpec, t9: torch.Tensor) -> torch.Tensor:
    """The gather of the equation table: per-triangle transform entries
    (..., 9, n_tris) (row-major T[d][c]) → per-equation (..., 9, n_eqs), the
    identity where an equation's target has no source. Identity tables pass
    through."""
    if spec.identity_eq:
        return t9
    eye = torch.tensor(_EYE9, dtype=t9.dtype, device=t9.device)
    ext = torch.cat([t9, eye[:, None].expand(t9.shape[:-1] + (1,))], dim=-1)
    return ext.index_select(-1, consts.eq_idx)


def _product(consts: DeformConsts, spec: SolverSpec, t9: torch.Tensor,
             cnst_verts: torch.Tensor) -> torch.Tensor:
    """(..., 9, n_tris) transform entries → vertices (..., V, 3): the gather,
    X_d = Σ_c T[d][c]·P_c as one (3·rows, 3·n_eqs) × (3·n_eqs, n_free)
    product, ``assemble_from_free``."""
    t = equation_entries(consts, spec, t9)
    batch = t.shape[:-2]
    x = (t.reshape(-1, 3 * spec.n_eqs) @ consts.p.reshape(3 * spec.n_eqs, spec.n_free))
    return assemble_from_free(consts, spec, x.reshape(batch + (3, spec.n_free)), cnst_verts)


def solve_fn(consts: DeformConsts, dgrad: torch.Tensor, cnst_verts: torch.Tensor,
             spec: SolverSpec) -> torch.Tensor:
    """Direct solve: dgrad planes (..., n_tris·9) in the k-major layout
    [k·n_tris + tri] → vertices (..., V, 3)."""
    n = spec.n_tris
    t = transform_entries_from_planes([dgrad[..., k * n:(k + 1) * n] for k in range(9)])
    return _product(consts, spec, torch.stack([t[i][j] for i in range(3) for j in range(3)],
                                              dim=-2), cnst_verts)


def solve_mat_fn(consts: DeformConsts, spec: SolverSpec, dmat: torch.Tensor,
                 cnst_verts: torch.Tensor) -> torch.Tensor:
    """Direct solve from raw row-major matrices (..., n_tris, 3, 3) → vertices
    (..., V, 3); the least-squares rows are Tᵀ, as in the dgrad path."""
    t9 = dmat.reshape(dmat.shape[:-3] + (spec.n_tris, 9)).transpose(-1, -2)
    return _product(consts, spec, t9, cnst_verts)


def refine_fn(consts: DeformConsts, rc: RefineConsts, spec: SolverSpec, dgrad: torch.Tensor,
              cnst_verts: torch.Tensor, refine: int = 2) -> torch.Tensor:
    """dgrad (..., n_tris, 9) → vertices (..., V, 3) through the right-hand
    side Aᵀ·(D − Ar·C) by segment sums over the equations, x = inv·rhs and
    ``refine`` steps x += inv·(rhs − AᵀA·x)."""
    from .dgrad import dgrad_to_transforms_t

    tt = dgrad_to_transforms_t(dgrad)                          # (..., F, 3, 3)
    batch = tt.shape[:-3]
    t9 = equation_entries(consts, spec, tt.reshape(batch + (spec.n_tris, 9)).transpose(-1, -2))
    tt_eq = t9.transpose(-1, -2).reshape(batch + (spec.n_eqs, 3, 3))
    e = torch.einsum("kvc,...kcd->...kvd", rc.w_eq, tt_eq)  # (..., n_eqs, 3 slots, 3)
    flat = e.reshape(batch + (spec.n_eqs * 3, 3))
    rhs = flat.new_zeros(batch + (spec.n_free + 1, 3))
    rhs.index_add_(-2, rc.seg_ids, flat)
    rhs = rhs[..., :spec.n_free, :]
    if spec.n_cnsts > 0:
        rhs = rhs - rc.atar @ cnst_verts
    x = rc.inv @ rhs
    for _ in range(refine):
        x = x + rc.inv @ (rhs - rc.ata @ x)
    out = x.new_zeros(batch + (spec.n_verts, 3))
    out[..., consts.free_ids, :] = x
    if spec.n_cnsts > 0:
        out[..., consts.cnst_ids, :] = cnst_verts.expand(batch + cnst_verts.shape)
    return out
