"""Plain reference of the ``dgrad`` configuration: the network of
``common.Reference``, then the PCA inversions to per-triangle deformation
gradients and the least-squares vertex solve of deformation transfer.

Per triangle j the heads give S - I (6 values, symmetric) and an axis-angle
rotation r (3 values; the axis-angle vector is (-r2, r1, -r0)); T = exp(skew)
S. The vertices x minimize sum_j |sum_s W_j[s] x_{v_s} - T_j^T|^2 over the
triangles j = (v_0, v_1, v_2), with the frame weights W_j = [-u0 - u1, u0,
u1] from the rows of the pseudo-inverse U_j of the template edge matrix
[v1 - v0, v2 - v0]; the constrained vertices stay at the template and A^T A
is regularized by 1e-10. The factorization is built here from the
template alone.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import Reference, tf32_mode

REG = 1e-10


class Model:
    def __init__(self, hp, state, template, device, dtype=torch.float64, tf32=False):
        self.net = Reference(hp, state, device, dtype, tf32)
        self.device, self.dtype, self.tf32 = torch.device(device), dtype, tf32
        verts, faces, cnst = template
        verts = np.asarray(verts, np.float64)
        faces = np.asarray(faces, np.int64)
        self.n_verts, self.n_tris = len(verts), len(faces)
        free = np.ones(self.n_verts, bool)
        free[cnst] = False
        self.free_ids = np.nonzero(free)[0]
        self.moving = self.free_ids  # the vertices a frame moves: the rest are the template's
        col = np.full(self.n_verts, -1, np.int64)
        col[self.free_ids] = np.arange(len(self.free_ids))
        edges = np.stack([verts[faces[:, 1]] - verts[faces[:, 0]],
                          verts[faces[:, 2]] - verts[faces[:, 0]]], axis=2)  # (T, 3, 2)
        u = np.linalg.solve(edges.transpose(0, 2, 1) @ edges, edges.transpose(0, 2, 1))  # (T, 2, 3)
        w = np.stack([-u[:, 0] - u[:, 1], u[:, 0], u[:, 1]], axis=1)  # (T, slot, c)
        # A: row 3j + c, column of the free vertex at slot s; the constrained
        # slots move to the right-hand side with the template's positions
        a = np.zeros((3 * self.n_tris, len(self.free_ids)))
        y0 = np.zeros((3 * self.n_tris, 3))
        rows = 3 * np.arange(self.n_tris)
        for s in range(3):
            vi = faces[:, s]
            for c in range(3):
                is_free = col[vi] >= 0
                np.add.at(a, (rows[is_free] + c, col[vi[is_free]]), w[is_free, s, c])
                y0[rows[~is_free] + c] += w[~is_free, s, c][:, None] * verts[vi[~is_free]]
        t = dict(device=self.device, dtype=torch.float64)
        at = torch.as_tensor(a.T.copy(), **t)
        ata = at @ at.T + REG * torch.eye(len(self.free_ids), **t)
        self.chol = torch.linalg.cholesky(ata).to(dtype)
        self.at = at.to(dtype)
        self.y0 = torch.as_tensor(y0, device=self.device, dtype=dtype)
        self.template = torch.as_tensor(verts, device=self.device, dtype=dtype)
        self.free_t = torch.as_tensor(self.free_ids, device=self.device)
        w_ = {k: v.to(device=self.device, dtype=dtype) for k, v in state.items()
              if k.endswith("_pca.compT") or k.endswith("_pca.means")}
        self.pca = {n: (w_[f"{n}_pca.compT"], w_[f"{n}_pca.means"]) for n in ("scale", "rotat")}

    def transforms_t(self, scale: torch.Tensor, rotat: torch.Tensor) -> torch.Tensor:
        """Per window and triangle T^T, (W, T, 3, 3)."""
        n, nt = scale.shape[0], self.n_tris
        d = scale.reshape(n, nt, 6)
        r = rotat.reshape(n, nt, 3)
        s = torch.stack([d[..., 0] + 1, d[..., 1], d[..., 2],
                         d[..., 1], d[..., 3] + 1, d[..., 4],
                         d[..., 2], d[..., 4], d[..., 5] + 1], -1).reshape(n, nt, 3, 3)
        w = torch.stack([-r[..., 2], r[..., 1], -r[..., 0]], -1)
        angle = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        axis = torch.where(angle >= 1e-6, w / torch.clamp(angle, min=1e-30), torch.zeros_like(w))
        z = torch.zeros_like(axis[..., 0])
        k = torch.stack([z, -axis[..., 2], axis[..., 1],
                         axis[..., 2], z, -axis[..., 0],
                         -axis[..., 1], axis[..., 0], z], -1).reshape(n, nt, 3, 3)
        eye = torch.eye(3, device=scale.device, dtype=scale.dtype)
        sa = torch.sin(angle)[..., None]
        ca = (1 - torch.cos(angle))[..., None]
        rot = eye + sa * k + ca * (k @ k)
        return (rot @ s).transpose(-1, -2)

    def decode(self, heads) -> torch.Tensor:
        """Head outputs → vertices (W, V, 3)."""
        scale = heads["scale"] @ self.pca["scale"][0].T + self.pca["scale"][1]
        rotat = heads["rotat"] @ self.pca["rotat"][0].T + self.pca["rotat"][1]
        tt = self.transforms_t(scale, rotat)  # (W, T, 3, 3): row c of equation j is T^T[c]
        y = tt.reshape(len(tt), 3 * self.n_tris, 3) - self.y0
        rhs = self.at @ y  # (W, n_free, 3)
        x = torch.cholesky_solve(rhs, self.chol)
        out = self.template.expand(len(tt), -1, -1).clone()
        out[:, self.free_t] = x
        return out

    def vertices(self, clip: np.ndarray, speaker: int, block: int = 256) -> np.ndarray:
        """(W, V, 3) float64 vertices of every window of a clip."""
        heads = self.net.coefficients(clip, speaker)
        with tf32_mode(self.tf32), torch.no_grad():
            n = len(heads["scale"])
            return np.concatenate([
                self.decode({k: v[i:i + block] for k, v in heads.items()}).double().cpu().numpy()
                for i in range(0, n, block)])
