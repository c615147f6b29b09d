"""Batched deformation-gradient extraction and reconstruction at triangle
level (counterpart of ``sdfa_tpu/ops/dgrad.py``): torch, vectorized over
triangles and any leading batch dimensions, on any device.

- extraction: edge frames with a |cross|^(1/2) third edge and a degeneracy
  guard, the affine T = Mb·Ma⁻¹, its polar decomposition through the SVD
  into a symmetric scale (6 values, diagonal − 1) and a rotation log (3
  values): 9 floats a triangle.
- reconstruction: T = exp(skew(r))·S, returned transposed for the
  least-squares right-hand side.

``deformation_gradients_f64`` is the preprocessing-grade extraction in
float64, batched over frames × triangles, that ``data.vocaset.preload``
runs on the card; ``deformation_gradients_np`` is its numpy plain version
(the JAX package's, copied), which the tests and ``chip_smoke.py`` hold it
against. Only the polar factors and the packed gradients are compared: the
signs and order of the SVD's vectors differ between cuSOLVER and LAPACK,
its polar factors of a non-degenerate T do not. Both take the same branches
(degenerate frames, the 1e-6 rad cut under which a rotation log is zero, the
axis near π) with the same formulas; a triangle whose rotation lies within
about 0.1% of the cut may still land on either side of it in the two
libraries, since the cut reads the angle from arccos((tr R − 1) / 2), whose
float64 value is good to about that near 1e-6 rad (``rotation_cut_flips``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rotation

EPS_DEFAULT = 1e-6
# frames × triangles per batch of the float64 extraction: about 12 live
# (n, 3, 3) float64 temporaries, under 1 GB at this size (105 frames at
# FLAME's 9976 triangles; a VOCASET sentence is up to about 420)
F64_BATCH = 1 << 20


def _edge3(e1: torch.Tensor, e2: torch.Tensor, eps: float):
    """Third-edge vector and validity flag of each triangle."""
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    len12 = torch.linalg.vector_norm(e1, dim=-1) * torch.linalg.vector_norm(e2, dim=-1)
    denom = torch.where(len12 == 0, torch.ones_like(len12), len12)
    valid = ((e1 * e2).sum(-1) / denom).abs() <= (1.0 - eps)
    norm = torch.pow((e3 * e3).sum(-1), 0.25)
    return e3 / torch.clamp(norm, min=eps)[..., None], valid


def triangle_frames(verts: torch.Tensor, faces: torch.Tensor, eps: float = EPS_DEFAULT):
    """(..., V, 3), (F, 3) → edge-frame matrices (..., F, 3, 3) (columns
    e1, e2, e3) and validity flags (..., F)."""
    faces = torch.as_tensor(faces, dtype=torch.long, device=verts.device)
    v1, v2, v3 = (verts.index_select(-2, faces[:, i]) for i in range(3))
    e1, e2 = v2 - v1, v3 - v1
    e3, valid = _edge3(e1, e2, eps)
    return torch.stack([e1, e2, e3], -1), valid


def _affine(src_verts, dst_verts, faces, eps):
    """T = Mb·Ma⁻¹ per triangle and the validity of both frames."""
    ma, ok_a = triangle_frames(src_verts, faces, eps)
    mb, ok_b = triangle_frames(dst_verts, faces, eps)
    inv_a, _ = torch.linalg.inv_ex(ma)  # a degenerate frame is masked by the caller
    return mb @ inv_a, ok_a & ok_b


def deformation_gradients(src_verts: torch.Tensor, dst_verts: torch.Tensor, faces,
                          eps: float = EPS_DEFAULT) -> torch.Tensor:
    """Per-triangle 9-float deformation gradients in the inputs' dtype (the
    JAX package's float32 path); (..., V, 3) → (..., F, 9). Degenerate source
    or target triangles give zero gradients, as the reference does."""
    t, valid = _affine(src_verts, dst_verts, faces, eps)
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    t = torch.where(valid[..., None, None], t, eye)  # no NaN into the SVD
    u, s, vt = torch.linalg.svd(t)
    v = vt.transpose(-1, -2)
    det = torch.linalg.det(u @ vt)
    temp_diag = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    rot = (u * temp_diag[..., None, :]) @ vt
    scale = (v * (temp_diag * s)[..., None, :]) @ vt
    rot_entries = rotation.dgrad_rotvec_to_entries(rotation.so3_log(rot))
    grad = torch.cat([scale[..., 0, 0, None] - 1.0, scale[..., 0, 1, None],
                      scale[..., 0, 2, None], scale[..., 1, 1, None] - 1.0,
                      scale[..., 1, 2, None], scale[..., 2, 2, None] - 1.0, rot_entries], -1)
    return torch.where(valid[..., None], grad, torch.zeros_like(grad))


def dgrad_to_transforms_t(dgrad: torch.Tensor) -> torch.Tensor:
    """dgrad (..., F, 9) → transposed transforms (..., F, 3, 3):
    (exp(skew)·S)ᵀ, the rows fed into the least-squares right-hand side."""
    d = dgrad
    s = torch.stack([torch.stack([d[..., 0] + 1.0, d[..., 1], d[..., 2]], -1),
                     torch.stack([d[..., 1], d[..., 3] + 1.0, d[..., 4]], -1),
                     torch.stack([d[..., 2], d[..., 4], d[..., 5] + 1.0], -1)], -2)
    r = rotation.so3_exp(rotation.dgrad_entries_to_rotvec(d[..., 6:9]))
    return (r @ s).transpose(-1, -2)


def deformation_matrices(src_verts: torch.Tensor, dst_verts: torch.Tensor, faces,
                         eps: float = EPS_DEFAULT) -> torch.Tensor:
    """Raw per-triangle affine transforms (..., F, 3, 3); degenerate → I
    (the reference's getDeformationMatrix)."""
    t, valid = _affine(src_verts, dst_verts, faces, eps)
    return torch.where(valid[..., None, None], t, torch.eye(3, dtype=t.dtype, device=t.device))


def _polar_log_f64(t: torch.Tensor) -> torch.Tensor:
    """float64 T (n, 3, 3) → packed gradients (n, 9): the numpy plain
    version's arithmetic, with its branches as masks (rotation log zero
    below 1e-6 rad; the axis from (R+I)/2 within 1e-6 of π)."""
    u, s, vt = torch.linalg.svd(t)
    det = torch.linalg.det(u @ vt)
    tmp = torch.eye(3, dtype=t.dtype, device=t.device).repeat(len(t), 1, 1)
    tmp[:, 2, 2] = det
    rot = u @ tmp @ vt
    scale = vt.transpose(1, 2) @ tmp @ (s[..., None] * vt)
    tr = rot[:, 0, 0] + rot[:, 1, 1] + rot[:, 2, 2]
    ang = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    taxis = torch.stack([rot[:, 2, 1] - rot[:, 1, 2], rot[:, 0, 2] - rot[:, 2, 0],
                         rot[:, 1, 0] - rot[:, 0, 1]], -1)
    sin = torch.sin(ang)
    sin_safe = torch.where(sin.abs() < 1e-12, torch.ones_like(sin), sin)
    wvec = taxis / (2.0 * sin_safe[:, None]) * ang[:, None]
    wvec = torch.where((ang < 1e-6)[:, None], torch.zeros_like(wvec), wvec)
    b = (rot + torch.eye(3, dtype=t.dtype, device=t.device)) / 2.0
    k1 = torch.sqrt(torch.clamp(b[:, 0, 0], min=0))
    one = torch.ones_like(k1)
    k2 = torch.where(k1 * b[:, 0, 1] > 0, one, -one) * torch.sqrt(torch.clamp(b[:, 1, 1], min=0))
    k3 = torch.where(k1 * b[:, 0, 2] > 0, one, -one) * torch.sqrt(torch.clamp(b[:, 2, 2], min=0))
    near_pi = ((ang - math.pi).abs() < 1e-6)[:, None]
    wvec = torch.where(near_pi, torch.stack([k1, k2, k3], -1) * math.pi, wvec)
    return torch.stack([scale[:, 0, 0] - 1.0, scale[:, 0, 1], scale[:, 0, 2],
                        scale[:, 1, 1] - 1.0, scale[:, 1, 2], scale[:, 2, 2] - 1.0,
                        -wvec[:, 2], wvec[:, 1], -wvec[:, 0]], -1)


def deformation_gradients_f64(src_verts: torch.Tensor, dst_verts: torch.Tensor, faces,
                              eps: float = EPS_DEFAULT) -> torch.Tensor:
    """The preprocessing-grade extraction in float64 on the inputs' device:
    src (V, 3), dst (..., V, 3) frames → (..., F, 9) float64, degenerate
    triangles zero. Batched over frames × triangles, ``F64_BATCH`` at a time;
    ``deformation_gradients_np`` is its plain version."""
    src = src_verts.to(torch.float64).reshape(-1, 3)
    dst = dst_verts.to(torch.float64)
    lead = dst.shape[:-2]
    dst = dst.reshape(-1, src.shape[0], 3)
    ma, ok_a = triangle_frames(src, faces, eps)
    inv_a, _ = torch.linalg.inv_ex(ma)
    n_tris = ma.shape[0]
    eye = torch.eye(3, dtype=torch.float64, device=src.device)
    out = torch.empty(len(dst), n_tris, 9, dtype=torch.float64, device=src.device)
    step = max(1, F64_BATCH // max(n_tris, 1))
    for i in range(0, len(dst), step):
        mb, ok_b = triangle_frames(dst[i:i + step], faces, eps)
        valid = ok_a & ok_b  # (frames, F)
        t = torch.where(valid[..., None, None], mb @ inv_a, eye)  # no NaN into the SVD
        g = _polar_log_f64(t.reshape(-1, 3, 3)).reshape(len(mb), n_tris, 9)
        out[i:i + step] = torch.where(valid[..., None], g, torch.zeros_like(g))
    return out.reshape(lead + (n_tris, 9))


def deformation_gradients_np(src_verts, dst_verts, faces, eps: float = EPS_DEFAULT):
    """float64 numpy extraction of one frame (the JAX package's, copied):
    the plain version of ``deformation_gradients_f64``."""
    src = np.asarray(src_verts, np.float64).reshape(-1, 3)
    dst = np.asarray(dst_verts, np.float64).reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)

    def frame(a1, a2):
        e3 = np.cross(a1, a2)
        len1 = np.linalg.norm(a1, axis=-1)
        len2 = np.linalg.norm(a2, axis=-1)
        denom = np.where(len1 * len2 == 0, 1.0, len1 * len2)
        cos = np.abs(np.sum(a1 * a2, axis=-1) / denom)
        valid = cos <= (1.0 - eps)
        norm = (np.sum(e3 * e3, axis=-1)) ** 0.25
        e3 = e3 / np.maximum(norm, eps)[:, None]
        return np.stack([a1, a2, e3], axis=-1), valid

    v1, v2, v3 = (src[faces[:, i]] for i in range(3))
    w1, w2, w3 = (dst[faces[:, i]] for i in range(3))
    ma, ok_a = frame(v2 - v1, v3 - v1)
    mb, ok_b = frame(w2 - w1, w3 - w1)
    t = mb @ np.linalg.inv(ma)
    u, s, vt = np.linalg.svd(t)
    det = np.linalg.det(u @ vt)
    tmp = np.tile(np.eye(3), (len(t), 1, 1))
    tmp[:, 2, 2] = det
    rot = u @ tmp @ vt
    scale = np.swapaxes(vt, 1, 2) @ tmp @ (s[..., None] * vt)
    tr = np.trace(rot, axis1=1, axis2=2)
    csin = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    ang = np.arccos(csin)
    taxis = np.stack([rot[:, 2, 1] - rot[:, 1, 2], rot[:, 0, 2] - rot[:, 2, 0],
                      rot[:, 1, 0] - rot[:, 0, 1]], axis=-1)
    sin_safe = np.where(np.abs(np.sin(ang)) < 1e-12, 1.0, np.sin(ang))
    wvec = taxis / (2.0 * sin_safe[:, None]) * ang[:, None]
    wvec[ang < 1e-6] = 0.0
    near_pi = np.abs(ang - np.pi) < 1e-6
    if near_pi.any():
        b = (rot[near_pi] + np.eye(3)) / 2.0
        k1 = np.sqrt(np.clip(b[:, 0, 0], 0, None))
        k2 = np.where(k1 * b[:, 0, 1] > 0, 1.0, -1.0) * np.sqrt(np.clip(b[:, 1, 1], 0, None))
        k3 = np.where(k1 * b[:, 0, 2] > 0, 1.0, -1.0) * np.sqrt(np.clip(b[:, 2, 2], 0, None))
        wvec[near_pi] = np.stack([k1, k2, k3], axis=-1) * np.pi

    g = np.zeros((len(t), 9))
    g[:, 0] = scale[:, 0, 0] - 1.0
    g[:, 1] = scale[:, 0, 1]
    g[:, 2] = scale[:, 0, 2]
    g[:, 3] = scale[:, 1, 1] - 1.0
    g[:, 4] = scale[:, 1, 2]
    g[:, 5] = scale[:, 2, 2] - 1.0
    g[:, 6] = -wvec[:, 2]
    g[:, 7] = wvec[:, 1]
    g[:, 8] = -wvec[:, 0]
    g[~(ok_a & ok_b)] = 0.0
    return g


def rotation_cut_flips(a: np.ndarray, b: np.ndarray, cut: float = 1e-6) -> np.ndarray:
    """Triangles (rows of two (F, 9) extractions of the same frame) whose
    rotation log one side zeroed under the cut and the other kept, the kept
    one within 1% of the cut: there the two differ by at most 1.01·cut in
    the rotation entries and agree elsewhere."""
    ra, rb = np.asarray(a)[:, 6:], np.asarray(b)[:, 6:]
    one_zeroed = (ra == 0).all(1) != (rb == 0).all(1)
    norm = np.maximum(np.linalg.norm(ra, axis=1), np.linalg.norm(rb, axis=1))
    return one_zeroed & (norm <= 1.01 * cut)
