"""Batched SO(3) exponential and logarithm maps (counterpart of
``sdfa_tpu/ops/rotation.py``): torch tensors of any float dtype on any
device, any leading batch dimensions. The conventions and the 1e-6
tolerance are the reference C++'s:

- skew(a) = [[0,-a2,a1],[a2,0,-a0],[-a1,a0,0]]
- exp: Rodrigues; angle < tol → identity
- log: angle = acos((tr-1)/2); near 0 → zero; near π the axis from the
  diagonal of (R+I)/2 with consistent signs.

The dgrad layout packs the log-rotation entries as (d6, d7, d8) =
(logR[0,1], logR[0,2], logR[1,2]), i.e. the rotation vector ω = (−d8, d7, −d6).
"""

from __future__ import annotations

import math

import torch

TOL = 1e-6


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vector → (..., 3, 3) skew matrix."""
    a0, a1, a2 = w.unbind(-1)
    zero = torch.zeros_like(a0)
    return torch.stack([torch.stack([zero, -a2, a1], -1),
                        torch.stack([a2, zero, -a0], -1),
                        torch.stack([-a1, a0, zero], -1)], -2)


def unskew(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew matrix → (..., 3) rotation vector."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exp of rotation vectors (..., 3) → (..., 3, 3)."""
    angle = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    small = angle < TOL
    k = skew(w / torch.where(small, torch.ones_like(angle), angle))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    rot = eye + torch.sin(angle)[..., None] * k + (1.0 - torch.cos(angle))[..., None] * (k @ k)
    return torch.where(small[..., None], eye, rot)


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """Matrix log of rotations (..., 3, 3) → rotation vectors (..., 3): zero
    near the identity; near π (within 1e-4) the sign-consistent square roots
    of the diagonal of (R+I)/2; otherwise the skew-part formula."""
    tr = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    angle = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    near_zero = angle.abs() < TOL
    near_pi = (angle - math.pi).abs() < 1e-4

    taxis = torch.stack([rot[..., 2, 1] - rot[..., 1, 2],
                         rot[..., 0, 2] - rot[..., 2, 0],
                         rot[..., 1, 0] - rot[..., 0, 1]], -1)
    sin_safe = torch.where(near_zero | near_pi, torch.ones_like(angle), torch.sin(angle))
    axis_gen = taxis / (2.0 * sin_safe[..., None])

    b = (rot + torch.eye(3, dtype=rot.dtype, device=rot.device)) / 2.0
    diag = torch.clamp(torch.diagonal(b, dim1=-2, dim2=-1), min=0.0)
    k1 = torch.sqrt(diag[..., 0])
    one = torch.ones_like(k1)
    k2 = torch.where(k1 * b[..., 0, 1] > 0, one, -one) * torch.sqrt(diag[..., 1])
    k3 = torch.where(k1 * b[..., 0, 2] > 0, one, -one) * torch.sqrt(diag[..., 2])
    axis = torch.where(near_pi[..., None], torch.stack([k1, k2, k3], -1), axis_gen)
    w = axis * angle[..., None]
    return torch.where(near_zero[..., None], torch.zeros_like(w), w)


def dgrad_rotvec_to_entries(w: torch.Tensor) -> torch.Tensor:
    """rotvec (..., 3) → dgrad rotation entries (d6, d7, d8)."""
    return torch.stack([-w[..., 2], w[..., 1], -w[..., 0]], -1)


def dgrad_entries_to_rotvec(d: torch.Tensor) -> torch.Tensor:
    """dgrad rotation entries (d6, d7, d8) → rotvec (..., 3)."""
    return torch.stack([-d[..., 2], d[..., 1], -d[..., 0]], -1)
