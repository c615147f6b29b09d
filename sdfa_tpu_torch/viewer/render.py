"""Offscreen mesh renderer (counterpart of ``sdfa_tpu/viewer/render.py``,
copied): a numpy painter's-algorithm rasterizer with Lambertian shading, the
triangles filled by OpenCV. OpenCV is imported inside the function: the
package imports without it."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def render_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    image_size: Tuple[int, int] = (512, 512),
    background: float = 0.15,
) -> np.ndarray:
    """(V, 3), (F, 3) → uint8 (H, W, 3) front view (−z camera)."""
    import cv2

    h, w = image_size
    v = np.asarray(verts, np.float64).copy()
    # centre, and scale the larger of x and y to 0.85 of the half-width
    v -= v.mean(axis=0)
    scale = 0.85 / max(np.abs(v[:, :2]).max(), 1e-9)
    v *= scale

    tri = v[faces]  # (F, 3, 3)
    # Lambertian shading from a headlight and a top-left key light
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    light1 = np.array([0.0, 0.0, 1.0])
    light2 = np.array([-0.4, 0.6, 0.7])
    light2 = light2 / np.linalg.norm(light2)
    shade = 0.65 * np.clip(n @ light1, 0, 1) + 0.35 * np.clip(n @ light2, 0, 1)
    shade = 0.12 + 0.88 * shade

    # screen coordinates
    xy = tri[:, :, :2].copy()
    xy[:, :, 0] = (xy[:, :, 0] * 0.5 + 0.5) * (w - 1)
    xy[:, :, 1] = (1.0 - (xy[:, :, 1] * 0.5 + 0.5)) * (h - 1)
    depth = tri[:, :, 2].mean(axis=1)

    # back-face culling, then far to near
    visible = n[:, 2] > 0
    order = np.argsort(depth[visible])
    idx = np.nonzero(visible)[0][order]

    img = np.full((h, w, 3), int(background * 255), np.uint8)
    pts = xy[idx].astype(np.int32)
    cols = (shade[idx, None] * np.array([230, 212, 200])[None, :]).astype(np.uint8)
    for p, c in zip(pts, cols):
        cv2.fillConvexPoly(img, p, c.tolist(), lineType=cv2.LINE_8)
    return img
