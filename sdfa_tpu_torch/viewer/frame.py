"""Template state (counterpart of ``sdfa_tpu/viewer/frame.py``): the mesh
the deformation solver is prefactorized for. Takes arrays, not a path —
the FLAME template and its non-face mask are not part of the repository,
so callers pass them (or ``mesh.synthetic_template()``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.deform_solver import DeformationSolver

_state = dict(solver=None)


def set_template_mesh(verts: np.ndarray, faces: np.ndarray,
                      cnst_ids: Optional[np.ndarray] = None) -> DeformationSolver:
    """Install the template and prefactorize its solver (float64 host build)."""
    solver = DeformationSolver(verts, faces, cnst_indices=cnst_ids)
    _state["solver"] = solver
    return solver


def get_solver() -> DeformationSolver:
    if _state["solver"] is None:
        raise RuntimeError("no template mesh: call set_template_mesh(verts, faces, cnst_ids)")
    return _state["solver"]

