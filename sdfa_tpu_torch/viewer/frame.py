"""Template state and prediction → mesh reconstruction (counterpart of
``sdfa_tpu/viewer/frame.py``). The template comes as arrays, not a path —
the FLAME template and its non-face mask are not part of the repository,
so callers pass them (or ``mesh.synthetic_template()``).

``frames_to_meshes`` is the round-trip path (prediction frames on the host →
vertices): dgrad frames go through the direct solve ``ops.solve_fn`` on the
device the caller names, in bounded chunks; offsets add to the template;
positions pass through.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.deform_solver import DeformConsts, DeformationSolver, solve_fn

SOLVE_CHUNK = 256  # frames per solve call: about 40 live (frames, n_tris) float32 temporaries

_state = dict(solver=None, verts=None, faces=None, consts={})


def set_template_mesh(verts: np.ndarray, faces: np.ndarray,
                      cnst_ids: Optional[np.ndarray] = None) -> DeformationSolver:
    """Install the template and prefactorize its solver (float64 host build)."""
    solver = DeformationSolver(verts, faces, cnst_indices=cnst_ids)
    _state.update(solver=solver, verts=np.asarray(verts, np.float32).reshape(-1, 3),
                  faces=np.asarray(faces, np.int64).reshape(-1, 3), consts={})
    return solver


def get_solver() -> DeformationSolver:
    if _state["solver"] is None:
        raise RuntimeError("no template mesh: call set_template_mesh(verts, faces, cnst_ids)")
    return _state["solver"]


def device_consts(device) -> DeformConsts:
    """The installed solver's direct-solve constants on ``device``, uploaded
    once per device and template."""
    solver, device = get_solver(), torch.device(device)
    if device not in _state["consts"]:
        _state["consts"][device] = solver.device_consts(device)
    return _state["consts"][device]


def template() -> Tuple[np.ndarray, np.ndarray]:
    """(verts (V, 3) float32, faces (F, 3)) of the installed template."""
    get_solver()
    return _state["verts"], _state["faces"]


@torch.inference_mode()
def frames_to_meshes(data_frames: np.ndarray, face_data_type,
                     device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Batched (N, D) prediction frames → (N, V, 3) vertices + (F, 3) faces.
    ``face_data_type``: "dgrad_3d" (frames in the reference layout
    [tri·9 + k], solved on ``device``), "verts_off_3d" or "verts_pos_3d"."""
    name = getattr(face_data_type, "name", face_data_type)
    verts_t, faces = template()
    data_frames = np.asarray(data_frames, np.float32)
    if data_frames.ndim == 1:
        data_frames = data_frames[None]
    n = len(data_frames)
    if name == "dgrad_3d":
        solver = get_solver()
        if data_frames.shape[-1] != solver.n_tris * 9:
            raise ValueError(f"dgrad frame must have {solver.n_tris * 9} floats, "
                             f"got {data_frames.shape[-1]}")
        consts = device_consts(device)
        out = np.empty((n, solver.n_verts, 3), np.float32)
        for i in range(0, n, SOLVE_CHUNK):
            chunk = torch.from_numpy(data_frames[i:i + SOLVE_CHUNK]).to(device)
            planes = chunk.reshape(len(chunk), -1, 9).transpose(1, 2).reshape(len(chunk), -1)
            out[i:i + SOLVE_CHUNK] = solve_fn(consts, planes, consts.template_cnst,
                                              solver.spec).cpu().numpy()
        return out, faces
    if name == "verts_off_3d":
        return data_frames.reshape(n, -1, 3) + verts_t[None], faces
    if name == "verts_pos_3d":
        return data_frames.reshape(n, -1, 3), faces
    raise NotImplementedError(str(face_data_type))


def frame_to_mesh(data_frame: np.ndarray, face_data_type,
                  device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Single-frame convenience wrapper."""
    verts, faces = frames_to_meshes(np.asarray(data_frame)[None], face_data_type, device)
    return verts[0], faces
