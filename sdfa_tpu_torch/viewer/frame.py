"""Template state and prediction → mesh reconstruction (counterpart of
``sdfa_tpu/viewer/frame.py``). The template comes as arrays (a caller's own,
or ``mesh.synthetic_template()``) or as paths: a ``.ply`` / ``.obj`` mesh and a
file of constrained vertex ids, as the CLI's ``--template_mesh`` /
``--mesh_constraints`` name them. There is no default template: the FLAME
template is not part of this repository, so with neither the caller is told
to pass ``--template_mesh``.

``frames_to_meshes`` is the round-trip path (prediction frames on the host →
vertices): dgrad frames go through the direct solve ``ops.solve_fn`` on the
device the caller names, in bounded chunks; offsets add to the template;
positions pass through.
"""

from __future__ import annotations

import ast
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..mesh import io as mesh_io
from ..ops.deform_solver import DeformConsts, DeformationSolver, solve_fn

log = logging.getLogger(__name__)

SOLVE_CHUNK = 256  # frames per solve call: about 40 live (frames, n_tris) float32 temporaries

_state = dict(solver=None, verts=None, faces=None, consts={})


def default_constraints(template_path: str) -> np.ndarray:
    """FLAME's non-face vertex ids, for a template in the VOCASET layout
    (``template/FLAME_sample.ply`` beside ``mask/non_face.py``): the mask's
    ``non_face_verts`` list, read as data, never run. None, with a warning,
    where the mask is absent."""
    vocaset = os.path.dirname(os.path.dirname(os.path.abspath(template_path)))
    path = os.path.join(vocaset, "mask", "non_face.py")
    if not os.path.exists(path):
        log.warning("non-face mask not found; using no constraints")
        return np.asarray([], np.int64)
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "non_face_verts" for t in node.targets):
            return np.asarray(ast.literal_eval(node.value), np.int64)
    raise ValueError(f"{path} assigns no literal non_face_verts list")


def set_template_mesh(verts: Optional[np.ndarray] = None, faces: Optional[np.ndarray] = None,
                      cnst_ids: Optional[np.ndarray] = None, *,
                      template_path: Optional[str] = None,
                      constraints_path: Optional[str] = None,
                      corres_path: Optional[str] = None, reg: float = 1e-10) -> DeformationSolver:
    """Install the template and prefactorize its solver (float64 host build).

    Either arrays (``verts``, ``faces``, ``cnst_ids``) or paths: a mesh file
    (``template_path``) and a constraints file (``constraints_path``, else
    ``default_constraints(template_path)``)."""
    if corres_path is not None:
        raise NotImplementedError(
            "triangle correspondences (--mesh_tricorres) are not ported: the solver's "
            "fan-out equations are ROADMAP queue A, item 8")
    if verts is None:
        if faces is not None or cnst_ids is not None:
            raise ValueError("faces / cnst_ids given without verts")
        if template_path is None or not os.path.exists(template_path):
            raise FileNotFoundError(
                f"no template mesh{f' at {template_path}' if template_path else ''}: pass "
                "--template_mesh <.ply or .obj> (and --mesh_constraints <vertex ids>), or "
                "set_template_mesh(template_path=...)")
        verts, faces = mesh_io.read_mesh(template_path, dtype=np.float64)
        if constraints_path is not None:  # vertex ids separated by white space
            with open(constraints_path) as fp:
                cnst_ids = np.asarray([int(t) for t in fp.read().split()], np.int64)
        else:
            cnst_ids = default_constraints(template_path)
    elif template_path is not None or constraints_path is not None:
        raise ValueError("pass the template as arrays or as paths, not both")
    solver = DeformationSolver(verts, faces, cnst_indices=cnst_ids, reg=reg)
    _state.update(solver=solver, verts=np.asarray(verts, np.float32).reshape(-1, 3),
                  faces=np.asarray(faces, np.int64).reshape(-1, 3), consts={})
    return solver


def get_solver() -> DeformationSolver:
    """The installed solver; with none installed, ``set_template_mesh()``'s
    ``FileNotFoundError`` that names ``--template_mesh``."""
    if _state["solver"] is None:
        set_template_mesh()
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
