"""Template state and prediction → mesh reconstruction (counterpart of
``sdfa_tpu/viewer/frame.py``). The template comes as arrays (a caller's own,
or ``mesh.synthetic_template()``) or as paths: a ``.ply`` / ``.obj`` mesh and a
file of constrained vertex ids, as the CLI's ``--template_mesh`` /
``--mesh_constraints`` name them. There is no default template: the FLAME
template is not part of this repository, so with neither the caller is told
to pass ``--template_mesh``.

``frames_to_meshes`` is the round-trip path (prediction frames on the host →
vertices): dgrad frames go through the direct solve ``ops.solve_fn`` (with
the equation gather of a correspondence table) on the device the caller
names, in bounded chunks; offsets add to the template; positions pass
through.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.vocaset import config as vocaset_config
from ..mesh import io as mesh_io
from ..ops.deform_solver import DeformConsts, DeformationSolver, solve_fn

log = logging.getLogger(__name__)

SOLVE_CHUNK = 256  # frames per solve call: about 40 live (frames, n_tris) float32 temporaries

_state = dict(solver=None, verts=None, faces=None)


def default_constraints(template_path: str) -> np.ndarray:
    """FLAME's non-face vertex ids, for a template in the VOCASET layout
    (``template/FLAME_sample.ply`` beside ``mask/non_face.py``): the mask's
    ``non_face_verts`` list, read as data, never run. None, with a warning,
    where the mask is absent."""
    path = vocaset_config.mask_path(template_path)
    if not os.path.exists(path):
        log.warning("non-face mask not found; using no constraints")
        return np.asarray([], np.int64)
    return vocaset_config.read_mask(path, "non_face_verts")


def read_correspondences(path: str, n_tris: int):
    """(corr_count, corr_faces) of a triangle-correspondence file in the
    reference's format: a count line, then that many ``src,dst,_`` rows (the
    target triangle ``dst`` takes source triangle ``src``); a target triangle
    with no row gets count 0 and one placeholder. A malformed line raises
    ``ValueError`` naming it."""
    sources = {}
    with open(path) as fp:
        lines = fp.read().splitlines()
    if not lines:
        raise ValueError(f"{path}: empty correspondence file")
    try:
        count = int(lines[0].strip())
    except ValueError:
        raise ValueError(f"{path}:1: expected the row count, got {lines[0]!r}") from None
    if len(lines) - 1 < count:
        raise ValueError(f"{path}: {count} rows announced, {len(lines) - 1} present")
    for no, line in enumerate(lines[1:count + 1], start=2):
        parts = line.strip().split(",")
        try:
            src, dst = int(parts[0]), int(parts[1])
        except (ValueError, IndexError):
            raise ValueError(f"{path}:{no}: expected 'src,dst,_', got {line!r}") from None
        if len(parts) != 3 or not (0 <= dst < n_tris):
            raise ValueError(f"{path}:{no}: expected 'src,dst,_' with a target triangle "
                             f"in 0..{n_tris - 1}, got {line!r}")
        sources.setdefault(dst, []).append(src)
    corr_count, corr_faces = [], []
    for i in range(n_tris):
        src = sources.get(i)
        corr_count.append(len(src) if src else 0)
        corr_faces.extend(src if src else [0])
    return corr_count, corr_faces


def set_template_mesh(verts: Optional[np.ndarray] = None, faces: Optional[np.ndarray] = None,
                      cnst_ids: Optional[np.ndarray] = None, *,
                      template_path: Optional[str] = None,
                      constraints_path: Optional[str] = None,
                      corres_path: Optional[str] = None, reg: float = 1e-10) -> DeformationSolver:
    """Install the template and prefactorize its solver (float64 host build).

    Either arrays (``verts``, ``faces``, ``cnst_ids``) or paths: a mesh file
    (``template_path``) and a constraints file (``constraints_path``, else
    ``default_constraints(template_path)``). ``corres_path``: triangle
    correspondences onto this template (``read_correspondences``) for
    cross-topology retargeting; the dgrad frames then still have the
    template's triangle count, and each equation reads its source's."""
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
    corr_count = corr_faces = None
    if corres_path is not None:
        corr_count, corr_faces = read_correspondences(corres_path, len(np.reshape(faces, (-1, 3))))
    solver = DeformationSolver(verts, faces, cnst_indices=cnst_ids, corr_count=corr_count,
                               corr_faces=corr_faces, reg=reg)
    _state.update(solver=solver, verts=np.asarray(verts, np.float32).reshape(-1, 3),
                  faces=np.asarray(faces, np.int64).reshape(-1, 3))
    return solver


def get_solver() -> DeformationSolver:
    """The installed solver; with none installed, ``set_template_mesh()``'s
    ``FileNotFoundError`` that names ``--template_mesh``."""
    if _state["solver"] is None:
        set_template_mesh()
    return _state["solver"]


def device_consts(device) -> DeformConsts:
    """The installed solver's constants on ``device``, uploaded once per
    device and template."""
    return get_solver().device_consts(device)


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
