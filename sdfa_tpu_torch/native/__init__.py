"""ctypes binding for the native float64 deformation runtime (counterpart of
``sdfa_tpu/native/__init__.py``).

The port's own copy of the C++ runtime, ``sdfa_tpu_torch/csrc/deformation.cpp``
(the JAX package's ``csrc/deformation.cpp`` but for its header comment), is
built by the host's C++ compiler with ``csrc/Makefile``'s flags on first use,
into the git-ignored ``build/sdfa_tpu_torch/`` (``ops/build.py``), and loaded
with ctypes. It is a CPU library, not a kernel: the independent float64
oracle that the port's solver and its K3 kernel are held to. Public surface
as the reference pybind module's (pybind.cpp:129-153): ``set_target``,
``is_same``, ``get_deform_grad``, ``get_mesh`` and ``get_deform_mat`` /
``get_mesh_from_dm``, with the batched ``get_meshes`` /
``get_meshes_from_dm``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..ops import build

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load_host_library("deformation")
    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_int64_p = ctypes.POINTER(ctypes.c_int64)
    lib.sdfa_set_target.argtypes = [c_double_p, ctypes.c_int, c_int64_p,
                                    ctypes.c_int, c_int64_p, ctypes.c_int,
                                    ctypes.c_double]
    lib.sdfa_set_target.restype = ctypes.c_int
    lib.sdfa_is_same.argtypes = [ctypes.c_int] * 3
    lib.sdfa_is_same.restype = ctypes.c_int
    lib.sdfa_get_deform_grad.argtypes = [c_double_p, c_double_p, ctypes.c_int,
                                         c_int64_p, ctypes.c_int,
                                         ctypes.c_double, c_float_p]
    lib.sdfa_get_deform_grad.restype = ctypes.c_int
    lib.sdfa_get_mesh_from_dgrad.argtypes = [c_float_p, ctypes.c_int,
                                             c_double_p, c_double_p]
    lib.sdfa_get_mesh_from_dgrad.restype = ctypes.c_int
    lib.sdfa_get_deform_mat.argtypes = [c_double_p, c_double_p, ctypes.c_int,
                                        c_int64_p, ctypes.c_int,
                                        ctypes.c_double, c_float_p]
    lib.sdfa_get_deform_mat.restype = ctypes.c_int
    lib.sdfa_get_mesh_from_dm.argtypes = [c_float_p, ctypes.c_int,
                                          c_double_p, c_double_p]
    lib.sdfa_get_mesh_from_dm.restype = ctypes.c_int
    for name in ("sdfa_n_free", "sdfa_n_tris"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    _lib = lib
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def set_target(verts, faces, cnsts=None, reg: float = 1e-10) -> bool:
    lib = _load()
    verts = np.ascontiguousarray(np.asarray(verts, np.float64).reshape(-1, 3))
    faces = np.ascontiguousarray(np.asarray(faces, np.int64).reshape(-1, 3))
    cnsts = np.ascontiguousarray(np.asarray(
        cnsts if cnsts is not None else [], np.int64).reshape(-1))
    ok = lib.sdfa_set_target(_dptr(verts), len(verts), _iptr(faces), len(faces),
                             _iptr(cnsts), len(cnsts), reg)
    return bool(ok)


def is_same(n_verts: int, n_tris: int, n_cnsts: int) -> bool:
    return bool(_load().sdfa_is_same(n_verts, n_tris, n_cnsts))


def get_deform_grad(verts_a, verts_b, faces, eps: float = 1e-6) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(np.asarray(verts_a, np.float64).reshape(-1, 3))
    b = np.ascontiguousarray(np.asarray(verts_b, np.float64).reshape(-1, 3))
    faces = np.ascontiguousarray(np.asarray(faces, np.int64).reshape(-1, 3))
    out = np.empty((len(faces), 9), np.float32)
    ok = lib.sdfa_get_deform_grad(_dptr(a), _dptr(b), len(a), _iptr(faces),
                                  len(faces), eps, _fptr(out))
    if not ok:
        raise RuntimeError("get_deform_grad failed")
    return out


def get_meshes(dgrad, n_verts: int, cnst_verts: Optional[np.ndarray] = None) -> np.ndarray:
    """Batched: (F?, n_tris·9) → (F?, n_verts, 3)."""
    lib = _load()
    n_tris = lib.sdfa_n_tris()
    if n_tris <= 0:
        raise RuntimeError("set_target must be called first")
    dgrad = np.ascontiguousarray(np.asarray(dgrad, np.float32))
    frame_floats = n_tris * 9
    if dgrad.size % frame_floats:
        raise ValueError(f"dgrad size {dgrad.size} is not a multiple of n_tris*9={frame_floats}")
    squeeze = dgrad.size == frame_floats and dgrad.ndim <= 2
    dgrad = dgrad.reshape(-1, frame_floats)
    out = np.empty((len(dgrad), n_verts, 3), np.float64)
    cv = None
    if cnst_verts is not None and len(cnst_verts):
        cv = np.ascontiguousarray(np.asarray(cnst_verts, np.float64).reshape(-1, 3))
    ok = lib.sdfa_get_mesh_from_dgrad(
        _fptr(dgrad), len(dgrad),
        _dptr(cv) if cv is not None else ctypes.cast(None, ctypes.POINTER(ctypes.c_double)),
        _dptr(out),
    )
    if not ok:
        raise RuntimeError("get_mesh_from_dgrad failed (set_target not called?)")
    return out[0] if squeeze else out


def get_mesh(deform_grad, n_verts: int, vert_cnsts=None, **_) -> np.ndarray:
    """Single-frame surface matching the reference call site (frame.py:129)."""
    return get_meshes(deform_grad, n_verts, vert_cnsts)


def get_deform_mat(verts_a, verts_b, faces, eps: float = 1e-6) -> np.ndarray:
    """Raw per-triangle affine transforms (n_tris, 9) row-major; degenerate
    triangles emit identity (reference get_deform_mat, pybind.cpp:137-144)."""
    lib = _load()
    a = np.ascontiguousarray(np.asarray(verts_a, np.float64).reshape(-1, 3))
    b = np.ascontiguousarray(np.asarray(verts_b, np.float64).reshape(-1, 3))
    faces = np.ascontiguousarray(np.asarray(faces, np.int64).reshape(-1, 3))
    out = np.empty((len(faces), 9), np.float32)
    ok = lib.sdfa_get_deform_mat(_dptr(a), _dptr(b), len(a), _iptr(faces),
                                 len(faces), eps, _fptr(out))
    if not ok:
        raise RuntimeError("get_deform_mat failed")
    return out


def get_meshes_from_dm(dmat, n_verts: int,
                       cnst_verts: Optional[np.ndarray] = None) -> np.ndarray:
    """Batched mesh reconstruction from raw matrices (reference
    get_mesh_from_dm, pybind.cpp:145-152): (F?, n_tris·9) → (F?, n_verts, 3)."""
    lib = _load()
    n_tris = lib.sdfa_n_tris()
    if n_tris <= 0:
        raise RuntimeError("set_target must be called first")
    dmat = np.ascontiguousarray(np.asarray(dmat, np.float32))
    frame_floats = n_tris * 9
    if dmat.size % frame_floats:
        raise ValueError(f"dmat size {dmat.size} is not a multiple of n_tris*9={frame_floats}")
    squeeze = dmat.size == frame_floats and dmat.ndim <= 3
    dmat = dmat.reshape(-1, frame_floats)
    out = np.empty((len(dmat), n_verts, 3), np.float64)
    cv = None
    if cnst_verts is not None and len(cnst_verts):
        cv = np.ascontiguousarray(np.asarray(cnst_verts, np.float64).reshape(-1, 3))
    ok = lib.sdfa_get_mesh_from_dm(
        _fptr(dmat), len(dmat),
        _dptr(cv) if cv is not None else ctypes.cast(None, ctypes.POINTER(ctypes.c_double)),
        _dptr(out),
    )
    if not ok:
        raise RuntimeError("get_mesh_from_dm failed (set_target not called?)")
    return out[0] if squeeze else out


def get_mesh_from_dm(dmat, n_verts: int, vert_cnsts=None, **_) -> np.ndarray:
    """Single-frame raw-matrix reconstruction (pybind.cpp:145-152)."""
    return get_meshes_from_dm(dmat, n_verts, vert_cnsts)
