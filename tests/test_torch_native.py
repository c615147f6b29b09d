"""The port's native float64 runtime (``sdfa_tpu_torch/native``, its own copy
of the C++ built into ``build/``) against the JAX package's binding (built
into ``csrc/`` by its Makefile) on ``synthetic_template(0)`` (FLAME's 5023 /
9976 / 1261 counts): the same source and flags, so every output is bit-equal.
Then against the port's float64 solver (``DeformationSolver.solve_host``),
within 1e-9 m."""

import os

import numpy as np
import pytest

from sdfa_tpu import native as jnative
from sdfa_tpu_torch import native
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.ops import build
from sdfa_tpu_torch.ops.deform_solver import DeformationSolver

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

SOLVER_TOL_M = 1e-9  # native float64 vs the port's float64 solver


@pytest.fixture(scope="module")
def target():
    verts, faces, cnst = synthetic_template(0)
    assert native.set_target(verts, faces, cnst) and jnative.set_target(verts, faces, cnst)
    rng = np.random.default_rng(6)
    frames = []
    for seed in range(3):  # smooth bumps, constrained vertices held at the template
        out = verts.copy()
        for _ in range(3):
            center = verts[rng.integers(len(verts))]
            w = np.exp(-np.sum((verts - center) ** 2, axis=1) / (2 * 0.03 ** 2))
            out = out + 0.004 * w[:, None] * rng.normal(size=3)
        out[cnst] = verts[cnst]
        frames.append(out)
    return verts, faces, cnst, frames


def test_built_from_the_port_copy_into_build(target):
    lib = native._load()._name
    assert lib.startswith(build.BUILD_ROOT) and os.path.basename(lib) == "libdeformation.so"
    assert os.path.dirname(jnative._SO) != os.path.dirname(lib)


def test_is_same(target):
    _, faces, cnst, _ = target
    assert native.is_same(5023, len(faces), len(cnst))
    assert not native.is_same(5023, len(faces), 0)
    assert native._load().sdfa_n_free() == 5023 - len(cnst) == 1261


def test_deform_grad_and_meshes_bit_equal_to_jax(target):
    verts, faces, cnst, frames = target
    grads = [native.get_deform_grad(verts, f, faces) for f in frames]
    for got, f in zip(grads, frames):
        np.testing.assert_array_equal(got, jnative.get_deform_grad(verts, f, faces))
    batch = np.stack(grads)
    got = native.get_meshes(batch, len(verts))
    np.testing.assert_array_equal(got, jnative.get_meshes(batch, len(verts)))
    np.testing.assert_array_equal(native.get_mesh(grads[0], n_verts=len(verts)), got[0])
    cv = verts[cnst] + 1e-4
    np.testing.assert_array_equal(native.get_meshes(batch, len(verts), cv),
                                  jnative.get_meshes(batch, len(verts), cv))


def test_deform_mat_pair_bit_equal_to_jax(target):
    verts, faces, _, frames = target
    mats = np.stack([native.get_deform_mat(verts, f, faces) for f in frames])
    np.testing.assert_array_equal(mats, np.stack([jnative.get_deform_mat(verts, f, faces)
                                                  for f in frames]))
    got = native.get_meshes_from_dm(mats, len(verts))
    np.testing.assert_array_equal(got, jnative.get_meshes_from_dm(mats, len(verts)))
    np.testing.assert_array_equal(native.get_mesh_from_dm(mats[1], len(verts)), got[1])
    assert float(np.abs(got - np.stack(frames)).max()) < 1e-6  # raw matrices give the mesh back


def test_meshes_match_the_port_float64_solver(target):
    verts, faces, cnst, frames = target
    solver = DeformationSolver(verts, faces, cnst_indices=cnst)
    grads = np.stack([native.get_deform_grad(verts, f, faces) for f in frames])
    got = native.get_meshes(grads, len(verts))
    want = np.stack([solver.solve_host(g.astype(np.float64)) for g in grads])
    assert float(np.abs(got - want).max()) <= SOLVER_TOL_M


def test_refusals(target):
    with pytest.raises(ValueError, match="multiple of n_tris"):
        native.get_meshes(np.zeros(10, np.float32), 5023)


def test_single_threaded_build_gives_the_same_bits(target, monkeypatch):
    """A compiler without OpenMP's runtime builds the runtime without
    ``-fopenmp`` (the card's host); its meshes are the OpenMP build's bits."""
    verts, faces, cnst, frames = target
    grads = np.stack([native.get_deform_grad(verts, f, faces) for f in frames])
    want = native.get_meshes(grads, len(verts))
    flags_seen = []
    real = build._host_build

    def no_openmp(name, cxx, flags):
        flags_seen.append(list(flags))
        if "-fopenmp" in flags:
            raise RuntimeError("g++-real: fatal error: cannot read spec file 'libgomp.spec'")
        return real(name, cxx, flags)

    monkeypatch.setattr(build, "_host_build", no_openmp)
    monkeypatch.delitem(build._LIBS, "host:deformation")
    monkeypatch.setattr(native, "_lib", None)
    assert native.set_target(verts, faces, cnst)
    assert "-fopenmp" in flags_seen[0] and "-fopenmp" not in flags_seen[1]
    np.testing.assert_array_equal(native.get_meshes(grads, len(verts)), want)
