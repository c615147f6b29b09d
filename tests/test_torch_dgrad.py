"""``sdfa_tpu_torch.ops.rotation`` and ``ops.dgrad`` against the JAX package's
on ``mesh.synthetic_template(0)`` (FLAME's 5023 vertices / 9976 triangles)
with seeded deformations: the SO(3) maps and their conventions, the float32
extraction within the JAX tests' bound (tests/test_deformation.py), the
float64 extraction that the preprocessing runs on the card ≤ 1e-10 of the
numpy plain version (through its near-π and small-angle branches and
degenerate triangles; a rotation within 1% of the 1e-6 rad cut may land on
either side of it, ``ops.dgrad.rotation_cut_flips``), the transforms and the
raw matrices."""

import math

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax.numpy as jnp

from sdfa_tpu.ops import dgrad as jdgrad
from sdfa_tpu.ops import rotation as jrot

from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.ops import dgrad, rotation

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

F64_TOL = 1e-10
F32_TOL = 5e-3  # the JAX tests' bound on the float32 extraction (input-precision-limited)


@pytest.fixture(scope="module")
def mesh():
    verts, faces, _ = synthetic_template(0)
    return verts, faces


def _smooth_deform(verts, seed, scale=0.004):
    """tests/test_deformation.py's smooth displacement field."""
    rng = np.random.default_rng(seed)
    out = verts.copy()
    for _ in range(4):
        center = verts[rng.integers(len(verts))]
        w = np.exp(-np.sum((verts - center) ** 2, axis=1) / (2 * 0.05 ** 2))
        out = out + scale * w[:, None] * rng.normal(size=3)
    return out


def _rotation(w):
    return Rotation.from_rotvec(w).as_matrix()


def test_so3_maps_match_jax():
    w = np.random.default_rng(0).normal(size=(64, 3)) * 0.5
    w[0] = 0.0
    w[1] = 1e-8                                 # below the exp's 1e-6 cut
    w[2] = [np.pi - 1e-6, 0, 0]                 # the log's near-π branch
    w[3] = [0.0, -(np.pi - 5e-5), 0.0]
    w32 = w.astype(np.float32)  # the JAX package runs without x64: float32 on both sides
    r32 = rotation.so3_exp(torch.from_numpy(w32))
    np.testing.assert_allclose(r32.numpy(), np.asarray(jrot.so3_exp(jnp.asarray(w32))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(rotation.so3_log(r32).numpy(),
                               np.asarray(jrot.so3_log(jnp.asarray(r32.numpy()))),
                               rtol=0, atol=1e-5)
    r = rotation.so3_exp(torch.from_numpy(w)).numpy()  # float64 against scipy
    np.testing.assert_allclose(r[2:], Rotation.from_rotvec(w[2:]).as_matrix(), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(r[:2], np.tile(np.eye(3), (2, 1, 1)))  # under the cut
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", r, r), np.tile(np.eye(3), (64, 1, 1)),
                               atol=1e-12)
    back = rotation.so3_log(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(back[4:], w[4:], atol=1e-10)   # the generic branch
    np.testing.assert_allclose(np.abs(back[2:4]), np.abs(w[2:4]), atol=1e-3)  # near π
    np.testing.assert_array_equal(back[:2], 0.0)


def test_entry_conventions():
    w = torch.tensor([[0.1, 0.2, 0.3]])
    k = rotation.skew(w)[0]
    assert (k[2, 1], k[0, 2], k[1, 0]) == pytest.approx((0.1, 0.2, 0.3))
    np.testing.assert_array_equal(rotation.unskew(rotation.skew(w)).numpy(), w.numpy())
    d = rotation.dgrad_rotvec_to_entries(w)
    np.testing.assert_array_equal(d.numpy(),
                                  np.asarray(jrot.dgrad_rotvec_to_entries(jnp.asarray(w.numpy()))))
    np.testing.assert_array_equal(rotation.dgrad_entries_to_rotvec(d).numpy(), w.numpy())


def _cases(verts):
    """dst meshes: identity, a rotation, a uniform scale, two smooth fields,
    a rotation within 1e-8 of π, a tiny rotation under the log's cut."""
    return {"identity": verts.copy(),
            "rotation": verts @ _rotation([0.0, 0.3, 0.0]).T,
            "scale": verts * 1.05,
            "smooth1": _smooth_deform(verts, 1),
            "smooth2": _smooth_deform(verts, 2, scale=0.01),
            # an axis off the coordinate axes: the branch's signs come from the
            # diagonal of (R+I)/2 and are ill-posed where an entry of it is ~0
            "near_pi": verts @ _rotation((math.pi - 1e-8) * np.array([0.6, 0.64, 0.48])).T,
            "tiny": verts @ _rotation([1e-8, 0.0, 0.0]).T}


def test_f64_extraction_matches_numpy(mesh):
    """All cases in one batch of frames × triangles; a collapsed triangle in
    one frame is zero on both sides."""
    verts, faces = mesh
    cases = _cases(verts)
    bad = cases["smooth1"].copy()
    f0 = faces[0]
    bad[f0[2]] = bad[f0[0]] + 2.0 * (bad[f0[1]] - bad[f0[0]])
    cases["degenerate"] = bad
    dst = np.stack(list(cases.values()))
    got = dgrad.deformation_gradients_f64(torch.from_numpy(verts), torch.from_numpy(dst),
                                          torch.from_numpy(faces)).numpy()
    assert got.shape == (len(cases), len(faces), 9) and got.dtype == np.float64
    for i, (name, d) in enumerate(cases.items()):
        want = jdgrad.deformation_gradients_np(verts, d, faces)
        np.testing.assert_array_equal(dgrad.deformation_gradients_np(verts, d, faces), want)
        diff = np.abs(got[i] - want)
        flips = dgrad.rotation_cut_flips(want, got[i])  # within 1% of the 1e-6 rad cut
        diff[flips, 6:] = 0.0
        assert float(diff.max()) <= F64_TOL, (name, float(diff.max()))
        assert flips.sum() <= 1e-3 * len(faces), (name, int(flips.sum()))
    assert np.abs(got[-1, 0]).max() == 0.0  # the degenerate triangle
    # the branches were taken: the near-π frame's rotation entries at π, the tiny one's at 0
    assert np.abs(np.linalg.norm(got[5, :, 6:], axis=-1) - math.pi).max() < 1e-6
    np.testing.assert_array_equal(got[6, :, 6:], 0.0)
    np.testing.assert_allclose(got[2, :, [0, 3, 5]], 0.05, atol=1e-10)


def test_f64_extraction_batches(mesh, monkeypatch):
    """A batch bound smaller than the frames × triangles splits the work
    with the same result."""
    verts, faces = mesh
    dst = torch.from_numpy(np.stack([_smooth_deform(verts, s) for s in range(3)]))
    args = (torch.from_numpy(verts), dst, torch.from_numpy(faces))
    whole = dgrad.deformation_gradients_f64(*args)
    monkeypatch.setattr(dgrad, "F64_BATCH", len(faces) + 1)
    np.testing.assert_array_equal(dgrad.deformation_gradients_f64(*args).numpy(), whole.numpy())


@pytest.mark.parametrize("case", ["identity", "rotation", "scale", "smooth1"])
def test_f32_extraction_matches_jax(mesh, case):
    verts, faces = mesh
    dst = _cases(verts)[case].astype(np.float32)
    src = verts.astype(np.float32)
    got = dgrad.deformation_gradients(torch.from_numpy(src), torch.from_numpy(dst),
                                      torch.from_numpy(faces)).numpy()
    want = np.asarray(jdgrad.deformation_gradients(jnp.asarray(src), jnp.asarray(dst),
                                                   jnp.asarray(faces)))
    assert got.shape == want.shape == (len(faces), 9)
    assert float(np.abs(got - want).max()) <= F32_TOL
    exact = jdgrad.deformation_gradients_np(verts, dst.astype(np.float64), faces)
    assert float(np.abs(got - exact).max()) <= F32_TOL


def test_transforms_and_matrices_match_jax(mesh):
    verts, faces = mesh
    rng = np.random.default_rng(2)
    d = np.zeros((32, 9))
    d[:, [0, 3, 5]] = rng.uniform(-0.1, 0.1, (32, 3))
    d[:, [1, 2, 4]] = rng.uniform(-0.05, 0.05, (32, 3))
    d[:, 6:] = rng.uniform(-0.4, 0.4, (32, 3))
    d = d.astype(np.float32)
    np.testing.assert_allclose(dgrad.dgrad_to_transforms_t(torch.from_numpy(d)).numpy(),
                               np.asarray(jdgrad.dgrad_to_transforms_t(jnp.asarray(d))),
                               rtol=0, atol=1e-6)
    bad = _smooth_deform(verts, 11)
    f0 = faces[0]
    bad[f0[2]] = bad[f0[0]] + 2.0 * (bad[f0[1]] - bad[f0[0]])
    src, bad = verts.astype(np.float32), bad.astype(np.float32)
    got = dgrad.deformation_matrices(torch.from_numpy(src), torch.from_numpy(bad),
                                     torch.from_numpy(faces)).numpy()
    want = np.asarray(jdgrad.deformation_matrices(jnp.asarray(src), jnp.asarray(bad),
                                                  jnp.asarray(faces)))
    np.testing.assert_array_equal(got[0], np.eye(3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
