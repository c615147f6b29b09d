"""Deformation solver parity on a small synthetic torus mesh: the port's
float64 host build vs sdfa_tpu's, and its decode+solve path vs the f64
SuperLU oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdfa_tpu.ops import deform_solver as jds
from sdfa_tpu_torch.mesh import FLAME_COUNTS, read_ply, synthetic_template, write_ply
from sdfa_tpu_torch.ops import decode_solve as K3
from sdfa_tpu_torch.ops import deform_solver as tds

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)


@pytest.fixture(scope="module")
def pair():
    verts, faces, cnst = synthetic_template(1, n_major=9, n_minor=12, n_extra=4, n_free=40)
    return (verts, faces, cnst, jds.DeformationSolver(verts, faces, cnst_indices=cnst),
            tds.DeformationSolver(verts, faces, cnst))


def test_synthetic_template_has_flame_counts():
    verts, faces, cnst = synthetic_template(0)
    assert (len(verts), len(faces), len(verts) - len(cnst)) == FLAME_COUNTS == (5023, 9976, 1261)
    referenced = np.zeros(len(verts), bool)
    referenced[faces.ravel()] = True
    free = np.setdiff1d(np.arange(len(verts)), cnst)
    assert referenced[free].all()  # an unreferenced free vertex makes AᵀA singular


def test_ply_roundtrip(tmp_path, pair):
    verts, faces, *_ = pair
    write_ply(str(tmp_path / "t.ply"), verts, faces)
    v, f = read_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(f, faces)
    np.testing.assert_allclose(v, verts.astype(np.float32), rtol=0, atol=0)


def test_host_operator_matches_jax(pair):
    *_, jsolver, tsolver = pair
    assert (tsolver.n_verts, tsolver.n_tris, tsolver.n_free) == (
        jsolver.n_verts, jsolver.n_tris, jsolver.n_free)
    np.testing.assert_allclose(tsolver._p_np, jsolver._p_np, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tsolver.p_planes(), np.asarray(jsolver.consts.p, np.float64),
                               rtol=0, atol=1e-6)  # the JAX planes are stored f32


def test_solve_host_matches_jax(pair):
    *_, jsolver, tsolver = pair
    d = np.random.default_rng(2).uniform(-0.05, 0.05, (tsolver.n_tris, 9))
    np.testing.assert_allclose(tsolver.solve_host(d), jsolver.solve_host(d), rtol=0,
                               atol=1e-12)


def test_solve_fn_matches_jax_planes(pair):
    *_, jsolver, tsolver = pair
    n = tsolver.n_tris
    planes = np.random.default_rng(3).uniform(-0.05, 0.05, (4, 9 * n)).astype(np.float32)
    want = np.asarray(jds.solve_fn(jsolver.consts, jnp.asarray(planes),
                                   jsolver.consts.template_cnst, spec=jsolver.spec,
                                   out_layout="v3", dgrad_layout="planes"))
    consts = tsolver.device_consts("cpu")
    got = tds.solve_fn(consts, torch.from_numpy(planes), consts.template_cnst,
                       tsolver.spec).numpy()
    assert got.shape == (4, tsolver.n_verts, 3)
    assert float(np.abs(got - want).max()) < 1e-6


@pytest.mark.parametrize("rows", [1, 7])
def test_decode_solve_plain_matches_f64_oracle(pair, rows):
    """coefficients → decode → solve (plain version + assemble_from_free) vs
    the float64 SuperLU oracle on the decoded dgrads: ≤ 1e-5 m."""
    *_, tsolver = pair
    n, Ks, Kr = tsolver.n_tris, 10, 6
    rng = np.random.default_rng(4)
    sc, sm = rng.normal(0, 0.02, (6 * n, Ks)), rng.normal(0, 0.02, 6 * n)
    rc, rm = rng.normal(0, 0.02, (3 * n, Kr)), rng.normal(0, 0.02, 3 * n)
    cs, cr = rng.normal(0, 1, (rows, Ks)), rng.normal(0, 1, (rows, Kr))
    dsc = K3.prep_consts(sc.astype(np.float32), sm.astype(np.float32), rc.astype(np.float32),
                         rm.astype(np.float32), tsolver, "cpu")
    consts = tsolver.device_consts("cpu")
    got = K3.decode_solve_fused(torch.tensor(cs, dtype=torch.float32),
                                torch.tensor(cr, dtype=torch.float32), dsc, consts,
                                tsolver.spec, consts.template_cnst).numpy()
    scale = cs.astype(np.float32).astype(np.float64) @ sc.astype(np.float32).T + sm.astype(np.float32)
    rotat = cr.astype(np.float32).astype(np.float64) @ rc.astype(np.float32).T + rm.astype(np.float32)
    dg = np.concatenate([scale.reshape(rows, n, 6), rotat.reshape(rows, n, 3)], axis=-1)
    oracle = np.stack([tsolver.solve_host(dg[i]) for i in range(rows)])
    assert got.shape == (rows, tsolver.n_verts, 3)
    assert float(np.abs(got - oracle).max()) < 1e-5
