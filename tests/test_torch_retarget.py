"""Cross-topology retargeting in the port: the deformation solver's
triangle-correspondence equations against the JAX package's.

On tests/test_deformation.py's small grid with its fan-out (two sources on
every even triangle, none on every fifth, otherwise one to one):
- the equation table (``n_eqs``, ``eq_src``) and the host operators equal;
- ``solve`` (direct), ``solve_from_matrices`` and the float64
  ``solve_host`` / ``solve_host_from_matrices`` against the JAX calls
  ≤ 1e-5 (host ≤ 1e-12), the direct and refined solves against the float64
  oracle ≤ 1e-4. The JAX package's refine method reads each equation's frame
  weights at its source triangle instead of its target (a fault of the
  reference implementation, recorded in ROADMAP.md queue C), so the port's
  refine is held to the JAX call on the identity table and to the oracle
  on the fan-out;
- a correspondence file read by both ``set_template_mesh`` gives equal
  tables, and the identity file is recognized as the identity table.

A narrow network (``test_torch_slice.py::task_pair(narrow=True)``) over a
correspondence template: ``generate_vertices`` on f32 / i16 / i8d, a
``StreamingSession`` and ``CoefDecoder`` against the JAX ones; those requests
run the fused decode + solve kernel's full body (its plain version on the
CPU), where the JAX package decodes to planes and takes ``solve_fn``. The same
network over the table with every equation twice (not an identity table)
against no table.
"""

import numpy as np
import pytest
import torch

from test_torch_slice import _signal, task_pair

from sdfa_tpu.ops import deform_solver as jds
from sdfa_tpu.streaming import CoefDecoder as JCoefDecoder
from sdfa_tpu.viewer import frame as jframe

from sdfa_tpu_torch.ops import decode_solve as K3
from sdfa_tpu_torch.ops import deform_solver as tds
from sdfa_tpu_torch.streaming import CoefDecoder
from sdfa_tpu_torch.task import WIRE_LSB, WIRE_LSB8
from sdfa_tpu_torch.viewer import frame as tframe

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

JAX_TOL_M = 1e-5
ORACLE_TOL_M = 1e-4
STEP = {"f32": 0.0, "i16": WIRE_LSB, "i8d": WIRE_LSB8}


def fanout(nf):
    """(corr_count, corr_faces) of the pattern, and the file's rows."""
    count, faces, rows = [], [], []
    for i in range(nf):
        if i % 5 == 4:
            count.append(0)
            faces.append(0)
        elif i % 2 == 0:
            count.append(2)
            faces.extend([i, (i + 3) % nf])
            rows += [(i, i), ((i + 3) % nf, i)]
        else:
            count.append(1)
            faces.append(i)
            rows.append((i, i))
    return count, faces, rows


def write_corres(path, rows):
    with open(path, "w") as fp:
        fp.write(f"{len(rows)}\n" + "".join(f"{s},{d},0\n" for s, d in rows))


@pytest.fixture(scope="module")
def grid():
    n = 6
    xs, ys = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    verts = np.stack([xs.ravel(), ys.ravel(), 0.02 * np.sin(xs.ravel() * 6)], 1)
    faces = []
    for r in range(n - 1):
        for c in range(n - 1):
            a = r * n + c
            faces.append([a, a + 1, a + n])
            faces.append([a + 1, a + n + 1, a + n])
    faces = np.asarray(faces, np.int64)
    count, corr, _ = fanout(len(faces))
    cnst = np.arange(6)
    return (verts, faces, cnst,
            jds.DeformationSolver(verts, faces, cnst_indices=cnst, corr_count=count,
                                  corr_faces=corr),
            tds.DeformationSolver(verts, faces, cnst, corr_count=count, corr_faces=corr))


def _dgrad(nf, seed):
    return np.random.default_rng(seed).uniform(-0.05, 0.05, (nf, 9))


def test_equation_table_matches_jax(grid):
    *_, js, ts = grid
    assert ts.n_eqs == js.n_eqs == ts.spec.n_eqs == sum(max(1, c) for c in fanout(ts.n_tris)[0])
    assert ts.n_eqs > ts.n_tris and not ts.spec.identity_eq and not js.spec.identity_eq
    np.testing.assert_array_equal(ts._eq_src, js._eq_src)
    assert (ts._eq_src < 0).sum() == ts.n_tris // 5
    np.testing.assert_allclose(ts._p_np, js._p_np, rtol=0, atol=1e-10)


def test_host_solves_match_jax(grid):
    *_, js, ts = grid
    d = _dgrad(ts.n_tris, 0)
    np.testing.assert_allclose(ts.solve_host(d), js.solve_host(d), rtol=0, atol=1e-12)
    dm = np.tile(np.eye(3), (ts.n_tris, 1, 1)) + np.random.default_rng(1).uniform(
        -0.01, 0.01, (ts.n_tris, 3, 3))
    np.testing.assert_allclose(ts.solve_host_from_matrices(dm), js.solve_host_from_matrices(dm),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_direct_solve_matches_jax_and_oracle(grid, batch):
    *_, js, ts = grid
    d = np.stack([_dgrad(ts.n_tris, s) for s in range(int(np.prod(batch)))]).reshape(
        batch + (ts.n_tris, 9)).astype(np.float32)
    got = ts.solve(d, device="cpu").numpy()
    assert got.shape == batch + (ts.n_verts, 3)
    assert float(np.abs(got - np.asarray(js.solve(d))).max()) <= JAX_TOL_M
    oracle = np.stack([ts.solve_host(x) for x in d.reshape(-1, ts.n_tris, 9)]).reshape(got.shape)
    assert float(np.abs(got - oracle).max()) <= ORACLE_TOL_M


def test_refine_matches_oracle_and_jax_on_identity(grid):
    verts, faces, cnst, _, ts = grid
    d = _dgrad(ts.n_tris, 2).astype(np.float32)
    got = ts.solve(d, method="refine", device="cpu").numpy()
    assert float(np.abs(got - ts.solve_host(d)).max()) <= ORACLE_TOL_M
    jid = jds.DeformationSolver(verts, faces, cnst_indices=cnst)
    tid = tds.DeformationSolver(verts, faces, cnst)
    for method in ("direct", "refine"):
        assert float(np.abs(tid.solve(d, method=method, device="cpu").numpy()
                            - np.asarray(jid.solve(d, method=method))).max()) <= JAX_TOL_M


def test_matrix_solve_matches_jax(grid):
    *_, js, ts = grid
    dm = (np.tile(np.eye(3), (2, ts.n_tris, 1, 1)) + np.random.default_rng(3).uniform(
        -0.01, 0.01, (2, ts.n_tris, 3, 3))).astype(np.float32)
    got = ts.solve_from_matrices(dm, device="cpu").numpy()
    assert float(np.abs(got - np.asarray(js.solve_from_matrices(dm))).max()) <= JAX_TOL_M
    flat = ts.solve_from_matrices(dm.reshape(2, -1, 9), device="cpu").numpy()
    np.testing.assert_array_equal(flat, got)
    assert float(np.abs(got[1] - ts.solve_host_from_matrices(dm[1])).max()) <= ORACLE_TOL_M


def test_files_read_into_equal_tables(grid, tmp_path):
    """Both ``set_template_mesh`` read the reference's file format into the
    same table; the one-to-one file is recognized as the identity table and
    solves as no file does."""
    from sdfa_tpu_torch.mesh import write_ply

    verts, faces, cnst, *_ = grid
    ply, txt = str(tmp_path / "grid.ply"), str(tmp_path / "cnst.txt")
    write_ply(ply, verts, faces)
    (tmp_path / "cnst.txt").write_text(" ".join(map(str, cnst)))
    saved_j, saved_t = dict(jframe._state), dict(tframe._state)
    try:
        for name, rows in (("fanout", fanout(len(faces))[2]),
                           ("identity", [(i, i) for i in range(len(faces))])):
            path = str(tmp_path / f"{name}.txt")
            write_corres(path, rows)
            js = jframe.set_template_mesh(ply, txt, path)
            ts = tframe.set_template_mesh(template_path=ply, constraints_path=txt,
                                          corres_path=path)
            np.testing.assert_array_equal(ts._eq_src, js._eq_src)
            assert ts.spec.identity_eq == js.spec.identity_eq == (name == "identity")
        d = _dgrad(len(faces), 4).astype(np.float32)
        plain = tframe.set_template_mesh(template_path=ply, constraints_path=txt)
        assert float(np.abs(ts.solve(d, device="cpu").numpy()
                            - plain.solve(d, device="cpu").numpy()).max()) <= JAX_TOL_M
    finally:
        jframe._state.clear()
        jframe._state.update(saved_j)
        tframe._state.clear()
        tframe._state.update(saved_t)


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    """task_pair's narrow network over its template with the fan-out's
    correspondences installed on both sides."""
    root = tmp_path_factory.mktemp("retarget")
    with task_pair(root, narrow=True) as (jtask, ttask, n_verts):
        n_tris = len(tframe.template()[1])
        corres = str(root / "corres.txt")
        write_corres(corres, fanout(n_tris)[2])
        args = (str(root / "template.ply"), str(root / "cnst.txt"), corres)
        jframe.set_template_mesh(*args)
        tframe.set_template_mesh(template_path=args[0], constraints_path=args[1],
                                 corres_path=args[2])
        yield jtask, ttask, n_verts


@pytest.fixture(scope="module")
def request_f32(tasks):
    jtask, ttask, _ = tasks
    sig = _signal(0.9, 4)
    return sig, jtask.generate_vertices(sig, 1), ttask.generate_vertices(sig, 1)


def test_wire_f32_matches_jax_and_oracle(tasks, request_f32):
    _, ttask, n_verts = tasks
    sig, (ts_j, verts_j), (ts_t, verts_t) = request_f32
    # the fused kernel's full body is the path: its constants, over the equations
    fsc = ttask._decode_consts()[2]
    assert isinstance(fsc, K3.DecodeSolveFullConsts)
    assert fsc.p.shape[1] >= tframe.get_solver().n_eqs
    assert list(ts_t) == list(ts_j) and verts_t.shape == (len(ts_j), n_verts, 3)
    assert float(np.abs(verts_t - np.asarray(verts_j)).max()) <= JAX_TOL_M
    solver = tframe.get_solver()
    assert solver.n_eqs > solver.n_tris
    sample = [0, len(ts_t) // 2, len(ts_t) - 1]
    with torch.inference_mode():
        frame_idx, _, z, _ = ttask._overlap_prefix(sig)
        preds, _, _ = ttask.model.forward_windows(
            z, torch.from_numpy(frame_idx[sample]).long(),
            torch.full((len(sample),), 1, dtype=torch.long), raw_pca=True)
        dgrad = ttask.model.decode_to_anime(preds)[:, 0].double().numpy()
    oracle = np.stack([solver.solve_host(d) for d in dgrad])
    assert float(np.abs(verts_t[sample] - oracle).max()) <= ORACLE_TOL_M


@pytest.mark.parametrize("wire", ["i16", "i8d"])
def test_quantized_wires_match_jax(tasks, request_f32, wire):
    jtask, ttask, _ = tasks
    sig, _, (_, verts_f) = request_f32
    _, got = ttask.generate_vertices(sig, 1, wire=wire)
    assert float(np.abs(got - verts_f).max()) <= STEP[wire] / 2 + 1e-7
    diff = np.abs(got - np.asarray(jtask.generate_vertices(sig, 1, wire=wire)[1]))
    assert float(diff.max()) <= STEP[wire] + 1e-7
    assert float((diff > 1e-7).mean()) < 0.02  # cells a rounding boundary split


def test_session_matches_offline_and_jax(tasks, request_f32):
    jtask, ttask, _ = tasks
    sig, _, (ts_f, verts_f) = request_f32

    def session(task):
        sess, got = task.stream(1, emit_batch=8), []
        for lo in range(0, len(sig), 1700):
            got.extend(sess.push(sig[lo:lo + 1700]))
        return got + sess.flush()

    got, jgot = session(ttask), session(jtask)
    assert [t for t, _ in got] == list(ts_f) == [t for t, _ in jgot]
    verts = np.stack([v for _, v in got])
    assert float(np.abs(verts - verts_f).max()) <= JAX_TOL_M
    assert float(np.abs(verts - np.stack([np.asarray(v) for _, v in jgot])).max()) <= JAX_TOL_M


def test_coef_decoder_matches_jax(tasks):
    jtask, ttask, n_verts = tasks
    jdec, tdec = JCoefDecoder(jtask), CoefDecoder(ttask)
    assert tdec.fingerprint() == jdec.fingerprint()
    coefs = np.random.default_rng(11).normal(0, 1.0, (5, 85 + 180)).astype(np.float32)
    precise = tdec.decode(coefs, precise=True)
    assert precise.shape == (5, n_verts, 3)
    np.testing.assert_allclose(precise, jdec.decode(coefs, precise=True), rtol=0, atol=2e-8)
    np.testing.assert_allclose(tdec.decode(coefs), precise, rtol=0, atol=5e-7)
    np.testing.assert_allclose(tdec.decode(coefs), jdec.decode(coefs), rtol=0, atol=5e-7)


def test_doubled_table_matches_no_table(tasks, request_f32, tmp_path):
    """Every equation twice is not an identity table, so a request takes the
    full body; its least-squares solution is the one-to-one solve's, within
    the JAX budget of the same network over no table."""
    _, ttask, _ = tasks
    sig = request_f32[0]
    solver = tframe.get_solver()
    verts, faces, cnst = solver.template_verts, tframe.template()[1], solver.cnst_indices
    doubled = str(tmp_path / "doubled.txt")
    write_corres(doubled, [(i, i) for i in range(len(faces)) for _ in range(2)])
    saved = dict(tframe._state)
    try:
        out = {}
        for name, path in (("doubled", doubled), ("none", None)):
            installed = tframe.set_template_mesh(verts, faces, cnst, corres_path=path)
            assert installed.spec.identity_eq == (path is None)
            assert installed.n_eqs == (1 if path is None else 2) * len(faces)
            task = type(ttask)(ttask.hp, ttask.model, "cpu")
            kind = K3.DecodeSolveConsts if path is None else K3.DecodeSolveFullConsts
            assert isinstance(task._decode_consts()[2], kind)
            out[name] = task.generate_vertices(sig, 1)
    finally:
        tframe._state.clear()
        tframe._state.update(saved)
    assert list(out["doubled"][0]) == list(out["none"][0])
    assert float(np.abs(out["doubled"][1] - out["none"][1]).max()) <= JAX_TOL_M
