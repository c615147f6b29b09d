"""K3's full body (``ops/decode_solve.py::decode_solve_full``), held to the
JAX package on the CPU.

On a card the full body decodes each triangle's ΔT = T − T0 once and
multiplies it by Pt, the equation table folded into P on the host in float64
(``fold_table``), as 3xTF32 on the tensor cores, then adds x0f = T0·Pt + x_id.
Here, on the small solver of ``tests/test_torch_kernels_plain.py`` with
seeded bases:

- on the identity table its plain version against the TPU ``_kernel`` in
  interpret mode (``delta=False, precise=True``, P in float32) within 1e-5 m,
  and no further from the float64 product than that kernel is;
- on the fan-out correspondence table of ``tests/test_torch_retarget.py``
  against the JAX ``solve_fn`` of the same decoded planes (1e-5 m) and the
  float64 host solve (1e-4 m);
- the fold against the per-equation float64 product on the fan-out, the
  doubled, the identity table and one that leaves triangles without an
  equation (<= 1e-9 m);
- ``split_tf32`` and ``decode_solve_full_rounded`` (the kernel's operands in
  plain tensors) against the plain version and the JAX ``solve_fn``, the
  operands' layout and padding, ``k_parts`` over K = 3T' and ``cost_full``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_retarget import fanout

from sdfa_tpu.ops import deform_solver as jds
from sdfa_tpu.ops import pallas_decode_solve as jpds
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.ops import decode_solve as K3
from sdfa_tpu_torch.ops.deform_solver import DeformationSolver

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

KERNEL_TOL_M = 1e-5   # the kernel's gate against its plain version; the port against JAX
ORACLE_TOL_M = 1e-4   # against the float64 solve
ROUNDED_TOL_M = 1e-6  # the 3xTF32 operands against the plain float32 product
FOLD_TOL_M = 1e-9     # the fold against the per-equation product, both in float64
KS, KR, ROWS = 12, 7, 9


def _bits(x):
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


@pytest.fixture(scope="module")
def case():
    """The small template, seeded bases and coefficients, the port's solvers
    and constants on the identity and the fan-out table, and the JAX solvers."""
    verts, faces, cnst = synthetic_template(0, n_major=8, n_minor=10, n_extra=3, n_free=30)
    n = len(faces)
    count, corr, _ = fanout(n)
    rng = np.random.default_rng(5)

    def rand(shape, scale):
        return rng.normal(0, scale, shape).astype(np.float32)

    bases = (rand((6 * n, KS), 0.05), rand((6 * n,), 0.05), rand((3 * n, KR), 0.05),
             rand((3 * n,), 0.05))
    coef_s, coef_r = rand((ROWS, KS), 1.0), rand((ROWS, KR), 1.0)
    ident = DeformationSolver(verts, faces, cnst)
    fan = DeformationSolver(verts, faces, cnst, corr_count=count, corr_faces=corr)
    return dict(
        verts=verts, faces=faces, cnst=cnst, count=count, corr=corr, bases=bases,
        coef_s=coef_s, coef_r=coef_r, cs=torch.from_numpy(coef_s), cr=torch.from_numpy(coef_r),
        ident=ident, fan=fan, ident_fsc=K3.prep_full_consts(*bases, ident, "cpu"),
        fan_fsc=K3.prep_consts(*bases, fan, "cpu"))


def _tables(n):
    """(corr_count, corr_faces) of the tables the fold is held on: the fan-out
    table, every equation twice, none (the identity), and one-to-one but
    with the first targets reading triangle 0, so that triangles 1-3 are no
    equation's source."""
    count, corr, _ = fanout(n)
    return {"fanout": (count, corr), "doubled": ([2] * n, [i for i in range(n) for _ in "ab"]),
            "identity": (None, None),
            "uncovered": ([1] * n, [0 if 0 < i < 4 else i for i in range(n)])}


def _exact(case, fsc):
    """The float64 decode, gather and product of the case's coefficients."""
    f64 = K3.DecodeSolveFullConsts(*(t.double() if t.is_floating_point() else t for t in fsc))
    return K3.decode_solve_full_plain(case["cs"].double(), case["cr"].double(), f64)


def _per_equation(solver, t):
    """Σ_e T_src(e)·P[e] in float64 over the equations, T the identity where
    an equation has no source: t (W, 9, n_tris) → (W, 3, NF)."""
    src = np.asarray(solver._eq_src)
    eye = np.eye(3).reshape(9, 1)
    t_eq = np.where(src >= 0, t[:, :, np.maximum(src, 0)], eye)  # (W, 9, n_eqs)
    p = solver.p_planes()
    return np.stack([sum(np.einsum("we,en->wn", t_eq[:, 3 * d + c], p[c]) for c in range(3))
                     for d in range(3)], axis=1)


@pytest.mark.parametrize("table", ["fanout", "doubled", "identity", "uncovered"])
def test_fold_matches_the_per_equation_product_in_float64(case, table):
    """Pt and x_id (``fold_table``) give the per-equation product for any
    transforms, and x0f (``fold_x0``) the per-equation product of T0; the
    constants hold x0f rounded once to float32 and Pt split into TF32 parts."""
    count, corr = _tables(len(case["faces"]))[table]
    solver = DeformationSolver(case["verts"], case["faces"], case["cnst"], corr_count=count,
                               corr_faces=corr)
    assert solver.spec.identity_eq == (table == "identity")
    n, nf = solver.n_tris, solver.n_free
    fsc = K3.prep_full_consts(*case["bases"], solver, "cpu")
    tp = fsc.t0.shape[1]
    pt, x_id = K3.fold_table(solver, tp)
    assert pt.shape == (3, tp, nf) and x_id.shape == (3, nf) and pt.dtype == np.float64
    src = np.asarray(solver._eq_src)
    unread = np.setdiff1d(np.arange(n), src)
    assert (table == "uncovered") <= (len(unread) == 3)
    assert not pt[:, unread].any() and not pt[:, n:].any()  # no equation reads them
    assert bool((x_id != 0).any()) == bool((src < 0).any())
    t = np.random.default_rng(7).normal(0, 0.3, (ROWS, 9, n)) + np.eye(3).reshape(1, 9, 1)
    want = _per_equation(solver, t)
    folded = np.stack([sum(np.einsum("wt,tn->wn", t[:, 3 * d + c], pt[c, :n]) for c in range(3))
                       for d in range(3)], axis=1) + x_id
    assert float(np.abs(folded - want).max()) <= FOLD_TOL_M
    t0 = fsc.t0.double().numpy()
    x0f = K3.fold_x0(t0, pt, x_id)
    assert float(np.abs(x0f - _per_equation(solver, t0[None, :, :n])[0]).max()) <= FOLD_TOL_M
    assert torch.equal(fsc.x0, torch.from_numpy(x0f.astype(np.float32)))
    hi, lo = K3.split_tf32(torch.from_numpy(pt.astype(np.float32)).reshape(3 * tp, nf).T
                           .contiguous())
    assert torch.equal(fsc.b_t[0, :nf], hi) and torch.equal(fsc.b_t[1, :nf], lo)


def test_prep_consts_routes_by_table(case):
    assert isinstance(K3.prep_consts(*case["bases"], case["ident"], "cpu"), K3.DecodeSolveConsts)
    assert isinstance(case["fan_fsc"], K3.DecodeSolveFullConsts)
    assert case["fan"].n_eqs > case["fan"].n_tris and not case["fan"].spec.identity_eq


def test_identity_table_matches_the_tpu_kernel_in_interpret_mode(case):
    """The full body on an identity table computes ``_kernel``'s function: the
    port's plain version within 1e-5 m of the TPU kernel in interpret mode
    (three bf16 passes, P in float32), and no further from the float64
    product than that kernel; the kernel's 3xTF32 operands neither."""
    sc, sm, rc, rm = case["bases"]
    jsolver = jds.DeformationSolver(case["verts"], case["faces"], cnst_indices=case["cnst"])
    jdsc = jpds.prep_consts({"compT": sc, "means": sm}, {"compT": rc, "means": rm},
                            jsolver.consts, jsolver.spec, p_dtype=jnp.float32)
    want = np.asarray(jpds.decode_solve_free(jnp.asarray(case["coef_s"]),
                                             jnp.asarray(case["coef_r"]), jdsc, interpret=True,
                                             delta=False, precise=True))
    fsc = case["ident_fsc"]
    got = K3.decode_solve_full(case["cs"], case["cr"], fsc)  # CPU tensors: the plain version
    assert got.shape == want.shape == (ROWS, 3, case["ident"].n_free)
    assert float(np.abs(got.numpy() - want).max()) <= KERNEL_TOL_M
    exact = _exact(case, fsc).numpy()
    err_jax = float(np.abs(want - exact).max())
    assert float(np.abs(got.numpy() - exact).max()) <= err_jax
    rounded = K3.decode_solve_full_rounded(case["cs"], case["cr"], fsc).numpy()
    assert float(np.abs(rounded - exact).max()) <= err_jax


def test_identity_table_full_body_matches_delta_body(case):
    """Both bodies on the identity table: the same function."""
    dsc = K3.prep_consts(*case["bases"], case["ident"], "cpu")
    full = K3.decode_solve_full_plain(case["cs"], case["cr"], case["ident_fsc"])
    delta = K3.decode_solve_plain(case["cs"], case["cr"], dsc)
    assert float((full - delta).abs().max()) <= KERNEL_TOL_M


def test_fanout_table_matches_jax_solve_fn_and_float64(case):
    """On the correspondence table: the port's fused call (decode, gather,
    product, ``assemble_from_free``) against the JAX solver's ``solve_fn`` of
    the same decoded planes and against the float64 host solve."""
    sc, sm, rc, rm = case["bases"]
    fan = case["fan"]
    n = fan.n_tris
    jfan = jds.DeformationSolver(case["verts"], case["faces"], cnst_indices=case["cnst"],
                                 corr_count=case["count"], corr_faces=case["corr"])
    consts = fan.device_consts("cpu")
    got = K3.decode_solve_fused(case["cs"], case["cr"], case["fan_fsc"], consts, fan.spec,
                                consts.template_cnst).numpy()
    assert got.shape == (ROWS, fan.n_verts, 3)
    dgrad = np.concatenate([(case["coef_s"] @ sc.T + sm).reshape(ROWS, n, 6),
                            (case["coef_r"] @ rc.T + rm).reshape(ROWS, n, 3)], axis=-1)
    assert float(np.abs(got - np.asarray(jfan.solve(dgrad))).max()) <= KERNEL_TOL_M
    d64 = np.concatenate([(case["coef_s"].astype(np.float64) @ sc.T.astype(np.float64)
                           + sm).reshape(ROWS, n, 6),
                          (case["coef_r"].astype(np.float64) @ rc.T.astype(np.float64)
                           + rm).reshape(ROWS, n, 3)], axis=-1)
    oracle = np.stack([fan.solve_host(d) for d in d64])
    assert float(np.abs(got - oracle).max()) <= ORACLE_TOL_M


def test_split_keeps_22_bits_in_two_tf32_values():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(0, 1, 20000) * 10.0 ** rng.integers(-6, 4, 20000))
                         .astype(np.float32))
    hi, lo = K3.split_tf32(x)
    assert int((_bits(hi) & 0x1FFF).max()) == 0 and int((_bits(lo) & 0x1FFF).max()) == 0
    assert torch.equal(hi, K3.round_tf32(x))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -21).all())  # at least 21 bits
    assert float(lo.abs().max() / x.abs().max()) < 2.0 ** -10


@pytest.mark.parametrize("table", ["ident_fsc", "fan_fsc"])
def test_rounded_operands_within_1e6_of_plain(case, table):
    fsc = case[table]
    got = K3.decode_solve_full_rounded(case["cs"], case["cr"], fsc)
    plain = K3.decode_solve_full_plain(case["cs"], case["cr"], fsc)
    assert got.shape == plain.shape
    assert float((got - plain).abs().max()) <= ROUNDED_TOL_M
    # one TF32 pass alone would err far further from float64: the long mantissa is what
    # the body needs, on ΔT as on T
    nf, tp = fsc.x0.shape[1], fsc.t0.shape[1]
    dt = K3.delta_transforms(case["cs"], case["cr"], fsc).reshape(3 * ROWS, 3 * tp)
    one_pass = (K3.round_tf32(dt) @ fsc.b_t[0, :nf].T).reshape(plain.shape) + fsc.x0
    exact = _exact(case, fsc)
    err_three = float((got.double() - exact).abs().max())
    assert float((one_pass.double() - exact).abs().max()) > 10 * err_three
    assert err_three <= float((plain.double() - exact).abs().max())


def test_rounded_operands_match_jax_solve_fn_on_the_fanout_table(case):
    """The kernel's operands in plain tensors, through ``assemble_from_free``,
    within 1e-5 m of the JAX solver's ``solve_fn`` of the same decoded planes."""
    sc, sm, rc, rm = case["bases"]
    fan = case["fan"]
    n = fan.n_tris
    jfan = jds.DeformationSolver(case["verts"], case["faces"], cnst_indices=case["cnst"],
                                 corr_count=case["count"], corr_faces=case["corr"])
    consts = fan.device_consts("cpu")
    free = K3.decode_solve_full_rounded(case["cs"], case["cr"], case["fan_fsc"])
    got = K3.assemble_from_free(consts, fan.spec, free, consts.template_cnst).numpy()
    dgrad = np.concatenate([(case["coef_s"] @ sc.T + sm).reshape(ROWS, n, 6),
                            (case["coef_r"] @ rc.T + rm).reshape(ROWS, n, 3)], axis=-1)
    want = np.asarray(jfan.solve(dgrad))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= KERNEL_TOL_M


@pytest.mark.parametrize("table", ["ident_fsc", "fan_fsc"])
def test_operand_layout_and_padding(case, table):
    fsc = case[table]
    solver = case["fan"] if table == "fan_fsc" else case["ident"]
    _, ep, nf = fsc.p.shape
    n, n_eqs = solver.n_tris, solver.n_eqs
    tp = fsc.basis_s.shape[2]
    # the plain version's table and P over the equations
    assert ep % K3.T_ALIGN == 0 and ep >= n_eqs > ep - K3.T_ALIGN
    assert fsc.eq_idx.dtype == torch.int32 and fsc.eq_idx.shape == (ep,)
    np.testing.assert_array_equal(fsc.eq_idx[:n_eqs].numpy(), solver._eq_src)
    assert bool((fsc.eq_idx[n_eqs:] == -1).all())  # the padded tail reads the identity ...
    assert int(torch.count_nonzero(fsc.p[:, n_eqs:])) == 0  # ... times zero P rows
    # the kernel's operands over the triangles: K = 3T' whole k tiles
    assert tp % K3.T_ALIGN == 0 and tp >= n > tp - K3.T_ALIGN and (3 * tp) % K3.K_TILE == 0
    assert fsc.t0.shape == (9, tp) and fsc.x0.shape == (3, nf)
    n_pad = -(-nf // K3.N_TILE) * K3.N_TILE
    assert fsc.b_t.shape == (2, n_pad, 3 * tp) and fsc.b_t.is_contiguous()
    hi, lo = fsc.b_t
    assert int((_bits(hi) & 0x1FFF).max()) == 0 and int((_bits(lo) & 0x1FFF).max()) == 0
    assert int(torch.count_nonzero(fsc.b_t[:, nf:])) == 0  # the N tile's dead columns
    pt = (hi[:nf].double() + lo[:nf].double()).T.reshape(3, tp, nf)
    assert int(torch.count_nonzero(pt[:, n:])) == 0  # the padded triangles multiply zero
    pt64, _ = K3.fold_table(solver, tp)
    assert float((pt - torch.from_numpy(pt64)).abs().max()) <= 2.0 ** -21 * float(
        np.abs(pt64).max())
    # ΔT: the padded tail's T and T0 are both the identity
    dt = K3.delta_transforms(case["cs"], case["cr"], fsc)
    assert dt.shape == (ROWS, 9, tp) and int(torch.count_nonzero(dt[:, :, n:])) == 0
    eye = torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0])
    assert torch.equal(fsc.t0[:, n:], eye[:, None].expand(9, tp - n))
    t = K3.equation_transforms(case["cs"], case["cr"], fsc)
    no_source = (fsc.eq_idx < 0).nonzero()[:, 0]
    assert len(no_source) >= ep - n_eqs
    assert torch.equal(t[:, :, no_source], eye[None, :, None].expand(ROWS, 9, len(no_source)))


@pytest.mark.parametrize("windows", [1, 7, 43, 216, 512])
def test_k_parts_over_k_prime_leave_no_part_empty(windows):
    """K = 3T' over the folded triangles at FLAME's count (9976, T' 10112),
    as the full product walks it: every part has k tiles, together all of
    them, at one and two resident blocks a multiprocessor."""
    m, n_pad, k = 3 * windows, 1280, 3 * 10112
    for resident in (132, 264):
        parts = K3.k_parts(m, n_pad, k, resident)
        per = -(-(k // K3.K_TILE) // parts)
        assert parts >= 1 and (parts - 1) * per < k // K3.K_TILE <= parts * per
        assert parts == 1 or per >= K3.MIN_PART_TILES
    assert K3.k_parts(3 * 216, 1280, 3 * 10112, 264) == 4
    assert K3.k_parts(3 * 216, 1280, 3 * 10112, 132) == 2


def test_cost_full_counts_three_tensor_core_products(case):
    """``cost_full``: the kernel's arithmetic as ``decode_solve_full_rounded``
    repeats it (the decode once per triangle, three TF32 products over K =
    3T'), every input of the kernel read once, the output once."""
    from torch.utils.flop_counter import FlopCounterMode

    fsc = case["fan_fsc"]
    tp = fsc.basis_s.shape[2]
    nf = fsc.x0.shape[1]
    flops, moved = K3.cost_full(ROWS, KS, KR, tp, nf)
    with FlopCounterMode(display=False) as counter:
        K3.decode_solve_full_rounded(case["cs"], case["cr"], fsc)
    assert flops == pytest.approx(counter.get_total_flops(), rel=1e-6)
    product = 2.0 * ROWS * 9 * tp * nf
    assert flops - 3 * product == pytest.approx(2.0 * ROWS * (6 * KS + 3 * KR) * tp)
    inputs = sum(t.numel() for t in (case["cs"], case["cr"], fsc.basis_s, fsc.means_s,
                                     fsc.basis_r, fsc.means_r, fsc.t0, fsc.x0, fsc.b_t))
    assert moved == 4 * (inputs + ROWS * 3 * nf)
