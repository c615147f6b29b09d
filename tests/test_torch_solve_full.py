"""K3's full body (``ops/decode_solve.py::decode_solve_full``), held to the
JAX package on the CPU.

On a card the full body decodes each equation's T = exp(skew(r))·S from the
PCA coefficients (gathering its source triangle, the identity where it has
none) and multiplies by P over the equations as 3xTF32 on the tensor cores.
Here, on the small solver of ``tests/test_torch_kernels_plain.py`` with
seeded bases:

- on the identity table its plain version against the TPU ``_kernel`` in
  interpret mode (``delta=False, precise=True``, P in float32) within 1e-5 m,
  and no further from the float64 product than that kernel is;
- on the fan-out correspondence table of ``tests/test_torch_retarget.py``
  against the JAX ``solve_fn`` of the same decoded planes (1e-5 m) and the
  float64 host solve (1e-4 m);
- ``split_tf32`` and ``decode_solve_full_rounded`` (the kernel's operands in
  plain tensors) against the plain version, the operands' layout and
  padding, ``k_parts`` over K' = 9E' and ``cost_full``.
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


def _exact(case, fsc):
    """The float64 decode, gather and product of the case's coefficients."""
    f64 = K3.DecodeSolveFullConsts(*(t.double() if t.is_floating_point() else t for t in fsc))
    return K3.decode_solve_full_plain(case["cs"].double(), case["cr"].double(), f64)


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
    # one TF32 pass alone would miss: the long mantissa is what the body needs
    _, ep, nf = fsc.p.shape
    t = K3.equation_transforms(case["cs"], case["cr"], fsc).reshape(3 * ROWS, 3 * ep)
    one_pass = (K3.round_tf32(t) @ fsc.b_t[:nf, :3 * ep].T).reshape(plain.shape)
    assert float((one_pass - plain).abs().max()) > 10 * float((got - plain).abs().max())


@pytest.mark.parametrize("table", ["ident_fsc", "fan_fsc"])
def test_operand_layout_and_padding(case, table):
    fsc = case[table]
    solver = case["fan"] if table == "fan_fsc" else case["ident"]
    _, ep, nf = fsc.p.shape
    n_eqs = solver.n_eqs
    assert ep % K3.T_ALIGN == 0 and (9 * ep) % K3.K_TILE == 0 and ep >= n_eqs > ep - K3.T_ALIGN
    assert fsc.eq_idx.dtype == torch.int32 and fsc.eq_idx.shape == (ep,)
    np.testing.assert_array_equal(fsc.eq_idx[:n_eqs].numpy(), solver._eq_src)
    assert bool((fsc.eq_idx[n_eqs:] == -1).all())  # the padded tail reads the identity ...
    assert int(torch.count_nonzero(fsc.p[:, n_eqs:])) == 0  # ... times zero P rows
    n_pad = -(-nf // K3.N_TILE) * K3.N_TILE
    assert fsc.b_t.shape == (n_pad, 9 * ep) and fsc.b_t.is_contiguous()
    p_t = fsc.p.reshape(3 * ep, nf).T
    hi, lo = K3.split_tf32(p_t.contiguous())
    w = 3 * ep
    assert torch.equal(fsc.b_t[:nf, :w], hi) and torch.equal(fsc.b_t[:nf, w:2 * w], lo)
    assert torch.equal(fsc.b_t[:nf, 2 * w:], hi)
    assert int(torch.count_nonzero(fsc.b_t[nf:])) == 0
    t = K3.equation_transforms(case["cs"], case["cr"], fsc)
    a = K3.full_operand(t)
    ahi, alo = K3.split_tf32(t.reshape(3 * ROWS, w))
    assert a.shape == (3 * ROWS, 9 * ep)
    assert torch.equal(a[:, :w], ahi) and torch.equal(a[:, w:2 * w], ahi)
    assert torch.equal(a[:, 2 * w:], alo)
    eye = torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0])
    no_source = (fsc.eq_idx < 0).nonzero()[:, 0]
    assert len(no_source) >= ep - n_eqs
    assert torch.equal(t[:, :, no_source], eye[None, :, None].expand(ROWS, 9, len(no_source)))


@pytest.mark.parametrize("windows", [1, 7, 43, 216, 512])
def test_k_parts_over_k_prime_leave_no_part_empty(windows):
    """K' = 9E' at the fan-out table ``chip_smoke.py`` drives (13966
    equations, E' 14080): every part has k tiles, together all of them."""
    m, n_pad, k = 3 * windows, 1280, 9 * 14080
    for resident in (132, 264):
        parts = K3.k_parts(m, n_pad, k, resident)
        per = -(-(k // K3.K_TILE) // parts)
        assert parts >= 1 and (parts - 1) * per < k // K3.K_TILE <= parts * per
        assert parts == 1 or per >= K3.MIN_PART_TILES
    assert K3.k_parts(3 * 216, 1280, 9 * 14080, 264) == 4


def test_cost_full_counts_three_tensor_core_products(case):
    """``cost_full``: the plain version's FLOPs with the product counted three
    times (3xTF32), every input of the kernel read once, the output once."""
    from torch.utils.flop_counter import FlopCounterMode

    fsc = case["fan_fsc"]
    tp = fsc.basis_s.shape[2]
    _, ep, nf = fsc.p.shape
    flops, moved = K3.cost_full(ROWS, KS, KR, tp, ep, nf)
    with FlopCounterMode(display=False) as counter:
        K3.decode_solve_full_plain(case["cs"], case["cr"], fsc)
    product = 2.0 * ROWS * 9 * ep * nf
    assert flops - 2 * product == pytest.approx(counter.get_total_flops(), rel=1e-6)
    inputs = sum(t.numel() for t in (case["cs"], case["cr"], *fsc)) - fsc.p.numel()
    assert moved == 4 * (inputs + ROWS * 3 * nf)
