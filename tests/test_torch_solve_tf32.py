"""The decode + solve kernel's TF32 product, repeated in plain tensors on the CPU.

On a card ``csrc/decode_solve.cu`` multiplies ΔT = T − T0 by P on the tensor
cores in TF32 with float32 sums, both operands rounded to nearest first (the
tensor cores would truncate them). ``round_tf32`` and ``decode_solve_rounded``
in ``ops/decode_solve.py`` repeat that rounding; here they are held to the
plain version, to the float64 product and to the JAX package's delta kernel
in interpret mode, which multiplies in one bf16 pass, on the small solver of
``tests/test_torch_kernels_plain.py``. ``k_parts`` (into how many parts the
kernel splits K) is walked over the shapes a card would give it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdfa_tpu.ops import deform_solver as jds
from sdfa_tpu.ops import pallas_decode_solve as jpds
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.ops import decode_solve as K3
from sdfa_tpu_torch.ops.deform_solver import DeformationSolver

KERNEL_TOL_M = 1e-5  # the kernel's gate against the plain version, metres


def _f32(bits):
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(torch.float32)


def _bits(x):
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),  # 1.0: nothing to round
    (0x3F800FFF, 0x3F800000),  # just under half a step: down
    (0x3F801000, 0x3F800000),  # a tie, even below: down
    (0x3F801001, 0x3F802000),  # just over half: up
    (0x3F803000, 0x3F804000),  # a tie, odd below: up to even
    (0x3F802FFF, 0x3F802000),
    (0xBF803000, 0xBF804000),  # the sign does not change the rounding of the size
    (0xBF801000, 0xBF800000),
    (0x3FFFF000, 0x40000000),  # the mantissa carries into the exponent
    (0x00000000, 0x00000000),
])
def test_round_tf32_rounds_to_nearest_even(bits, want):
    assert int(_bits(K3.round_tf32(_f32([bits])))[0]) == want


def test_round_tf32_is_idempotent_and_nearest():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(0, 1, 20000) * 10.0 ** rng.integers(-6, 4, 20000))
                         .astype(np.float32))
    r = K3.round_tf32(x)
    assert torch.equal(K3.round_tf32(r), r)
    assert int((_bits(r) & 0x1FFF).max()) == 0  # 13 low bits clear: a TF32 value
    step = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 1 - 10)  # one TF32 step at |x|
    assert bool(((r - x).abs() <= step / 2).all())
    t = K3.truncate_tf32(x)
    assert bool((t.abs() <= x.abs()).all()) and bool(((t - x).abs() < step).all())
    assert float((r - x).abs().mean()) < 0.6 * float((t - x).abs().mean())


@pytest.fixture(scope="module")
def small():
    """The small solver with seeded PCA bases, 16 windows of coefficients, the
    port's constants and the JAX package's."""
    verts, faces, cnst = synthetic_template(0, n_major=8, n_minor=10, n_extra=3, n_free=30)
    jsolver = jds.DeformationSolver(verts, faces, cnst_indices=cnst)
    tsolver = DeformationSolver(verts, faces, cnst)
    n, ks, kr, rows = tsolver.n_tris, 12, 7, 16
    rng = np.random.default_rng(3)

    def rand(shape, scale):
        return rng.normal(0, scale, shape).astype(np.float32)

    sc, sm, rc, rm = rand((6 * n, ks), 0.05), rand((6 * n,), 0.05), rand((3 * n, kr), 0.05), \
        rand((3 * n,), 0.05)
    coef_s, coef_r = rand((rows, ks), 1.0), rand((rows, kr), 1.0)
    dsc = K3.prep_consts(sc, sm, rc, rm, tsolver, "cpu")
    jdsc = jpds.prep_consts({"compT": sc, "means": sm}, {"compT": rc, "means": rm},
                            jsolver.consts, jsolver.spec)
    cs, cr = torch.from_numpy(coef_s), torch.from_numpy(coef_r)
    dt = K3.delta_transforms(cs, cr, dsc)
    _, tp, nf = dsc.p.shape
    exact = ((dt.double().reshape(3 * rows, 3 * tp) @ dsc.p.double().reshape(3 * tp, nf))
             .reshape(rows, 3, nf) + dsc.x0.double())
    return dict(dsc=dsc, jdsc=jdsc, cs=cs, cr=cr, coef_s=coef_s, coef_r=coef_r, exact=exact)


def test_p_t_is_p_transposed_padded_and_rounded(small):
    dsc = small["dsc"]
    _, tp, nf = dsc.p.shape
    assert dsc.p_t.shape == (-(-nf // K3.N_TILE) * K3.N_TILE, 3 * tp)
    assert dsc.p_t.is_contiguous() and dsc.p_t.dtype == torch.float32
    assert torch.equal(dsc.p_t[:nf], K3.round_tf32(dsc.p.reshape(3 * tp, nf).T))
    assert float(dsc.p_t[nf:].abs().max()) == 0.0  # the N tile's dead columns multiply by zero
    assert float((dsc.p_t[:nf].T - dsc.p.reshape(3 * tp, nf)).abs().max()) > 0.0  # p is not TF32
    assert tp % K3.T_ALIGN == 0 and (3 * tp) % K3.K_TILE == 0  # K is whole k tiles


def test_rounded_product_is_within_the_kernel_gate_of_plain(small):
    got = K3.decode_solve_rounded(small["cs"], small["cr"], small["dsc"])
    want = K3.decode_solve_plain(small["cs"], small["cr"], small["dsc"])
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < KERNEL_TOL_M


def test_rounded_product_is_no_further_from_float64_than_the_jax_delta_kernel(small):
    """The TPU kernel's delta form multiplies ΔT by P in one bf16 pass (8
    mantissa bits); TF32 keeps 10, so the port's product must not be further
    from the float64 product than the JAX kernel in interpret mode is."""
    jax_x = np.asarray(jpds.decode_solve_free(jnp.asarray(small["coef_s"]),
                                              jnp.asarray(small["coef_r"]), small["jdsc"],
                                              interpret=True, delta=True, precise=True))
    exact = small["exact"].numpy()
    err_jax = float(np.abs(jax_x - exact).max())
    err_port = float((K3.decode_solve_rounded(small["cs"], small["cr"], small["dsc"]).double()
                      - small["exact"]).abs().max())
    assert err_port <= err_jax
    assert err_jax < 1e-4  # the JAX kernel itself is inside the end-to-end budget here


def test_truncation_is_measurably_worse_than_rounding(small):
    """Why both operands are rounded before the tensor cores see them: left
    alone they are truncated, which errs twice as far and always towards zero."""
    dsc, cs, cr, exact = small["dsc"], small["cs"], small["cr"], small["exact"]
    _, tp, nf = dsc.p.shape
    truncated_p = dsc._replace(p_t=torch.nn.functional.pad(
        K3.truncate_tf32(dsc.p.reshape(3 * tp, nf).T), (0, 0, 0, dsc.p_t.shape[0] - nf)))
    err_round = (K3.decode_solve_rounded(cs, cr, dsc).double() - exact).abs()
    err_trunc = (K3.decode_solve_rounded(cs, cr, truncated_p, rounding=K3.truncate_tf32).double()
                 - exact).abs()
    assert float(err_trunc.mean()) > 1.5 * float(err_round.mean())
    assert float(err_trunc.max()) > float(err_round.max())


@pytest.mark.parametrize("resident", [132, 264])
@pytest.mark.parametrize("windows", [1, 7, 43, 216, 256, 257, 2048, 27648])
def test_k_parts_fill_the_card_and_leave_no_part_empty(windows, resident):
    m, n_pad, k = 3 * windows, 1280, 3 * 10112
    parts = K3.k_parts(m, n_pad, k, resident)
    tiles = -(-m // K3.M_TILE) * (n_pad // K3.N_TILE)
    k_tiles = k // K3.K_TILE
    per = -(-k_tiles // parts)
    assert parts >= 1 and (parts - 1) * per < k_tiles <= parts * per  # none empty, all covered
    assert parts == 1 or parts * tiles <= resident  # one wave of resident blocks
    assert parts == 1 or per >= K3.MIN_PART_TILES
    if (windows, resident) in ((216, 264), (256, 264)):
        assert parts == 4  # a request: 60 tiles x 4 parts = 240 blocks of the 264 resident
    if windows >= 2048:
        assert parts == 1  # enough tiles of their own
    assert K3.k_parts(m, n_pad, k, resident) == parts  # a shape's split is one


def test_k_parts_small_solver():
    """The small solver's K is a few k tiles: one part."""
    assert K3.k_parts(48, 128, 3 * 256, 264) == 1
    assert K3.k_parts(3, 128, 3 * 128 * 16, 264) == 3 * 128 * 16 // K3.K_TILE // K3.MIN_PART_TILES


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """Fault C4: PCA bases fitted by the port's ``synthetic._fit_pca`` on frames
    made as ``synthetic.generate`` makes them, at the small solver's triangle
    count, and the reader's own projected target coefficients of every frame
    (the magnitudes training aims at)."""
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.data import DatasetSlidingWindow, synthetic

    verts, faces, cnst = synthetic_template(0, n_major=8, n_minor=10, n_extra=3, n_free=30)
    solver = DeformationSolver(verts, faces, cnst)
    root = str(tmp_path_factory.mktemp("c4") / "voca")
    saved = synthetic.N_TRIS
    synthetic.N_TRIS = solver.n_tris
    try:
        synthetic.generate(root, "dgrad_3d", speakers=["m0", "f0"], sentences_per_speaker=1,
                           seconds_per_sentence=2.0)  # the shipped 85 + 180 coefficients
    finally:
        synthetic.N_TRIS = saved
    reader = DatasetSlidingWindow(configure("dgrad", dataset_root=root,
                                            overrides={"trainer": {"pca_targets": True}}), True)
    coefs = np.concatenate([np.asarray(reader._frame_store(
        info["npy_data_path:path"], info["anime_minfi:int"], info["anime_maxfi:int"])[3])
        for info in reader.info_list])
    (sc, sm), (rc, rm) = reader._pca_mats
    dsc = K3.prep_consts(sc, sm, rc, rm, solver, "cpu")
    ks = sc.shape[1]
    return dict(dsc=dsc, cs=torch.from_numpy(coefs[:, :ks].copy()),
                cr=torch.from_numpy(coefs[:, ks:].copy()), n_frames=len(coefs))


def test_fitted_bases_rounded_product_within_budgets(fitted, small):
    """K3's TF32 product at trained magnitudes: within 1e-5 m of the plain
    version and 1e-4 m of the float64 decode + product, on every frame."""
    dsc, cs, cr = fitted["dsc"], fitted["cs"], fitted["cr"]
    assert fitted["n_frames"] == 240 and cs.shape[1] == 85 and cr.shape[1] == 180
    got = K3.decode_solve_rounded(cs, cr, dsc)
    plain = K3.decode_solve_plain(cs, cr, dsc)
    exact = K3.decode_solve_plain(cs.double(), cr.double(),
                                  K3.DecodeSolveConsts(*(t.double() for t in dsc)))
    assert float((got - plain).abs().max()) <= KERNEL_TOL_M
    assert float((got.double() - exact).abs().max()) <= 1e-4
    # the fitted bases reach further from T0 than the seeded ones the card held before
    dt_fitted = float(K3.delta_transforms(cs, cr, dsc).abs().max())
    dt_seeded = float(K3.delta_transforms(small["cs"], small["cr"], small["dsc"]).abs().max())
    assert np.isfinite(dt_fitted) and dt_fitted > 0.05 and dt_seeded > 0


def test_fitted_bases_truncation_would_err_further(fitted):
    """At trained magnitudes, as at seeded ones: operands left to the tensor
    cores' truncation err further from the float64 product than rounded ones."""
    dsc, cs, cr = fitted["dsc"], fitted["cs"], fitted["cr"]
    _, tp, nf = dsc.p.shape
    exact = K3.decode_solve_plain(cs.double(), cr.double(),
                                  K3.DecodeSolveConsts(*(t.double() for t in dsc)))
    truncated_p = dsc._replace(p_t=torch.nn.functional.pad(
        K3.truncate_tf32(dsc.p.reshape(3 * tp, nf).T), (0, 0, 0, dsc.p_t.shape[0] - nf)))
    err_round = (K3.decode_solve_rounded(cs, cr, dsc).double() - exact).abs()
    err_trunc = (K3.decode_solve_rounded(cs, cr, truncated_p, rounding=K3.truncate_tf32)
                 .double() - exact).abs()
    assert float(err_trunc.mean()) > 1.5 * float(err_round.mean())
