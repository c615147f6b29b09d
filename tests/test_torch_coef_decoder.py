"""``CoefDecoder`` of the port, the client's CPU decoder of the coefficient
wire, against the float64 solve oracle and the JAX package's decoder on the
same template, PCA bases and coefficients (the fixture of
tests/test_torch_slice.py, narrow widths).

Tolerances (metres): ``precise=True`` is the oracle's own arithmetic: 1e-6
to ``solve_host`` fed the float32 PCA decode, 2e-8 to the JAX decoder's
precise path (float64 both; the results are float32 at 0.1 m, so one
rounding, 1.5e-8, at most); the default path (float32
front half, float64 back-substitution) 5e-7 to the precise one and to the JAX
decoder's default path (tests/test_streaming.py:398); one frame against its
row of a batch 1e-6 on the default path, bit for bit on the precise one; the
elementwise Rodrigues form against the oracle's matrix form 1e-13.
"""

import numpy as np
import pytest
import torch

from test_torch_slice import task_pair

from sdfa_tpu.streaming import CoefDecoder as JCoefDecoder
from sdfa_tpu_torch.ops.deform_solver import transforms_t_np
from sdfa_tpu_torch.streaming import CoefDecoder

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    with task_pair(tmp_path_factory.mktemp("coef"), narrow=True) as (jtask, ttask, n_verts):
        yield JCoefDecoder(jtask), CoefDecoder(ttask), ttask, n_verts


@pytest.fixture(scope="module")
def coefs():
    return np.random.default_rng(11).normal(0, 1.0, (9, 85 + 180)).astype(np.float32)


def test_fingerprint_equal_on_both_sides(decoders):
    jdec, tdec, _, _ = decoders
    assert tdec.fingerprint() == jdec.fingerprint()
    assert (tdec.n_scale, tdec.n_rotat, tdec.n_coefs) == (jdec.n_scale, jdec.n_rotat, 265)
    tdec.check_fingerprint(jdec.fingerprint())
    tdec.check_fingerprint(None)  # a server that announces none
    with pytest.raises(AssertionError, match="decode system"):
        tdec.check_fingerprint(dict(jdec.fingerprint(), system_sha1="0" * 16))


def test_precise_is_the_solve_oracle(decoders, coefs):
    jdec, tdec, ttask, n_verts = decoders
    got = tdec.decode(coefs, precise=True)
    assert got.shape == (len(coefs), n_verts, 3) and got.dtype == np.float32
    model = ttask.model
    with torch.no_grad():
        c = torch.from_numpy(coefs).double()
        preds = {"dgrad_3d_scale_pca": c[:, None, :85].float(),
                 "dgrad_3d_rotat_pca": c[:, None, 85:].float()}
        dgrad = model.decode_to_anime(preds)[:, 0].double().numpy()
    oracle = np.stack([tdec._solver.solve_host(d) for d in dgrad])
    assert float(np.abs(got - oracle).max()) <= 1e-6  # the oracle's dgrad went through float32
    assert float(np.abs(got - jdec.decode(coefs, precise=True)).max()) <= 2e-8


def test_default_path_tracks_precise_and_jax(decoders, coefs):
    jdec, tdec, _, _ = decoders
    fast, precise = tdec.decode(coefs), tdec.decode(coefs, precise=True)
    assert fast.dtype == np.float32 and fast.shape == precise.shape
    np.testing.assert_allclose(fast, precise, atol=5e-7)
    np.testing.assert_allclose(fast, jdec.decode(coefs), atol=5e-7)
    # float16 coefficients (the coef16 wire) are upcast by the decoder itself
    half = coefs.astype(np.float16)
    np.testing.assert_allclose(tdec.decode(half), jdec.decode(half), atol=5e-7)


def test_single_frame_matches_its_batch_row(decoders, coefs):
    _, tdec, _, n_verts = decoders
    one = tdec.decode(coefs[0])
    assert one.shape == (n_verts, 3)
    np.testing.assert_allclose(one, tdec.decode(coefs)[0], atol=1e-6)
    np.testing.assert_array_equal(tdec.decode(coefs[0], precise=True),
                                  tdec.decode(coefs, precise=True)[0])
    with pytest.raises(ValueError, match="265"):
        tdec.decode(coefs[:, :100])


def test_elementwise_rodrigues_is_the_oracle_s(decoders):
    jdec, tdec, _, _ = decoders
    dg = np.random.default_rng(2).normal(size=(512, 9)) * 0.2
    dg[:3, 6:] = 0.0  # the small-angle branch: R = I
    got = tdec._transforms_t_fast(dg)
    np.testing.assert_allclose(got, transforms_t_np(dg), atol=1e-13, rtol=1e-13)
    np.testing.assert_allclose(got, jdec._transforms_t_fast(dg), atol=1e-13, rtol=1e-13)
